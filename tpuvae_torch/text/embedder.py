"""Lyrics -> (N, 768) embedding front-end with backend selection
(counterpart of ``tpuvae/text/embedder.py``).

Capability match of ``create_lyrics_embeddings``
(``1_preprocessing_advanced.py:327-341``): coerces empty lyrics to ``' '``,
batches the encode.  Backend resolution order:

  1. ``checkpoint`` path (or ``$TPUVAE_TEXT_CHECKPOINT``) — a HuggingFace
     XLM-RoBERTa torch state dict (``pytorch_model.bin``, optional
     ``config.json``) + a sentencepiece model; runs
     :class:`~tpuvae_torch.text.encoder.SentenceEncoder` on ``device``.
  2. hashed n-grams (deterministic, offline; needs no device).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from tpuvae_torch.text.hashing import embed_texts


def embed_lyrics(lyrics_list, *, checkpoint: str | None = None,
                 batch_size: int = 32,
                 device: str | torch.device = "cuda") -> tuple[np.ndarray, str]:
    """Embed lyrics; returns ``(embeddings, backend_name)``, float32.

    ``backend_name`` is recorded into the saved artifact metadata so
    downstream results are attributable (a hashed-ngram embedding is NOT
    semantically equivalent to the reference's sentence-transformer).  The
    ``checkpoint`` argument takes precedence over
    ``$TPUVAE_TEXT_CHECKPOINT``; one that does not exist is an error, never
    a silent fallback.  A checkpoint runs on ``device`` (CUDA by default;
    raises without a card), ``batch_size`` sentences at a time; the
    hashed path ignores both.
    """
    lyrics_cleaned = [
        str(l) if l is not None and len(str(l)) > 0 else " " for l in lyrics_list
    ]
    checkpoint = checkpoint or os.environ.get("TPUVAE_TEXT_CHECKPOINT")
    if checkpoint:
        if not Path(checkpoint).exists():
            raise FileNotFoundError(
                f"lyrics-encoder checkpoint {checkpoint!r} does not exist "
                f"(from the `checkpoint` argument or $TPUVAE_TEXT_CHECKPOINT); "
                f"unset it to use the offline hashed-ngram fallback")
        enc = load_checkpoint_encoder(checkpoint, device)
        return (enc.encode(lyrics_cleaned, batch_size),
                f"xlmr-checkpoint:{Path(checkpoint).name}")
    return embed_texts(lyrics_cleaned), "hashed-ngram"


def create_lyrics_embeddings(lyrics_list, *, checkpoint: str | None = None,
                             batch_size: int = 32,
                             device: str | torch.device = "cuda") -> np.ndarray:
    return embed_lyrics(lyrics_list, checkpoint=checkpoint,
                        batch_size=batch_size, device=device)[0]


@dataclasses.dataclass
class CheckpointEncoder:
    """A checkpoint's encoder on its device, with its tokenizer."""

    model: torch.nn.Module        # SentenceEncoder, eval mode, on ``device``
    tokenizer: object             # XlmRobertaTokenizer
    max_len: int
    device: torch.device
    load_seconds: dict = dataclasses.field(default_factory=dict)  # by step

    def tokenize(self, texts) -> tuple[np.ndarray, np.ndarray]:
        batch = self.tokenizer(list(texts), max_length=self.max_len)
        return batch["input_ids"], batch["attention_mask"]

    def forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return self.model(torch.from_numpy(ids).to(self.device),
                              torch.from_numpy(mask).to(self.device))

    def encode(self, texts, batch_size: int = 32) -> np.ndarray:
        out = [self.forward(*self.tokenize(texts[i:i + batch_size])).cpu().numpy()
               for i in range(0, len(texts), batch_size)]
        return np.concatenate(out).astype(np.float32)


_LOADED: dict = {}
_LOAD_LOCK = threading.Lock()


def load_checkpoint_encoder(checkpoint: str | Path,
                            device: str | torch.device = "cuda"
                            ) -> CheckpointEncoder:
    """Read a checkpoint directory into a :class:`CheckpointEncoder` on
    ``device``.

    ``pytorch_model.bin`` is read with ``weights_only=True``; the geometry
    comes from its shapes and the optional ``config.json``
    (:func:`~tpuvae_torch.text.encoder.infer_encoder_config`); sequences
    are cut to ``min(128, max_positions - pad_token_id - 1)`` tokens, so
    position ids stay inside the table.  The encoder is kept for each
    (directory, weight file's mtime, device) for the life of the process:
    the JAX package re-reads the file on every call, the port reads it
    once (serving embeds every request's lyrics).  The outputs are the same.
    """
    from tpuvae_torch.device import resolve_device
    from tpuvae_torch.text.encoder import (
        SentenceEncoder,
        convert_hf_state_dict,
        infer_encoder_config,
    )
    from tpuvae_torch.text.tokenizer import (
        XlmRobertaTokenizer,
        find_sentencepiece_model,
    )

    dev = resolve_device(device)
    ckpt = Path(checkpoint).resolve()
    weights = ckpt / "pytorch_model.bin"
    key = (str(ckpt), weights.stat().st_mtime_ns, str(dev))
    with _LOAD_LOCK:
        enc = _LOADED.get(key)
        if enc is not None:
            return enc
        spm = find_sentencepiece_model(ckpt)
        if spm is None:
            raise FileNotFoundError(
                f"no sentencepiece model (*.model) in checkpoint dir "
                f"{str(checkpoint)!r}")
        t = [time.perf_counter()]
        state_dict = torch.load(weights, map_location="cpu", weights_only=True)
        t.append(time.perf_counter())
        cfg_json = ckpt / "config.json"
        hf_config = (json.loads(cfg_json.read_text())
                     if cfg_json.exists() else None)
        cfg = infer_encoder_config(state_dict, hf_config)
        with torch.device("meta"):      # no random init of 278 M weights
            model = SentenceEncoder(cfg)
        model.load_state_dict(convert_hf_state_dict(state_dict, cfg),
                              assign=True)
        del state_dict
        t.append(time.perf_counter())
        model.to(dev).eval()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t.append(time.perf_counter())
        tokenizer = XlmRobertaTokenizer(spm)
        t.append(time.perf_counter())
        enc = CheckpointEncoder(
            model=model, tokenizer=tokenizer,
            max_len=min(128, cfg.max_positions - cfg.pad_token_id - 1),
            device=dev, load_seconds=dict(zip(
                ("read", "convert", "to_device", "tokenizer"),
                np.diff(t).tolist())))
        _LOADED[key] = enc
        return enc
