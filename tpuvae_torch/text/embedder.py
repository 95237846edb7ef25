"""Lyrics -> (N, 768) embedding front-end (counterpart of
``tpuvae/text/embedder.py``).

Capability match of ``create_lyrics_embeddings``
(``1_preprocessing_advanced.py:327-341``): coerces empty lyrics to ``' '``.
The only backend ported is the deterministic, offline hashed-n-gram
embedder, which is what the JAX package uses without a checkpoint.  A
checkpoint of the XLM-RoBERTa sentence encoder (argument or
``$TPUVAE_TEXT_CHECKPOINT``) is never silently ignored: one that does not
exist raises ``FileNotFoundError``, one that exists raises
``NotImplementedError`` until the encoder is ported.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from tpuvae_torch.text.hashing import embed_texts


def embed_lyrics(lyrics_list, *,
                 checkpoint: str | None = None) -> tuple[np.ndarray, str]:
    """Embed lyrics; returns ``(embeddings, backend_name)``.

    ``backend_name`` is recorded into the saved artifact metadata so
    downstream results are attributable (hashed n-grams are NOT
    semantically equivalent to the reference's sentence-transformer).
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
        raise NotImplementedError(
            f"the XLM-RoBERTa lyrics encoder is not ported to tpuvae_torch "
            f"yet (ROADMAP.md, queue 1, item 4: text/tokenizer, "
            f"text/encoder), so checkpoint {checkpoint!r} cannot be used; "
            f"unset it to use the offline hashed-ngram embedder")
    return embed_texts(lyrics_cleaned), "hashed-ngram"

