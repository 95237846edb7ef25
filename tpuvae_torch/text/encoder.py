"""Multilingual sentence encoder as ``nn.Module``s (counterpart of
``tpuvae/text/encoder.py``).

The reference embeds lyrics with ``SentenceTransformer(
'paraphrase-multilingual-mpnet-base-v2')`` -> (N, 768)
(``1_preprocessing_advanced.py:327-341``), published as
``sentence-transformers/paraphrase-multilingual-mpnet-base-v2``: an
XLM-RoBERTa-base encoder (12 layers, hidden 768, 12 heads, vocab 250,002)
with attention-masked mean pooling.  This module is the same graph in
PyTorch, in fp32, with the numerics of the JAX package's flax model:

* XLM-R position ids ``cumsum(mask) * mask + pad_token_id``: padded
  tokens take position ``pad_token_id``;
* attention in flax's order (``flax.linen.dot_product_attention_weights``):
  the query divided by sqrt(head_dim) before the QK^T product, masked
  logits set to ``finfo(float32).min`` (not ``-inf``), every query row
  attending to the valid keys only, softmax, then the values;
* exact (erf) GELU;
* LayerNorm with flax's statistics (``use_fast_variance``: E[x^2] - E[x]^2,
  clipped at 0) and the config's eps everywhere;
* masked mean pooling divided by ``max(sum(mask), 1e-9)``.

The products are plain ``nn.Linear`` / ``torch.matmul`` (the JAX package
computes them in flax, outside any Pallas kernel); entry points turn TF32
off for cuBLAS (``tpuvae_torch.device.resolve_device``).  Parameter names
follow the flax modules (``word_emb``, ``layers.<i>.attention.query``,
``layers.<i>.ffn_in``, ...); :func:`convert_hf_state_dict` maps a
HuggingFace checkpoint onto them and ``tpuvae_torch.convert`` carries
weights to and from flax.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250002
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 514
    type_vocab: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: mean and E[x^2] in one pass, variance
    ``max(0, E[x^2] - E[x]^2)``, then ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp(x.square().mean(-1, keepdim=True) - mean.square(),
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = hidden) over
    one sequence, keys masked."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x, key_mask):
        b, t, h = x.shape
        d = h // self.heads

        def split(v):                       # (b, t, h) -> (b, heads, t, d)
            return v.view(b, t, self.heads, d).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(d)
        k, v = split(self.key(x)), split(self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2))     # (b, heads, t, t)
        logits = logits.masked_fill(~key_mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
        attn = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out(attn.transpose(1, 2).reshape(b, t, h))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden
        self.attention = SelfAttention(h, cfg.heads)
        self.attn_ln = LayerNorm(h, cfg.layer_norm_eps)
        self.ffn_in = nn.Linear(h, cfg.intermediate)
        self.ffn_out = nn.Linear(cfg.intermediate, h)
        self.ffn_ln = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, x, key_mask):
        x = self.attn_ln(x + self.attention(x, key_mask))
        hid = F.gelu(self.ffn_in(x), approximate="none")
        return self.ffn_ln(x + self.ffn_out(hid))


class SentenceEncoder(nn.Module):
    """Token ids + mask -> mean-pooled ``hidden``-d sentence embeddings."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.word_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos_emb = nn.Embedding(cfg.max_positions, cfg.hidden)
        self.type_emb = nn.Embedding(cfg.type_vocab, cfg.hidden)
        self.emb_ln = LayerNorm(cfg.hidden, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            [TransformerLayer(cfg) for _ in range(cfg.layers)])

    def forward(self, input_ids, attention_mask):
        ids = input_ids.long()
        mask = attention_mask.long()
        # XLM-R position ids: pad-aware offset from pad_token_id + 1
        positions = torch.cumsum(mask, dim=1) * mask + self.cfg.pad_token_id
        x = (self.word_emb(ids) + self.pos_emb(positions)
             + self.type_emb(torch.zeros_like(ids)))
        x = self.emb_ln(x)
        key_mask = mask.bool()
        for layer in self.layers:
            x = layer(x, key_mask)
        # attention-masked mean pooling (sentence-transformers default)
        m = mask[..., None].to(x.dtype)
        return (x * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)


def _getter(state_dict: dict):
    def g(key):
        for prefix in ("", "roberta.", "0.auto_model."):
            k = prefix + key
            if k in state_dict:
                return state_dict[k]
        raise KeyError(key)
    return g


def _shape(v) -> tuple:
    return tuple(v.shape)


def infer_encoder_config(state_dict: dict,
                         hf_config: dict | None = None) -> EncoderConfig:
    """Encoder geometry from a checkpoint's weight shapes.

    vocab/hidden/layers/intermediate/max_positions/type_vocab are all
    determined by shapes.  ``heads`` is NOT recoverable from shapes (the
    per-head split is a reshape): pass the checkpoint's ``config.json``
    dict as ``hf_config`` to use its ``num_attention_heads``; without it
    the XLM-R family's 64-d head convention is assumed (768 hidden ->
    12 heads).  Lets the checkpoint path run any XLM-R-family size, not
    just the 278 M-param base.
    """
    g = _getter(state_dict)
    vocab, hidden = _shape(g("embeddings.word_embeddings.weight"))
    layers = 1 + max(
        int(m.group(1))
        for k in state_dict
        if (m := re.search(r"encoder\.layer\.(\d+)\.", k))
    )
    heads = int((hf_config or {}).get("num_attention_heads", 0)) or max(
        1, int(hidden) // 64
    )
    if hidden % heads:
        raise ValueError(
            f"hidden={hidden} not divisible by heads={heads}; supply the "
            f"checkpoint's config.json (num_attention_heads) next to "
            f"pytorch_model.bin"
        )
    return EncoderConfig(
        vocab_size=int(vocab),
        hidden=int(hidden),
        layers=layers,
        heads=heads,
        intermediate=int(_shape(
            g("encoder.layer.0.intermediate.dense.weight"))[0]),
        max_positions=int(_shape(
            g("embeddings.position_embeddings.weight"))[0]),
        type_vocab=int(_shape(
            g("embeddings.token_type_embeddings.weight"))[0]),
    )


# HuggingFace XLM-R name (after "encoder.layer.<i>.") -> the port's name
# (after "layers.<i>."); every weight keeps its torch layout
_HF_LAYER = {
    "attention.self.query": "attention.query",
    "attention.self.key": "attention.key",
    "attention.self.value": "attention.value",
    "attention.output.dense": "attention.out",
    "attention.output.LayerNorm": "attn_ln",
    "intermediate.dense": "ffn_in",
    "output.dense": "ffn_out",
    "output.LayerNorm": "ffn_ln",
}
_HF_EMB = {
    "embeddings.word_embeddings": "word_emb",
    "embeddings.position_embeddings": "pos_emb",
    "embeddings.token_type_embeddings": "type_emb",
    "embeddings.LayerNorm": "emb_ln",
}


def convert_hf_state_dict(state_dict: dict, cfg: EncoderConfig = EncoderConfig()
                          ) -> "OrderedDict[str, torch.Tensor]":
    """Map a HuggingFace XLM-RoBERTa state dict (``roberta.*`` /
    ``embeddings.*`` / ``0.auto_model.*`` naming; tensors or numpy arrays)
    onto :class:`SentenceEncoder`'s ``state_dict`` names, for
    ``load_state_dict``.  Tensors pass through as float32, no copy where
    they already are."""
    g = _getter(state_dict)

    def t(key):
        v = g(key)
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        return v.to(torch.float32)

    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for hf, port in _HF_EMB.items():
        out[f"{port}.weight"] = t(f"{hf}.weight")
        if hf.endswith("LayerNorm"):
            out[f"{port}.bias"] = t(f"{hf}.bias")
    for i in range(cfg.layers):
        for hf, port in _HF_LAYER.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{port}.{leaf}"] = t(
                    f"encoder.layer.{i}.{hf}.{leaf}")
    return out
