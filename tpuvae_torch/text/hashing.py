"""Deterministic offline lyrics embedder (feature-hashed char n-grams; own
copy of ``tpuvae/text/hashing.py``).

Fallback for environments without the pretrained multilingual
checkpoint.  Produces the same (N, 768) float32
contract as the sentence-transformer (C8), is language-agnostic (char
n-grams work for Bangla and English alike), deterministic, and similar texts
map to nearby vectors — enough structure for the multi-modal VAEs and for
tests.  NOT a semantic-quality substitute for the sentence encoder, which
is not ported yet (ROADMAP.md, queue 1, item 4).
"""

from __future__ import annotations

import hashlib

import numpy as np

DIM = 768


def _ngrams(text: str, n_values=(2, 3, 4)):
    text = f" {text.strip().lower()} "
    for n in n_values:
        for i in range(max(len(text) - n + 1, 0)):
            yield text[i : i + n]


def embed_text(text: str, dim: int = DIM) -> np.ndarray:
    """One text → L2-normalized hashed n-gram vector."""
    if not text or not str(text).strip():
        text = " "   # empty lyrics coerced to ' ' (ref :332)
    vec = np.zeros(dim, dtype=np.float64)
    for gram in _ngrams(str(text)):
        h = hashlib.blake2b(gram.encode("utf-8"), digest_size=8).digest()
        idx = int.from_bytes(h[:4], "little") % dim
        sign = 1.0 if h[4] & 1 else -1.0
        vec[idx] += sign
    norm = np.linalg.norm(vec)
    return (vec / norm if norm > 0 else vec).astype(np.float32)


def embed_texts(texts, dim: int = DIM) -> np.ndarray:
    return np.stack([embed_text(t, dim) for t in texts])
