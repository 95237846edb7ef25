"""Host-side label utilities shared by clustering and metrics
(counterpart of ``tpuvae/metrics/labels.py``)."""

from __future__ import annotations

import numpy as np


def compact_labels(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Map arbitrary label values to 0..k-1 by order of value.

    DBSCAN's -1 noise label becomes cluster 0; sklearn's silhouette likewise
    treats every distinct value as a cluster.
    """
    labels = np.asarray(labels)
    uniq, compact = np.unique(labels, return_inverse=True)
    return compact.astype(np.int32), int(len(uniq))


def encode_labels(values) -> tuple[np.ndarray, list]:
    """LabelEncoder equivalent: sorted-unique classes -> integer codes
    (ref ``Simple_VAE.py:40-41`` et al.)."""
    values = np.asarray(values)
    classes, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int32), list(classes)


def one_hot_np(codes: np.ndarray, k: int | None = None) -> np.ndarray:
    """OneHotEncoder equivalent (ref ``Conditional_VAE.py:89-90``)."""
    codes = np.asarray(codes)
    k = k if k is not None else int(codes.max()) + 1
    out = np.zeros((len(codes), k), dtype=np.float32)
    out[np.arange(len(codes)), codes] = 1.0
    return out
