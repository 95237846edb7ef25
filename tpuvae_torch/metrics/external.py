"""External (ground-truth) clustering metrics from a contingency table:
NMI, ARI, purity (counterpart of ``tpuvae/metrics/external.py``).

The contingency table is one one-hot product on the labels' device; the
(k x k) reductions after it run in float64.  ``y_true`` / ``y_pred`` are
integer codes in ``[0, n_true)`` / ``[0, n_pred)``, numpy arrays or tensors.
"""

from __future__ import annotations

import torch


def _codes(y) -> torch.Tensor:
    return torch.as_tensor(y).long()


def contingency(y_true, y_pred, n_true: int, n_pred: int) -> torch.Tensor:
    """``(n_true, n_pred)`` float64 counts of (true class, predicted cluster)."""
    yt, yp = _codes(y_true), _codes(y_pred)
    ot = torch.nn.functional.one_hot(yt, n_true).to(torch.float64)
    op = torch.nn.functional.one_hot(yp.to(yt.device), n_pred).to(torch.float64)
    return ot.T @ op


def purity_score(y_true, y_pred, n_true: int, n_pred: int) -> float:
    """Column-max purity (reference ``calculate_purity``,
    ``Conditional_VAE.py:279-287``)."""
    cm = contingency(y_true, y_pred, n_true, n_pred)
    return float(cm.max(dim=0).values.sum() / cm.sum())


def _comb2(x: torch.Tensor) -> torch.Tensor:
    return x * (x - 1.0) / 2.0


def adjusted_rand_score(y_true, y_pred, n_true: int, n_pred: int) -> float:
    cm = contingency(y_true, y_pred, n_true, n_pred)
    sum_comb = _comb2(cm).sum()
    sum_a = _comb2(cm.sum(dim=1)).sum()
    sum_b = _comb2(cm.sum(dim=0)).sum()
    expected = sum_a * sum_b / _comb2(cm.sum())
    denom = 0.5 * (sum_a + sum_b) - expected
    # all-singleton / single-cluster degenerate cases -> 1.0 like sklearn
    if float(denom) == 0.0:
        return 1.0
    return float((sum_comb - expected) / denom)


def _entropy(p: torch.Tensor) -> torch.Tensor:
    p = p[p > 0]
    return -(p * torch.log(p)).sum()


def normalized_mutual_info(y_true, y_pred, n_true: int, n_pred: int) -> float:
    """NMI with arithmetic-mean normalization (sklearn default)."""
    cm = contingency(y_true, y_pred, n_true, n_pred)
    pij = cm / cm.sum()
    pi = pij.sum(dim=1)
    pj = pij.sum(dim=0)
    outer = pi[:, None] * pj[None, :]
    nz = pij > 0
    mi = (pij[nz] * torch.log(pij[nz] / outer[nz])).sum()
    h_true, h_pred = float(_entropy(pi)), float(_entropy(pj))
    # sklearn: both partitions trivial -> 1.0; exactly one trivial -> 0.0
    if h_true == 0.0 and h_pred == 0.0:
        return 1.0
    if h_true == 0.0 or h_pred == 0.0:
        return 0.0
    return max(float(mi), 0.0) / (0.5 * (h_true + h_pred))
