"""Exact t-SNE on the device (counterpart of ``tpuvae/viz/tsne.py``).

Replaces sklearn's TSNE (``Simple_VAE.py:302``, ``Conditional_VAE.py:516``,
``Convolutional_VAE.py:468``: 2 components, seed 42, perplexity 30) with
the JAX package's exact O(N^2) method and constants: a 50-step bisection
per point for the perplexity's betas, PCA init scaled to 1e-4 std,
``lr = max(n / 48, 50)``, early exaggeration x12 with momentum 0.5 for 250
of 1,000 steps (then 0.8), gains clipped at 0.01.

Every distance matrix goes through ``metrics.pairwise.squared_distances``:
on a CUDA tensor that launches kernel 5, once at the input's width and once
per step at D = 2 (1,001 launches for the default 1,000 steps).  The loop
never waits for the host: selects stand in for the JAX ``jnp.where``s, and
the velocity and gains are updated in place.  Embeddings are for plots;
parity with the JAX package is visual, not bitwise (the sign-dependent
gains carry fp32 noise along each trajectory).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvae_torch.cluster.pca import pca_transform
from tpuvae_torch.device import resolve_device
from tpuvae_torch.metrics.pairwise import squared_distances


def _calibrated_p(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Per-point binary search for the betas that hit ``perplexity``; the
    symmetrised joint probabilities ``(P + P^T) / 2n``, clamped at 1e-12."""
    n = d2.shape[0]
    target = torch.log(torch.tensor(perplexity, dtype=d2.dtype))
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)

    def entropy_and_p(beta):
        w = torch.exp(-d2 * beta[:, None]).masked_fill_(eye, 0.0)
        sum_w = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-30)
        p = w / sum_w
        h = torch.log(sum_w[:, 0]) + beta * torch.sum(d2 * p, dim=1)
        return h, p

    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))
    for _ in range(50):
        h, _ = entropy_and_p(beta)
        too_high = h > target.to(d2.device)   # entropy too high: raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    _, p = entropy_and_p(beta)
    p = (p + p.T) / (2.0 * n)
    return torch.clamp_min(p, 1e-12)


def _tsne_optimize(p: torch.Tensor, y0: torch.Tensor, lr: float,
                   n_iter: int = 1000,
                   exaggeration_iters: int = 250) -> torch.Tensor:
    """Momentum gradient descent on the t-SNE objective from ``y0``."""
    n = y0.shape[0]
    off_diag = 1.0 - torch.eye(n, dtype=y0.dtype, device=y0.device)
    y = y0.clone()
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    for i in range(n_iter):
        early = i < exaggeration_iters
        d2 = squared_distances(y, y)
        num = (1.0 / (1.0 + d2)) * off_diag
        q = torch.clamp_min(num / torch.sum(num), 1e-12)
        pq = ((12.0 if early else 1.0) * p - q) * num
        grad = 4.0 * ((torch.diag(torch.sum(pq, dim=1)) - pq) @ y)
        same_sign = torch.sign(grad) == torch.sign(vel)
        torch.where(same_sign, gains * 0.8, gains + 0.2, out=gains)
        gains.clamp_(min=0.01)
        vel.mul_(0.5 if early else 0.8).sub_(lr * gains * grad)
        y.add_(vel)
    return y


def tsne(x, n_components: int = 2, perplexity: float = 30.0, seed: int = 42,
         n_iter: int = 1000, device: str | torch.device = "cuda") -> np.ndarray:
    """``(N, D) -> (N, n_components)`` embedding, computed on ``device``
    (CUDA by default; raises without a card).  ``seed`` is accepted and
    ignored, as in the JAX package: the PCA init is deterministic."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    n = x.shape[0]
    perplexity = min(perplexity, (n - 1) / 3.0)   # sklearn's guard
    p = _calibrated_p(squared_distances(x, x), float(perplexity))
    init = pca_transform(x, n_components).cpu().numpy()
    init = init / max(np.std(init[:, 0]), 1e-12) * 1e-4  # sklearn's pca init
    lr = max(n / 48.0, 50.0)        # sklearn 'auto': n / exaggeration / 4
    y = _tsne_optimize(p, torch.from_numpy(init).to(dev), lr, n_iter=n_iter)
    return y.cpu().numpy()
