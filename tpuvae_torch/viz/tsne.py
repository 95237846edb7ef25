"""Exact t-SNE on the device (counterpart of ``tpuvae/viz/tsne.py``).

Replaces sklearn's TSNE (``Simple_VAE.py:302``, ``Conditional_VAE.py:516``,
``Convolutional_VAE.py:468``: 2 components, seed 42, perplexity 30) with
the JAX package's exact O(N^2) method and constants: a 50-step bisection
per point for the perplexity's betas, PCA init scaled to 1e-4 std,
``lr = max(n / 48, 50)``, early exaggeration x12 with momentum 0.5 for 250
of 1,000 steps (then 0.8), gains clipped at 0.01.

Every distance matrix goes through ``metrics.pairwise.squared_distances``:
on a CUDA tensor that launches kernel 5, once at the input's width and once
per step at D = 2 (1,001 launches for the default 1,000 steps).  The loops
never wait for the host: selects stand in for the JAX ``jnp.where``s, and
the state (betas and bounds; embedding, velocity and gains) is updated in
place.  On a card each loop runs as CUDA graphs (``graphs.CapturedGraph``),
as the JAX package runs each as one jitted ``fori_loop``: the perplexity
search's 50 bisection steps as one graph, warmed up by a step on scratch
copies; the descent in graphs of ``STEPS_PER_GRAPH`` steps, whose first
chunk runs eagerly as real work (kernel 5 then counts each step once), the
exaggeration and momentum device tensors that the host sets between the
two phases (so one graph serves both), and a graph of one step for a
phase's steps beyond a multiple of ``STEPS_PER_GRAPH``.  The graphs launch
the eager loop's kernels in its order, so the embedding is bit-equal to it.
The CPU runs the same step functions eagerly.  Embeddings are for plots;
parity with the JAX package is visual, not bitwise (the sign-dependent
gains carry fp32 noise along each trajectory).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvae_torch import graphs
from tpuvae_torch.cluster.pca import pca_transform
from tpuvae_torch.device import resolve_device
from tpuvae_torch.metrics.pairwise import squared_distances

BISECTION_STEPS = 50
STEPS_PER_GRAPH = 50


class _Calibration:
    """The per-point binary search for the betas that hit a perplexity: its
    state (``beta``, ``lo``, ``hi``) on ``d2``'s device and one bisection
    step as a function of device tensors."""

    def __init__(self, d2: torch.Tensor, perplexity: float):
        n = d2.shape[0]
        self.d2 = d2
        # computed on the host and copied once, outside the loop
        self.target = torch.log(torch.tensor(perplexity, dtype=d2.dtype)).to(
            d2.device)
        self.eye = torch.eye(n, dtype=torch.bool, device=d2.device)
        self.beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
        self.lo = torch.zeros_like(self.beta)
        self.hi = torch.full_like(self.beta, float("inf"))

    def entropy_and_p(self, beta):
        d2 = self.d2
        w = torch.exp(-d2 * beta[:, None]).masked_fill_(self.eye, 0.0)
        sum_w = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-30)
        p = w / sum_w
        h = torch.log(sum_w[:, 0]) + beta * torch.sum(d2 * p, dim=1)
        return h, p

    def bisect(self, beta, lo, hi) -> None:
        h, _ = self.entropy_and_p(beta)
        too_high = h > self.target         # entropy too high: raise beta
        torch.where(too_high, beta, lo, out=lo)
        torch.where(too_high, hi, beta, out=hi)
        torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi), out=beta)

    def step(self) -> None:
        self.bisect(self.beta, self.lo, self.hi)

    def steps(self) -> None:
        for _ in range(BISECTION_STEPS):
            self.step()

    def p(self) -> torch.Tensor:
        """The symmetrised joint probabilities ``(P + P^T) / 2n`` at the
        current betas, clamped at 1e-12."""
        _, p = self.entropy_and_p(self.beta)
        p = (p + p.T) / (2.0 * self.d2.shape[0])
        return torch.clamp_min(p, 1e-12)


def _calibrated_p(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Per-point binary search for the betas that hit ``perplexity``; the
    symmetrised joint probabilities ``(P + P^T) / 2n``, clamped at 1e-12.
    On a card the 50 bisection steps are one CUDA graph."""
    cal = _Calibration(d2, perplexity)
    run = graphs.runner(
        cal.steps, d2.device, what="t-SNE's perplexity search",
        warmup=lambda: cal.bisect(cal.beta.clone(), cal.lo.clone(),
                                  cal.hi.clone()))
    try:
        run()
    finally:
        graphs.close(run)
    return cal.p()


class _Descent:
    """t-SNE's momentum gradient descent from ``y0``: its state (``y``,
    ``vel``, ``gains``, and the phase's ``exaggeration`` and ``momentum``
    as 0-d tensors) on the device and one step as a function of device
    tensors."""

    def __init__(self, p: torch.Tensor, y0: torch.Tensor, lr: float):
        n = y0.shape[0]
        self.p = p
        self.lr = lr
        self.off_diag = 1.0 - torch.eye(n, dtype=y0.dtype, device=y0.device)
        self.y = y0.clone()
        self.vel = torch.zeros_like(y0)
        self.gains = torch.ones_like(y0)
        self.exaggeration = torch.ones((), dtype=y0.dtype, device=y0.device)
        self.momentum = torch.ones((), dtype=y0.dtype, device=y0.device)

    def phase(self, early: bool) -> None:
        """Exaggeration x12 with momentum 0.5 early, then 1 and 0.8."""
        self.exaggeration.fill_(12.0 if early else 1.0)
        self.momentum.fill_(0.5 if early else 0.8)

    def step(self) -> None:
        y, vel, gains = self.y, self.vel, self.gains
        d2 = squared_distances(y, y)
        num = (1.0 / (1.0 + d2)) * self.off_diag
        q = torch.clamp_min(num / torch.sum(num), 1e-12)
        pq = (self.exaggeration * self.p - q) * num
        grad = 4.0 * ((torch.diag(torch.sum(pq, dim=1)) - pq) @ y)
        same_sign = torch.sign(grad) == torch.sign(vel)
        torch.where(same_sign, gains * 0.8, gains + 0.2, out=gains)
        gains.clamp_(min=0.01)
        vel.mul_(self.momentum).sub_(self.lr * gains * grad)
        y.add_(vel)


def _tsne_optimize(p: torch.Tensor, y0: torch.Tensor, lr: float,
                   n_iter: int = 1000,
                   exaggeration_iters: int = 250) -> torch.Tensor:
    """Momentum gradient descent on the t-SNE objective from ``y0``:
    ``exaggeration_iters`` exaggerated steps, then the rest, ``n_iter`` in
    all; on a card in graphs of ``STEPS_PER_GRAPH`` steps and of one."""
    desc = _Descent(p, y0, lr)
    runs = {}

    def run(k: int) -> None:
        if k not in runs:
            def chunk():
                for _ in range(k):
                    desc.step()
            runs[k] = graphs.runner(chunk, y0.device, what="t-SNE's descent")
        runs[k]()

    early = max(0, min(exaggeration_iters, n_iter))
    try:
        for exaggerated, count in ((True, early), (False, n_iter - early)):
            if count <= 0:
                continue
            desc.phase(exaggerated)
            full, rest = divmod(count, STEPS_PER_GRAPH)
            for k in [STEPS_PER_GRAPH] * full + [1] * rest:
                run(k)
    finally:
        for r in runs.values():
            graphs.close(r)
    return desc.y


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
