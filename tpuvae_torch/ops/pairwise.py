"""Pairwise Euclidean distances (kernel 5 and its plain version).

Counterpart of ``tpuvae/ops/pairwise.py``: the O(N^2 D) core of the
silhouette k-sweep and of the VAE and PCA rows of the Simple VAE pipeline
(and, in later slices, DBSCAN and Ward).  On a CUDA tensor the CUDA kernel
``csrc/pairwise.cu`` runs (64 x 64 output tiles, fp32 FMAs, fused
clamp, and for self-distances a fused square root and zero diagonal); on a
CPU tensor the plain PyTorch version does.
"""

from __future__ import annotations

import ctypes

import torch

from tpuvae_torch.ops import _build

PAIRWISE = _build.Kernel(
    "pairwise", "pairwise", "tpuvae_pairwise_distances",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

_TILE = 64
_MAX_GRID_Y = 65535


def squared_distances_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 5: ``(N, D), (M, D) -> (N, M)`` squared
    distances clamped at 0, in the op order of
    ``tpuvae/ops/pairwise.py:28-36``."""
    cross = torch.matmul(x, y.T)
    xn = torch.sum(x * x, dim=1, keepdim=True)
    yn = torch.sum(y * y, dim=1, keepdim=True)
    return torch.clamp_min(xn + yn.T - 2.0 * cross, 0.0)


def self_distances_plain(x: torch.Tensor) -> torch.Tensor:
    """``(N, N)`` Euclidean distances with an exactly-zero diagonal."""
    d = torch.sqrt(squared_distances_plain(x, x))
    return d.fill_diagonal_(0.0)


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name} must be (N, D) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _launch(x: torch.Tensor, y: torch.Tensor, self_mode: bool) -> torch.Tensor:
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    n, d = x.shape
    m = y.shape[0]
    if -(-n // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"N = {n} rows exceed the kernel's grid "
                         f"({_MAX_GRID_Y} tiles of {_TILE})")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        PAIRWISE(_build.ptr(x), _build.ptr(y), n, m, d, _build.ptr(out),
                 int(self_mode), _build.stream_ptr(x.device))
    return out


def squared_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(N, D), (M, D) -> (N, M)`` squared Euclidean distances, clamped at
    0, in fp32.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`squared_distances_plain`.  The kernel replaces
    ``tpuvae/ops/pairwise.py:27`` (``_kernel``); it is bound by the bytes
    of its output at D = 32, and ``csrc/pairwise.cu`` gives its design.
    """
    _check(x, "x")
    _check(y, "y")
    if x.shape[1] != y.shape[1] or x.device != y.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and y "
                         f"{tuple(y.shape)} on {y.device} do not pair")
    if x.device.type == "cpu":
        return squared_distances_plain(x, y)
    return _launch(x, y, self_mode=False)


def self_distances(x: torch.Tensor) -> torch.Tensor:
    """``(N, N)`` Euclidean distances of the rows of ``x`` with an
    exactly-zero diagonal: one launch of kernel 5 on a CUDA tensor (square
    root and diagonal fused), :func:`self_distances_plain` on a CPU one."""
    _check(x, "x")
    if x.device.type == "cpu":
        return self_distances_plain(x)
    return _launch(x, x, self_mode=True)
