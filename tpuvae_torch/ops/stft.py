"""STFT power kernels and their plain versions: the fused STFT power +
spectral-feature epilogue (kernel 1) and the dense-DFT STFT power
(kernel 4, at the end of the module).

Counterpart of ``tpuvae/ops/stft.py``'s fused Cooley-Tukey kernel
(``stft_fused_features_ct_pallas``) and, through :func:`stft_power`, of its
power-only variant (``stft_power_ct_pallas``).  One pass over a batch of
waveforms ``y (B, n_samples)`` gives, per centred Hann-windowed frame:

* ``power (B, n_fft//2+1, T)`` — bfloat16 when ``exact=False``, else fp32;
* ``mel_power (B, n_mels, T)``;
* ``centroid``, ``bandwidth``, ``rolloff`` (85%), ``zcr`` (librosa edge
  semantics), ``rms`` and ``colmax`` (the per-frame max power, the tuning
  stage's piptrack reference), each ``(B, T)``.

Every statistic is computed from fp32 power whatever the stored dtype.
The TPU kernel's padded bin-order layout and hop-row pre-layout served
Mosaic's DMA alignment and have no counterpart here.

On a CUDA tensor the CUDA kernel ``csrc/stft_features.cu`` runs; on a CPU
tensor the plain PyTorch version does (``torch.fft.rfft`` on framed input
plus the staged features of :mod:`tpuvae_torch.dsp.features`).  Kernel 1
takes the geometries of the JAX kernel (:func:`stft_kernel_supports`):
every ``n_fft = 256 q``, ``q = 1 .. 23``, with any hop that divides it.
:func:`kernel_plan` names the plan a size runs: n_fft 256 .. 1,792 a
register plan of ``m = 32 r`` points (``csrc/stft_small.cu``), 2048 the
radix-32 x 32 register plan, every larger size a register plan of ``m =
128 q`` points over a group of four warps (``csrc/stft_large.cuh``).  The
mixed-radix plan in shared memory that ran those sizes before
(:func:`_radix_plan`, :func:`_general_tables`) stays in the tree, run by no
size.  A non-constant
``pad_mode`` is applied here, on the card, and the kernel reads the padded
signal, as the JAX wrappers pad on the host.

Kernel 4 (``csrc/stft_dense.cu``) is the counterpart of
``tpuvae/ops/stft.py``'s ``stft_power_pallas``: the same power spectrogram
as two dense products of the frames against window-folded cos / sin bases,
in fp32, with any ``n_fft`` that ``hop_length`` divides.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpuvae_torch.dsp import primitives as prim
from tpuvae_torch.ops import _build

KERNEL_MAX_N_FFT = 5888   # 256 x 23: the largest size of the JAX kernel
_REGISTER_PLAN_N_FFT = 2048   # the radix-32 x 32 register plan's size
_REGISTER_R_MAX_N_FFT = 1792  # r = m / 32 <= 28: one warp's registers
_POW2_RADICES = (16, 8, 4, 2)
_ODD_RADICES = (3, 5, 7, 11, 13, 17, 19, 23)   # the primes of q <= 23

STFT_FEATURES = _build.Kernel(
    "stft_features", "stft_features", "tpuvae_stft_features",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
# the register plan of n_fft 256 .. 1,792 (its own library, built in
# parallel): the same C signature, counted under the same name
STFT_SMALL = _build.Kernel("stft_features", "stft_small", "tpuvae_stft_small",
                           STFT_FEATURES.argtypes)
# the group register plan of n_fft 2,304 .. 5,888 (csrc/stft_large.cuh), in
# three libraries of five sizes each, built in parallel: the same C
# signature, counted under the same name; keyed by the first q of each
STFT_LARGE = {
    q0: _build.Kernel("stft_features", f"stft_large_{part}",
                      f"tpuvae_stft_large_{part}", STFT_FEATURES.argtypes)
    for q0, part in ((9, "a"), (14, "b"), (19, "c"))}


def kernel_plan(n_fft: int) -> str:
    """The plan kernel 1 runs at ``n_fft`` (one of
    :func:`stft_kernel_supports`'s sizes): ``"register_r"`` for n_fft =
    256 q, q <= 7 (``m = 32 r`` points, ``r = 4 q`` a lane, a lane FFT by
    shuffles); ``"register32x32"`` for 2048; ``"register_w"`` for q >= 9
    (``m = 128 q`` points in the registers of a group of four warps, ``q`` a
    thread, one exchange through shared memory)."""
    if not 256 <= n_fft <= KERNEL_MAX_N_FFT or n_fft % 256:
        raise ValueError(f"kernel 1 has no plan for n_fft {n_fft}")
    if n_fft == _REGISTER_PLAN_N_FFT:
        return "register32x32"
    return "register_r" if n_fft <= _REGISTER_R_MAX_N_FFT else "register_w"


def plan_kernel(n_fft: int) -> _build.Kernel:
    """The library entry that runs kernel 1 at ``n_fft`` (:func:`kernel_plan`);
    every one is counted as ``stft_features``."""
    plan = kernel_plan(n_fft)
    if plan == "register_r":
        return STFT_SMALL
    if plan == "register32x32":
        return STFT_FEATURES
    return STFT_LARGE[max(q0 for q0 in STFT_LARGE if q0 <= n_fft // 256)]


def stft_kernel_supports(n_fft: int, hop_length: int) -> bool:
    """Geometry predicate of kernel 1, the counterpart of
    ``tpuvae.ops.stft.ct_pallas_supports``: ``256 | n_fft`` with
    ``n_fft <= 5888`` (the JAX kernel's largest size: its VMEM model takes
    5888 at hops 1-8 and refuses every larger size) and ``hop | n_fft``.
    Every hop is taken: a warp reads its frame from the waveform wherever
    it starts, so only the shared-memory plan, which depends on ``n_fft``
    alone, bounds it."""
    return (256 <= n_fft <= KERNEL_MAX_N_FFT and n_fft % 256 == 0
            and hop_length > 0 and n_fft % hop_length == 0)


def _check_kernel_geometry(n_fft: int, hop_length: int) -> None:
    if not stft_kernel_supports(n_fft, hop_length):
        # the JAX wrappers' words (tpuvae/ops/stft.py:917-921)
        raise ValueError(
            f"ct_pallas requires 256 | n_fft and hop | n_fft; got "
            f"n_fft={n_fft}, hop={hop_length}")


class FusedFrontEnd(NamedTuple):
    """Outputs of :func:`stft_fused_features`."""

    power: torch.Tensor
    mel_power: torch.Tensor
    centroid: torch.Tensor
    bandwidth: torch.Tensor
    rolloff: torch.Tensor
    zcr: torch.Tensor
    rms: torch.Tensor
    colmax: torch.Tensor


def _check_waveform(y: torch.Tensor) -> None:
    if y.dim() != 2:
        raise ValueError(f"y must be batched waveforms (B, n_samples), got "
                         f"shape {tuple(y.shape)} — wrap single clips with "
                         f"y[None, :]")
    if y.dtype != torch.float32:
        raise ValueError(f"y must be float32, got {y.dtype}")


def _frame_power(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    window = torch.from_numpy(prim.hann_window(n_fft)).to(frames.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    return power.transpose(1, 2).contiguous()


def stft_power_plain(y: torch.Tensor, n_fft: int = 2048,
                     hop_length: int = 512, *,
                     pad_mode: str = "constant") -> torch.Tensor:
    """Plain STFT power ``(B, n_fft//2+1, T)`` fp32: centred frames
    (padded by ``pad_mode``), periodic-Hann-windowed, through
    ``torch.fft.rfft``."""
    return _frame_power(
        prim.frame_signal(y, n_fft, hop_length, pad_mode=pad_mode), n_fft)


def stft_fused_features_plain(y: torch.Tensor, n_fft: int = 2048,
                              hop_length: int = 512, *, sr: float,
                              n_mels: int, exact: bool = False,
                              pad_mode: str = "constant") -> FusedFrontEnd:
    """Plain version of kernel 1 (same function, staged PyTorch ops).  The
    power and rms come from the frames of the signal padded by
    ``pad_mode`` (the JAX kernel reads the padded signal for both); zcr
    keeps librosa's edge semantics whatever the mode."""
    from tpuvae_torch.dsp import features as feat

    _check_waveform(y)
    frames = prim.frame_signal(y, n_fft, hop_length, pad_mode=pad_mode)
    power = _frame_power(frames, n_fft)
    s_mag = torch.sqrt(power)
    freqs = torch.from_numpy(prim.fft_frequencies(sr, n_fft)).to(y.device)
    cent = feat.spectral_centroid(s_mag, freqs)
    return FusedFrontEnd(
        power=power if exact else power.to(torch.bfloat16),
        mel_power=feat.mel_power_from_stft(power, sr, n_fft, n_mels),
        centroid=cent,
        bandwidth=feat.spectral_bandwidth(s_mag, freqs, cent),
        rolloff=feat.spectral_rolloff(s_mag, freqs),
        zcr=feat.zero_crossing_rate(y, n_fft, hop_length),
        rms=torch.sqrt(torch.sum(frames * frames, dim=-1) / n_fft),
        colmax=torch.amax(power, dim=1),
    )


def _unit(ang: np.ndarray) -> np.ndarray:
    """``exp(i ang)`` as ``(..., 2)`` fp32 (cos, sin), with the float64
    values within 1e-12 of zero snapped to it."""
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    tw[np.abs(tw) < 1e-12] = 0.0
    return tw.astype(np.float32)


def _fft_tables(n_fft: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host tables of kernel 1's FFT, built in float64 and cast to fp32:
    the periodic Hann window; the split twiddles ``exp(-2 pi i k / n_fft)``,
    ``k = 0 .. n_fft/2``, as ``(n_fft/2 + 1, 2)``; and the exchange twiddles
    of the radix-32 x 32 complex FFT of ``m = n_fft/2 = 1024`` points,
    ``[k1, l] = exp(-2 pi i l k1 / m)``, as ``(32, 32, 2)``."""
    m = n_fft // 2
    if m != 32 * 32:
        raise ValueError(f"the radix-32 x 32 FFT takes n_fft 2048, got {n_fft}")
    k = np.arange(m + 1, dtype=np.float64)
    lk = np.outer(np.arange(32, dtype=np.float64), np.arange(32))
    return (prim.hann_window(n_fft), _unit(-2.0 * np.pi * k / n_fft),
            _unit(-2.0 * np.pi * lk / m))


def _radix_plan(m: int) -> tuple[int, ...]:
    """The radices of the mixed-radix plan of an ``m``-point complex FFT,
    ``m = 128 q``: the odd primes of ``m`` first (their first-stage
    reads, at an odd stride, take 32 banks), then powers of two no larger
    than 16 nor than ``m / 32``, so that every stage has a butterfly for
    each lane."""
    plan, rest = [], m
    for p in _ODD_RADICES:
        while rest % p == 0:
            plan.append(p)
            rest //= p
    cap = max(r for r in _POW2_RADICES if r <= max(2, m // 32))
    while rest > 1:
        r = max(x for x in _POW2_RADICES if x <= cap and rest % x == 0)
        plan.append(r)
        rest //= r
    if int(np.prod(plan)) != m:
        raise ValueError(f"no radix plan for a {m}-point FFT")
    return tuple(plan)


def _digit_reversal(plan: tuple[int, ...]) -> np.ndarray:
    """``perm[i]``: the input point that position ``i`` holds before the
    in-place decimation-in-time stages of ``plan`` (last radix outermost:
    position ``r L + i'`` holds point ``r + R perm_L[i']``)."""
    perm = np.zeros(1, np.int64)
    for radix in plan:
        perm = (np.arange(radix)[:, None] + radix * perm[None, :]).reshape(-1)
    return perm


def _general_tables(n_fft: int):
    """Host tables of kernel 1's mixed-radix plan in shared memory (which no
    size runs; its emulation test holds it), built in float64 and cast to
    fp32: the periodic Hann window; the split
    twiddles ``exp(-2 pi i k / n_fft)``, ``k = 0 .. m``; the ``m``-point
    twiddles ``exp(-2 pi i k / m)``, ``k < m`` (every stage's and every
    odd radix's, by stride); the inverse digit reversal as int32 (point
    ``n`` goes to position ``iperm[n]``); and the plan packed 6 bits a
    radix, first stage lowest."""
    m = n_fft // 2
    plan = _radix_plan(m)
    iperm = np.empty(m, np.int32)
    iperm[_digit_reversal(plan)] = np.arange(m, dtype=np.int32)
    code = sum(r << (6 * s) for s, r in enumerate(plan))
    return (prim.hann_window(n_fft),
            _unit(-2.0 * np.pi * np.arange(m + 1, dtype=np.float64) / n_fft),
            _unit(-2.0 * np.pi * np.arange(m, dtype=np.float64) / m),
            iperm, code)


def _lane_angles() -> np.ndarray:
    """``(5, 32)``: the twiddle angle of lane ``l`` at stage ``s`` of a
    radix-2 decimation-in-frequency FFT over the warp's 32 lanes.  At
    stage ``s`` lane ``l`` pairs with ``l ^ d``, ``d = 16 >> s``; the lower
    lane keeps the sum (angle 0), the upper one takes the difference times
    ``W_(2d)^(l mod d)``."""
    lane = np.arange(32)
    d = (16 >> np.arange(5))[:, None]
    return np.where(lane & d, -2.0 * np.pi * (lane % d) / (2 * d), 0.0)


def _register_tables(n_fft: int):
    """Host tables of kernel 1's register plan of ``m = n_fft / 2 = 32 r``
    points (n_fft 256 .. 1,792), built in float64 and cast to fp32: the
    periodic Hann window; the split twiddles ``exp(-2 pi i k / n_fft)``,
    ``k = 0 .. m``; and ``(r + 5, 32, 2)``: rows ``k1 < r`` the twiddles
    ``exp(-2 pi i l k1 / m)`` of lane ``l`` between its r-point DFT and the
    32-point DFT over the lanes, rows ``r .. r + 4`` the lane twiddles of
    that DFT's five stages (:func:`_lane_angles`)."""
    m = n_fft // 2
    r = m // 32
    if kernel_plan(n_fft) != "register_r":
        raise ValueError(f"the register plan takes n_fft 256 .. "
                         f"{_REGISTER_R_MAX_N_FFT}, got {n_fft}")
    lk = np.outer(np.arange(r, dtype=np.float64), np.arange(32))
    xtw = _unit(np.concatenate([-2.0 * np.pi * lk / m, _lane_angles()]))
    k = np.arange(m + 1, dtype=np.float64)
    return prim.hann_window(n_fft), _unit(-2.0 * np.pi * k / n_fft), xtw


def _group_tables(n_fft: int):
    """Host tables of kernel 1's group register plan of ``m = n_fft / 2 =
    128 q`` points (n_fft 2,304 .. 5,888), built in float64 and cast to
    fp32: the periodic Hann window; the split twiddles ``exp(-2 pi i k /
    n_fft)``, ``k = 0 .. m``; and ``(128 q + 288, 2)``: rows ``k1 < q`` of
    128 the twiddles ``exp(-2 pi i t k1 / m)`` of thread ``t`` after its
    q-point DFT, then ``(4, 32)`` ``exp(-2 pi i l c / 128)`` of lane ``l``
    after the 4-point DFT of pass B, then the ``(5, 32)`` lane twiddles of
    its 32-point DFT's five stages (:func:`_lane_angles`)."""
    m = n_fft // 2
    q = m // 128
    if kernel_plan(n_fft) != "register_w":
        raise ValueError(f"the group register plan takes n_fft 256 q, "
                         f"q = 9 .. 23, got {n_fft}")
    tk = np.outer(np.arange(q, dtype=np.float64), np.arange(128)).reshape(-1)
    lc = np.outer(np.arange(4, dtype=np.float64), np.arange(32)).reshape(-1)
    xtw = _unit(np.concatenate([-2.0 * np.pi * tk / m,
                                -2.0 * np.pi * lc / 128,
                                _lane_angles().reshape(-1)]))
    k = np.arange(m + 1, dtype=np.float64)
    return prim.hann_window(n_fft), _unit(-2.0 * np.pi * k / n_fft), xtw


@functools.lru_cache(maxsize=8)
def _fft_consts(device: str, n_fft: int):
    """The tables of the plan kernel 1 runs at ``n_fft``, on ``device``:
    ``(window, split twiddles, the plan's twiddles)``."""
    plan = kernel_plan(n_fft)
    if plan == "register32x32":
        tables = _fft_tables(n_fft)
    elif plan == "register_r":
        tables = _register_tables(n_fft)
    else:
        tables = _group_tables(n_fft)
    return tuple(torch.from_numpy(t).to(device) for t in tables)


def _mel_csr(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The mel filterbank in the kernel's compressed form: every filter's
    run of non-zero weights, concatenated, and ``(n_mels, 3)`` int32 rows of
    first bin, one past the last, and the run's offset (the triangles
    overlap pairwise, ~2 non-zeros per bin)."""
    nz = fb != 0
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, fb.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    offset = np.concatenate([[0], np.cumsum(last - first)[:-1]])
    weights = np.concatenate([fb[i, a:b] for i, (a, b)
                              in enumerate(zip(first, last))])
    meta = np.stack([first, last, offset], axis=1).astype(np.int32)
    return weights.astype(np.float32), meta


@functools.lru_cache(maxsize=8)
def _epilogue_consts(device: str, sr: float, n_fft: int, n_mels: int):
    """Bin frequencies and the compressed mel filterbank (:func:`_mel_csr`)
    on ``device``."""
    weights, meta = _mel_csr(prim.mel_filterbank(sr, n_fft, n_mels))
    return (torch.from_numpy(prim.fft_frequencies(sr, n_fft)).to(device),
            torch.from_numpy(weights).to(device),
            torch.from_numpy(meta).to(device))


def _launch(y: torch.Tensor, n_fft: int, hop_length: int,
            power_dtype: torch.dtype, sr: float | None = None,
            n_mels: int = 0, pad_mode: str = "constant"):
    """Run kernel 1; with ``sr`` given also its epilogue (mel + stats).
    A non-constant ``pad_mode`` pads ``y`` here and hands the kernel the
    padded rows with the offset of each row's first sample (``origin``);
    the kernel's zcr counts only the pairs inside the true samples."""
    _check_waveform(y)
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    b, n_samples = y.shape
    t = prim.num_frames(n_samples, hop_length)
    dev = y.device
    if pad_mode == "constant":
        buf, origin = y, 0
    else:
        buf, origin = prim.center_pad(y, n_fft, pad_mode).contiguous(), n_fft // 2
    window, tw, xtw = _fft_consts(str(dev), n_fft)
    power = torch.empty((b, n_fft // 2 + 1, t), dtype=power_dtype, device=dev)
    null = ctypes.c_void_p(None)
    freqs = mel_w = mel_meta = mel = stats = None
    if sr is not None:
        freqs, mel_w, mel_meta = _epilogue_consts(str(dev), float(sr), n_fft,
                                                  n_mels)
        mel = torch.empty((b, n_mels, t), dtype=torch.float32, device=dev)
        # one contiguous (B, T) plane per statistic
        stats = torch.empty((6, b, t), dtype=torch.float32, device=dev)
    p = lambda x: null if x is None else _build.ptr(x)  # noqa: E731
    plan_kernel(n_fft)(
        _build.ptr(buf), b, buf.shape[1], origin, n_samples, n_fft,
        hop_length, t, p(window), p(tw), p(xtw), null, 0, p(freqs),
        p(mel_w), p(mel_meta), n_mels, 0 if mel_w is None else mel_w.numel(),
        p(power), int(power_dtype == torch.bfloat16), p(mel), p(stats),
        _build.stream_ptr(dev))
    return power, mel, stats


def stft_fused_features(y: torch.Tensor, n_fft: int = 2048,
                        hop_length: int = 512, *, sr: float, n_mels: int,
                        exact: bool = False,
                        pad_mode: str = "constant") -> FusedFrontEnd:
    """STFT power with the spectral-feature epilogue fused in.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`stft_fused_features_plain`.  Either way the geometry
    must satisfy :func:`stft_kernel_supports` (the JAX kernel's
    ``ValueError`` otherwise).  The kernel replaces
    ``tpuvae/ops/stft.py:418`` (``_make_ct_kernel``); it is bound by the
    bytes it must move, and ``csrc/stft_features.cu`` says how its design
    keeps the frames and the fp32 power out of device memory.
    """
    _check_kernel_geometry(n_fft, hop_length)
    if y.device.type == "cpu":
        return stft_fused_features_plain(y, n_fft, hop_length, sr=sr,
                                         n_mels=n_mels, exact=exact,
                                         pad_mode=pad_mode)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    power, mel, stats = _launch(
        y, n_fft, hop_length, torch.float32 if exact else torch.bfloat16,
        sr=sr, n_mels=n_mels, pad_mode=pad_mode)
    cent, bw, roll, zcr, rms, colmax = stats.unbind(dim=0)
    return FusedFrontEnd(power=power, mel_power=mel, centroid=cent,
                         bandwidth=bw, rolloff=roll, zcr=zcr, rms=rms,
                         colmax=colmax)


def stft_power(y: torch.Tensor, n_fft: int = 2048,
               hop_length: int = 512, *,
               pad_mode: str = "constant") -> torch.Tensor:
    """STFT power only ``(B, n_fft//2+1, T)`` fp32 — kernel 1 without its
    epilogue on a CUDA tensor, :func:`stft_power_plain` on a CPU tensor;
    the geometry as :func:`stft_fused_features`."""
    _check_kernel_geometry(n_fft, hop_length)
    if y.device.type == "cpu":
        _check_waveform(y)
        return stft_power_plain(y, n_fft, hop_length, pad_mode=pad_mode)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    power, _, _ = _launch(y, n_fft, hop_length, torch.float32,
                          pad_mode=pad_mode)
    return power


# -----------------------------------------------------------------------------
# Kernel 4: dense-DFT STFT power
# -----------------------------------------------------------------------------

STFT_DENSE = _build.Kernel(
    "stft_dense", "stft_dense", "tpuvae_stft_dense",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

_DENSE_N_FFT_STEP = 16   # n_fft must be a multiple of this
_DENSE_K_STAGE = 32      # samples the kernel stages per step
_DENSE_BIN_TILE = 128    # packed bins per CTA


def _check_dense_geometry(n_fft: int, hop_length: int) -> None:
    if hop_length <= 0 or n_fft % hop_length:
        # the JAX kernel's message: 'pallas' is the method's name in both
        raise ValueError("pallas STFT requires hop_length | n_fft")


@functools.lru_cache(maxsize=4)
def _folded_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """``(cos, -sin)`` real-DFT bases ``(n_fft, n_fft//2 + 1)`` with the
    periodic Hann window folded in (float64 angles, cast to fp32, then an
    fp32 multiply — the arithmetic of ``stft_power_pallas``)."""
    cos_b, sin_b = prim._dft_basis(n_fft)
    window = prim.hann_window(n_fft).astype(np.float32)[:, None]
    return cos_b * window, sin_b * window


def _round_tf32(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to TF32 (10 mantissa bits; nearest, ties away
    from zero — ``cvt.rna.tf32.f32``) by integer arithmetic on the bit
    pattern: the 13 low mantissa bits come out zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``x = hi + lo`` with both halves TF32 values: ``hi = tf32(x)``,
    ``lo = tf32(x - hi)``; ``hi + lo`` is ``x`` to 2^-22 relative."""
    hi = _round_tf32(x)
    return hi, _round_tf32(np.asarray(x, np.float32) - hi)


@functools.lru_cache(maxsize=4)
def _interleaved_basis(n_fft: int) -> np.ndarray:
    """The folded bases in the kernel's layout, K-major: ``(2 * nb_pad,
    k_pad)`` fp32 with the cos and sin bases of packed bin ``k`` in rows
    ``2 k`` and ``2 k + 1``.  ``n_fft // 2`` packed bins are padded with
    zero rows to a multiple of the bin tile, the ``n_fft`` samples with zero
    columns to a multiple of the K stage.  The sin row of bin 0 (identically
    zero) carries the Nyquist bin's cosine, whose own sine is zero as
    well."""
    cos_w, sin_w = _folded_basis(n_fft)
    n_half = n_fft // 2
    nb_pad = -(-n_half // _DENSE_BIN_TILE) * _DENSE_BIN_TILE
    k_pad = -(-n_fft // _DENSE_K_STAGE) * _DENSE_K_STAGE
    basis = np.zeros((2 * nb_pad, k_pad), np.float32)
    basis[0:2 * n_half:2, :n_fft] = cos_w[:, :n_half].T
    basis[1:2 * n_half:2, :n_fft] = sin_w[:, :n_half].T
    basis[1, :n_fft] = cos_w[:, n_half]
    return basis


@functools.lru_cache(maxsize=4)
def _packed_basis(device: str, n_fft: int):
    """The TF32 split (:func:`_split_tf32`) of :func:`_interleaved_basis`
    on ``device``: ``(hi, lo, nb_pad, k_pad)``."""
    basis = _interleaved_basis(n_fft)
    hi, lo = _split_tf32(basis)
    return (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device),
            basis.shape[0] // 2, basis.shape[1])


def stft_power_dense_plain(y: torch.Tensor, n_fft: int = 2048,
                           hop_length: int = 512, *,
                           pad_mode: str = "constant") -> torch.Tensor:
    """Plain version of kernel 4: pad, frame, one ``torch.matmul`` against
    each window-folded basis, square and add -> ``(B, n_fft//2+1, T)``."""
    _check_dense_geometry(n_fft, hop_length)
    _check_waveform(y)
    frames = prim.frame_signal(y, n_fft, hop_length, pad_mode=pad_mode)
    cos_w, sin_w = (torch.from_numpy(m).to(y.device)
                    for m in _folded_basis(n_fft))
    re = torch.matmul(frames, cos_w)
    im = torch.matmul(frames, sin_w)
    return (re * re + im * im).transpose(1, 2).contiguous()


def stft_power_dense(y: torch.Tensor, n_fft: int = 2048,
                     hop_length: int = 512, *,
                     pad_mode: str = "constant") -> torch.Tensor:
    """Dense-DFT STFT power ``(B, n_fft//2+1, 1 + n_samples // hop)`` fp32.

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through :func:`stft_power_dense_plain`.  The kernel replaces
    ``tpuvae/ops/stft.py:73`` (``_make_kernel``); it is bound by its
    operations, and ``csrc/stft_dense.cu`` says how its design runs them on
    the tensor cores as three TF32 products of split operands, gathers the
    frames from the waveform and keeps ``re`` and ``im`` in registers.
    Padding stays out here, as in the JAX wrapper: the kernel reads the
    padded signal.
    """
    _check_dense_geometry(n_fft, hop_length)
    if y.device.type == "cpu":
        return stft_power_dense_plain(y, n_fft, hop_length, pad_mode=pad_mode)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    _check_waveform(y)
    if n_fft % _DENSE_N_FFT_STEP:
        raise ValueError(f"the CUDA dense-DFT kernel needs n_fft to be a "
                         f"multiple of {_DENSE_N_FFT_STEP}, got {n_fft}")
    b, n_samples = y.shape
    t = prim.num_frames(n_samples, hop_length)
    y_pad = prim.center_pad(y, n_fft, pad_mode)
    if y_pad.shape[1] % 4:
        # a row stride that is a multiple of 4 samples keeps every frame's
        # 16-byte loads aligned (when hop_length is one too)
        y_pad = torch.nn.functional.pad(y_pad, (0, -y_pad.shape[1] % 4))
    y_pad = y_pad.contiguous()
    b_hi, b_lo, nb_pad, k_pad = _packed_basis(str(y.device), n_fft)
    out = torch.empty((b, n_fft // 2 + 1, t), dtype=torch.float32,
                      device=y.device)
    if b:
        STFT_DENSE(_build.ptr(y_pad), b, y_pad.shape[1], n_fft, hop_length, t,
                   _build.ptr(b_hi), _build.ptr(b_lo), nb_pad, k_pad,
                   _build.ptr(out), _build.stream_ptr(y.device))
    return out
