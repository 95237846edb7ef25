"""Frame-axis-sharded STFT — sequence parallelism over the mesh
(counterpart of ``tpuvae/dsp/long.py``).

STFT frames are independent n_fft windows at hop offsets, so for clips too
long for one device the frame axis itself is split over the ranks of the
data axis: every rank computes its contiguous block of frames from the
(replicated) waveform, and the window overlap means each block needs only
``n_fft - hop`` extra samples of halo, which its slice already includes.
The output is a DTensor sharded on the frame axis (``Shard(2)``, the JAX
``P(None, None, axis)``), ready for frame-blocked reductions downstream.
With one rank the whole clip is one block.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpuvae_torch.dsp import primitives as prim
from tpuvae_torch.parallel.mesh import MeshContext, axis_size


def _frame_placements(mesh, axis: str) -> list:
    return [Shard(2) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def stft_power_framesharded(
    y: torch.Tensor,
    mesh,
    n_fft: int = 2048,
    hop_length: int = 512,
    *,
    axis: str = "data",
    pad_mode: str = "constant",
    method: str = "auto",
):
    """Power spectrogram with the FRAME axis sharded over ``mesh[axis]``.

    ``y (B, T)`` is the same on every rank, on the rank's device (the
    waveform is small next to the (B, n_bins, T / hop) output, which is
    what does not fit on one device).  ``mesh`` is a ``DeviceMesh`` or a
    :class:`MeshContext`.  Returns ``(s_power, n_frames)``: a DTensor of
    global shape ``(B, n_bins, n_frames_padded)`` placed ``Shard(2)`` on
    the data axis; slice to ``n_frames`` after gathering.

    As the JAX function: frames by reshapes when ``hop | n_fft``, by a
    gather otherwise; the periodic Hann window; ``method='dft'`` is two
    fp32 products against the port's DFT basis, any other method
    ``torch.fft.rfft`` (``'auto'`` resolves to ``'fft'`` on the CPU and the
    card, JAX's rule for ``cpu`` / ``gpu``)."""
    if isinstance(mesh, MeshContext):
        mesh, axis = mesh.mesh, mesh.axis
    if method == "auto":
        method = "fft"
    b, t = y.shape
    half = n_fft // 2
    n_frames = prim.num_frames(t, hop_length)
    n_dev = axis_size(mesh, axis)
    frames_per_dev = -(-n_frames // n_dev)
    n_frames_pad = frames_per_dev * n_dev

    y_pad = prim.center_pad(y, n_fft, pad_mode)
    # extra tail so every rank's block slice is in bounds
    need = (n_frames_pad - 1) * hop_length + n_fft
    if y_pad.shape[1] < need:
        y_pad = torch.nn.functional.pad(y_pad, (0, need - y_pad.shape[1]))
    window = torch.from_numpy(prim.hann_window(n_fft)).to(y.device)

    start = mesh.get_local_rank(axis) * frames_per_dev * hop_length
    span = (frames_per_dev - 1) * hop_length + n_fft
    yblk = y_pad[:, start:start + span]
    if n_fft % hop_length == 0:
        # local framing without a gather: n_fft / hop shifted reshapes
        parts = [yblk[:, k * hop_length:
                      k * hop_length + frames_per_dev * hop_length]
                 .reshape(b, frames_per_dev, hop_length)
                 for k in range(n_fft // hop_length)]
        frames = torch.cat(parts, dim=-1)
    else:
        idx = (torch.arange(frames_per_dev, device=y.device)[:, None]
               * hop_length + torch.arange(n_fft, device=y.device))
        frames = yblk[:, idx]
    frames = frames * window
    if method == "dft":
        cos_b, sin_b = (torch.from_numpy(m).to(y.device)
                        for m in prim._dft_basis(n_fft))
        re = torch.matmul(frames, cos_b)
        im = torch.matmul(frames, sin_b)
        power = re * re + im * im
    else:
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
    local = power.transpose(1, 2).contiguous()     # (B, bins, local frames)
    shape = torch.Size((b, n_fft // 2 + 1, n_frames_pad))
    out = DTensor.from_local(local, mesh, _frame_placements(mesh, axis),
                             run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return out, n_frames


def mel_image_framesharded(
    y: torch.Tensor,
    mesh,
    sr: int,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    axis: str = "data",
):
    """Sharded mel-power image: each rank projects its own frame block
    through the mel filterbank (no cross-rank traffic until a consumer
    gathers); ``(mel (B, n_mels, n_frames_padded) Shard(2), n_frames)``."""
    s_power, n_frames = stft_power_framesharded(
        y, mesh, n_fft, hop_length, axis=axis)
    fb = torch.from_numpy(prim.mel_filterbank(sr, n_fft, n_mels)).to(y.device)
    local = torch.matmul(fb, s_power.to_local())
    shape = torch.Size((y.shape[0], n_mels, s_power.shape[2]))
    mel = DTensor.from_local(local, s_power.device_mesh, s_power.placements,
                             run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return mel, n_frames
