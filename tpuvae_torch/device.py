"""Device resolution for the port's entry points.

Every entry point (``ClipEncoder.load``, ``serve``, the CLI) defaults to
``device="cuda"`` and raises when CUDA is absent: the port never carries
on on the CPU by itself.  Tests pass ``device="cpu"`` explicitly, which
runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is
    no card.

    On CUDA this also pins float32 matmuls and convolutions to full fp32
    (``allow_tf32 = False`` for both cuBLAS and cuDNN): the large plain
    matmuls of the path — the MFCC DCT, the chroma projection and the
    VAE's Linear layers — are held to the JAX reference at fp32
    tolerances, which TF32's ~10-bit mantissa would break.  It also turns
    off cuBLAS's reduced-precision reductions for bfloat16 products
    (``allow_bf16_reduced_precision_reduction``, on by default), which may
    sum split-K partials in bfloat16: XLA sums a bfloat16 dot in float32,
    and the bfloat16 models are held to it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run the plain "
                "PyTorch versions of the kernels on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
