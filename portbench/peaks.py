"""Published peaks of the cards the benchmark reports against.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 67 TFLOP/s in float32 outside the tensor cores, 495
TFLOP/s in TF32, 989 TFLOP/s in bfloat16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

H100_SXM = {
    "fp32_flops_per_s": 67e12,
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def peaks_for(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold."""
    return H100_SXM if "H100" in kind else None
