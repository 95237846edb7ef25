"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

==========================  ======================================  ===========================
kernel                      replaces (Pallas, tpuvae/ops/)          wrapper
==========================  ======================================  ===========================
``stft_features``           stft.py:418 ``_make_ct_kernel``         :func:`stft.stft_fused_features`,
                                                                    :func:`stft.stft_power`
``tuning``                  tuning.py:352/:367 tuning kernels       :func:`tuning.estimate_tuning`
``masked_median_select``    select.py:32 ``_select_kernel``         :func:`select.select_stats`
``pairwise``                pairwise.py:27 ``_kernel``              :func:`pairwise.squared_distances`,
                                                                    :func:`pairwise.self_distances`
``stft_dense``              stft.py:73 ``_make_kernel``             :func:`stft.stft_power_dense`
``fusedconv_conv0``,        fusedconv.py:67 ``_conv0_kernel``,      :func:`fusedconv.conv0_stats`,
``fusedconv_conv1``         :88 ``_conv1_kernel``                   :func:`fusedconv.conv1_norm_stats`,
                                                                    :func:`fusedconv.fused_trunk2`
``bn_leaky_stats``,         none: BatchNorm + LeakyReLU of the      :func:`bn_leaky.bn_leaky`,
``bn_leaky_norm``,          trunks' layers 0-5 (encoder) and 0-4    :func:`bn_leaky.bn_leaky_given`,
``bn_leaky_grad_sums``,     (decoder) in training, which the JAX    :func:`bn_leaky.bn_leaky_backward`
``bn_leaky_grad_input``     package leaves to XLA
==========================  ======================================  ===========================

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version for a CPU tensor.  :func:`launch_counts` reads each
kernel's launch counter; :func:`reset_launch_counts` sets them to 0.  A
kernel called while a CUDA graph is captured counts once at every replay
of the graph (``_build.capture_tally``, ``_build.count_replay``), not at
the capture, which launches nothing.
"""

from tpuvae_torch.ops import (  # noqa: F401
    _build,
    bn_leaky,
    fusedconv,
    pairwise,
    select,
    stft,
    tuning,
)


def launch_counts() -> dict[str, int]:
    """Launches by kernel name; a kernel built as more than one library
    (kernel 1's plans) counts under one name."""
    counts: dict[str, int] = {}
    for k in _build.kernels():
        counts[k.name] = counts.get(k.name, 0) + k.launches
    return counts


def reset_launch_counts() -> None:
    for k in _build.kernels():
        k.launches = 0
