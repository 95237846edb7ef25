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
==========================  ======================================  ===========================

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version for a CPU tensor.  :func:`launch_counts` reads each
kernel's launch counter; :func:`reset_launch_counts` sets them to 0.
"""

from tpuvae_torch.ops import _build, pairwise, select, stft, tuning  # noqa: F401


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in _build.kernels()}


def reset_launch_counts() -> None:
    for k in _build.kernels():
        k.launches = 0
