"""``fusedconv_roofline_pct``: kernel 6's share of its roofline over the
traced stretch: the least time its two halves could take there over the
device time the profiler recorded for them (``conv0_kernel``,
``conv1_kernel``).  The least time of a half on a batch of b images is
the larger of its bytes over the memory bandwidth and its products over
the TF32 rate (``portbench.models.hybrid.pair_bound_s``); the traced
epochs hold one call of each half per training and validation batch.
Where the trace holds fewer records of a half than calls, the bound is
taken over the records it holds."""

from portbench.models import hybrid
from portbench.peaks import peaks_for

HALVES = {"conv0": "conv0_kernel", "conv1": "conv1_kernel"}


def read(record):
    peaks = peaks_for(record.kind)
    prof = record.profile
    if peaks is None or prof is None or not record.traced_epochs:
        return None
    per = hybrid.pair_epoch(record.config, record.n_train, record.n_val, peaks)
    expected = per["calls"] * len(record.traced_epochs)
    bound = seconds = 0.0
    for half, kernel in HALVES.items():
        count = sum(c for n, (c, _) in prof["kernels"].items() if kernel in n)
        seconds += sum(s for n, (_, s) in prof["kernels"].items()
                       if kernel in n)
        bound += per["bound_s"][half] * len(record.traced_epochs) * min(
            1.0, count / expected)
    return 100.0 * bound / seconds if seconds > 0 else None
