"""``train_mfu``: the model's float32 work in the window over the window's
time, as a share of the card's float32 peak (67 TFLOP/s on an H100 SXM;
TF32 is off by the port's contract).  The work is counted from the
configuration's shapes (``portbench/models/<family>.py``): each training
row's forward, weight gradients and input gradients, each validation
row's forward, and Adam's arithmetic per parameter and step.  The host
time spent starting and stopping the profiler is left out of the time."""

from portbench.peaks import peaks_for


def read(record):
    peaks = peaks_for(record.kind)
    if peaks is None or record.epochs == 0:
        return None
    seconds = record.window_s - record.profile_overhead_s
    flops = record.work["epoch_flops"] * record.epochs
    return 100.0 * flops / seconds / peaks["fp32_flops_per_s"]
