"""``device_idle_pct``: the share of the traced stretch of the window in
which no operation ran on the card: one less the union of the profiler's
device records (kernels, copies, fills) over the stretch's length."""


def read(record):
    prof = record.profile
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
