"""``replay_epoch_ms``: milliseconds an epoch in the chunks after each
fit's first, each epoch one CUDA graph replay, from
``history["epoch_seconds"]`` (a chunk's wall time up to its host read,
over its epochs); in the traced fit the chunks whose timing holds the
profiler's start, stop or records are left out."""


def read(record):
    times = []
    for i, seconds in enumerate(record.fits):
        skip = record.touched_epochs if i == record.traced_fit else ()
        times += [t for e, t in enumerate(seconds)
                  if e >= record.k and e not in skip]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
