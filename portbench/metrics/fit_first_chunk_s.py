"""``fit_first_chunk_s``: a fit's first chunk as the fit's own clock has
it (``history["epoch_seconds"]``): the eager first epoch, the capture of
the epoch as a CUDA graph and K - 1 replays, up to the chunk's host read;
the mean over the window's fits."""


def read(record):
    firsts = [sum(s[:record.k]) for s in record.fits if s]
    return sum(firsts) / len(firsts) if firsts else None
