"""What the port's spans say about a window's ``fit`` calls.

The port records spans in memory while
``tpuvae_torch.utils.logging.recording()`` is open: ``fit`` (one call),
``fit.host_read`` (a host read of the losses) and, for each CUDA graph,
``graph.warm``, ``graph.drain``, ``graph.capture`` (with ``kernels``) and
``graph.replay``.  Each is a dict with ``name``, ``start_ns``, ``end_ns``
(``time.time_ns()``, the clock of ``torch.profiler``'s records),
``parent`` (an index into the list) and ``attrs``.  Only graph spans whose
parent is a ``fit`` count: those of each fit's epoch graph.

``busy`` and ``bounds`` are a profiled stretch's merged device intervals
and its ``(lo, hi)``, in ns on the same clock.  Each function returns None
where the spans or the stretch it needs are missing.  No metric of
``BENCHMARK.json`` reads these yet: ``portbench/drivers/train.py`` records
no spans.
"""

from __future__ import annotations

import statistics

from portbench.profiling import merge


def _ns(s: dict) -> int:
    return s["end_ns"] - s["start_ns"]


def _fit_children(spans, names) -> list[list[dict]]:
    """For each ``fit`` span, its direct children named in ``names``."""
    if not spans:
        return []
    fits = {i: [] for i, s in enumerate(spans) if s["name"] == "fit"}
    for s in spans:
        if s["parent"] in fits and s["name"] in names \
                and s["end_ns"] is not None:
            fits[s["parent"]].append(s)
    return list(fits.values())


def _mean_over_fits(spans, names) -> float | None:
    per_fit = [sum(_ns(s) for s in c) for c in _fit_children(spans, names)
               if c]
    return 1e-9 * sum(per_fit) / len(per_fit) if per_fit else None


def eager_epoch_s(spans) -> float | None:
    """Seconds of a fit's eager epoch on the card: its epoch graph's
    ``graph.warm`` (launching the eager epoch) and ``graph.drain`` (the
    wait for it), the mean over the fits."""
    return _mean_over_fits(spans, ("graph.warm", "graph.drain"))


def capture_s(spans) -> float | None:
    """Seconds of a fit's ``graph.capture``, the mean over the fits."""
    return _mean_over_fits(spans, ("graph.capture",))


def epoch_graph_kernels(spans) -> float | None:
    """Kernel nodes of a fit's captured epoch graph, the mean over the
    fits."""
    counts = [s["attrs"]["kernels"]
              for c in _fit_children(spans, ("graph.capture",)) for s in c
              if "kernels" in s["attrs"]]
    return sum(counts) / len(counts) if counts else None


def replay_launch_ms(spans, bounds=None) -> float | None:
    """The median ``graph.replay`` of the fits' epoch graphs in ms, leaving
    out those that overlap the profiled stretch ``bounds``."""
    lo, hi = bounds if bounds is not None else (0, 0)
    times = [_ns(s) for c in _fit_children(spans, ("graph.replay",))
             for s in c if not (s["end_ns"] > lo and s["start_ns"] < hi)]
    return 1e-6 * statistics.median(times) if times else None


def idle_host_pct(spans, busy, bounds) -> float | None:
    """The share of the stretch ``bounds`` in which no device interval of
    ``busy`` runs and the host is inside no ``fit.host_read`` and no
    ``graph.replay``: idle that the host left, between its launches.
    Inside a host read every launch of the chunk is queued; a replay's
    launch returns only once the card has taken most of the replay in
    (it waits on the replays queued before it), so idle inside it is the
    graph's own."""
    if not spans or busy is None or bounds is None:
        return None
    lo, hi = bounds
    if hi <= lo:
        return None
    waits = [(max(s["start_ns"], lo), min(s["end_ns"], hi)) for s in spans
             if s["name"] in ("fit.host_read", "graph.replay")
             and s["end_ns"] is not None
             and s["end_ns"] > lo and s["start_ns"] < hi]
    covered = sum(e - s for s, e in merge(list(busy) + waits))
    return 100.0 * (1.0 - covered / (hi - lo))
