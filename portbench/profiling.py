"""A sub-window of a traced run under ``torch.profiler``, and what its
trace says: the device's busy intervals, kernel time by name, and what
the host was doing in each idle gap.

The profiler starts and stops between two chunks of the fit (from the
fit's logger, on the host, after a host read), so the traced window is
whole chunks of graph replays; two marks (``portbench.window``) bound it
on the profiler's clock, which its device records share.
"""

from __future__ import annotations

import time

import torch

BEGIN, END = "portbench.window_begin", "portbench.window_end"
GAPS_NAMED = 10            # the longest idle gaps, each named by the host


class SubWindow:
    """Start and stop the profiler once; :meth:`summary` reduces the trace."""

    def __init__(self):
        self.prof = None
        self.overhead_s = 0.0       # host time spent starting and stopping
        self.done = False

    def start(self) -> None:
        t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        with torch.profiler.record_function(BEGIN):
            pass
        self.overhead_s += time.perf_counter() - t0

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        with torch.profiler.record_function(END):
            pass
        self.prof.stop()
        self.done = True
        self.overhead_s += time.perf_counter() - t0

    def summary(self) -> dict | None:
        """``window_s``, ``busy_s``, ``kernels`` ({name: (count, seconds)})
        and ``gaps`` ([(seconds, what the host did)], the longest first),
        or None when the trace holds no device record inside its marks."""
        if self.prof is None or not self.done:
            return None
        return reduce_events(_raw_events(self.prof))


def _raw_events(prof) -> list[tuple[str, bool, int, int]]:
    """``(name, on_device, start_ns, end_ns)`` of every record."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def merge(intervals) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals, in order."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events) -> dict | None:
    """The summary of :meth:`SubWindow.summary` from raw records."""
    marks = {n: s for n, dev, s, _ in events if not dev and n in (BEGIN, END)}
    if BEGIN not in marks or END not in marks:
        return None
    lo, hi = marks[BEGIN], marks[END]
    device = [(n, max(s, lo), min(e, hi)) for n, dev, s, e in events
              if dev and e > lo and s < hi]
    if not device:
        return None
    busy = merge((s, e) for _, s, e in device)
    kernels: dict[str, list] = {}
    for n, s, e in device:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    host = [(n, s, e) for n, dev, s, e in events
            if not dev and n not in (BEGIN, END) and e > lo and s < hi]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans = sorted(((g1 - g0, g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2])
                    if g1 > g0), reverse=True)[:GAPS_NAMED]
    gaps = []
    for length, g0, g1 in spans:
        what, most = "host: no record", 0
        for n, s, e in host:
            cover = min(e, g1) - max(s, g0)
            if cover > most:
                what, most = n, cover
        gaps.append((length * 1e-9, what))
    return {"window_s": (hi - lo) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernels": {n: tuple(v) for n, v in kernels.items()},
            "gaps": gaps}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The ``breakdown`` of a traced result line: the device operations
    that took most time and the longest idle gaps, by name."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[n[:160], v[1]] for n, v in ops],
            "idle_gaps": [[w[:160], s] for s, w in summary["gaps"][:top]]}
