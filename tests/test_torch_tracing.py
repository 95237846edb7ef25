"""The port's span recorder (``tpuvae_torch.utils.logging``: ``span``,
``recording``) on the CPU, and the benchmark's reductions of its spans
(``portbench/spans.py``) on hand-made spans.

Off, a span is one check of a module-level flag: it records nothing,
allocates nothing and reads no clock.  On, spans nest by their ``parent``
index and are stamped with ``time.time_ns()``, the clock of
``torch.profiler``'s records: a span and a ``record_function`` mark opened
back to back start within 1 ms of each other (the median of 20 pairs).  A
CPU ``fit`` records one ``fit`` span and a ``fit.host_read`` for every
host read it counts; on the CPU its epochs are no CUDA graphs, so the
``graph.*`` spans are held to their order on the card
(``tests/test_torch_cuda.py``).
"""

import itertools
import statistics
import tracemalloc

import numpy as np
import pytest
import torch

from portbench import spans as reduce
from tpuvae_torch.utils import logging as tlog
from tpuvae_torch.utils.logging import recording, span

torch.set_num_threads(1)


def _names(recorded):
    return [s["name"] for s in recorded]


def _memory(fn, n):
    """``fn(n)``'s net and peak bytes on the Python heap, after a warm-up."""
    fn(10)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        start, _ = tracemalloc.get_traced_memory()
        fn(n)
        end, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return end - start, peak - start


def _loop(n):
    for _ in itertools.repeat(None, n):
        pass


def _calls(n):
    for _ in itertools.repeat(None, n):
        span("graph.replay", "the epoch")


def _withs(n):
    for _ in itertools.repeat(None, n):
        with span("graph.replay", "the epoch"):
            pass


def test_a_span_while_off_records_allocates_and_reads_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(tlog.time, "time_ns", no_clock)
    with span("graph.replay", "the epoch") as attrs:
        assert attrs is None
    # the call allocates nothing beyond the bare loop; the ``with`` keeps
    # nothing (the interpreter's bound ``__exit__``, freed at once, is the
    # same for 10 spans as for 10,000)
    assert _memory(_calls, 10_000) == _memory(_loop, 10_000)
    assert _memory(_withs, 10_000) == _memory(_withs, 10)
    assert _memory(_withs, 10_000)[0] == 0
    assert tlog._SPANS is None


def test_spans_nest_by_parent_and_close_on_an_exception():
    with recording() as recorded:
        with span("fit"):
            with span("graph.capture", "the epoch") as attrs:
                attrs["kernels"] = 12
            with pytest.raises(ValueError), span("fit.host_read"):
                raise ValueError
            with span("graph.replay", "the epoch"):
                with span("inner"):
                    pass
        with span("fit"):
            pass
    assert _names(recorded) == ["fit", "graph.capture", "fit.host_read",
                                "graph.replay", "inner", "fit"]
    assert [s["parent"] for s in recorded] == [None, 0, 0, 0, 3, None]
    assert recorded[1]["attrs"] == {"what": "the epoch", "kernels": 12}
    assert recorded[2]["attrs"] == {}
    for s in recorded:
        assert s["start_ns"] <= s["end_ns"]
    outer, inner = recorded[0], recorded[3]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]
    with span("after"):             # off again
        pass
    assert len(recorded) == 6


def test_a_recording_inside_another_takes_the_spans_until_it_closes():
    with recording() as outer:
        with span("a"):
            with recording() as inner:
                with span("b"):
                    pass
            with span("c"):
                pass
    assert _names(outer) == ["a", "c"] and outer[1]["parent"] == 0
    assert _names(inner) == ["b"] and inner[0]["parent"] is None
    assert tlog._SPANS is None


def test_spans_share_the_profilers_clock():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with recording() as recorded, \
            torch.profiler.profile(activities=acts) as prof:
        for i in range(20):
            with span(f"tracing.{i}"), \
                    torch.profiler.record_function(f"tracing.{i}"):
                pass
    marks = {e.name(): e.start_ns()
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("tracing.")}
    diffs = [marks[s["name"]] - s["start_ns"] for s in recorded]
    assert len(diffs) == 20
    assert abs(statistics.median(diffs)) < 1_000_000, diffs


def _simple_fit(scan_epochs, epochs, **kw):
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train import (FitConfig, create_state, fit,
                                    simple_vae_objective)

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(40, 12)).astype(np.float32))
    model = SimpleVAE(input_dim=12, hidden_dims=(8,), latent_dim=4,
                      generator=torch.Generator().manual_seed(0))
    cfg = FitConfig(epochs=epochs, batch_size=16, patience=100, seed=0,
                    scan_epochs=scan_epochs, **kw)
    return fit(create_state(model, 1e-2), simple_vae_objective(0.5), (x,),
               cfg)


@pytest.mark.parametrize("scan_epochs, epochs, reads, checkpoint", [
    (4, 10, 3, False),          # chunks of 4, 4, 2: one read each
    (4, 10, 5, True),           # and the counters' reads at two checkpoints
    (1, 3, 3, False),           # the per-epoch loop: one read an epoch
])
def test_a_cpu_fit_records_its_span_and_one_read_per_chunk(
        tmp_path, scan_epochs, epochs, reads, checkpoint):
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=4) \
        if checkpoint else {}
    with recording() as recorded:
        res = _simple_fit(scan_epochs, epochs, **kw)
    assert _names(recorded) == ["fit"] + ["fit.host_read"] * reads
    assert res.host_reads == reads
    fit_span = recorded[0]
    for s in recorded[1:]:
        assert s["parent"] == 0
        assert fit_span["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= fit_span["end_ns"]


# -- the benchmark's reductions, on hand-made spans ---------------------------

MS = 1_000_000


def _span(name, start_ms, end_ms, parent=None, **attrs):
    return {"name": name, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "parent": parent, "attrs": attrs}


def _window():
    """Two fits: each an eager epoch (warm + drain), a capture, replays and
    a host read per chunk of two epochs; a stray graph outside the fits."""
    out = []
    for t0, kernels in ((0, 1000), (10_000, 3000)):
        i = len(out)
        out.append(_span("fit", t0, t0 + 5000))
        out += [_span("graph.warm", t0 + 10, t0 + 110, i, what="the epoch"),
                _span("graph.drain", t0 + 110, t0 + 410, i, what="the epoch"),
                _span("graph.capture", t0 + 410, t0 + 610, i,
                      what="the epoch", kernels=kernels),
                _span("graph.replay", t0 + 610, t0 + 612, i),
                _span("fit.host_read", t0 + 612, t0 + 700, i)]
        for c in range(3):
            s = t0 + 1000 + 1000 * c
            out += [_span("graph.replay", s, s + 3, i),
                    _span("graph.replay", s + 3, s + 4, i),
                    _span("fit.host_read", s + 4, s + 90, i)]
    out += [_span("graph.capture", 20_000, 20_500, None, kernels=7),
            _span("graph.replay", 20_500, 20_600, None)]
    return out


def test_eager_capture_and_kernel_reductions():
    w = _window()
    assert reduce.eager_epoch_s(w) == pytest.approx(0.400)
    assert reduce.capture_s(w) == pytest.approx(0.200)
    assert reduce.epoch_graph_kernels(w) == 2000
    for fn in (reduce.eager_epoch_s, reduce.capture_s,
               reduce.epoch_graph_kernels):
        assert fn(None) is None and fn([]) is None
        assert fn([_span("fit", 0, 1)]) is None         # no graph under it


def test_replay_launch_leaves_out_the_profiled_stretch():
    w = _window()
    # 14 replays under fits: 2 of 2 ms, 6 of 3 ms, 6 of 1 ms; the stray
    # graph's 100 ms replay is no fit's
    assert reduce.replay_launch_ms(w) == pytest.approx(2.0)
    # a stretch over the first fit's last chunk and the second fit's first
    # replay: those three are left out
    bounds = (int(3000 * MS), int(11_000 * MS))
    kept = [s for s in w if s["name"] == "graph.replay"
            and s["parent"] is not None
            and not (s["end_ns"] > bounds[0] and s["start_ns"] < bounds[1])]
    assert len(kept) == 11
    want = statistics.median((s["end_ns"] - s["start_ns"]) / MS for s in kept)
    assert reduce.replay_launch_ms(w, bounds) == pytest.approx(want)
    assert reduce.replay_launch_ms(w, (0, int(30_000 * MS))) is None
    assert reduce.replay_launch_ms(None) is None


def test_idle_host_splits_idle_at_the_edges_of_reads_and_launches():
    lo, hi = 1000 * MS, 2000 * MS
    spans = [_span("fit", 0, 3000),
             _span("fit.host_read", 900, 1100, 0),     # crosses lo
             _span("graph.replay", 1400, 1500, 0),
             _span("fit.host_read", 1500, 1600, 0),
             _span("fit.host_read", 1950, 2100, 0)]    # crosses hi
    busy = [(1050 * MS, 1300 * MS), (1550 * MS, 1700 * MS)]
    # covered: [1000, 1300] + [1400, 1700] + [1950, 2000] = 650 of 1000
    assert reduce.idle_host_pct(spans, busy, (lo, hi)) == pytest.approx(35.0)
    # all of the device's 60% idle is the host's without reads or launches
    assert reduce.idle_host_pct(spans[:1], busy, (lo, hi)) == \
        pytest.approx(60.0)
    assert reduce.idle_host_pct(None, busy, (lo, hi)) is None
    assert reduce.idle_host_pct(spans, None, (lo, hi)) is None
    assert reduce.idle_host_pct(spans, busy, None) is None


class _Driver:
    """The two CUDA driver calls ``graphs._count_nodes`` makes, over one
    made-up graph: ``[(node, type)]``."""

    def __init__(self, nodes, fail=False):
        self.nodes, self.fail = dict(nodes), fail

    def cuGraphGetNodes(self, graph, nodes, count):
        if self.fail:
            return 1
        if nodes is not None:
            for i, n in enumerate(self.nodes):
                nodes[i] = n
        count._obj.value = len(self.nodes)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        kind._obj.value = self.nodes[node.value]
        return 0


def test_graph_nodes_are_counted_by_type():
    import ctypes

    from tpuvae_torch import graphs

    kernel, memcpy, memset, empty = 0, 1, 2, 5
    graph = ctypes.c_void_p(100)
    driver = _Driver([(1, kernel), (2, memset), (3, memcpy), (4, kernel),
                      (5, empty), (6, kernel)])
    assert graphs._count_nodes(driver, graph) == {kernel: 3, memcpy: 1,
                                                  memset: 1, empty: 1}
    assert graphs._count_nodes(_Driver([]), graph) == {}
    with pytest.raises(RuntimeError, match="cuGraphGetNodes"):
        graphs._count_nodes(_Driver([], fail=True), graph)
