"""The harness on the CPU: cells found by the names in ``BENCHMARK.json``,
a clear error for a missing file, no result without a card, the metric
readers and the trace reduction on made-up records, and ``BENCHMARK.json``
within the benchmark contract's limits.  The test marked ``cuda`` runs a
short cell on the card and skips elsewhere, deciding inside the test."""

from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import correct, harness, profiling
from portbench.drivers.train import Probe, window_plan
from portbench.peaks import H100_SXM

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cells_are_found_by_their_names(cell):
    spec = harness.cell_spec(cell)
    w = spec["cell"]
    assert spec["config"]["family"] in ("hybrid", "simple")
    assert spec["traffic"]["kind"] == "train"
    names = correct.compared_names(spec["limits"])
    assert {"loss_gap", "change_gap", "replay_loss_gap",
            "replay_change_gap"} <= set(names)
    assert {"grad_gap", "grad_gap_median"} & set(names)
    assert spec["window"]["epoch_s"] > 0
    names = [m["name"] for m in spec["metrics"]["end_to_end"]]
    assert names == ["train_clips_per_s", "setup_s"]
    layer = [m["name"] for m in spec["metrics"]["per_layer"]]
    assert ("fusedconv_roofline_pct" in layer) == (w["config"] == "hybrid_vae")
    for m in names + layer:
        assert callable(harness.reader(m))


@pytest.mark.parametrize("break_it, missing", [
    (lambda b: b["configs"][0].update(file="portbench/configs/nothing.json"),
     "portbench/configs/nothing.json"),
    (lambda b: b["workloads"][0].update(traffic="no_such_mix"),
     "portbench/traffic/no_such_mix.json"),
    (lambda b: b["workloads"][0].update(name="x.no_limits"),
     "portbench/limits/x.no_limits.json"),
    (lambda b: b["per_layer"].append(
        {"name": "no_such_metric", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "fit loop",
         "moves": "train_clips_per_s"}),
     "portbench/metrics/no_such_metric.py"),
])
def test_a_missing_file_is_named(break_it, missing):
    bench = copy.deepcopy(BENCH)
    break_it(bench)
    with pytest.raises(harness.CellError, match=re.escape(missing)):
        harness.cell_spec(bench["workloads"][0]["name"], bench)


def test_a_missing_window_file_is_named(tmp_path, monkeypatch):
    import shutil

    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("windows", "__pycache__"))
    monkeypatch.setattr(harness, "PKG", tmp_path / "portbench")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(harness.CellError,
                       match=re.escape("portbench/windows/hybrid_vae.train.json")):
        harness.cell_spec("hybrid_vae.train", BENCH)


def test_an_unknown_cell_is_named():
    with pytest.raises(harness.CellError, match="no workload named 'x.y'"):
        harness.cell_spec("x.y")


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "{" not in proc.stdout


@pytest.mark.cuda
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "simple_vae.train", "--seed", "3", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert list(line)[-1] == "compared"


def test_benchmark_json_within_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_dims")) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _record(**kw):
    base = dict(k=4, epochs=12, n_train=1135, n_val=201, window_s=10.0,
                setup_s=3.0, profile_overhead_s=0.5, kind="NVIDIA H100 80GB HBM3",
                fits=[[2.0] * 4 + [1.0] * 8], traced_fit=0,
                traced_epochs=range(8, 12),
                touched_epochs=range(4, 12), profile=None,
                work={"epoch_flops": 1e12}, config=json.loads(
                    (ROOT / "portbench/configs/hybrid_vae.json").read_text()))
    base.update(kw)
    return SimpleNamespace(**base)


def test_end_to_end_readers():
    r = _record()
    assert harness.reader("train_clips_per_s")(r) == 1135 * 12 / 10.0
    assert harness.reader("setup_s")(r) == 3.0


def test_chunk_readers_leave_out_the_traced_chunks():
    r = _record(fits=[[2.0] * 4 + [1.0] * 4 + [9.0] * 4],
                touched_epochs=range(8, 12))
    assert harness.reader("fit_first_chunk_s")(r) == 8.0
    assert harness.reader("replay_epoch_ms")(r) == 1000.0
    r = _record(touched_epochs=range(4, 12))
    assert harness.reader("replay_epoch_ms")(r) is None
    # three fits, the middle one traced: each first chunk counts once, the
    # traced fit's touched chunks not at all
    r = _record(fits=[[3.0] * 4 + [1.0] * 4, [5.0] * 4 + [9.0] * 4,
                      [4.0] * 4 + [2.0] * 4], traced_fit=1,
                touched_epochs=range(4, 8))
    assert harness.reader("fit_first_chunk_s")(r) == 16.0
    assert harness.reader("replay_epoch_ms")(r) == 1500.0
    mfu = harness.reader("train_mfu")(_record())
    assert mfu == pytest.approx(100 * 12e12 / 9.5 / 67e12)
    assert harness.reader("train_mfu")(_record(kind="cpu")) is None


def test_trace_readers():
    from portbench.models import hybrid

    assert harness.reader("device_idle_pct")(_record()) is None
    per = hybrid.pair_epoch(_record().config, 1135, 201, H100_SXM)
    n = per["calls"] * 4                     # four traced epochs
    prof = {"window_s": 5.0, "busy_s": 4.5, "kernels": {
        "void conv0_kernel<...>": (n, 0.010), "conv1_kernel": (n, 0.030),
        "gemm": (10, 1.0)}, "gaps": []}
    r = _record(profile=prof)
    assert harness.reader("device_idle_pct")(r) == pytest.approx(10.0)
    bound = 4 * (per["bound_s"]["conv0"] + per["bound_s"]["conv1"])
    roof = harness.reader("fusedconv_roofline_pct")
    assert roof(r) == pytest.approx(100 * bound / 0.040)
    prof["kernels"]["conv1_kernel"] = (n // 2, 0.015)   # records missing
    assert roof(r) == pytest.approx(
        100 * 4 * (per["bound_s"]["conv0"] + per["bound_s"]["conv1"] / 2) / 0.025)
    del prof["kernels"]["void conv0_kernel<...>"], prof["kernels"]["conv1_kernel"]
    assert roof(r) is None


def test_trace_reduction():
    B, E = profiling.BEGIN, profiling.END
    events = [(B, False, 100, 101), (E, False, 1000, 1001),
              ("k1", True, 150, 300), ("k2", True, 250, 400),
              ("k1", True, 700, 900), ("k3", True, 50, 120),
              ("aten::copy_", False, 400, 690), ("other", False, 2000, 3000)]
    s = profiling.reduce_events(events)
    assert s["window_s"] == pytest.approx(900e-9)
    # busy: [100, 120] + [150, 400] + [700, 900]
    assert s["busy_s"] == pytest.approx(470e-9)
    assert s["kernels"]["k1"] == (2, pytest.approx(350e-9))
    assert s["gaps"][0] == (pytest.approx(300e-9), "aten::copy_")
    assert s["gaps"][1][0] == pytest.approx(100e-9)
    b = profiling.breakdown(s)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 3
    assert profiling.reduce_events(events[2:]) is None


class _Window:
    def __init__(self):
        self.calls, self.done, self.overhead_s = [], False, 0.0

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")
        self.done = True


@pytest.mark.parametrize("k, log_every, start_at, traced", [
    (4, 1, 12, range(16, 20)),            # the hybrid's: every epoch logs
    (8, 10, 330, range(344, 352)),        # the Simple VAE's: every 10th
    (8, 10, 35, range(40, 56)),           # chunk 5 logs nothing: two traced
])
def test_probe_traces_whole_chunks(k, log_every, start_at, traced):
    probe = Probe(k, start_at)
    probe.window = _Window()
    epochs = 600
    for chunk_start in range(0, epochs, k):
        for e in range(chunk_start, chunk_start + k):
            if (e + 1) % log_every == 0:
                probe.log("epoch", epoch=e + 1)
    assert probe.window.calls == ["start", "stop"]
    assert probe.traced_epochs(epochs) == traced
    assert probe.touched_epochs(epochs) == range(traced.start - k, traced.stop)


@pytest.mark.parametrize("seconds, epoch_s, k, plan", [
    (51, 1.141, 4, [45]),                 # the hybrid's: one fit
    (51, 0.044, 8, [385] * 3),            # the Simple VAE's: 1,159 epochs
    (30, 1.14, 4, [25]),
    (3, 1.14, 4, [5]),                    # at least a chunk and a replay
    (0.2, 0.044, 8, [9]),
])
def test_window_plan(seconds, epoch_s, k, plan):
    got = window_plan(seconds, epoch_s, k, 500)
    assert got == plan
    assert all(e <= 500 and e % k == 1 % k and e > k for e in got)


def test_limits_name_what_is_compared():
    assert correct.compared_names({"loss_gap": 1.0, "exclude_below": 0.1,
                                   "replay_loss_gap": 2.0}) == [
        "loss_gap", "replay_loss_gap"]
    with pytest.raises(ValueError, match="los_gap"):
        correct.compared_names({"los_gap": 1.0})
