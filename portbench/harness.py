"""The harness: find a cell by name, run it on the card, print its line.

``BENCHMARK.json`` names each cell's configuration and traffic mix and the
metrics it reports.  The files are found by those names:

* ``portbench/configs/<config>.json`` (its ``file`` entry): the sizes, and
  the ``family`` that names ``portbench/models/<family>.py`` (the port's
  side) and ``portbench/reference/<family>.py`` (the plain reference);
* ``portbench/traffic/<traffic>.json``: the mix, whose ``kind`` names the
  driver ``portbench/drivers/<kind>.py``;
* ``portbench/limits/<cell>.json``: the limits of the comparison that
  decides ``correct``;
* ``portbench/windows/<cell>.json``: the window's work, as the nominal
  seconds of one epoch (``epoch_s``) that ``--seconds`` is divided by;
* ``portbench/metrics/<metric>.py``: one reader per metric, ``read(record)
  -> float | None``; a reader that finds nothing returns None and the
  metric is left out of the line.

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.  A run needs the card: without CUDA, or
with fewer cards than the cell asks for, it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuvae")


class CellError(Exception):
    """A cell that cannot be run as named: unknown, or a file missing."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """Everything the cell ``name`` needs, read from its files; raises
    :class:`CellError` naming what is missing."""
    if bench is None:
        bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload named {name!r} in BENCHMARK.json "
                        f"(there are {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"workload {name!r} names config {cell['config']!r}, "
                        "which BENCHMARK.json does not list")
    config = _json(ROOT / configs[cell["config"]]["file"])
    traffic = _json(PKG / "traffic" / f"{cell['traffic']}.json")
    limits = _json(PKG / "limits" / f"{name}.json")
    window = _json(PKG / "windows" / f"{name}.json")
    for sub, stem in (("models", config["family"]),
                      ("reference", config["family"]),
                      ("drivers", traffic["kind"])):
        if not (PKG / sub / f"{stem}.py").is_file():
            raise CellError(f"missing file portbench/{sub}/{stem}.py")
    metrics = {}
    for group in ("end_to_end", "per_layer"):
        metrics[group] = [m for m in bench[group] if _for_cell(m, name)]
        for m in metrics[group]:
            if not (PKG / "metrics" / f"{m['name']}.py").is_file():
                raise CellError(f"missing file portbench/metrics/{m['name']}.py")
    return {"name": name, "cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "window": window, "metrics": metrics}


def reader(metric: str):
    """``read(record)`` of ``portbench/metrics/<metric>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list[str]:
    """Modules loaded whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``tpuvae_torch`` is not ``tpuvae``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _number(v):
    """A finite float for the line, or None."""
    return float(v) if v is not None and math.isfinite(v) else None


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = cell_spec(args.workload)
    except CellError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2

    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs only on the card", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < chips:
        print(f"portbench: {spec['name']} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    from tpuvae_torch.device import resolve_device

    resolve_device(device)          # the port's precision: TF32 off
    driver = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['kind']}")
    out = driver.run(spec, args.seed, args.seconds, bool(args.trace), device,
                     t_start)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    group = "per_layer" if args.trace else "end_to_end"
    record = out["record"]
    metrics = {}
    for m in spec["metrics"][group]:
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit_w": power_limit_w()}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        prof = out["profile"]
        dev["busy_s"] = prof["busy_s"] if prof else 0.0
        dev["window_s"] = prof["window_s"] if prof else 0.0
        if prof:
            from portbench.profiling import breakdown

            line["breakdown"] = breakdown(prof)
    print("stages " + json.dumps(record.stages)
          + f" epochs {record.epochs} in {len(record.fits)} fits"
          f" window_s {record.window_s}", file=sys.stderr)
    compared = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                for k, c in out["compared"].items()}
    line["compared"] = compared
    for k, c in compared.items():
        print(f"compared {k}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0
