"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--seconds 51] [--sides program control half frozen]
    python3 portbench/calibrate.py --workload <cell> --seeds ... --start-only
    python3 portbench/calibrate.py --workload <cell> --seeds ... --epochs 3

Default: for each seed, in one process, a run's set-up and window at
``--seconds``, then the five numbers a run compares, with the plain
reference in float32 as the base and in the program's place: the program
(``program``); the reference in TF32 (``control``); the reference with
half of each batch left out (``half``); the reference whose replayed
epoch makes the draws of the fit's epoch 1 (``frozen``: a graph that
replays its captured draws; the first steps have no such fault).
``--start-only``: the first steps' numbers of the sides (the program's
from a run's set-up ``fit``, no window), with the leaf that sets
``grad_gap``.  ``--epochs E``: each epoch's
training and validation loss over E epochs from the seed's weights, of
the program's ``fit`` and of the reference in float32 and float64.  One
JSON line per seed and side on standard output.  A run of the benchmark
never runs this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import correct, data, harness  # noqa: E402
from portbench.drivers import train  # noqa: E402
from portbench.reference import common  # noqa: E402

FAULTS = {"control": ("tf32", None), "half": ("fp32", "half"),
          "frozen": ("fp32", "frozen")}


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def readings(spec: dict, seed: int, seconds: float, sides,
             device) -> list[dict]:
    cfg = spec["config"]
    exclude = spec["limits"]["exclude_below"]
    t0 = time.perf_counter()
    m = train.measure(spec, seed, seconds, False, device, t0)
    _free()
    dat = data.make(cfg["inputs"], spec["traffic"], seed, device)
    ref = m.ref
    base = train.reference_steps(ref, cfg, dat, seed, device)
    base_r = train.reference_replay(ref, cfg, dat, seed, device, m.before,
                                    m.epochs_before)
    out = []
    for side in sides:
        if side == "program":
            start, replay = m.prog, m.replay_prog
        else:
            precision, fault = FAULTS[side]
            start = (m.prog if fault == "frozen" else train.reference_steps(
                ref, cfg, dat, seed, device, precision, fault))
            replay = train.reference_replay(ref, cfg, dat, seed, device,
                                            m.before, m.epochs_before,
                                            precision, fault)
        values = correct.readings(start, base, exclude)
        values.update(correct.replay_readings(replay, base_r, exclude))
        out.append({"workload": spec["name"], "seed": seed, "side": side,
                    **values, "epochs": m.ran,
                    "replay_losses": [replay["train_loss"], replay["val_loss"]],
                    "ref_replay_losses": [base_r["train_loss"],
                                          base_r["val_loss"]]})
    del m, dat
    _free()
    out[-1]["seconds"] = time.perf_counter() - t0
    return out


def start_only(spec: dict, seed: int, sides, device) -> list[dict]:
    """The first steps' numbers of each side (``program``: a run's set-up
    ``fit``), with the leaf that sets ``grad_gap`` and its reference norm
    over the median leaf's."""
    cfg = spec["config"]
    ref = train.families(cfg)[1]
    dat = data.make(cfg["inputs"], spec["traffic"], seed, device)
    prog = None
    if "program" in sides:
        _, _, _, init, job = train.set_up(spec, seed, device)
        prog = train.set_up_fit(job, init)[1]
        del job, init
        _free()
    base = train.reference_steps(ref, cfg, dat, seed, device)
    floor = sorted(base["first_grad"].values())[len(base["first_grad"]) // 2]
    out = []
    for side in [x for x in sides if x != "frozen"]:
        if side == "program":
            other = prog
        else:
            precision, fault = FAULTS[side]
            other = train.reference_steps(ref, cfg, dat, seed, device,
                                          precision, fault)
        gaps = correct.leaf_gaps(other["first_grad"], base["first_grad"],
                                 base["first_grad"])
        worst = max(gaps, key=gaps.get)
        out.append({"workload": spec["name"], "seed": seed, "side": side,
                    **correct.readings(other, base,
                                       spec["limits"]["exclude_below"]),
                    "worst_leaf": worst,
                    "worst_leaf_norm_over_median":
                        base["first_grad"][worst] / floor})
    return out


def epoch_losses(spec: dict, seed: int, epochs: int, device) -> list[dict]:
    """Each epoch's losses from the seed's weights: the program's ``fit``,
    and the reference in float32 and in float64."""
    cfg = spec["config"]
    fam, ref, dat, init, job = train.set_up(spec, seed, device)
    res = train.set_up_fit(job, init, epochs)[0]
    out = [{"side": "program", "train": res.history["train_loss"],
            "val": res.history["val_loss"]}]
    del res, job, init
    _free()
    for precision in ("fp32", "fp64"):
        model = ref.make_model(cfg, device, precision)
        model.load_state_dict(common.initial_state(model, seed, device))
        train_, val = ref.splits(cfg, train.reference_data(dat, precision),
                                 seed)
        fit_set = ref.fit_settings(cfg)
        opt = common.Adam(model.parameters(), fit_set["learning_rate"])
        gen = torch.Generator(device=device).manual_seed(seed)
        tl, vl = [], []
        with common.precision_scope(precision, device):
            for _ in range(epochs):
                e = common.train_epoch(model, opt, ref.objective(cfg), train_,
                                       val, fit=fit_set, gen=gen)
                tl.append(e["train_loss"])
                vl.append(e["val_loss"])
        out.append({"side": precision, "train": tl, "val": vl})
        del model, opt, train_, val
        _free()
    return [{"workload": spec["name"], "seed": seed, **o} for o in out]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--sides", nargs="+",
                    default=["program", "control", "half", "frozen"])
    ap.add_argument("--start-only", action="store_true")
    ap.add_argument("--epochs", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    from tpuvae_torch.device import resolve_device

    device = resolve_device("cuda:0")
    spec = harness.cell_spec(args.workload)
    for seed in args.seeds:
        if args.start_only:
            lines = start_only(spec, seed, args.sides, device)
        elif args.epochs:
            lines = epoch_losses(spec, seed, args.epochs, device)
        else:
            lines = readings(spec, seed, args.seconds, args.sides, device)
        for line in lines:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
