"""The comparison that decides ``correct`` for a training cell.

The program and the plain reference each take the first optimizer steps
from the same initial weights on the same rows with the same draws; each
side then gives each step's loss, the norm of each parameter's first
gradient and the norm of each parameter's change over the steps.  The
numbers below are worked out; a cell compares those its limits file
names, each against its limit (``portbench/limits/<cell>.json``):

* ``loss_gap``: the largest relative gap between a step's loss and the
  reference's;
* ``grad_gap``: over the leaves, the gap between the norms of the first
  gradient, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
* ``grad_gap_median``: the median over the leaves of that gap (steady
  from seed to seed where the worst leaf swings);
* ``change_gap``: the same of the change, over the leaves whose first
  gradient in the reference is at least ``exclude_below`` of the median
  leaf's (those under it move by round-off alone, as a bias before a
  BatchNorm does).

The replayed epoch that the window's last fit ends with is compared as
well: the reference takes it from the state the program held before it,
with the draws of that epoch worked out again from the seed.

* ``replay_loss_gap``: the larger relative gap of the epoch's training
  and validation losses as the fit reports them;
* ``replay_change_gap``: over the entries of the model's state (weights
  and BatchNorm's running statistics), the gap between the norms of each
  entry's change over the epoch, over the reference's norm of that entry
  or of the median entry, whichever is larger; weights whose gradient at
  the epoch's first step in the reference is under ``exclude_below`` of
  the median weight's are left out, as above.

A number that is not finite fails, and so does a check whose epoch the
program never reported.
"""

from __future__ import annotations

import math
import statistics

START = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap")
REPLAY = ("replay_loss_gap", "replay_change_gap")
NAMES = START + REPLAY


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict[str, float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger (inf where the program has no
    such leaf or the gap is not finite)."""
    leaves = list(leaves)
    floor = statistics.median(ref[k] for k in leaves)
    out = {}
    for k in leaves:
        gap = (abs(prog[k] - ref[k]) / max(ref[k], floor) if k in prog
               else math.inf)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def _norm_gap(prog: dict, ref: dict, leaves) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def readings(prog: dict, ref: dict, exclude_below: float) -> dict:
    """The three numbers, from each side's ``losses`` (a list),
    ``first_grad`` and ``change`` (norms by leaf name)."""
    if prog.get("first_grad") is None or len(prog["losses"]) != len(
            ref["losses"]):
        return {name: math.inf for name in START}
    loss_gap = 0.0
    for p, r in zip(prog["losses"], ref["losses"]):
        gap = abs(p - r) / abs(r)
        loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
    g_ref = ref["first_grad"]
    floor = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= exclude_below * floor]
    grads = leaf_gaps(prog["first_grad"], g_ref, g_ref)
    return {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
            "grad_gap_median": statistics.median(grads.values()),
            "change_gap": _norm_gap(prog["change"], ref["change"], moved)}


def _rel(p, r) -> float:
    gap = abs(p - r) / abs(r)
    return gap if math.isfinite(gap) else math.inf


def replay_readings(prog: dict | None, ref: dict | None,
                    exclude_below: float) -> dict:
    """The two numbers of the replayed epoch, from each side's
    ``train_loss``, ``val_loss`` (None without a validation set) and
    ``change`` (norms by state entry), and the reference's ``first_grad``
    (norms by weight)."""
    if prog is None or ref is None:
        return {name: math.inf for name in REPLAY}
    gaps = [_rel(prog["train_loss"], ref["train_loss"])]
    if ref["val_loss"] is not None:
        gaps.append(_rel(prog["val_loss"], ref["val_loss"])
                    if prog["val_loss"] is not None else math.inf)
    g_ref = ref["first_grad"]
    floor = statistics.median(g_ref.values())
    leaves = [k for k in ref["change"]
              if k not in g_ref or g_ref[k] >= exclude_below * floor]
    return {"replay_loss_gap": max(gaps),
            "replay_change_gap": _norm_gap(prog["change"], ref["change"],
                                           leaves)}


def compared_names(limits: dict, names=NAMES) -> list[str]:
    """The numbers of ``names`` that a cell's limits file holds a limit
    for; a key it does not know is refused."""
    unknown = set(limits) - set(NAMES) - {"exclude_below"}
    if unknown:
        raise ValueError(f"limits for unknown numbers {sorted(unknown)}")
    return [k for k in names if k in limits]


def judge(values: dict, limits: dict, names=NAMES) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: each of ``names`` that
    the limits hold at or under its limit."""
    compared = {k: {"value": values[k], "limit": limits[k]}
                for k in compared_names(limits, names)}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
