"""The general generator of the benchmark's data.

A configuration lists its inputs (``inputs``: a name, the shape of one
row, and either ``standardize``, as the preprocess pipelines' scalers
leave a column, or a ``scale``); a traffic mix gives how many rows, in how
many planted groups, and how far the groups and the rows spread.  Every
row is its group's centre plus its own noise; the arrays are drawn on the
device from the seed, in a few large calls.
"""

from __future__ import annotations

import math

import torch


def make(inputs: list[dict], traffic: dict, seed: int,
         device) -> dict[str, torch.Tensor]:
    """``{name: (rows, *row_shape) float32}`` and ``labels`` (the groups)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 1) % (1 << 63))
    rows, groups = int(traffic["rows"]), int(traffic["groups"])
    labels = torch.randint(groups, (rows,), generator=gen, device=device)
    out = {"labels": labels}
    for spec in inputs:
        width = math.prod(spec["row_shape"])
        centres = torch.randn(groups, width, generator=gen, device=device)
        x = torch.randn(rows, width, generator=gen, device=device)
        x.mul_(float(traffic["noise"])).add_(
            centres.mul_(float(traffic["group_spread"]))[labels])
        if spec.get("standardize"):
            mean = x.mean(dim=0)
            std = torch.sqrt(torch.clamp_min(
                (x * x).mean(dim=0) - mean * mean, 0.0))
            x.sub_(mean).div_(torch.where(std > 0, std, torch.ones_like(std)))
        else:
            x.mul_(float(spec["scale"]))
        out[spec["name"]] = x.view(rows, *spec["row_shape"])
    return out
