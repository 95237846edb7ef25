"""The cells at a size a CPU test run holds: the published widths, a 64 x
64 mel image instead of 128 x 1,024, and tens of rows."""

from __future__ import annotations

import copy

from portbench import harness


def tiny_spec(cell: str) -> dict:
    spec = copy.deepcopy(harness.cell_spec(cell))
    if spec["config"]["family"] == "hybrid":
        spec["config"]["input_hw"] = [64, 64]
        spec["config"]["inputs"][0]["row_shape"] = [64, 64, 1]
        spec["traffic"]["rows"] = 60
    else:
        spec["traffic"]["rows"] = 100
    return spec
