"""Consolidated results CSV (counterpart of ``tpuvae/io/results.py``).

The reference's read-modify-write contract (``Simple_VAE.py:277-295``):
read ``results/clustering_metrics.csv`` if present, drop all rows whose
``Architecture`` matches, append the new rows, rewrite.  Column sets of
different scripts are unioned with NaN fill, as pandas concat does.  (The
JAX function's per-architecture copy, which only its conv pipelines ask
for, comes with them.)
"""

from __future__ import annotations

from pathlib import Path

import pandas as pd


def consolidate_metrics(
    results_dir: str | Path,
    df_new: pd.DataFrame,
    architecture: str,
) -> Path:
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    common = results_dir / "clustering_metrics.csv"
    df_new = df_new.copy()
    df_new["Architecture"] = architecture

    df_common = df_new
    if common.exists():
        try:
            df_old = pd.read_csv(common)
            df_old = df_old[df_old["Architecture"] != architecture]
            df_common = pd.concat([df_old, df_new], ignore_index=True)
        except (KeyError, ValueError):
            # unreadable or foreign CSV: replaced, as the reference does
            df_common = df_new
    df_common.to_csv(common, index=False)
    return common
