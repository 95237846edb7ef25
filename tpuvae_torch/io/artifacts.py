"""Artifact store: the ``processed_data1`` contract (counterpart of
``tpuvae/io/artifacts.py``; the reference's ``1_preprocessing.py:329-343``).

  processed_data1/: features_raw.npy, features_normalized.npy, labels.npy,
                    metadata.csv, scaler.pkl, imputer.pkl, config.pkl

The pickles hold the port's own ``MeanImputer`` / ``StandardScaler``
(``tpuvae_torch.io.normalize``) and the config as a dict; saving ends with
a reload check like the reference's (``1_preprocessing.py:358-368``).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import pandas as pd


def _save_pickles(out: Path, **objs) -> None:
    for name, obj in objs.items():
        with open(out / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)


def save_basic(out_dir, *, features_raw, features_normalized, labels,
               metadata: pd.DataFrame, scaler, imputer, config) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "features_raw.npy", np.asarray(features_raw))
    np.save(out / "features_normalized.npy", np.asarray(features_normalized))
    np.save(out / "labels.npy", np.asarray(labels))
    metadata.to_csv(out / "metadata.csv", index=False)
    _save_pickles(out, scaler=scaler, imputer=imputer,
                  config=config.to_dict() if hasattr(config, "to_dict") else config)
    verify_roundtrip(out, ["features_normalized.npy", "labels.npy"])


def verify_roundtrip(out: Path, names: list[str]) -> None:
    for name in names:
        try:
            # memory-mapped: the header carries the shape
            arr = np.load(Path(out) / name, mmap_mode="r")
        except ValueError:  # object arrays (e.g. string labels) can't mmap
            arr = np.load(Path(out) / name, allow_pickle=True)
        if arr.shape[0] == 0:
            raise IOError(f"artifact {name} is empty after save")


def load_basic(data_dir) -> dict:
    d = Path(data_dir)
    return {
        "features": np.load(d / "features_normalized.npy"),
        "features_raw": np.load(d / "features_raw.npy"),
        "labels": np.load(d / "labels.npy", allow_pickle=True),
        "metadata": pd.read_csv(d / "metadata.csv"),
    }
