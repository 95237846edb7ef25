"""Artifact store: the inter-stage data contract (counterpart of
``tpuvae/io/artifacts.py``; the reference's ``1_preprocessing.py:329-343``
and ``1_preprocessing_advanced.py:406-421``).

  processed_data1/: features_raw.npy, features_normalized.npy, labels.npy,
                    metadata.csv, scaler.pkl, imputer.pkl, config.pkl
  processed_data2/: mel_spectrograms_{raw,normalized}.npy,
                    features_{raw,normalized}.npy, lyrics_embeddings.npy,
                    labels.npy, metadata.csv, mel_scaler.pkl, flat_scaler.pkl,
                    imputer.pkl, config.pkl

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


def save_advanced(out_dir, *, mel_raw, mel_normalized, features_raw,
                  features_normalized, lyrics_embeddings, labels,
                  metadata: pd.DataFrame, mel_scaler, flat_scaler, imputer,
                  config) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    # mel arrays arrive as None when the streaming assembly
    # (tpuvae_torch.io.assembly) already wrote them memmap-backed into out_dir
    if mel_raw is not None:
        np.save(out / "mel_spectrograms_raw.npy", np.asarray(mel_raw))
    if mel_normalized is not None:
        np.save(out / "mel_spectrograms_normalized.npy",
                np.asarray(mel_normalized))
    np.save(out / "features_raw.npy", np.asarray(features_raw))
    np.save(out / "features_normalized.npy", np.asarray(features_normalized))
    np.save(out / "lyrics_embeddings.npy", np.asarray(lyrics_embeddings))
    np.save(out / "labels.npy", np.asarray(labels))
    metadata.to_csv(out / "metadata.csv", index=False)
    _save_pickles(out, mel_scaler=mel_scaler, flat_scaler=flat_scaler,
                  imputer=imputer,
                  config=config.to_dict() if hasattr(config, "to_dict") else config)
    verify_roundtrip(out, ["mel_spectrograms_normalized.npy",
                           "lyrics_embeddings.npy", "labels.npy"])


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


def load_advanced(data_dir, mmap: bool = False) -> dict:
    """Load the processed_data2 contract.  ``mmap=True`` memory-maps the
    big mel tensor (for streamed training); the small arrays load eagerly
    either way."""
    d = Path(data_dir)
    return {
        "mel": np.load(d / "mel_spectrograms_normalized.npy",
                       mmap_mode="r" if mmap else None),
        "text": np.load(d / "lyrics_embeddings.npy"),
        "handcrafted": np.load(d / "features_normalized.npy"),
        "labels": np.load(d / "labels.npy", allow_pickle=True),
        "metadata": pd.read_csv(d / "metadata.csv"),
    }


def save_latents(path, latents: np.ndarray, dtype: str = "float32") -> None:
    """Write latents as the JAX pipeline's ``np.save`` does for its compute
    dtype.  Under ``"bfloat16"`` that is an ml_dtypes array: a ``.npy``
    whose header says ``'descr': '<V2'`` and whose data are the raw
    bfloat16 bits.  ``latents`` holds bfloat16 values in float32 there, so
    the narrowing is exact (numpy has no bfloat16 and ``np.save`` of a
    ``'V2'`` view would write ``'|V2'``)."""
    import torch

    if dtype == "float32":
        np.save(path, np.asarray(latents, np.float32))
        return
    if dtype != "bfloat16":
        raise ValueError(f"latents dtype must be float32 or bfloat16, got "
                         f"{dtype!r}")
    wide = torch.from_numpy(np.ascontiguousarray(latents, np.float32))
    narrow = wide.to(torch.bfloat16)
    if not torch.equal(narrow.float(), wide):
        raise ValueError("latents are not bfloat16 values")
    bits = narrow.view(torch.int16).numpy().astype("<i2")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": bits.shape})
        f.write(bits.tobytes())


def load_latents(path) -> np.ndarray:
    """float32 latents of a file :func:`save_latents` (or the JAX
    pipeline) wrote; a ``V2`` file's bfloat16 bits are widened exactly."""
    import torch

    arr = np.load(path)
    if arr.dtype.kind != "V":
        return np.asarray(arr, np.float32)
    bits = torch.from_numpy(np.ascontiguousarray(arr).view("<i2"))
    return bits.view(torch.bfloat16).float().numpy()
