"""Normalizers: StandardScaler + mean SimpleImputer equivalents
(counterpart of ``tpuvae/io/normalize.py:31-91``, host numpy only).

The fitted parameters are small dataclasses persisted as the
``scaler.pkl`` / ``imputer.pkl`` artifacts.  :func:`load_normalizer`
reads such a pickle through a restricted unpickler: it maps the JAX
package's classes (``tpuvae.io.normalize.MeanImputer`` /
``StandardScaler``) onto the ones here, so a bundle written by the JAX
pipeline loads without importing ``tpuvae``, and it refuses every other
global except numpy's array reconstruction.
"""

from __future__ import annotations

import dataclasses
import pickle
import warnings
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class MeanImputer:
    """inf->NaN then column-mean imputation (SimpleImputer(strategy='mean'))."""

    means: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "MeanImputer":
        x = np.where(np.isinf(x), np.nan, x)
        with warnings.catch_warnings():
            # all-NaN columns mean-impute to NaN, silently
            warnings.simplefilter("ignore", RuntimeWarning)
            self.means = np.asarray(np.nanmean(x, axis=0))
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.where(np.isinf(x), np.nan, x)
        return np.where(np.isnan(x), np.asarray(self.means)[None, :], x)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


@dataclasses.dataclass
class StandardScaler:
    """Per-feature (x - mean) / std with population std (sklearn semantics;
    zero-variance features pass through unscaled)."""

    mean: np.ndarray | None = None
    scale: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        mean = np.mean(x, axis=0, dtype=x.dtype)
        var = np.var(x, axis=0, dtype=x.dtype)
        scale = np.sqrt(var)
        scale = np.where(scale == 0.0, np.asarray(1.0, scale.dtype), scale)
        self.mean, self.scale = np.asarray(mean), np.asarray(scale)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        out = np.subtract(x, self.mean, dtype=np.result_type(x, self.mean))
        np.divide(out, self.scale, out=out)
        return out

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


def impute_and_scale(features: np.ndarray):
    """inf->NaN, mean-impute, standardize (ref ``1_preprocessing.py:305-311``).
    Returns (normalized, imputer, scaler)."""
    imputer = MeanImputer()
    imputed = imputer.fit_transform(features)
    scaler = StandardScaler()
    return scaler.fit_transform(imputed).astype(np.float32), imputer, scaler


_CLASSES = {"MeanImputer": MeanImputer, "StandardScaler": StandardScaler}
_NORMALIZER_MODULES = ("tpuvae.io.normalize", "tpuvae_torch.io.normalize")
_NUMPY_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}


class _BundleUnpickler(pickle.Unpickler):
    """Loads normalizer / config pickles of either package; nothing else."""

    def find_class(self, module: str, name: str):
        if module in _NORMALIZER_MODULES and name in _CLASSES:
            return _CLASSES[name]
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to load global {module}.{name} from a serving bundle")


def load_normalizer(path: str | Path):
    """Unpickle a ``scaler.pkl`` / ``imputer.pkl`` / ``config.pkl`` written
    by either package (see the module docstring)."""
    with open(path, "rb") as f:
        return _BundleUnpickler(f).load()
