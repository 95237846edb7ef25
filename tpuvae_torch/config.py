"""Typed configuration (own copy of ``tpuvae/config.py:22-115``).

Only what the serving slice reads: the dict round trip and
``PreprocessConfig`` with the same fields and defaults as the JAX
package, so a ``config.pkl`` written by either pipeline loads here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any


def _asdict(cfg: Any) -> dict[str, Any]:
    d = dataclasses.asdict(cfg)
    return {k: (str(v) if isinstance(v, Path) else v) for k, v in d.items()}


class _ConfigBase:
    """Dict round trip shared by the config dataclasses."""

    def to_dict(self) -> dict[str, Any]:
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]):
        names = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in names:
                raise KeyError(f"{cls.__name__} has no field {k!r}")
            if names[k].type in ("Path", Path) or isinstance(
                getattr(cls, k, None), Path
            ):
                v = Path(v)
            kwargs[k] = v
        return cls(**kwargs)


@dataclass(frozen=True)
class PreprocessConfig(_ConfigBase):
    """Basic pipeline settings (reference ``1_preprocessing.py:21-37``)."""

    sample_rate: int = 22050
    duration: float = 30.0
    n_mels: int = 128
    n_fft: int = 2048
    hop_length: int = 512
    n_mfcc: int = 40
    n_chroma: int = 12
    max_samples_per_class: int = 160
    dataset_root: str = "Datasets"
    metadata_csv: str = "Datasets/updated_metadata.csv"
    output_dir: str = "processed_data1"
    extract_batch: int = 128
    # 'fast' stores the (B, 1025, T) power spectrogram as bfloat16 (every
    # statistic is still computed from fp32 power); 'exact' keeps it fp32
    precision_mode: str = "fast"
    # read by the JAX package only (its STFT lowering); kept so a config
    # written by either package round-trips
    stft_method: str = "auto"
    # host->device wire dtype: 'int16' ships PCM and widens on device
    # (x * 2^-15); 'auto' = int16 in fast mode, float32 in exact mode
    transfer_dtype: str = "auto"

    @property
    def num_samples(self) -> int:
        return int(self.sample_rate * self.duration)

    @property
    def feature_dim(self) -> int:
        # mel mean+std, mfcc mean+std, 5 spectral stats x2, chroma mean+std
        return self.n_mels * 2 + self.n_mfcc * 2 + 10 + self.n_chroma * 2
