"""Typed configuration (own copy of ``tpuvae/config.py``).

The dict round trip, ``key=value`` overrides, and the configs the ported
slices read — ``PreprocessConfig``, ``AdvancedPreprocessConfig``,
``SimpleVAEConfig``, ``ConditionalVAEConfig``, ``HybridVAEConfig``,
``TrainConfig`` and ``ClusterConfig`` — with the same fields and defaults
as the JAX package,
so a ``config.pkl`` written by either pipeline loads here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Sequence


def _asdict(cfg: Any) -> dict[str, Any]:
    d = dataclasses.asdict(cfg)
    return {k: (str(v) if isinstance(v, Path) else v) for k, v in d.items()}


class _ConfigBase:
    """Dict round trip and overrides shared by the config dataclasses."""

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

    def override(self, args: Sequence[str]):
        """Apply ``key=value`` CLI overrides, parsing values as JSON first."""
        d = self.to_dict()
        for arg in args:
            key, _, raw = arg.partition("=")
            key = key.lstrip("-")
            if key not in d:
                raise KeyError(f"{type(self).__name__} has no field {key!r}")
            try:
                val = json.loads(raw)
            except json.JSONDecodeError:
                val = raw
            d[key] = val
        return type(self).from_dict(d)


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
    # 'auto' and 'ct_pallas' = the fused FFT kernel (kernel 1, with the
    # fused tuning kernel 2); 'pallas' = the dense-DFT kernel (kernel 4);
    # 'fft' = torch.fft.rfft; 'dft' = dense matmuls outside any kernel.
    # Every method but the first two runs the staged front end (fp32 power
    # in both precision modes) and the staged tuning route (kernel 3).
    # 'ct' (the JAX package's XLA reference lowering) raises.
    stft_method: str = "auto"  # 'auto'|'fft'|'dft'|'ct'|'ct_pallas'|'pallas'
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


@dataclass(frozen=True)
class AdvancedPreprocessConfig(_ConfigBase):
    """Advanced pipeline settings (reference ``1_preprocessing_advanced.py:28-47``)."""

    sample_rate: int = 22050
    duration: float = 30.0
    n_mels: int = 128
    n_fft: int = 2048
    hop_length: int = 512
    n_chroma: int = 12
    fixed_time_steps: int = 1024
    max_samples_per_class: int = 200
    min_lyrics_chars: int = 15       # ref :246-249
    exclude_genres: tuple = ("jazz",)  # ref :227-229
    dataset_root: str = "Datasets"
    metadata_csv: str = "Datasets/updated_metadata.csv"
    output_dir: str = "processed_data2"
    text_model: str = "sentence-transformers/paraphrase-multilingual-mpnet-base-v2"
    text_dim: int = 768
    extract_batch: int = 128
    precision_mode: str = "fast"   # see PreprocessConfig.precision_mode
    stft_method: str = "auto"      # see PreprocessConfig.stft_method
    transfer_dtype: str = "auto"   # see PreprocessConfig.transfer_dtype
    # 'inmem' | 'stream' | 'auto': how the mel artifacts are assembled from
    # extraction shards.  'stream' bounds host RAM to one shard + one chunk
    # (tpuvae_torch.io.assembly); 'auto' streams once the raw mel tensor
    # exceeds 1 GiB.  'stream' requires resume=True (shards are the source).
    assembly_mode: str = "auto"

    @property
    def num_samples(self) -> int:
        return int(self.sample_rate * self.duration)

    @property
    def flat_feature_dim(self) -> int:
        # mel(db) mean+std + 5 spectral x2 + chroma mean+std = 290 (no MFCC;
        # ref :120-156)
        return self.n_mels * 2 + 10 + self.n_chroma * 2


@dataclass(frozen=True)
class SimpleVAEConfig(_ConfigBase):
    """Simple (MLP) VAE hyperparameters (reference ``Simple_VAE.py:118-126``)."""

    input_dim: int = 370
    hidden_dims: tuple = (128, 64, 32)
    latent_dim: int = 32
    dropout: float = 0.2
    learning_rate: float = 1e-4
    batch_size: int = 32
    epochs: int = 500
    beta: float = 0.8
    patience: int = 15
    plateau_patience: int = 15       # ReduceLROnPlateau(factor=.5, patience=15)
    plateau_factor: float = 0.5
    # read by the JAX package only (epochs per device call); the port runs
    # one epoch per step of its host loop and logs that it ignores this
    scan_epochs: int = 8
    # periodic full-train-state checkpoints (0 = off), written to
    # <results_dir>/<arch>/checkpoints with CheckpointManager rotation
    checkpoint_every: int = 0
    checkpoint_keep: int = 1
    seed: int = 42


@dataclass(frozen=True)
class ConditionalVAEConfig(_ConfigBase):
    """Conditional conv VAE hyperparameters (reference ``Conditional_VAE.py:29-41``)."""

    latent_dim: int = 64
    text_dim: int = 768
    num_classes: int = 10
    # the port computes in float32 only: 'bfloat16' raises (kernel 6 has no
    # bf16 form; ROADMAP.md, queue 1, item 5)
    compute_dtype: str = "float32"
    learning_rate: float = 1e-4
    batch_size: int = 32
    epochs: int = 600
    beta: float = 4.0
    text_loss_weight: float = 200.0  # dim-balancing weight, ref :238-240
    patience: int = 20
    val_fraction: float = 0.15
    scan_epochs: int = 4             # read by the JAX package only
    # memory-map the mel tensor and stream one batch per step
    # (FitConfig.host_stream): O(batch) host and device memory instead of
    # O(N), for datasets larger than either
    host_stream: bool = False
    # periodic full-train-state checkpoints (0 = off), written to
    # <results_dir>/<arch>/checkpoints with CheckpointManager rotation
    checkpoint_every: int = 0
    checkpoint_keep: int = 1
    seed: int = 42


@dataclass(frozen=True)
class HybridVAEConfig(_ConfigBase):
    """Hybrid conv+MLP VAE hyperparameters (reference ``Convolutional_VAE.py:202-205``)."""

    latent_dim: int = 128
    text_dim: int = 768
    compute_dtype: str = "float32"   # see ConditionalVAEConfig
    learning_rate: float = 1e-4
    batch_size: int = 32
    epochs: int = 500
    beta: float = 1.0
    alpha: float = 1.0               # declared-but-unused in the reference (:187)
    text_loss_weight: float = 350.0  # ref :194
    patience: int = 15
    val_fraction: float = 0.15
    scan_epochs: int = 4             # read by the JAX package only
    host_stream: bool = False        # see ConditionalVAEConfig
    checkpoint_every: int = 0
    checkpoint_keep: int = 1
    seed: int = 42


@dataclass(frozen=True)
class TrainConfig(_ConfigBase):
    """Cross-cutting training/runtime options (``tpuvae/config.py:239``).
    The port reads none of them yet: the mesh item takes ``mesh_*``, the
    bf16 item ``compute_dtype``; the rest are the JAX package's knobs."""

    mesh_shape: tuple = (-1,)        # -1 = all devices on the 'data' axis
    mesh_axes: tuple = ("data",)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"   # 'bfloat16' for large models
    checkpoint_dir: str = "checkpoints"
    restore_best: bool = True
    log_every: int = 10
    profile: bool = False


@dataclass(frozen=True)
class ClusterConfig(_ConfigBase):
    """Clustering/eval settings covering all three reference sweeps."""

    kmeans_n_init: int = 10
    kmeans_max_iter: int = 300
    kmeans_tol: float = 1e-4
    seed: int = 42
    simple_k_sweep: tuple = (3, 5, 7, 9)        # ref Simple_VAE.py:241 range(3,10,2)
    hybrid_k_min: int = 2                        # ref Convolutional_VAE.py:311 range(2,15)
    hybrid_k_max: int = 14
    dbscan_eps_min: float = 3.0                  # ref Convolutional_VAE.py:350 arange(3,20,1)
    dbscan_eps_max: float = 19.0
    dbscan_eps_step: float = 1.0
    dbscan_min_samples: int = 5
    dbscan_fallback_eps: float = 10.0            # ref :370-372
    tsne_perplexity: float = 30.0
    results_dir: str = "results"


DEFAULTS = {
    "preprocess": PreprocessConfig,
    "preprocess_advanced": AdvancedPreprocessConfig,
    "simple_vae": SimpleVAEConfig,
    "conditional_vae": ConditionalVAEConfig,
    "hybrid_vae": HybridVAEConfig,
    "train": TrainConfig,
    "cluster": ClusterConfig,
}
