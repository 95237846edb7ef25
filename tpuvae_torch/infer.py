"""Serving: encode NEW clips with a trained model and assign clusters
(counterpart of ``tpuvae/infer.py``).

Loads the serving bundle the training pipeline persisted
(``results/<Arch>/serving/`` — final weights, K-Means centroids,
model-rebuild metadata) together with the preprocessing normalizers
(``processed_data1/{scaler,imputer,config}.pkl``), and maps raw audio to
latent vectors and nearest-centroid cluster ids, batched on the card.  The
bundle layout is the JAX pipeline's, so a bundle written by either package
loads here.

Usage::

    enc = ClipEncoder.load("simple", results_dir="results",
                           data_dir="processed_data1")     # device="cuda"
    out = enc.encode_paths(["new_song.wav"])
    out.latents   # (1, 32)
    out.clusters  # (1,) int — nearest training centroid

or ``python -m tpuvae_torch.cli encode --arch=simple song.wav``.  Only the
``simple`` architecture is served; ``cvae`` / ``hybrid`` serving is queued
in ROADMAP.md (queue 1, item 8), though ``run_conditional_vae`` already
writes its bundle through :func:`save_serving_model`.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import torch

from tpuvae_torch.config import PreprocessConfig
from tpuvae_torch.convert import simple_vae_from_flax
from tpuvae_torch.device import resolve_device
from tpuvae_torch.dsp.features import extract_basic_features, make_extractor
from tpuvae_torch.io.normalize import load_normalizer
from tpuvae_torch.io.wav import load_audio
from tpuvae_torch.models import SimpleVAE
from tpuvae_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tpuvae_torch.utils.batching import batched_apply

_ARCH_DIRS = {
    "simple": ("Simple_VAE", "processed_data1"),
    "cvae": ("Conditional_VAE", "processed_data2"),
    "hybrid": ("Convolutional_VAE", "processed_data2"),
}


@dataclasses.dataclass
class EncodeResult:
    latents: np.ndarray    # (N, latent_dim) encoder means
    clusters: np.ndarray   # (N,) nearest training centroid (-1 if none saved)
    paths: list[str]


def _nearest_center(latents: np.ndarray, centers: np.ndarray | None):
    if centers is None or len(centers) == 0:
        return np.full((len(latents),), -1, np.int32)
    d2 = ((latents[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    # NaN rows mark label ids whose cluster was empty at training time —
    # never the nearest
    d2 = np.where(np.isnan(d2), np.inf, d2)
    return np.argmin(d2, axis=1).astype(np.int32)


@dataclasses.dataclass
class ClipEncoder:
    """A trained model + its preprocessing state, ready to encode new clips."""

    arch: str
    meta: dict
    model: SimpleVAE
    pre_cfg: PreprocessConfig
    centers: np.ndarray | None
    imputer: object
    scaler: object
    device: torch.device
    tuning_route: str = "fused"

    # -- construction ------------------------------------------------------

    @classmethod
    def load(cls, arch: str, results_dir: str = "results",
             data_dir: str | None = None, device: str = "cuda",
             tuning_route: str = "fused") -> "ClipEncoder":
        """Load the serving bundle written by a training pipeline.

        ``data_dir`` defaults to the preprocessing dir recorded in the
        bundle's metadata, then to ``processed_data1``.  ``device`` defaults
        to CUDA and raises without a card; pass ``device='cpu'`` to run the
        kernels' plain versions.
        """
        if arch not in _ARCH_DIRS:
            raise ValueError(f"arch must be one of {sorted(_ARCH_DIRS)}, "
                             f"got {arch!r}")
        if arch != "simple":
            raise NotImplementedError(
                f"arch {arch!r} is not ported to tpuvae_torch yet "
                f"(ROADMAP.md, queue 1, item 8: cvae/hybrid serving)")
        dev = resolve_device(device)
        subdir, default_data = _ARCH_DIRS[arch]
        serving = Path(results_dir) / subdir / "serving"
        if not (serving / "model").exists():
            raise FileNotFoundError(
                f"no serving bundle at {serving}/model — run the "
                f"train-{arch} pipeline first (it persists final weights + "
                f"centroids there)")
        flat, meta = load_checkpoint(serving / "model")
        if data_dir is None:
            trained_from = meta.get("data_dir")
            if trained_from and Path(trained_from, "config.pkl").exists():
                data = Path(trained_from)
            else:
                if trained_from:
                    warnings.warn(
                        f"training-time data dir {trained_from!r} no longer "
                        f"exists; falling back to {default_data!r} — pass "
                        f"data_dir= if its scalers differ", stacklevel=2)
                data = Path(default_data)
        else:
            data = Path(data_dir)
        centers_path = serving / "kmeans_centers.npy"
        centers = np.load(centers_path) if centers_path.exists() else None

        cfg_dict = dict(load_normalizer(data / "config.pkl"))
        cfg_dict.pop("lyrics_embedder_backend", None)
        model = SimpleVAE(
            input_dim=meta["input_dim"], hidden_dims=tuple(meta["hidden_dims"]),
            latent_dim=meta["latent_dim"], dropout=meta["dropout"])
        model.load_state_dict(simple_vae_from_flax(flat))
        model.to(dev).eval()
        return cls(arch=arch, meta=meta, model=model,
                   pre_cfg=PreprocessConfig.from_dict(cfg_dict),
                   centers=centers,
                   imputer=load_normalizer(data / "imputer.pkl"),
                   scaler=load_normalizer(data / "scaler.pkl"),
                   device=dev, tuning_route=tuning_route)

    # -- encoding ----------------------------------------------------------

    def extract(self, waveforms: np.ndarray) -> torch.Tensor:
        """Raw 370-d features of one device batch ``(B, num_samples)``."""
        fn = make_extractor(extract_basic_features, self.pre_cfg, self.device,
                            tuning_route=self.tuning_route)
        return fn(waveforms)

    def normalize(self, feats: np.ndarray) -> np.ndarray:
        return self.scaler.transform(
            self.imputer.transform(feats)).astype(np.float32)

    def apply_latent(self, x: np.ndarray) -> torch.Tensor:
        """Encoder means of normalized model inputs ``(B, input_dim)``."""
        with torch.no_grad():
            return self.model.latent(torch.as_tensor(x).to(self.device))

    def validate_args(self, n: int, lyrics=None, genres=None) -> None:
        """Raise the errors :meth:`encode_waveforms` would, without touching
        the device."""
        if lyrics is not None or genres is not None:
            raise ValueError("the simple arch uses neither lyrics nor genres"
                             " — they would be silently dropped")

    def encode_waveforms(self, waveforms: np.ndarray, lyrics=None,
                         genres=None, batch_size: int = 32) -> EncodeResult:
        """Encode pre-loaded ``(N, num_samples)`` float32 waveforms."""
        n = waveforms.shape[0]
        self.validate_args(n, lyrics=lyrics, genres=genres)
        waveforms = np.asarray(waveforms, np.float32)
        raw = batched_apply(self.extract, (waveforms,), batch_size)
        mu = batched_apply(self.apply_latent, (self.normalize(raw),),
                           batch_size).astype(np.float32)
        return EncodeResult(latents=mu,
                            clusters=_nearest_center(mu, self.centers),
                            paths=[])

    def load_waveforms(self, paths) -> np.ndarray:
        """Decode audio files host-side at the bundle's training geometry."""
        return np.stack([
            load_audio(p, self.pre_cfg.sample_rate, self.pre_cfg.duration)
            for p in paths
        ])

    def encode_paths(self, paths, lyrics=None, genres=None,
                     batch_size: int = 32) -> EncodeResult:
        """Decode audio files host-side, then :meth:`encode_waveforms`."""
        paths = [str(p) for p in paths]
        res = self.encode_waveforms(self.load_waveforms(paths), lyrics=lyrics,
                                    genres=genres, batch_size=batch_size)
        return EncodeResult(latents=res.latents, clusters=res.clusters,
                            paths=paths)


def save_serving_model(results_dir: str | Path, model: torch.nn.Module,
                       centers: np.ndarray, meta: dict) -> Path:
    """Write the serving model of ``meta["arch"]`` and its centroids in the
    JAX pipeline's layout (``tpuvae/pipelines.py:549-567``):
    ``<results_dir>/<Arch dir>/serving/{model/, kmeans_centers.npy}``.
    Returns the ``serving`` directory."""
    out = Path(results_dir) / _ARCH_DIRS[meta["arch"]][0] / "serving"
    save_checkpoint(out / "model", model, meta)
    np.save(out / "kmeans_centers.npy", np.asarray(centers, np.float32))
    return out


def save_serving_bundle(results_dir: str | Path, data_dir: str | Path,
                        model: SimpleVAE, centers: np.ndarray, *,
                        pre_cfg: PreprocessConfig, imputer, scaler,
                        meta: dict) -> None:
    """:func:`save_serving_model` plus the preprocessing pickles a bundle
    needs (the ``io/artifacts.py`` ones):
    ``<data_dir>/{config,imputer,scaler}.pkl``."""
    import pickle

    save_serving_model(results_dir, model, centers, meta)
    data = Path(data_dir)
    data.mkdir(parents=True, exist_ok=True)
    for name, obj in (("config", pre_cfg.to_dict()), ("imputer", imputer),
                      ("scaler", scaler)):
        with open(data / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)
