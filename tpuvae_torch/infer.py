"""Serving: encode NEW clips with a trained model and assign clusters
(counterpart of ``tpuvae/infer.py``).

Loads the serving bundle a training pipeline persisted
(``results/<Arch>/serving/`` — final weights, K-Means centroids,
model-rebuild metadata) together with the preprocessing normalizers
(``processed_data1/{scaler,imputer,config}.pkl`` for ``simple``,
``processed_data2/{mel_scaler,config}.pkl`` for ``cvae`` / ``hybrid``), and
maps raw audio (+ lyrics, + genres for ``cvae``) to latent vectors and
nearest-centroid cluster ids, batched on the card.  Lyrics are embedded as
at training time when ``$TPUVAE_TEXT_CHECKPOINT`` names the same
checkpoint (on the encoder's device), else by hashed n-grams, with a
warning when the backend differs from the bundle's.  The bundle layout is
the JAX pipeline's, so a bundle written by either package loads here.

Usage::

    enc = ClipEncoder.load("hybrid", results_dir="results",
                           data_dir="processed_data2")     # device="cuda"
    out = enc.encode_paths(["new_song.wav"], lyrics=["la la la"])
    out.latents   # (1, 128)
    out.clusters  # (1,) int — nearest training centroid

or ``python -m tpuvae_torch.cli encode --lyrics="la la la" song.wav``.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import torch

from tpuvae_torch.config import AdvancedPreprocessConfig, PreprocessConfig
from tpuvae_torch.convert import from_flax
from tpuvae_torch.device import resolve_device
from tpuvae_torch.dsp.features import (
    extract_basic_features,
    extract_mel_image,
    make_extractor,
)
from tpuvae_torch.io.normalize import load_normalizer
from tpuvae_torch.io.wav import load_audio
from tpuvae_torch.models import ConditionalVAE, HybridVAE, SimpleVAE
from tpuvae_torch.models.layers import compute_dtype
from tpuvae_torch.text.embedder import embed_lyrics
from tpuvae_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tpuvae_torch.utils.batching import batched_apply

_ARCH_DIRS = {
    "simple": ("Simple_VAE", "processed_data1"),
    "cvae": ("Conditional_VAE", "processed_data2"),
    "hybrid": ("Convolutional_VAE", "processed_data2"),
}
# the normalizer pickles of each architecture's preprocessing dir
_NORMALIZERS = {"simple": ("imputer", "scaler"), "cvae": ("mel_scaler",),
                "hybrid": ("mel_scaler",)}


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


def _build_model(arch: str, meta: dict) -> torch.nn.Module:
    if arch == "simple":
        return SimpleVAE(
            input_dim=meta["input_dim"], hidden_dims=tuple(meta["hidden_dims"]),
            latent_dim=meta["latent_dim"], dropout=meta["dropout"])
    # the compute dtype the bundle was trained with (tpuvae/infer.py:164)
    dtype = compute_dtype(meta.get("compute_dtype", "float32"))
    if arch == "hybrid":
        return HybridVAE(latent_dim=meta["latent_dim"],
                         text_dim=meta["text_dim"],
                         input_hw=tuple(meta["input_hw"]), dtype=dtype)
    return ConditionalVAE(latent_dim=meta["latent_dim"],
                          text_dim=meta["text_dim"],
                          num_classes=meta["num_classes"],
                          input_hw=tuple(meta["input_hw"]), dtype=dtype)


@dataclasses.dataclass
class ClipEncoder:
    """A trained model + its preprocessing state, ready to encode new clips."""

    arch: str
    meta: dict
    model: torch.nn.Module          # in eval mode on ``device``
    pre_cfg: object                 # Preprocess(Advanced)Config of training
    centers: np.ndarray | None
    normalizers: dict               # name -> fitted normalizer (_NORMALIZERS)
    device: torch.device
    tuning_route: str = "fused"
    embed_backend: str | None = None

    # -- construction ------------------------------------------------------

    @classmethod
    def load(cls, arch: str, results_dir: str = "results",
             data_dir: str | None = None, device: str = "cuda",
             tuning_route: str = "fused") -> "ClipEncoder":
        """Load the serving bundle written by a training pipeline.

        ``data_dir`` defaults to the preprocessing dir recorded in the
        bundle's metadata, then to the architecture's conventional one
        (``processed_data1`` / ``processed_data2``).  ``device`` defaults
        to CUDA and raises without a card; pass ``device='cpu'`` to run the
        kernels' plain versions.
        """
        if arch not in _ARCH_DIRS:
            raise ValueError(f"arch must be one of {sorted(_ARCH_DIRS)}, "
                             f"got {arch!r}")
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
        embed_backend = cfg_dict.pop("lyrics_embedder_backend", None)
        cfg_cls = PreprocessConfig if arch == "simple" else AdvancedPreprocessConfig
        model = _build_model(arch, meta)
        model.load_state_dict(from_flax(flat))
        model.to(dev).eval()
        return cls(arch=arch, meta=meta, model=model,
                   pre_cfg=cfg_cls.from_dict(cfg_dict), centers=centers,
                   normalizers={name: load_normalizer(data / f"{name}.pkl")
                                for name in _NORMALIZERS[arch]},
                   device=dev, tuning_route=tuning_route,
                   embed_backend=embed_backend)

    # -- encoding ----------------------------------------------------------

    def extract(self, waveforms: np.ndarray) -> torch.Tensor:
        """Raw features of one device batch ``(B, num_samples)``: the 370-d
        vector (``simple``) or the mel-dB image (``cvae`` / ``hybrid``,
        through the bundle's recorded ``stft_method``)."""
        if self.arch == "simple":
            fn = make_extractor(extract_basic_features, self.pre_cfg,
                                self.device, tuning_route=self.tuning_route)
        else:
            fn = make_extractor(extract_mel_image, self.pre_cfg, self.device)
        return fn(waveforms)

    def normalize(self, raw: np.ndarray) -> np.ndarray:
        """Raw features -> model input: imputer + scaler (``simple``), or
        the per-pixel mel scaler over the flattened image plus a channel
        axis (NHWC)."""
        if self.arch == "simple":
            return self.normalizers["scaler"].transform(
                self.normalizers["imputer"].transform(raw)).astype(np.float32)
        n = raw.shape[0]
        flat = self.normalizers["mel_scaler"].transform(raw.reshape(n, -1))
        return flat.reshape(raw.shape).astype(np.float32)[..., None]

    def apply_latent(self, *inputs: np.ndarray) -> torch.Tensor:
        """Encoder means of one batch of model inputs, in float32: a
        bfloat16 bundle's are widened exactly (``tpuvae/infer.py:283``)."""
        with torch.no_grad():
            return self.model.latent(
                *(torch.as_tensor(a).to(self.device) for a in inputs)).float()

    def _embed_texts(self, lyrics, n: int) -> np.ndarray:
        if lyrics is None:
            lyrics = [" "] * n          # ref coerces empty lyrics to ' '
        if len(lyrics) != n:
            raise ValueError(f"got {len(lyrics)} lyrics for {n} clips")
        emb, backend = embed_lyrics(list(lyrics), device=self.device)
        if self.embed_backend and backend != self.embed_backend:
            warnings.warn(
                f"lyrics embedder backend {backend!r} differs from the one "
                f"used at training time ({self.embed_backend!r}) — latents "
                f"will not be comparable (set TPUVAE_TEXT_CHECKPOINT to "
                f"match)", stacklevel=3)
        return emb.astype(np.float32)

    def _condition(self, genres, n: int) -> np.ndarray:
        names = list(self.meta.get("genre_names", []))
        cond = np.zeros((n, self.meta["num_classes"]), np.float32)
        if genres is None:
            return cond                 # marginal (all-zero) condition
        for i, g in enumerate(genres):
            if g is not None:
                cond[i, names.index(g)] = 1.0
        return cond

    def validate_args(self, n: int, lyrics=None, genres=None) -> None:
        """Raise the errors :meth:`encode_waveforms` would, without touching
        the device — lets batching layers reject one bad request up-front
        instead of failing a whole merged batch."""
        if self.arch == "simple" and (lyrics is not None or genres is not None):
            raise ValueError("the simple arch uses neither lyrics nor genres"
                             " — they would be silently dropped")
        if self.arch == "hybrid" and genres is not None:
            raise ValueError("the hybrid arch is unconditioned — genres "
                             "would be silently dropped (use arch='cvae')")
        if lyrics is not None and len(lyrics) != n:
            raise ValueError(f"got {len(lyrics)} lyrics for {n} clips")
        if genres is not None:
            if len(genres) != n:
                raise ValueError(f"got {len(genres)} genres for {n} clips")
            names = list(self.meta.get("genre_names", []))
            for g in genres:
                if g is not None and g not in names:
                    raise ValueError(f"unknown genre {g!r}; training genres: "
                                     f"{names}")

    def encode_waveforms(self, waveforms: np.ndarray, lyrics=None,
                         genres=None, batch_size: int = 32) -> EncodeResult:
        """Encode pre-loaded ``(N, num_samples)`` float32 waveforms: the
        extraction and the encoder each in device batches of
        ``batch_size``."""
        n = waveforms.shape[0]
        self.validate_args(n, lyrics=lyrics, genres=genres)
        waveforms = np.asarray(waveforms, np.float32)
        raw = batched_apply(self.extract, (waveforms,), batch_size)
        inputs = (self.normalize(raw),)
        if self.arch != "simple":
            inputs += (self._embed_texts(lyrics, n),)
            if self.arch == "cvae":
                if genres is None:
                    warnings.warn(
                        "cvae encoding without genres uses an all-zero "
                        "condition the model never saw in training — "
                        "cluster assignments may be unreliable; pass "
                        "genres= for in-distribution latents", stacklevel=2)
                inputs += (self._condition(genres, n),)
        mu = batched_apply(self.apply_latent, inputs,
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
