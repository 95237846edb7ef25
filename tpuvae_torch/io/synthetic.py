"""Synthetic dataset generator — reference-layout datasets for tests and
chip runs (own copy of ``tpuvae/io/synthetic.py``: the same numpy
arithmetic from the same seed, so both packages write byte-identical WAV
and FLAC files and the same metadata CSV).

The reference's Bangla+English WAV corpus is not distributable; this module
fabricates a corpus with the same on-disk layout
(``Datasets/{Bangla_Datasets,English_Datasets}/<genre>/<id>.wav`` +
``updated_metadata.csv`` with ID/genre/lyrics columns,
ref ``1_preprocessing.py:31-34``) whose genres have distinct spectral
signatures (base pitch, harmonic stack, noise floor, AM rate) so the
VAE→cluster pipeline has real structure to find.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import pandas as pd

GENRE_PROFILES = {
    # name: (base_hz, n_harmonics, noise, am_rate_hz)
    "rock":      (110.0, 8, 0.30, 4.0),
    "classical": (262.0, 5, 0.05, 0.5),
    "pop":       (440.0, 3, 0.15, 2.0),
    "folk":      (196.0, 4, 0.10, 1.0),
    "metal":     (82.0, 12, 0.45, 8.0),
}

LYRICS_BANK = {
    "bn": "amar sonar bangla ami tomay bhalobashi chirodin tomar akash tomar batash",
    "en": "the road goes ever on and on down from the door where it began",
}

# cross-genre mean profile (arithmetic; pitch handled geometrically below):
# the target every profile collapses onto as ``separation`` → 0
_MEAN_PROFILE = tuple(
    float(np.mean([p[i] for p in GENRE_PROFILES.values()]))
    for i in range(4)
)


def _blend_profile(genre: str, separation: float):
    """Interpolate a genre's spectral signature toward the cross-genre mean.

    ``separation=1`` is the unmodified profile (the default corpus);
    ``separation=0`` makes every genre identical.  Pitch blends in the log
    domain (perceptual), the rest linearly: a harder clustering problem
    than the default corpus.
    """
    base, n_harm, noise, am = GENRE_PROFILES[genre]
    if separation == 1.0:
        return base, n_harm, noise, am
    mb, mh, mn, ma = _MEAN_PROFILE
    base = float(mb * (base / mb) ** separation)
    n_harm = max(1, round(n_harm * separation + mh * (1.0 - separation)))
    noise = noise * separation + mn * (1.0 - separation)
    am = am * separation + ma * (1.0 - separation)
    return base, n_harm, noise, am


def synth_clip(
    genre: str, rng: np.random.Generator, sr: int = 22050,
    duration: float = 30.0, separation: float = 1.0,
) -> np.ndarray:
    base, n_harm, noise, am = _blend_profile(genre, separation)
    t = np.arange(int(sr * duration)) / sr
    f0 = base * 2 ** (rng.integers(-2, 3) / 12.0)   # random transposition
    y = np.zeros_like(t, dtype=np.float64)
    for h in range(1, n_harm + 1):
        y += rng.uniform(0.3, 1.0) / h * np.sin(
            2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)
        )
    y *= 0.5 + 0.5 * np.sin(2 * np.pi * am * t)      # amplitude modulation
    y += noise * rng.standard_normal(len(t))
    y /= max(np.abs(y).max(), 1e-9)
    return (0.7 * y).astype(np.float32)


def write_wav(path: str | Path, y: np.ndarray, sr: int) -> None:
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    data = b"data" + struct.pack("<I", len(pcm))
    Path(path).write_bytes(hdr + fmt + data + pcm)


def generate_dataset(
    root: str | Path,
    *,
    clips_per_genre_lang: int = 4,
    genres: tuple = ("rock", "classical", "pop"),
    sr: int = 22050,
    duration: float = 30.0,
    seed: int = 42,
    include_lyricless: bool = True,
    include_jazz: bool = False,
    container: str = "wav",
    separation: float = 1.0,
) -> Path:
    """Write a reference-layout synthetic corpus; returns metadata csv path.

    ``container`` ∈ {'wav', 'flac', 'mixed'} — 'mixed' alternates per clip,
    exercising the loader's magic-byte dispatch across a whole pipeline run.
    ``separation`` < 1 blends genre signatures toward their mean (harder
    clustering problem; see :func:`_blend_profile`).
    """
    if container not in ("wav", "flac", "mixed"):
        raise ValueError(f"unknown container {container!r}")
    root = Path(root)
    rng = np.random.default_rng(seed)
    rows = []
    idx = 0
    all_genres = genres + (("jazz",) if include_jazz else ())
    for dirname, lang in (("Bangla_Datasets", "bn"), ("English_Datasets", "en")):
        for genre in all_genres:
            gdir = root / dirname / genre
            gdir.mkdir(parents=True, exist_ok=True)
            for i in range(clips_per_genre_lang):
                file_id = f"{lang}_{genre}_{idx:04d}"
                idx += 1
                y = synth_clip(genre if genre != "jazz" else "classical",
                               rng, sr, duration, separation=separation)
                as_flac = container == "flac" or (
                    container == "mixed" and idx % 2 == 0)
                if as_flac:
                    from tpuvae_torch.io.flac import write_flac

                    pcm = np.clip(np.round(y * 32767.0), -32768,
                                  32767).astype(np.int64)
                    write_flac(gdir / f"{file_id}.flac", pcm, sr, 16)
                else:
                    write_wav(gdir / f"{file_id}.wav", y, sr)
                lyrics = LYRICS_BANK[lang] + f" verse {i}"
                if include_lyricless and i == clips_per_genre_lang - 1:
                    lyrics = "instrumental"      # filtered by the strict catalog
                rows.append({"ID": file_id, "genre": genre, "lyrics": lyrics})
    meta = root / "updated_metadata.csv"
    pd.DataFrame(rows).to_csv(meta, index=False)
    return meta


def generate_memory_batch(
    n_per_genre: int,
    genres: tuple = ("rock", "classical", "pop"),
    sr: int = 22050,
    duration: float = 30.0,
    seed: int = 42,
):
    """In-memory (waveforms, genre labels) batch — no disk IO."""
    rng = np.random.default_rng(seed)
    clips, labels = [], []
    for genre in genres:
        for _ in range(n_per_genre):
            clips.append(synth_clip(genre, rng, sr, duration))
            labels.append(genre)
    return np.stack(clips), np.array(labels)
