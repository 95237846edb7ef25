"""Dataset catalog: directory walk + metadata join + filters (own copy of
``tpuvae/io/catalog.py``).

Capability match of the reference's two collectors:
  * basic (``1_preprocessing.py:166-216``): per-genre cap, keep files whose
    id appears in the metadata;
  * strict (``1_preprocessing_advanced.py:191-267``): additionally exclude
    the configured genres (jazz) and tracks with missing/trivial/short
    lyrics, with per-reason skip tallies.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import pandas as pd

LANG_DIRS = (("Bangla_Datasets", "bn"), ("English_Datasets", "en"))
TRIVIAL_LYRICS = {"nan", "none", "null", "instrumental", "", " "}


@dataclasses.dataclass
class AudioEntry:
    path: str
    language: str
    genre: str
    filename: str
    file_id: str
    lyrics: str = ""


def load_metadata(metadata_csv: str | Path):
    df = pd.read_csv(metadata_csv)
    genre_lookup = dict(zip(df["ID"].astype(str), df["genre"]))
    lyrics_lookup = (
        dict(zip(df["ID"].astype(str), df["lyrics"].fillna("")))
        if "lyrics" in df.columns
        else {}
    )
    return genre_lookup, lyrics_lookup


def collect_audio_files(
    dataset_root: str | Path,
    metadata_csv: str | Path,
    *,
    max_per_class: int = 160,
    strict: bool = False,
    exclude_genres: tuple = ("jazz",),
    min_lyrics_chars: int = 15,
) -> tuple[list[AudioEntry], dict[str, int]]:
    """Walk <root>/{Bangla,English}_Datasets/<genre>/*.wav with metadata join.

    ``strict=True`` applies the advanced pipeline's jazz/lyrics filters.
    Returns (entries, skip_tallies).
    """
    root = Path(dataset_root)
    genre_lookup, lyrics_lookup = load_metadata(metadata_csv)
    skipped = {
        "not_in_metadata": 0,
        "jazz_excluded": 0,
        "empty_lyrics": 0,
        "short_lyrics": 0,
    }
    entries: list[AudioEntry] = []
    excl = {g.strip().lower() for g in exclude_genres}

    for dirname, lang in LANG_DIRS:
        base = root / dirname
        if not base.exists():
            continue
        for genre_folder in sorted(os.listdir(base)):
            genre_path = base / genre_folder
            if not genre_path.is_dir():
                continue
            files = sorted(f for f in os.listdir(genre_path)
                           if f.endswith((".wav", ".flac")))
            for audio_file in files[:max_per_class]:
                file_id = os.path.splitext(audio_file)[0]
                if file_id not in genre_lookup:
                    skipped["not_in_metadata"] += 1
                    continue
                genre = genre_lookup[file_id]
                lyrics = lyrics_lookup.get(file_id, "")
                if strict:
                    if str(genre).strip().lower() in excl:
                        skipped["jazz_excluded"] += 1
                        continue
                    if not isinstance(lyrics, str):
                        skipped["empty_lyrics"] += 1
                        continue
                    clean = lyrics.strip()
                    if clean.lower() in TRIVIAL_LYRICS:
                        skipped["empty_lyrics"] += 1
                        continue
                    if len(clean) < min_lyrics_chars:
                        skipped["short_lyrics"] += 1
                        continue
                entries.append(
                    AudioEntry(
                        path=str(genre_path / audio_file),
                        language=lang,
                        genre=genre,
                        filename=audio_file,
                        file_id=file_id,
                        lyrics=lyrics if isinstance(lyrics, str) else "",
                    )
                )
    return entries, skipped
