"""Streaming (host-RAM-bounded) assembly of the advanced artifact set
(own copy of ``tpuvae/io/assembly.py``).

The reference materializes the full ``(N, 128, 1024)`` mel tensor in RAM to
fit its per-pixel StandardScaler and save the ``.npy`` artifacts
(``1_preprocessing_advanced.py:369-421``) — ~0.7 GB at the reference N=1336,
but unusable at production dataset sizes.  Here the extraction shards already
persisted by :class:`tpuvae_torch.io.resume.ExtractionManifest` are streamed
straight into ``np.lib.format.open_memmap`` files:

  pass 1: shards → ``mel_spectrograms_raw.npy`` (memmap, filled in manifest
          order) while a float64 :class:`StreamingScalerFit` accumulates the
          per-pixel mean/var and the small flat vectors collect in RAM;
  pass 2: raw memmap → ``mel_spectrograms_normalized.npy`` chunk by chunk.

Peak host memory is one shard plus one chunk, independent of N.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpuvae_torch.io.normalize import StandardScaler, StreamingScalerFit


def assemble_advanced_streaming(
    manifest,
    out_dir: str | Path,
    mel_hw: tuple[int, int],
    flat_dim: int,
    chunk_rows: int = 128,
) -> tuple[list[str], np.ndarray, StandardScaler]:
    """Stream manifest shards into the two mel ``.npy`` artifacts.

    Returns ``(file_ids, flats, mel_scaler)`` — everything the rest of the
    advanced pipeline needs; the two big arrays are already on disk.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = manifest.total_rows()
    if not n:
        raise ValueError("streaming assembly on an empty manifest")
    h, w = mel_hw

    raw = np.lib.format.open_memmap(
        out / "mel_spectrograms_raw.npy", mode="w+",
        dtype=np.float32, shape=(n, h, w),
    )
    fit = StreamingScalerFit()
    ids: list[str] = []
    flat_parts: list[np.ndarray] = []
    row = 0
    for shard_ids, arrays in manifest.iter_shards():
        mel = np.asarray(arrays["mel"], np.float32)
        if mel.shape[1:] != (h, w):
            raise ValueError(
                f"shard mel shape {mel.shape[1:]} != configured {(h, w)}; "
                f"config changed between runs? delete {manifest.dir}"
            )
        raw[row : row + len(mel)] = mel
        fit.update(mel)
        flat_parts.append(np.asarray(arrays["flat"], np.float32))
        ids.extend(shard_ids)
        row += len(mel)
    assert row == n, (row, n)
    raw.flush()
    scaler = fit.finalize()

    norm = np.lib.format.open_memmap(
        out / "mel_spectrograms_normalized.npy", mode="w+",
        dtype=np.float32, shape=(n, h, w),
    )
    mean = scaler.mean.reshape(h, w)
    scale = scaler.scale.reshape(h, w)
    for i in range(0, n, chunk_rows):
        norm[i : i + chunk_rows] = (raw[i : i + chunk_rows] - mean) / scale
    norm.flush()
    del raw, norm

    flats = (np.concatenate(flat_parts) if flat_parts
             else np.zeros((0, flat_dim), np.float32))
    return ids, flats, scaler
