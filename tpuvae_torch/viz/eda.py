"""Exploratory data analysis report (counterpart of ``tpuvae/viz/eda.py``).

The figure set of ``notebooks/exploratory.ipynb`` from a ``processed_data2``
directory, as PNGs plus a text summary:

  * genre and language distributions (bar charts);
  * sample mel-spectrogram previews, one per genre (up to 6);
  * t-SNE of the raw 290-d audio features beside the lyric embeddings,
    both on the device (two runs of :func:`tpuvae_torch.viz.tsne.tsne`);
  * the feature correlation heatmap (flat 290-d features, ``np.corrcoef``
    on the host);
  * a ``describe()`` table of the features (CSV).

Exposed as ``python -m tpuvae_torch.cli eda``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
import torch

from tpuvae_torch.device import resolve_device
from tpuvae_torch.io.artifacts import load_advanced
from tpuvae_torch.viz.plots import pyplot
from tpuvae_torch.viz.tsne import tsne


def run_eda(data_dir: str = "processed_data2", out_dir: str = "results/EDA",
            tsne_perplexity: float = 30.0, seed: int = 42,
            device: str | torch.device = "cuda") -> dict:
    """Write the five EDA outputs under ``out_dir`` and return the summary
    dict (clip count, array shapes, genre and language counts).  The
    t-SNEs run on ``device`` (CUDA by default; raises without a card)."""
    dev = resolve_device(device)
    plt = pyplot()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    data = load_advanced(data_dir)
    mel = np.asarray(data["mel"])
    flat = np.asarray(data["handcrafted"])
    text = np.asarray(data["text"])
    meta = data["metadata"]

    # 1. class / language distributions
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    meta["genre"].value_counts().plot(kind="bar", ax=axes[0], color="steelblue")
    axes[0].set_title("Genre distribution")
    axes[0].set_ylabel("clips")
    meta["language"].value_counts().plot(kind="bar", ax=axes[1],
                                         color="indianred")
    axes[1].set_title("Language distribution")
    plt.tight_layout()
    plt.savefig(out / "distributions.png")
    plt.close(fig)

    # 2. sample spectrograms (one per genre, up to 6)
    genres = list(meta["genre"].unique())[:6]
    fig, axes = plt.subplots(1, max(len(genres), 1),
                             figsize=(4 * len(genres), 4))
    axes = np.atleast_1d(axes)
    for ax, g in zip(axes, genres):
        idx = meta.index[meta["genre"] == g][0]
        ax.imshow(mel[idx], aspect="auto", origin="lower", cmap="viridis")
        ax.set_title(str(g))
    plt.tight_layout()
    plt.savefig(out / "sample_spectrograms.png")
    plt.close(fig)

    # 3. t-SNE of raw audio features vs lyric embeddings
    genre_codes = pd.factorize(meta["genre"])[0]
    xy_audio = tsne(flat, perplexity=tsne_perplexity, seed=seed, device=dev)
    xy_text = tsne(text, perplexity=tsne_perplexity, seed=seed, device=dev)
    fig, axes = plt.subplots(1, 2, figsize=(15, 6))
    for ax, xy, title in (
        (axes[0], xy_audio, "t-SNE of raw audio features"),
        (axes[1], xy_text, "t-SNE of lyric embeddings"),
    ):
        sc = ax.scatter(xy[:, 0], xy[:, 1], c=genre_codes, cmap="tab10",
                        alpha=0.6, s=15)
        ax.set_title(title)
    plt.colorbar(sc, ax=axes[1], label="genre id")
    plt.tight_layout()
    plt.savefig(out / "tsne_raw_features.png")
    plt.close(fig)

    # 4. feature correlation heatmap
    corr = np.corrcoef(flat.T)
    fig = plt.figure(figsize=(8, 7))
    plt.imshow(corr, cmap="coolwarm", vmin=-1, vmax=1)
    plt.colorbar(label="Pearson r")
    plt.title(f"Feature correlation ({flat.shape[1]}×{flat.shape[1]})")
    plt.tight_layout()
    plt.savefig(out / "feature_correlation.png")
    plt.close(fig)

    # 5. describe() summary
    pd.DataFrame(flat).describe().T.to_csv(out / "feature_summary.csv")

    return {
        "n_clips": int(len(meta)),
        "mel_shape": list(mel.shape),
        "flat_shape": list(flat.shape),
        "text_shape": list(text.shape),
        "genres": {str(k): int(v) for k, v in
                   meta["genre"].value_counts().items()},
        "languages": {str(k): int(v) for k, v in
                      meta["language"].value_counts().items()},
    }
