"""Report plots: the reference's PNG set (counterpart of
``tpuvae/viz/plots.py``), with the same figure sizes, titles, colormaps
and destination paths, drawn with matplotlib's ``Agg`` backend:

  * Simple: t-SNE by cluster and by language (``Simple_VAE.py:299-323``);
  * CVAE: reconstruction pair, t-SNE by genre, cluster x language stacked
    bar (``Conditional_VAE.py:491-549``);
  * Hybrid: loss curve, t-SNE triptych cluster / language / true genre
    (``Convolutional_VAE.py:273-280,461-493``).

matplotlib is imported by :func:`pyplot`, never when this module is: the
pipelines call it before training when ``make_plots=True``, so a machine
without matplotlib refuses the run in its first second.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd


def pyplot():
    """``matplotlib.pyplot`` on the ``Agg`` backend; an ``ImportError``
    naming matplotlib when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the plots need matplotlib, which is not installed; install it "
            "or pass make_plots=False") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(plt, fig, out_path) -> Path:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)
    return out_path


def tsne_cluster_language(tsne_xy, clusters, languages, best_k, out_path) -> Path:
    plt = pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(15, 6))
    sc1 = axes[0].scatter(tsne_xy[:, 0], tsne_xy[:, 1], c=clusters,
                          cmap="viridis", alpha=0.6)
    axes[0].set_title(f"t-SNE of VAE Features (Clusters K={best_k})")
    axes[0].set_xlabel("t-SNE 1")
    axes[0].set_ylabel("t-SNE 2")
    plt.colorbar(sc1, ax=axes[0], label="Cluster")
    lang_codes = pd.Series(languages).map({"bn": 0, "en": 1}).values
    sc2 = axes[1].scatter(tsne_xy[:, 0], tsne_xy[:, 1], c=lang_codes,
                          cmap="coolwarm", alpha=0.6)
    axes[1].set_title("t-SNE of VAE Features (Multilingual)")
    axes[1].set_xlabel("t-SNE 1")
    axes[1].set_ylabel("t-SNE 2")
    cbar = plt.colorbar(sc2, ax=axes[1], ticks=[0, 1])
    cbar.ax.set_yticklabels(["Bangla", "English"])
    plt.tight_layout()
    return _save(plt, fig, out_path)


def reconstruction_pair(original, reconstruction, out_path,
                        title="CVAE Reconstruction") -> Path:
    plt = pyplot()
    fig = plt.figure(figsize=(12, 4))
    plt.subplot(1, 2, 1)
    plt.imshow(np.asarray(original), aspect="auto", origin="lower",
               cmap="viridis")
    plt.title("Original Mel Spectrogram")
    plt.colorbar()
    plt.subplot(1, 2, 2)
    plt.imshow(np.asarray(reconstruction), aspect="auto", origin="lower",
               cmap="viridis")
    plt.title(title)
    plt.colorbar()
    plt.tight_layout()
    return _save(plt, fig, out_path)


def tsne_by_genre(tsne_xy, genre_codes, genre_names, out_path) -> Path:
    plt = pyplot()
    fig = plt.figure(figsize=(10, 8))
    sc = plt.scatter(tsne_xy[:, 0], tsne_xy[:, 1], c=genre_codes,
                     cmap="tab10", alpha=0.6, s=15)
    plt.legend(handles=sc.legend_elements()[0], labels=list(genre_names),
               title="Genre")
    plt.title("CVAE Latent Space (t-SNE) by Genre")
    return _save(plt, fig, out_path)


def cluster_language_bar(cluster_labels, lang_codes, lang_names,
                         out_path) -> Path:
    plt = pyplot()
    ct = pd.crosstab(pd.Series(cluster_labels, name="Cluster"),
                     pd.Series(lang_codes, name="Language"))
    ct.columns = [lang_names[i] for i in ct.columns]
    ax = ct.plot(kind="bar", stacked=True, figsize=(10, 6), colormap="viridis")
    ax.set_title("Cluster Distribution by Language")
    ax.set_xlabel("Cluster ID")
    ax.set_ylabel("Count")
    plt.tight_layout()
    return _save(plt, "all", out_path)


def loss_curve(train_losses, out_path, title="Training Loss") -> Path:
    plt = pyplot()
    fig = plt.figure(figsize=(10, 5))
    plt.plot(train_losses)
    plt.title(title)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    return _save(plt, fig, out_path)


def tsne_triptych(tsne_xy, main_labels, lang_labels, true_labels, best_k,
                  out_path) -> Path:
    plt = pyplot()
    fig = plt.figure(figsize=(18, 5))
    plt.subplot(1, 3, 1)
    plt.scatter(tsne_xy[:, 0], tsne_xy[:, 1], c=main_labels, cmap="viridis",
                alpha=0.6, s=10)
    plt.title(f"Latent Space (Main K-Means, k={best_k})")
    plt.colorbar(label="Cluster ID")
    plt.subplot(1, 3, 2)
    plt.scatter(tsne_xy[:, 0], tsne_xy[:, 1], c=lang_labels, cmap="coolwarm",
                alpha=0.6, s=10)
    plt.title("Latent Space (Language Clusters, k=2)")
    plt.colorbar(label="Cluster ID")
    plt.subplot(1, 3, 3)
    if true_labels is not None:
        plt.scatter(tsne_xy[:, 0], tsne_xy[:, 1], c=true_labels, cmap="jet",
                    alpha=0.6, s=10)
        plt.title("Latent Space (True Genres)")
        plt.colorbar(label="Genre ID")
    else:
        plt.text(0.5, 0.5, "No True Labels Available", ha="center")
        plt.title("Latent Space (True Genres)")
    plt.tight_layout()
    return _save(plt, fig, out_path)
