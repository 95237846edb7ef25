"""Spectral clustering (RBF affinity -> normalized Laplacian -> k-means)
(counterpart of ``tpuvae/cluster/spectral.py``).

The reference README promises Spectral Clustering but its code never
implements it; this is the sklearn-compatible algorithm the JAX package
provides.  The squared distances come from kernel 5 on the card and the
RBF affinity is taken where ``x`` lies; the normalized Laplacian, its
eigendecomposition, the ``d^-1/2`` scaling and sklearn's sign flip run on
the host in float64; then the port's k-means, where ``x`` lies.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvae_torch.cluster.kmeans import kmeans
from tpuvae_torch.metrics.pairwise import squared_distances


def spectral_embedding(x, n_components: int, *,
                       gamma: float | None = None) -> np.ndarray:
    """Rows of the diffusion-scaled eigenvectors of the normalized Laplacian."""
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    if gamma is None:
        gamma = 1.0 / x.shape[1]     # sklearn default for rbf affinity
    d2 = squared_distances(x, x)
    affinity = torch.exp(-gamma * d2).cpu().numpy().astype(np.float64)

    deg = affinity.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = -(affinity * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :]
    np.fill_diagonal(lap, 1.0 + lap.diagonal())     # L_sym = I - D^-1/2 A D^-1/2

    _, evecs = np.linalg.eigh(lap)
    u = evecs[:, :n_components]                     # smallest eigenvalues
    embedding = u * d_inv_sqrt[:, None]             # random-walk vectors
    # deterministic sign convention (sklearn _deterministic_vector_sign_flip)
    signs = np.sign(embedding[np.argmax(np.abs(embedding), axis=0),
                              np.arange(n_components)])
    signs[signs == 0] = 1.0
    return (embedding * signs[None, :]).astype(np.float32)


def spectral_clustering(x, n_clusters: int, *, gamma: float | None = None,
                        n_init: int = 10, seed: int = 42) -> np.ndarray:
    x = torch.as_tensor(x, dtype=torch.float32)
    emb = spectral_embedding(x, n_clusters, gamma=gamma)
    return kmeans(torch.from_numpy(emb).to(x.device), n_clusters,
                  n_init=n_init, seed=seed).labels
