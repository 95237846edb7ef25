"""Clustering (counterpart of ``tpuvae.cluster``): k-means, Ward
agglomerative, DBSCAN, spectral clustering, PCA and the three sweeps of the
reference."""

from tpuvae_torch.cluster.kmeans import (  # noqa: F401
    KMeansResult,
    centers_from_labels,
    kmeans,
)
from tpuvae_torch.cluster.agglomerative import (  # noqa: F401
    agglomerative,
    ward_linkage,
    cut_tree,
)
from tpuvae_torch.cluster.dbscan import dbscan  # noqa: F401
from tpuvae_torch.cluster.pca import pca_fit, pca_transform, PCAResult  # noqa: F401
from tpuvae_torch.cluster.sweeps import (  # noqa: F401
    SweepResult,
    kmeans_k_sweep,
    agglomerative_k_sweep,
    dbscan_eps_sweep,
)
from tpuvae_torch.cluster.spectral import (  # noqa: F401
    spectral_clustering,
    spectral_embedding,
)
