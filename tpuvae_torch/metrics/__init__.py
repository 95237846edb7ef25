"""Clustering metrics (counterpart of ``tpuvae.metrics``): labels, the
pairwise distances of kernel 5, the internal and external quality
scores, and the row-sharded silhouette over a mesh."""

from tpuvae_torch.metrics.pairwise import (  # noqa: F401
    squared_distances,
    distances,
    self_distances,
)
from tpuvae_torch.metrics.internal import (  # noqa: F401
    silhouette_score,
    silhouette_from_distances,
    davies_bouldin_score,
    calinski_harabasz_score,
)
from tpuvae_torch.metrics.external import (  # noqa: F401
    contingency,
    purity_score,
    adjusted_rand_score,
    normalized_mutual_info,
)
from tpuvae_torch.metrics.labels import compact_labels, encode_labels, one_hot_np  # noqa: F401
from tpuvae_torch.metrics.distributed import silhouette_sharded  # noqa: F401
