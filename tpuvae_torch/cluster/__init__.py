"""Clustering (counterpart of ``tpuvae.cluster``): k-means, the k-sweep
and PCA.  The agglomerative and DBSCAN sweeps come with the clustering
slice (ROADMAP.md, queue 1, item 6)."""
