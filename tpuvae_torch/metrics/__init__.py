"""Clustering metrics (counterpart of ``tpuvae.metrics``): labels, the
pairwise distances of kernel 5, and the internal quality scores."""
