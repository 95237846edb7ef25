"""t-SNE, the report plots and the EDA report (counterpart of
``tpuvae/viz``).  Importing this package imports no matplotlib: the figure
functions import it when they draw."""

from tpuvae_torch.viz.tsne import tsne  # noqa: F401
from tpuvae_torch.viz.plots import (  # noqa: F401
    cluster_language_bar,
    loss_curve,
    reconstruction_pair,
    tsne_by_genre,
    tsne_cluster_language,
    tsne_triptych,
)
