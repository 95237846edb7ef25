"""PCA: the centred Gram on the device in fp32, the eigendecomposition on
the host in float64 (counterpart of ``tpuvae/cluster/pca.py``).

Component signs follow sklearn's svd_flip convention (largest-|loading|
coordinate positive) so projected coordinates match sklearn's up to fp
noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PCAResult:
    components: np.ndarray        # (k, D)
    mean: np.ndarray              # (D,)
    explained_variance: np.ndarray

    def transform(self, x) -> torch.Tensor:
        """Project ``x`` where it lies -> (N, k) fp32 tensor."""
        x = torch.as_tensor(x, dtype=torch.float32)
        mean = torch.from_numpy(self.mean).to(x.device)
        comps = torch.from_numpy(self.components).to(x.device)
        return torch.matmul(x - mean, comps.T)


def pca_fit(x, n_components: int) -> PCAResult:
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[0]
    mean = x.mean(dim=0)
    xc = x - mean
    gram = torch.matmul(xc.T, xc).cpu().numpy().astype(np.float64)
    evals, evecs = np.linalg.eigh(gram)                # ascending
    order = np.argsort(evals)[::-1][:n_components]
    comps = evecs[:, order].T                          # (k, D)
    # svd_flip sign convention: max-|value| entry of each component positive
    signs = np.sign(comps[np.arange(len(order)), np.argmax(np.abs(comps), axis=1)])
    comps = comps * signs[:, None]
    return PCAResult(
        components=comps.astype(np.float32),
        mean=mean.cpu().numpy(),
        explained_variance=(evals[order] / max(n - 1, 1)).astype(np.float32),
    )


def pca_transform(x, n_components: int) -> torch.Tensor:
    """fit_transform convenience (the reference always fit+transforms)."""
    return pca_fit(x, n_components).transform(x)
