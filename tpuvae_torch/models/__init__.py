"""Model families as ``nn.Module``s (counterpart of ``tpuvae.models``)."""

from tpuvae_torch.models.layers import MLPBlock  # noqa: F401
from tpuvae_torch.models.simple_vae import (  # noqa: F401
    SimpleVAE,
    simple_vae_loss,
)
