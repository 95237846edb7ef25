"""Model families as ``nn.Module``s (counterpart of ``tpuvae.models``)."""

from tpuvae_torch.models.autoencoder import (  # noqa: F401
    SimpleAutoencoder,
    ae_loss,
)
from tpuvae_torch.models.cond_vae import ConditionalVAE, cvae_loss  # noqa: F401
from tpuvae_torch.models.hybrid_vae import HybridVAE, hybrid_loss  # noqa: F401
from tpuvae_torch.models.layers import (  # noqa: F401
    ConvDecoderTrunk,
    ConvEncoderTrunk,
    MLPBlock,
    Stride2Conv,
    Stride2ConvTranspose,
    reparameterize,
)
from tpuvae_torch.models.simple_vae import (  # noqa: F401
    SimpleVAE,
    simple_vae_loss,
)
