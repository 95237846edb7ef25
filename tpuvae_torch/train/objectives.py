"""Loss adapters binding a model family to the generic ``fit`` loop
(counterpart of ``tpuvae/train/objectives.py``).

Each returns ``loss_fn(model, batch, generator, train) -> (loss, aux)``.
``fit`` sets ``model.train()`` / ``model.eval()``; the dropout masks and
the reparameterisation noise come from ``generator``.
"""

from __future__ import annotations

from tpuvae_torch.models import simple_vae_loss


def simple_vae_objective(beta: float = 0.8):
    def loss_fn(model, batch, generator, train):
        (x,) = batch
        recon, mu, logvar, _ = model(x, generator=generator)
        loss, rec, kl = simple_vae_loss(recon, x, mu, logvar, beta)
        return loss, {"recon": rec, "kl": kl}

    return loss_fn
