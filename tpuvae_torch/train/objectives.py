"""Loss adapters binding a model family to the generic ``fit`` loop
(counterpart of ``tpuvae/train/objectives.py``).

Each returns ``loss_fn(model, batch, generator, train) -> (loss, aux)``.
``fit`` sets ``model.train()`` / ``model.eval()``; the dropout masks and
the reparameterisation noise come from ``generator``.
"""

from __future__ import annotations

from tpuvae_torch.models import ae_loss, cvae_loss, hybrid_loss, simple_vae_loss


def simple_vae_objective(beta: float = 0.8):
    def loss_fn(model, batch, generator, train):
        (x,) = batch
        recon, mu, logvar, _ = model(x, generator=generator)
        loss, rec, kl = simple_vae_loss(recon, x, mu, logvar, beta)
        return loss, {"recon": rec, "kl": kl}

    return loss_fn


def cvae_objective(beta: float = 4.0, text_weight: float = 200.0):
    def loss_fn(model, batch, generator, train):
        audio, text, cond = batch
        ra, rt, mu, logvar = model(audio, text, cond, generator=generator)
        loss, ma, mt, kl = cvae_loss(ra, audio, rt, text, mu, logvar, beta,
                                     text_weight)
        return loss, {"mse_audio": ma, "mse_text": mt, "kl": kl}

    return loss_fn


def hybrid_objective(beta: float = 1.0, text_weight: float = 350.0):
    def loss_fn(model, batch, generator, train):
        audio, text = batch
        ra, rt, mu, logvar = model(audio, text, generator=generator)
        loss, ma, mt, kl = hybrid_loss(ra, audio, rt, text, mu, logvar,
                                       beta=beta, text_weight=text_weight)
        return loss, {"mse_audio": ma, "mse_text": mt, "kl": kl}

    return loss_fn


def autoencoder_objective():
    def loss_fn(model, batch, generator, train):
        (x,) = batch
        recon, _ = model(x)
        return ae_loss(recon, x), {}

    return loss_fn
