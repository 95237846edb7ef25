"""The Simple VAE as the port trains it, and the work it does.

:func:`build` makes what ``tpuvae_torch.pipelines.run_simple_vae`` hands
to ``fit``: the ``SimpleVAE`` module in the configuration's ``dtype``,
its Adam state, the Simple VAE objective, every row (no split) and the
``FitConfig`` (training loss monitored and the best weights restored,
ReduceLROnPlateau, per-batch normaliser, K epochs per host read, and the
traffic mix's ``fit`` entry), with the benchmark's initial weights loaded
in place of the pipeline's.  Early stopping and the plateau's patience
are both the fit's epoch count: in the source's jobs early stopping (15
epochs without a new best) always ends a fit before the plateau (16)
would halve the rate, so the rate stays the configuration's; with the
patience raised alone it would halve every 16 epochs of a long fit.  The counters give the
work of a training row and Adam's from the configuration's widths.
"""

from __future__ import annotations

from portbench.models.hybrid import ADAM_FLOPS_PER_PARAM, fit_overrides, placed


def _dims(cfg: dict) -> list[tuple[str, int, int, bool]]:
    dims = list(cfg["hidden_dims"])
    n_in, latent = cfg["input_dim"], cfg["latent_dim"]
    enc = [n_in, *dims]
    dec = [latent, *dims[::-1]]
    out = [(f"encoder{i}", a, b, i > 0)
           for i, (a, b) in enumerate(zip(enc[:-1], enc[1:]))]
    out += [("fc_mu", dims[-1], latent, True),
            ("fc_logvar", dims[-1], latent, True)]
    out += [(f"decoder{i}", a, b, True)
            for i, (a, b) in enumerate(zip(dec[:-1], dec[1:]))]
    out.append(("out", dims[0], n_in, True))
    return out


def layers(cfg: dict) -> list[tuple[str, int, bool]]:
    """``(layer, multiply-adds per row, needs the gradient of its input)``."""
    return [(name, a * b, g) for name, a, b, g in _dims(cfg)]


def n_params(cfg: dict) -> int:
    dims = list(cfg["hidden_dims"])
    dense = sum(a * b + b for _, a, b, _ in _dims(cfg))
    return dense + 2 * 2 * sum(dims)             # BatchNorm scale and shift


def work(cfg: dict, n_train: int, n_val: int) -> dict:
    """As :func:`portbench.models.hybrid.work`."""
    ls = layers(cfg)
    fwd = 2 * sum(m for _, m, _ in ls)
    train_row = fwd + 2 * sum(m for _, m, _ in ls) + 2 * sum(
        m for _, m, g in ls if g)
    steps = -(-n_train // cfg["batch_size"])
    adam = ADAM_FLOPS_PER_PARAM * n_params(cfg)
    return {"train_flops_per_row": train_row, "eval_flops_per_row": fwd,
            "n_params": n_params(cfg), "steps_per_epoch": steps,
            "adam_flops_per_step": adam,
            "epoch_flops": n_train * train_row + n_val * fwd + steps * adam}


def build(cfg: dict, traffic: dict, init: dict, data: dict, seed: int,
          device):
    """The port's model (in the configuration's ``dtype``), state,
    objective, data and ``FitConfig`` maker."""
    import torch

    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.models.layers import compute_dtype
    from tpuvae_torch.train.loop import FitConfig
    from tpuvae_torch.train.objectives import simple_vae_objective
    from tpuvae_torch.train.state import create_state

    with torch.device("meta"):
        model = SimpleVAE(input_dim=cfg["input_dim"],
                          hidden_dims=tuple(cfg["hidden_dims"]),
                          latent_dim=cfg["latent_dim"], dropout=cfg["dropout"],
                          dtype=compute_dtype(cfg["dtype"]))
    model = model.to_empty(device=device)
    model.load_state_dict(init, strict=True)
    state = create_state(model, cfg["learning_rate"])
    over = fit_overrides(traffic)
    k = 1 if over.get("host_stream") else int(cfg["scan_epochs"])

    def fit_config(epochs: int) -> FitConfig:
        return FitConfig(**{
            "epochs": epochs, "batch_size": cfg["batch_size"],
            "patience": epochs, "monitor": cfg["monitor"],
            "restore_best": cfg["restore_best"],
            "loss_normalizer": cfg["loss_normalizer"],
            "plateau_patience": epochs,
            "plateau_factor": cfg["plateau_factor"], "seed": seed,
            "log_every": 1, "scan_epochs": cfg["scan_epochs"], **over})

    x = data["features"]
    return {"model": model, "state": state,
            "loss_fn": simple_vae_objective(cfg["beta"]),
            "train": placed((x,), over), "val": None, "fit_config": fit_config,
            "scan_epochs": k, "n_train": int(x.shape[0]), "n_val": 0}
