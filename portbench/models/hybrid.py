"""The Hybrid VAE as the port trains it, and the work it does.

:func:`build` makes what ``tpuvae_torch.pipelines.run_hybrid_vae`` hands
to ``fit``: the ``HybridVAE`` module in the configuration's ``dtype``,
its Adam state, the hybrid objective, the seeded 85/15 split of the rows
and the ``FitConfig`` (validation loss monitored, per-row normaliser, K
epochs per host read, and whatever the traffic mix's ``fit`` entry sets,
such as ``host_stream``, which keeps the rows on the host), with the
benchmark's initial weights loaded in place of the pipeline's.  The counters give the work from the configuration's shapes
alone: the products of a training row and of a validation row, Adam's
arithmetic, and the bytes and operations of trunk layers 0-1, the two
halves of kernel 6.
"""

from __future__ import annotations

# Adam's arithmetic per parameter and step: m = b1 m + (1 - b1) g (3),
# v = b2 v + (1 - b2) g^2 (4), p -= lr m / (sqrt(v) + eps) with the bias
# corrections folded into per-tensor scalars (5)
ADAM_FLOPS_PER_PARAM = 12
F32 = 4


def _taps(ho: int, wo: int) -> int:
    """Products per (input channel, output channel) of a 3x3 stride-2 SAME
    convolution or transposed convolution whose smaller side is ho x wo:
    the taps that meet a real pixel, (3 ho - 1) (3 wo - 1); the zero row
    and column of the padding take none."""
    return (3 * ho - 1) * (3 * wo - 1)


def layers(cfg: dict) -> list[tuple[str, int, bool]]:
    """``(layer, multiply-adds per row, needs the gradient of its input)``
    for every product of the model."""
    h, w = cfg["input_hw"]
    feats = list(cfg["trunk_features"])
    chans = [1, *feats]
    out = []
    for i, (c, f) in enumerate(zip(chans[:-1], chans[1:])):
        ho, wo = h >> (i + 1), w >> (i + 1)
        out.append((f"enc_conv{i}", _taps(ho, wo) * c * f, i > 0))
    dchans = feats[::-1] + [1]
    for i, (c, f) in enumerate(zip(dchans[:-1], dchans[1:])):
        hi, wi = h >> (len(feats) - i), w >> (len(feats) - i)
        out.append((f"dec_conv{i}", _taps(hi, wi) * c * f, True))
    flat = feats[-1] * (h // 64) * (w // 64)
    audio, text = cfg["audio_dense"], cfg["text_dim"]
    t1, t2 = cfg["text_hidden"]
    fusion, latent = cfg["fusion_dim"], cfg["latent_dim"]
    dense = [("audio_fc", flat, audio, True), ("text_fc1", text, t1, False),
             ("text_fc2", t1, t2, True), ("fc_fusion", audio + t2, fusion, True),
             ("fc_mu", fusion, latent, True), ("fc_logvar", fusion, latent, True),
             ("decoder_input", latent, fusion, True),
             ("decoder_split", fusion, audio + t2, True),
             ("audio_decoder_fc", audio, flat, True),
             ("text_dec_fc1", t2, t1, True), ("text_dec_fc2", t1, text, True)]
    out += [(name, a * b, grad_in) for name, a, b, grad_in in dense]
    return out


def n_params(cfg: dict) -> int:
    feats = list(cfg["trunk_features"])
    chans = [1, *feats]
    convs = sum(9 * c * f + f for c, f in zip(chans[:-1], chans[1:]))
    dchans = feats[::-1] + [1]
    convs += sum(9 * c * f + f for c, f in zip(dchans[:-1], dchans[1:]))
    bn = 2 * (sum(feats) + sum(feats[::-1][1:]))   # encoder, decoder norms
    h, w = cfg["input_hw"]
    flat = feats[-1] * (h // 64) * (w // 64)
    audio, text = cfg["audio_dense"], cfg["text_dim"]
    t1, t2 = cfg["text_hidden"]
    fusion, latent = cfg["fusion_dim"], cfg["latent_dim"]
    pairs = [(flat, audio), (text, t1), (t1, t2), (audio + t2, fusion),
             (fusion, latent), (fusion, latent), (latent, fusion),
             (fusion, audio + t2), (audio, flat), (t2, t1), (t1, text)]
    dense = sum(a * b + b for a, b in pairs)
    bn += 2 * (t1 + t2 + t1)
    return convs + dense + bn


def work(cfg: dict, n_train: int, n_val: int) -> dict:
    """Operations of one epoch's products and Adam, from the shapes: a
    training row costs its forward, its weight gradients and the input
    gradients of every layer but the ones that read the data; a
    validation row its forward."""
    ls = layers(cfg)
    fwd = 2 * sum(m for _, m, _ in ls)
    train_row = fwd + 2 * sum(m for _, m, _ in ls) + 2 * sum(
        m for _, m, g in ls if g)
    steps = -(-n_train // cfg["batch_size"])
    return {"train_flops_per_row": train_row, "eval_flops_per_row": fwd,
            "n_params": n_params(cfg), "steps_per_epoch": steps,
            "adam_flops_per_step": ADAM_FLOPS_PER_PARAM * n_params(cfg),
            "epoch_flops": (n_train * train_row + n_val * fwd
                            + steps * ADAM_FLOPS_PER_PARAM * n_params(cfg))}


def pair_work(b: int, h: int, w: int, f0: int = 32, f1: int = 64) -> dict:
    """Bytes and operations of trunk layers 0-1 on ``b`` images of h x w,
    each half counted as one kernel: every input byte read once and every
    output byte written once.  conv0 reads the image and its weights and
    writes the raw ``y0`` and its batch statistics; conv1 reads ``y0``,
    BatchNorm 0's folded scale and shift and its weights, and writes the
    raw ``y1`` and its statistics.  Operations: the products' taps."""
    h0, w0 = h // 2, w // 2
    h1, w1 = h // 4, w // 4
    conv0_bytes = F32 * (b * h * w + 9 * f0 + f0 + b * h0 * w0 * f0 + 2 * f0)
    conv1_bytes = F32 * (b * h0 * w0 * f0 + 2 * f0 + 9 * f0 * f1 + f1
                         + b * h1 * w1 * f1 + 2 * f1)
    return {"conv0_bytes": conv0_bytes, "conv1_bytes": conv1_bytes,
            "conv0_flops": 2 * b * _taps(h0, w0) * f0,
            "conv1_flops": 2 * b * _taps(h1, w1) * f0 * f1}


def pair_bound_s(b: int, h: int, w: int, peaks: dict) -> dict:
    """The least time of each half on the card: its bytes at the memory
    bandwidth or its products at the tensor cores' TF32 rate (the least
    that any route to float32 products can need), the larger."""
    pw = pair_work(b, h, w)
    return {half: max(pw[f"{half}_bytes"] / peaks["hbm_bytes_per_s"],
                      pw[f"{half}_flops"] / peaks["tf32_flops_per_s"])
            for half in ("conv0", "conv1")}


def pair_epoch(cfg: dict, n_train: int, n_val: int, peaks: dict) -> dict:
    """Kernel 6's calls (each half once a batch, training and validation)
    and their bound over one epoch."""
    h, w = cfg["input_hw"]
    bs = cfg["batch_size"]
    calls = 0
    bound = {"conv0": 0.0, "conv1": 0.0}
    for n in (n_train, n_val):
        for start in range(0, n, bs):
            b = min(bs, n - start)
            for half, s in pair_bound_s(b, h, w, peaks).items():
                bound[half] += s
            calls += 1
    return {"calls": calls, "bound_s": bound}


def fit_overrides(traffic: dict) -> dict:
    """The ``FitConfig`` fields a traffic mix sets (its ``fit`` entry, such
    as ``host_stream``), over the pipeline's."""
    return dict(traffic.get("fit", {}))


def placed(arrays: tuple, overrides: dict) -> tuple:
    """The rows where the fit takes them: on the card, or as host arrays
    under ``host_stream``."""
    if overrides.get("host_stream"):
        return tuple(a.cpu().numpy() for a in arrays)
    return arrays


def build(cfg: dict, traffic: dict, init: dict, data: dict, seed: int,
          device):
    """The port's model (in the configuration's ``dtype``), state,
    objective, data and ``FitConfig`` maker."""
    import torch

    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.models.layers import compute_dtype
    from tpuvae_torch.train.loop import FitConfig, train_val_split
    from tpuvae_torch.train.objectives import hybrid_objective
    from tpuvae_torch.train.state import create_state

    with torch.device("meta"):
        model = HybridVAE(latent_dim=cfg["latent_dim"],
                          text_dim=cfg["text_dim"],
                          input_hw=tuple(cfg["input_hw"]),
                          dtype=compute_dtype(cfg["dtype"]))
    model = model.to_empty(device=device)
    model.load_state_dict(init, strict=True)
    state = create_state(model, cfg["learning_rate"])
    tr, va = train_val_split(data["mel"].shape[0], cfg["val_fraction"], seed)
    tr = torch.from_numpy(tr).to(device)
    va = torch.from_numpy(va).to(device)
    over = fit_overrides(traffic)
    train = placed((data["mel"][tr], data["text"][tr]), over)
    val = placed((data["mel"][va], data["text"][va]), over)
    k = 1 if over.get("host_stream") else int(cfg["scan_epochs"])

    def fit_config(epochs: int) -> FitConfig:
        return FitConfig(**{
            "epochs": epochs, "batch_size": cfg["batch_size"],
            "patience": epochs, "monitor": cfg["monitor"],
            "restore_best": False, "loss_normalizer": cfg["loss_normalizer"],
            "seed": seed, "log_every": 1, "scan_epochs": cfg["scan_epochs"],
            **over})

    return {"model": model, "state": state,
            "loss_fn": hybrid_objective(cfg["beta"], cfg["text_loss_weight"]),
            "train": train, "val": val, "fit_config": fit_config,
            "scan_epochs": k, "n_train": len(tr), "n_val": len(va)}
