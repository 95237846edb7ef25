"""Plain float32 training in PyTorch, written apart from the program.

What the reference models share: flax's BatchNorm (biased batch
statistics, running averages moved by 0.01), flax's Dropout, the products
in a stated precision, Adam, and the port's epoch loop as its
documentation states it: a permutation drawn from a generator on the
device, one optimizer step per batch of rows (the last one ragged), and
a validation pass in eval mode after each epoch.  The random draws
(permutation, dropout masks, noise) come from one ``torch.Generator`` on
the device, seeded as the fit's, in the order the forward pass asks for
them.

Precision: ``"fp32"`` keeps every product in float32 (TF32 off on a card);
``"tf32"`` is the control, the nearest precision below: on a card TF32 is
switched on for cuBLAS and cuDNN, on the CPU each product's operands are
rounded to TF32's 10-bit mantissa first; ``"fp64"`` holds the weights and
computes in float64 (the draws stay float32 and are widened), a witness
for the calibration only.  Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
BN_MOMENTUM = 0.01
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
TRUNC_STD = 0.87962566103423978     # std of a standard normal cut at +-2


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _tf32_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 in the forward pass; the gradient passes."""
    return x + (round_tf32(x.detach()) - x.detach())


DTYPES = {"fp32": torch.float32, "tf32": torch.float32, "fp64": torch.float64}
# a configuration's ``dtype`` -> the precision its reference computes in
PRECISION_OF_DTYPE = {"float32": "fp32"}


def precision_of(cfg: dict) -> str:
    """The reference's precision for the configuration's ``dtype``; a dtype
    that no plain reference here computes in is refused."""
    dtype = cfg.get("dtype", "float32")
    if dtype not in PRECISION_OF_DTYPE:
        raise ValueError(f"no plain reference computes in {dtype!r} "
                         f"(there is one for {sorted(PRECISION_OF_DTYPE)})")
    return PRECISION_OF_DTYPE[dtype]


class Products:
    """The model's linear maps and convolutions in one precision."""

    def __init__(self, precision: str = "fp32"):
        if precision not in DTYPES:
            raise ValueError(f"precision must be one of {sorted(DTYPES)}, "
                             f"got {precision!r}")
        self.precision = precision

    def _ops(self, x, w):
        if self.precision == "tf32" and x.device.type == "cpu":
            return _tf32_operand(x), _tf32_operand(w)
        return x, w

    def linear(self, x, w, b):
        x, w = self._ops(x, w)
        return F.linear(x, w, b)

    def conv2d(self, x, w, b, stride):
        x, w = self._ops(x, w)
        return F.conv2d(x, w, b, stride=stride)

    def conv_transpose2d(self, x, w, b, stride):
        x, w = self._ops(x, w)
        return F.conv_transpose2d(x, w, b, stride=stride)


@contextlib.contextmanager
def precision_scope(precision: str, device: torch.device):
    """cuBLAS's and cuDNN's TF32 switches as ``precision`` asks, on a card;
    restored on exit."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class Lin(nn.Module):
    """``y = x W^T + b``; ``weight`` is (out, in)."""

    def __init__(self, n_in: int, n_out: int, prod: Products):
        super().__init__()
        self.prod = prod
        self.fan_in = n_in
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x):
        return self.prod.linear(x, self.weight, self.bias)


class BN(nn.Module):
    """flax.linen.BatchNorm over every dim but 1 (the channels)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))
        self.register_buffer("running_mean", torch.empty(n))
        self.register_buffer("running_var", torch.empty(n))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            mean = x.mean(dim=dims)
            var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    mean, alpha=BN_MOMENTUM)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    var, alpha=BN_MOMENTUM)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


def noise(shape, like: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Standard normal noise drawn from ``gen`` in float32 (as the program
    draws it), in ``like``'s dtype."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=like.device).to(like.dtype)


def dropout(x, rate: float, training: bool, gen: torch.Generator):
    """flax.linen.Dropout with its mask drawn from ``gen`` (float32
    uniforms, kept where below ``1 - rate``)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def initial_state(model: nn.Module, seed: int,
                  device: torch.device) -> dict[str, torch.Tensor]:
    """The initial weights, made on ``device`` from ``seed``: every
    ``weight`` of a product a truncated normal of variance 1 / fan_in
    (flax's ``lecun_normal``), from one draw for all of them; biases 0;
    BatchNorm scale 1, shift 0, running mean 0, variance 1.  ``model``
    names the tensors and their shapes (it may sit on the meta device)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 17) % (1 << 63))
    state = {}
    drawn = []
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if hasattr(mod, "fan_in"):
            drawn.append((f"{pre}weight", tuple(mod.weight.shape), mod.fan_in))
            state[f"{pre}bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, BN):
            n = mod.weight.shape[0]
            state[f"{pre}weight"] = torch.ones(n, device=device)
            state[f"{pre}bias"] = torch.zeros(n, device=device)
            state[f"{pre}running_mean"] = torch.zeros(n, device=device)
            state[f"{pre}running_var"] = torch.ones(n, device=device)
            state[f"{pre}num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.empty(total, device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    at = 0
    for name, shape, fan_in in drawn:
        n = math.prod(shape)
        state[name] = flat[at:at + n].view(shape) * (fan_in ** -0.5 / TRUNC_STD)
        at += n
    missing = set(model.state_dict()) - set(state)
    if missing:
        raise ValueError(f"no initial value for {sorted(missing)}")
    return state


def split_rows(n: int, val_fraction: float, seed: int):
    """The 85/15 split as the port documents it: a numpy ``default_rng``
    permutation, the first ``int((1 - f) n)`` rows for training."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int((1.0 - val_fraction) * n)
    return perm[:n_train], perm[n_train:]


class Adam:
    """Adam as ``optax.adam``: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.lr = float(lr)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def load(self, m, v, t: int) -> None:
        """Moments (in the parameters' order) and the step count to go on
        from."""
        for dst, src in zip(self.m + self.v, list(m) + list(v)):
            dst.copy_(src)
        self.t = int(t)

    @torch.no_grad()
    def step(self, grads) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        c1 = 1.0 - b1 ** self.t
        c2 = 1.0 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))


def _batches(arrays, bs: int):
    n = arrays[0].shape[0]
    for i in range(0, n, bs):
        yield tuple(a[i:i + bs] for a in arrays)


def _half(batch):
    """The fault that leaves out half of a batch: its first ceil(b / 2)
    rows."""
    keep = -(-batch[0].shape[0] // 2)
    return tuple(a[:keep] for a in batch), batch[0].shape[0] / keep


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each tensor's 2-norm, summed in float64."""
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k], dtype=torch.float64)
                        for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def floating(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The floating-point entries of a state dict (weights, BatchNorm's
    running statistics; not its batch counters)."""
    return {k: v for k, v in state.items() if v.is_floating_point()}


def epoch_draws(model: nn.Module, loss_fn, train, val, bs: int,
                gen: torch.Generator) -> None:
    """One epoch's random draws, in the order a training epoch makes them
    (the permutation, then every forward pass's), the forward passes run
    without gradients and no step taken.  It changes BatchNorm's running
    statistics: load the weights again afterwards."""
    dev = train[0].device
    with torch.no_grad():
        perm = torch.randperm(train[0].shape[0], generator=gen, device=dev)
        model.train()
        for batch in _batches(tuple(a[perm] for a in train), bs):
            loss_fn(model, batch, gen, True)
        if val is not None:
            model.eval()
            for batch in _batches(val, bs):
                loss_fn(model, batch, gen, False)


def generator_at(seed: int, epochs: int, draws, device) -> torch.Generator:
    """The fit's generator after ``epochs`` whole epochs: seeded as the fit
    seeds it, then moved on by ``epochs`` epochs of ``draws(gen)``.  On a
    card one epoch is drawn and Philox's offset moved by that epoch's
    share times ``epochs`` (every epoch draws the same shapes); on the CPU
    the draws are made ``epochs`` times."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if torch.device(device).type == "cuda":
        start = gen.get_offset()
        draws(gen)
        per_epoch = gen.get_offset() - start
        gen.manual_seed(int(seed))
        gen.set_offset(start + per_epoch * int(epochs))
    else:
        for _ in range(int(epochs)):
            draws(gen)
    return gen


def _normaliser(fit: dict, rows: int) -> int:
    """What a summed epoch loss is divided by: its batches (``per_batch``)
    or its rows (``per_dataset``)."""
    if fit["loss_normalizer"] == "per_batch":
        return -(-rows // int(fit["batch_size"]))
    return rows


def train_epoch(model: nn.Module, opt: Adam, loss_fn, train, val, *,
                fit: dict, gen: torch.Generator,
                fault: str | None = None) -> dict:
    """One epoch of plain training from ``model``'s and ``opt``'s state, in
    the port's epoch loop: a permutation, one step a batch (the last one
    ragged), then the validation pass in eval mode.  Returns the epoch's
    training and validation losses as the fit reports them (each summed
    batch loss over its normaliser, ``fit["loss_normalizer"]``) and the
    norms of each parameter's gradient at the epoch's first step.
    ``fault='half'`` as :func:`train_steps`."""
    dev = train[0].device
    bs = int(fit["batch_size"])
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    dtype = params[0].dtype
    perm = torch.randperm(train[0].shape[0], generator=gen, device=dev)
    model.train()
    train_sum = torch.zeros((), dtype=dtype, device=dev)
    first_grad = None
    for batch in _batches(tuple(a[perm] for a in train), bs):
        if fault == "half":
            batch, scale = _half(batch)
        loss = loss_fn(model, batch, gen, True)
        if fault == "half" and fit["loss_reduction"] == "sum":
            loss = loss * scale
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if first_grad is None:
            first_grad = leaf_norms(dict(zip(names, grads)))
        opt.step(grads)
        train_sum = train_sum + loss.detach()
    out = {"train_loss": float(train_sum) / _normaliser(fit, train[0].shape[0]),
           "val_loss": None, "first_grad": first_grad}
    if val is not None:
        model.eval()
        val_sum = torch.zeros((), dtype=dtype, device=dev)
        with torch.no_grad():
            for batch in _batches(val, bs):
                val_sum = val_sum + loss_fn(model, batch, gen, False)
        out["val_loss"] = float(val_sum) / _normaliser(fit, val[0].shape[0])
    return out


def train_steps(model: nn.Module, loss_fn, train, val, *, fit: dict,
                steps: int, seed: int, fault: str | None = None) -> dict:
    """The first ``steps`` optimizer steps of plain training from
    ``model``'s weights, in the port's epoch loop: a permutation drawn each
    epoch, one step a batch, and, where the steps run past an epoch, its
    validation pass in eval mode, which draws noise too.  (The control
    between epochs, ReduceLROnPlateau and early stopping, cannot act within
    so few epochs.)

    ``loss_fn(model, batch, gen, train) -> loss`` (a 0-d float32 tensor);
    ``fit`` holds ``batch_size``, ``learning_rate`` and ``loss_reduction``
    ('mean' | 'sum').  ``fault='half'`` trains on half of each batch, the
    loss taken over those rows.  Returns each step's loss and the norms of
    each parameter's first gradient and of its change over the steps."""
    dev = train[0].device
    bs = int(fit["batch_size"])
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = Adam(params, fit["learning_rate"])
    n = train[0].shape[0]
    losses, first_grad = [], None
    while True:
        perm = torch.randperm(n, generator=gen, device=dev)
        model.train()
        for batch in _batches(tuple(a[perm] for a in train), bs):
            if fault == "half":
                batch, scale = _half(batch)
            loss = loss_fn(model, batch, gen, True)
            if fault == "half" and fit["loss_reduction"] == "sum":
                loss = loss * scale
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if first_grad is None:
                first_grad = leaf_norms(dict(zip(names, grads)))
            opt.step(grads)
            losses.append(float(loss.detach()))
            if len(losses) == steps:
                change = leaf_norms({k: p.detach() - p0 for k, p, p0
                                     in zip(names, params, start)})
                return {"losses": losses, "first_grad": first_grad,
                        "change": change}
        if val is not None:
            model.eval()
            with torch.no_grad():
                for batch in _batches(val, bs):
                    loss_fn(model, batch, gen, False)
