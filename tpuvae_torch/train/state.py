"""Train state: the model, its Adam optimizer and an adjustable learning
rate (counterpart of ``tpuvae/train/state.py``).

``torch.optim.Adam`` with beta 0.9 / 0.999 and eps 1e-8 makes the update
of ``optax.adam``: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.  The BatchNorm
running statistics live in the model's buffers.

The learning rate is a 0-d float64 tensor on the parameters' device, which
the optimizer reads at every step (the counterpart of the JAX package's
injected ``learning_rate`` hyperparameter): the scanned-epoch loop halves
it on the device, inside a CUDA graph of the epoch, and float64 keeps the
host's ``lr * factor`` exactly.  On a card Adam is ``capturable`` (its step
count stays on the device), which is what torch asks for a tensor rate
under its default multi-tensor update; on the CPU it runs the
single-tensor update, whose arithmetic with a float64 tensor rate is that
of a float rate.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_state(model: nn.Module, learning_rate: float) -> TrainState:
    p = next(model.parameters(), None)
    dev = p.device if p is not None else torch.device("cpu")
    lr = torch.tensor(float(learning_rate), dtype=torch.float64, device=dev)
    return TrainState(model=model, optimizer=torch.optim.Adam(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
        capturable=dev.type == "cuda"))


def traced_learning_rate(state: TrainState) -> torch.Tensor:
    """The learning rate as the 0-d device tensor the optimizer reads (the
    in-graph counterpart of :func:`get_learning_rate`)."""
    return state.optimizer.param_groups[0]["lr"]


def get_learning_rate(state: TrainState) -> float:
    return float(traced_learning_rate(state))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set ``lr`` on every param group (ReduceLROnPlateau support, ref
    ``Simple_VAE.py:151-153``), written into the rate tensor in place, so
    that a captured graph reads the new value.  Returns ``state``."""
    for group in state.optimizer.param_groups:
        group["lr"].fill_(lr)
    return state


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         saved: dict) -> None:
    """``optimizer.load_state_dict(saved)`` that keeps the optimizer's own
    rate tensors (written with the saved rates) and ``capturable`` flags:
    torch's loader replaces each param group by the saved one, which would
    leave a graph reading a stale rate and a card's Adam with its step
    count on the host."""
    keep = [(g["lr"], g["capturable"]) for g in optimizer.param_groups]
    groups = [{**g, "capturable": cap}
              for g, (_, cap) in zip(saved["param_groups"], keep)]
    optimizer.load_state_dict({**saved, "param_groups": groups})
    for group, (lr, _) in zip(optimizer.param_groups, keep):
        lr.fill_(float(group["lr"]))
        group["lr"] = lr


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
