"""Train state: the model, its Adam optimizer and an adjustable learning
rate (counterpart of ``tpuvae/train/state.py``).

``torch.optim.Adam`` with beta 0.9 / 0.999 and eps 1e-8 makes the update
of ``optax.adam``: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.  The BatchNorm
running statistics live in the model's buffers.
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
    return TrainState(model=model, optimizer=torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8))


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set ``lr`` on every param group (ReduceLROnPlateau support, ref
    ``Simple_VAE.py:151-153``); returns ``state``."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
