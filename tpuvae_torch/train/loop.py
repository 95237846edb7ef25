"""Generic per-epoch training loop (counterpart of ``tpuvae/train/loop.py``).

The reference's per-batch loop (``Simple_VAE.py:171-217``) with the JAX
package's epoch semantics (``tpuvae/train/loop.py:388-480``): a shuffled
permutation each epoch, full batches plus one remainder batch, a
``per_batch`` or ``per_dataset`` loss normaliser, and host-side control
between epochs:

  * ReduceLROnPlateau on the monitored loss: the LR is multiplied by
    ``plateau_factor`` once the plateau counter exceeds ``plateau_patience``;
  * early stop when the patience counter reaches ``patience``;
  * a deep copy of the best weights, restored when ``restore_best`` is set
    (Simple VAE: monitor **train** loss and restore, ``Simple_VAE.py:202-222``).

PyTorch runs eagerly: one optimizer step per batch, and one host sync per
epoch (the summed losses).  With ``FitConfig.host_stream`` the datasets
stay on the host (numpy arrays, ``np.memmap``, ``RowView``) and one batch
at a time goes to the device, staged while the previous step runs; batch
composition, noise and the ragged remainder are those of the resident
epoch, so the losses are the same.  Not ported: ``scan_epochs`` (TPU
dispatch amortisation; accepted and logged as ignored), a data-parallel
``mesh`` and mid-train checkpoints with resume (each raises
``NotImplementedError`` naming its ROADMAP.md item).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from tpuvae_torch.train.state import (
    TrainState,
    get_learning_rate,
    set_learning_rate,
)
from tpuvae_torch.utils.logging import RunLogger

# loss_fn(model, batch: tuple, generator, train) -> (loss, aux_dict)
LossFn = Callable[..., Any]


@dataclasses.dataclass
class FitConfig:
    epochs: int
    batch_size: int = 32
    patience: int = 15
    monitor: str = "train"          # 'train' | 'val'
    restore_best: bool = False
    plateau_patience: int | None = None   # None disables ReduceLROnPlateau
    plateau_factor: float = 0.5
    loss_normalizer: str = "per_batch"    # 'per_batch' | 'per_dataset'
    seed: int = 42
    log_every: int = 10
    checkpoint_dir: str | None = None     # mid-train checkpoints: not ported
    scan_epochs: int = 1                  # TPU dispatch amortisation: ignored
    host_stream: bool = False             # data stays on the host, one
                                          # batch at a time on the device


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: dict[str, list[float]]
    best_epoch: int
    stopped_epoch: int
    steps_per_sec: float


def _reject_unported(cfg: FitConfig, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is not ported to "
            "tpuvae_torch yet (ROADMAP.md, queue 1, item 9: torch.distributed)")
    if cfg.checkpoint_dir:
        raise NotImplementedError(
            "mid-train checkpoints and resume are not ported to tpuvae_torch "
            "yet (ROADMAP.md, queue 1, item 9)")


def _resident_batches(data, bs: int):
    """Batches of ``bs`` rows of device-resident ``data`` (the last one
    ragged)."""
    for i in range(0, data[0].shape[0], bs):
        yield tuple(d[i:i + bs] for d in data)


class _HostStager:
    """Moves one batch of host arrays to the device at a time.

    On a card each batch is gathered into one of two rotating pinned
    buffers and copied on a side stream, so that the gather and the copy
    of batch i + 1 run while step i computes; the consumer's stream waits
    for the copy's event.  A pinned buffer is written again only after the
    copy that read it has finished.  On the CPU a batch is a plain tensor.
    """

    def __init__(self, data, bs: int, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.stream = torch.cuda.Stream(device)
            self.slots = [[torch.empty(
                (bs, *d.shape[1:]), pin_memory=True,
                dtype=torch.from_numpy(np.empty(0, d.dtype)).dtype)
                for d in data] for _ in range(2)]
            self.slots_np = [[b.numpy() for b in slot] for slot in self.slots]
            self.copied = [None, None]
            self.turn = 0

    def stage(self, data, rows):
        """Start moving ``tuple(d[rows] for d in data)``; returns what
        :meth:`ready` takes."""
        if not self.on_card:
            # a copy: a slice of a read-only memmap is a view of the file
            return tuple(torch.from_numpy(np.array(d[rows]))
                         for d in data), None
        slot, self.turn = self.turn, 1 - self.turn
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        out = []
        with torch.cuda.stream(self.stream):
            for buf, buf_np, d in zip(self.slots[slot], self.slots_np[slot],
                                      data):
                h = d[rows]
                buf_np[:len(h)] = h
                out.append(buf[:len(h)].to(self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self.stream)
        self.copied[slot] = done
        return tuple(out), done

    def ready(self, staged):
        """The staged batch, safe to use on the current stream."""
        batch, done = staged
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in batch:
                t.record_stream(current)
        return batch


def _host_batches(stager: _HostStager, data, bs: int, rows=None):
    """Batches of ``bs`` rows of host ``data`` in the order ``rows`` (or
    file order), each staged while the consumer works on the one before."""
    n = len(rows) if rows is not None else data[0].shape[0]
    starts = list(range(0, n, bs))

    def sel(i):
        return rows[i:i + bs] if rows is not None else slice(i, min(i + bs, n))

    nxt = stager.stage(data, sel(starts[0])) if starts else None
    for j, _ in enumerate(starts):
        cur = nxt
        yield stager.ready(cur)
        if j + 1 < len(starts):
            nxt = stager.stage(data, sel(starts[j + 1]))


def _loss_sum(model, loss_fn, batches, device, gen, train: bool,
              optimizer=None) -> torch.Tensor:
    """Sum of the batch losses over ``batches``; with ``optimizer``, one
    step per batch."""
    total = torch.zeros((), device=device)
    for batch in batches:
        if optimizer is None:
            with torch.no_grad():
                loss, _ = loss_fn(model, batch, gen, train)
        else:
            optimizer.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch, gen, train)
            loss.backward()
            optimizer.step()
        total = total + loss.detach()
    return total


def fit(
    state: TrainState,
    loss_fn: LossFn,
    train_data: Sequence[torch.Tensor],
    cfg: FitConfig,
    val_data: Sequence[torch.Tensor] | None = None,
    logger: RunLogger | None = None,
    mesh=None,
) -> FitResult:
    """Train ``state`` with per-epoch host control flow.

    ``train_data``/``val_data`` are tuples of equal-length tensors on the
    model's device — or, with ``cfg.host_stream``, of host arrays (numpy,
    ``np.memmap``, ``RowView``); batches index dim 0.  The shuffles,
    dropout masks and reparameterisation noise come from one
    ``torch.Generator`` on the model's device, seeded with ``cfg.seed``.
    """
    if cfg.monitor == "val" and val_data is None:
        raise ValueError("FitConfig.monitor='val' requires val_data")
    _reject_unported(cfg, mesh)
    model, optimizer = state.model, state.optimizer
    train_data = tuple(train_data)
    stream = bool(cfg.host_stream)
    dev = (next(model.parameters()).device if stream
           else train_data[0].device)
    stager = _HostStager(train_data, cfg.batch_size, dev) if stream else None
    n = int(train_data[0].shape[0])
    bs = cfg.batch_size
    n_batches = -(-n // bs)
    if val_data is not None:
        val_data = tuple(val_data)
        n_val = int(val_data[0].shape[0])
        val_batches = -(-n_val // bs)
    if cfg.scan_epochs > 1 and logger is not None:
        logger.log("scan_epochs_ignored",
                   reason="the port runs one epoch per host-loop step")

    history: dict[str, list[float]] = {"train_loss": [], "val_loss": [],
                                       "lr": [], "epoch_seconds": []}
    best = float("inf")
    best_epoch = -1
    best_snapshot = None
    patience_counter = 0
    plateau_best = float("inf")
    plateau_counter = 0
    lr = get_learning_rate(state)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    t0 = time.time()
    total_steps = 0
    epoch = -1

    for epoch in range(cfg.epochs):
        t_epoch = time.perf_counter()
        perm = torch.randperm(n, generator=gen, device=dev)
        model.train()
        batches = (_host_batches(stager, train_data, bs, perm.cpu().numpy())
                   if stream else
                   _resident_batches(tuple(d[perm] for d in train_data), bs))
        loss_sum = _loss_sum(model, loss_fn, batches, dev, gen, True, optimizer)
        total_steps += n_batches
        val_total = None
        if val_data is not None:
            model.eval()
            batches = (_host_batches(stager, val_data, bs) if stream
                       else _resident_batches(val_data, bs))
            val_total = _loss_sum(model, loss_fn, batches, dev, gen, False)

        denom = n_batches if cfg.loss_normalizer == "per_batch" else n
        train_loss = float(loss_sum) / denom
        history["train_loss"].append(train_loss)
        history["lr"].append(lr)
        if val_data is not None:
            vdenom = val_batches if cfg.loss_normalizer == "per_batch" else n_val
            val_loss = float(val_total) / vdenom
            history["val_loss"].append(val_loss)
        monitored = train_loss if cfg.monitor == "train" else val_loss
        # the float() above waited for the epoch's last step
        history["epoch_seconds"].append(time.perf_counter() - t_epoch)

        # ReduceLROnPlateau on the monitored loss
        if cfg.plateau_patience is not None:
            if monitored < plateau_best:
                plateau_best = monitored
                plateau_counter = 0
            else:
                plateau_counter += 1
                if plateau_counter > cfg.plateau_patience:
                    lr *= cfg.plateau_factor
                    set_learning_rate(state, lr)
                    plateau_counter = 0

        # early stopping + best tracking
        if monitored < best:
            best = monitored
            best_epoch = epoch
            patience_counter = 0
            if cfg.restore_best:
                best_snapshot = {k: v.detach().clone()
                                 for k, v in model.state_dict().items()}
        else:
            patience_counter += 1

        if logger is not None and (epoch + 1) % cfg.log_every == 0:
            logger.log(
                "epoch", epoch=epoch + 1, train_loss=train_loss,
                val_loss=history["val_loss"][-1] if val_data is not None else None,
                lr=lr,
            )
        if patience_counter >= cfg.patience:
            break

    if cfg.restore_best and best_snapshot is not None:
        model.load_state_dict(best_snapshot)

    elapsed = time.time() - t0
    return FitResult(
        state=state,
        history=history,
        best_epoch=best_epoch,
        stopped_epoch=epoch,
        steps_per_sec=total_steps / max(elapsed, 1e-9),
    )


def train_val_split(n: int, val_fraction: float,
                    seed: int) -> tuple[np.ndarray, np.ndarray]:
    """85/15-style random split (ref ``Conditional_VAE.py:381-383``): the
    JAX package's, row for row (``numpy.random.default_rng(seed)``)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int((1.0 - val_fraction) * n)
    return perm[:n_train], perm[n_train:]
