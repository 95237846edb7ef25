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
epoch, so the losses are the same.

With ``FitConfig.checkpoint_dir`` the loop saves its whole state every
``checkpoint_every`` epochs (``tpuvae/train/loop.py:454-465``; rotated by
:class:`~tpuvae_torch.train.checkpoint.CheckpointManager`): weights,
optimizer, the counters of early stopping and ReduceLROnPlateau, the
history and the state of its ``torch.Generator``, so a resumed run draws
the same permutations, dropout masks and noise as an uninterrupted one.
With ``restore_best`` it also writes the best weights to ``best/`` on each
improvement and reads them back on resume (``:336-370``, ``:425-440``).

With ``mesh`` (a ``DeviceMesh`` whose first axis, ``data``, holds more
than one rank) each epoch is :func:`tpuvae_torch.parallel.dp.make_dp_epoch`
on the rank's contiguous block of the data (``tpuvae/train/loop.py:89-130``):
micro-batches of ``batch_size / D`` rows, the gradients reduced as
``loss_reduction`` names the objective's batch reduction.  Every rank
reads the same reduced epoch losses, so early stopping and
ReduceLROnPlateau take the same decision on every rank; rank 0 writes the
checkpoints and every rank reads them on resume.

Not ported: ``scan_epochs`` (TPU dispatch amortisation; accepted and
logged as ignored).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpuvae_torch.convert import from_flax
from tpuvae_torch.parallel.dp import make_dp_epoch
from tpuvae_torch.parallel.mesh import axis_size
from tpuvae_torch.train.checkpoint import (
    CheckpointManager,
    latest_train_state_dir,
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)
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
    checkpoint_dir: str | None = None     # periodic full-state checkpoints
    checkpoint_every: int = 50
    checkpoint_keep: int = 1              # rotation depth (CheckpointManager)
    resume: bool = True                   # continue from checkpoint_dir if present
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


def _dp_blocks(mesh, axis: str, data, bs: int, logger, trim_key: str):
    """``(n, this rank's contiguous blocks, batches a rank runs)`` of
    ``data`` over the data axis: rows beyond a multiple of D dropped (at
    most D - 1, logged as ``dp_trim``), micro-batches of ``bs / D``."""
    n_dev = axis_size(mesh, axis)
    n = int(data[0].shape[0])
    dropped = n % n_dev
    if dropped:
        n -= dropped
        if logger is not None:
            logger.log("dp_trim", **{trim_key: dropped})
    n_local = n // n_dev
    r = mesh.get_local_rank(axis)
    blocks = tuple(d[r * n_local:(r + 1) * n_local] for d in data)
    return n, blocks, -(-n_local // max(bs // n_dev, 1))


def fit(
    state: TrainState,
    loss_fn: LossFn,
    train_data: Sequence[torch.Tensor],
    cfg: FitConfig,
    val_data: Sequence[torch.Tensor] | None = None,
    logger: RunLogger | None = None,
    mesh=None,
    loss_reduction: str = "mean",
) -> FitResult:
    """Train ``state`` with per-epoch host control flow.

    ``train_data``/``val_data`` are tuples of equal-length tensors on the
    model's device — or, with ``cfg.host_stream``, of host arrays (numpy,
    ``np.memmap``, ``RowView``); batches index dim 0.  The shuffles,
    dropout masks and reparameterisation noise come from one
    ``torch.Generator`` on the model's device, seeded with ``cfg.seed``.

    With ``mesh`` (a ``DeviceMesh`` whose first axis, the data axis, has
    D > 1 ranks; every rank calls ``fit`` with the same data) each rank
    trains on its contiguous block of ``n / D`` rows in micro-batches of
    ``batch_size / D``, its generator seeded from the epoch and its rank
    (:func:`tpuvae_torch.parallel.dp.make_dp_epoch`), and only gradients
    and BatchNorm statistics cross ranks.  ``loss_reduction`` must then
    name the objective's batch reduction ('mean' for Simple VAE/AE, 'sum'
    for CVAE/Hybrid) so the gradient reduction matches single-device
    semantics.  Rows beyond a multiple of D (at most D - 1) are dropped
    with a ``dp_trim`` log entry.
    """
    if cfg.monitor == "val" and val_data is None:
        raise ValueError("FitConfig.monitor='val' requires val_data")
    if cfg.host_stream and mesh is not None:
        raise ValueError(
            "host_stream=True streams host batches to a single device; "
            "it cannot be combined with mesh= (the DP epoch operates on "
            "device-sharded data)"
        )
    model, optimizer = state.model, state.optimizer
    train_data = tuple(train_data)
    stream = bool(cfg.host_stream)
    dev = (next(model.parameters()).device if stream
           else train_data[0].device)
    stager = _HostStager(train_data, cfg.batch_size, dev) if stream else None
    n = int(train_data[0].shape[0])
    bs = cfg.batch_size
    n_batches = -(-n // bs)
    dp_axis = mesh.mesh_dim_names[0] if mesh is not None else None
    n_dev = axis_size(mesh, dp_axis) if mesh is not None else 1
    dp = n_dev > 1
    if dp:
        n, train_data, n_batches = _dp_blocks(mesh, dp_axis, train_data, bs,
                                              logger, "dropped_train_rows")
    if val_data is not None:
        val_data = tuple(val_data)
        n_val = int(val_data[0].shape[0])
        val_batches = -(-n_val // bs)
        if dp:
            n_val, val_data, val_batches = _dp_blocks(
                mesh, dp_axis, val_data, bs, logger, "dropped_val_rows")
    if dp:
        dp_epoch = make_dp_epoch(
            loss_fn, mesh, batch_size=bs, n_local=n // n_dev,
            n_train_arrays=len(train_data),
            n_val_arrays=len(val_data) if val_data is not None else 0,
            n_val_local=n_val // n_dev if val_data is not None else 0,
            loss_reduction=loss_reduction, axis=dp_axis)
    # rank 0 of a process group writes the checkpoints, also where the
    # ranks train unsharded copies (a batch that does not divide over D)
    writer = not dist.is_initialized() or dist.get_rank() == 0
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
    epoch = -1                     # the last epoch run

    if cfg.checkpoint_dir and cfg.resume:
        ck = latest_train_state_dir(cfg.checkpoint_dir)
        if ck is not None:
            state, meta = restore_train_state(ck, state, generator=gen)
            epoch = int(meta["epoch"])
            best = float(meta["best"])
            best_epoch = int(meta["best_epoch"])
            patience_counter = int(meta["patience_counter"])
            plateau_best = float(meta["plateau_best"])
            plateau_counter = int(meta["plateau_counter"])
            lr = float(meta["lr"])
            set_learning_rate(state, lr)
            history = meta["history"]
            best_ck = Path(cfg.checkpoint_dir) / "best"
            if cfg.restore_best and (best_ck / "weights.npz").exists():
                # rehydrate the best-weights snapshot, else a resumed run
                # that never improves again would keep its final weights
                flat, _ = load_checkpoint(best_ck)
                best_snapshot = {k: v.to(dev)
                                 for k, v in from_flax(flat).items()}
            if logger is not None:
                logger.log("resume_training", from_epoch=epoch + 1)
    # a run that had stopped early before its last save stays stopped
    start_epoch = (cfg.epochs if epoch >= 0 and patience_counter >= cfg.patience
                   else epoch + 1)

    for epoch in range(start_epoch, cfg.epochs):
        t_epoch = time.perf_counter()
        if dp:
            state, loss_sum, val_total = dp_epoch(
                state, cfg.seed * 1_000_003 + epoch, *train_data,
                *(val_data or ()))
        else:
            perm = torch.randperm(n, generator=gen, device=dev)
            model.train()
            batches = (_host_batches(stager, train_data, bs,
                                     perm.cpu().numpy())
                       if stream else
                       _resident_batches(tuple(d[perm] for d in train_data),
                                         bs))
            loss_sum = _loss_sum(model, loss_fn, batches, dev, gen, True,
                                 optimizer)
            val_total = None
            if val_data is not None:
                model.eval()
                batches = (_host_batches(stager, val_data, bs) if stream
                           else _resident_batches(val_data, bs))
                val_total = _loss_sum(model, loss_fn, batches, dev, gen,
                                      False)
        total_steps += n_batches

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
                if cfg.checkpoint_dir and writer:
                    save_checkpoint(Path(cfg.checkpoint_dir) / "best",
                                    best_snapshot,
                                    {"epoch": epoch, "monitored": monitored})
        else:
            patience_counter += 1

        if logger is not None and (epoch + 1) % cfg.log_every == 0:
            logger.log(
                "epoch", epoch=epoch + 1, train_loss=train_loss,
                val_loss=history["val_loss"][-1] if val_data is not None else None,
                lr=lr,
            )
        if cfg.checkpoint_dir and (epoch + 1) % cfg.checkpoint_every == 0:
            t_save = time.perf_counter()
            if writer:
                saved = CheckpointManager(
                    cfg.checkpoint_dir, cfg.checkpoint_keep).save(
                    state,
                    {"epoch": epoch, "best": best, "best_epoch": best_epoch,
                     "patience_counter": patience_counter,
                     "plateau_best": plateau_best,
                     "plateau_counter": plateau_counter, "lr": lr,
                     "history": history},
                    step=epoch, generator=gen)
                if logger is not None:
                    logger.log("checkpoint_saved", dir=str(saved),
                               epoch=epoch,
                               seconds=time.perf_counter() - t_save)
            if dp:
                dist.barrier()      # every rank sees the checkpoint
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
