"""Generic training loop (counterpart of ``tpuvae/train/loop.py``).

The reference's per-batch loop (``Simple_VAE.py:171-217``) with the JAX
package's epoch semantics (``tpuvae/train/loop.py:205-243``): a shuffled
permutation each epoch, full batches plus one remainder batch, a
``per_batch`` or ``per_dataset`` loss normaliser, and control between
epochs:

  * ReduceLROnPlateau on the monitored loss: the LR is multiplied by
    ``plateau_factor`` once the plateau counter exceeds ``plateau_patience``;
  * early stop when the patience counter reaches ``patience``;
  * a copy of the best weights, restored when ``restore_best`` is set
    (Simple VAE: monitor **train** loss and restore, ``Simple_VAE.py:202-222``).

A resident epoch (the data on the device, no mesh of several ranks) is one
function of device tensors (:func:`resident_epoch`) that reads nothing on
the host.  On a card it runs as one CUDA graph
(:class:`tpuvae_torch.graphs.CapturedGraph`): the first epoch of a ``fit``
runs eagerly on the graph's stream and is then captured, and every later
epoch is one replay, as the JAX package's epoch is one ``jax.jit`` call.
With ``scan_epochs = 1`` the host reads the epoch's two sums after every
epoch and runs the control in float64
(``tpuvae/train/loop.py:388-480``).  With ``scan_epochs = K > 1`` the
control runs on the device too (:class:`_DeviceControl`, counterpart of
``_fit_chunked``, ``:483-663``): K epochs run back to back, and the host
reads once per K epochs.  On the CPU the same functions run eagerly; they
are the plain version of the graph.

With ``FitConfig.host_stream`` the datasets stay on the host (numpy arrays,
``np.memmap``, ``RowView``) and one batch at a time goes to the device,
staged while the previous step runs; batch composition, noise and the
ragged remainder are those of the resident epoch, so the losses are the
same.  Its steps are functions of static device inputs
(:class:`_StreamSteps`, counterpart of the JAX package's jitted
``train_step`` and ``_val_batch_loss``): on a card each batch shape's
training step and validation batch is a CUDA graph after its first call,
and the staged batch is copied into the graph's inputs on the card.  The
epoch reads its permutation on the host once, as the JAX package's does,
and runs with the host control of ``scan_epochs = 1``.

With ``FitConfig.checkpoint_dir`` the loop saves its whole state every
``checkpoint_every`` epochs (``tpuvae/train/loop.py:454-465``; with
``scan_epochs > 1`` at the end of a chunk that crossed such a boundary,
``:622-646``; rotated by
:class:`~tpuvae_torch.train.checkpoint.CheckpointManager`): weights,
optimizer, the counters of early stopping and ReduceLROnPlateau, the
history and the state of its ``torch.Generator``, so a resumed run draws
the same permutations, dropout masks and noise as an uninterrupted one.
With ``restore_best`` it also writes the best weights to ``best/`` and
reads them back on resume (``:336-370``, ``:425-440``).

With ``mesh`` (a ``DeviceMesh`` whose first axis, ``data``, holds more
than one rank) each epoch is :func:`tpuvae_torch.parallel.dp.make_dp_epoch`
on the rank's contiguous block of the data (``tpuvae/train/loop.py:89-130``):
micro-batches of ``batch_size / D`` rows, the gradients reduced as
``loss_reduction`` names the objective's batch reduction.  Every rank
reads the same reduced epoch losses, so early stopping and
ReduceLROnPlateau take the same decision on every rank; rank 0 writes the
checkpoints and every rank reads them on resume.  The epoch is a function
of device tensors (:class:`~tpuvae_torch.parallel.dp.DPEpoch`) whose
generator ``fit`` re-seeds before each epoch; where the group's backend
for the card is NCCL, the first epoch runs eagerly (it also creates NCCL's
communicator, which a capture cannot) and every later one is one replay of
a CUDA graph (:func:`dp_epoch_runner`).  Under gloo (the CPU, or ranks
that share a card) the epoch runs eagerly, since gloo's collectives pass
through the host; ``fit`` makes that choice before the first epoch and
logs it once (``dp_epoch_graph``).  The control is the host's of
``scan_epochs = 1``: as in the JAX package ``scan_epochs`` is then
ignored, and so it is with ``host_stream`` (``:383-386``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpuvae_torch import graphs
from tpuvae_torch.convert import from_flax
from tpuvae_torch.parallel.dp import DPEpoch, make_dp_epoch
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
    traced_learning_rate,
)
from tpuvae_torch.utils.logging import RunLogger, span

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
    # >1 runs K epochs per host read, with early stopping, ReduceLROnPlateau
    # and best-weights tracking on the device; epochs past the stop point
    # change nothing.  Resident data on one rank only (else ignored, logged)
    scan_epochs: int = 1
    host_stream: bool = False             # data stays on the host, one
                                          # batch at a time on the device


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: dict[str, list[float]]
    best_epoch: int
    stopped_epoch: int
    steps_per_sec: float
    host_reads: int = 0      # reads of epoch results from the device


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


def resident_epoch(model, optimizer, loss_fn, train_data, val_data,
                   batch_size: int, generator: torch.Generator):
    """The resident epoch as one function of device tensors,
    ``epoch() -> (train_sum, val_sum)`` (counterpart of
    ``tpuvae/train/loop.py:205-243``): a permutation drawn from
    ``generator``, one gather of every training array, the full batches
    and the ragged remainder (one optimizer step each), then the
    validation pass in eval mode.  The sums are 0-d float32 tensors on the
    device (``val_sum`` is 0 without ``val_data``); nothing is read on the
    host, so the function can be captured as a CUDA graph."""
    dev = train_data[0].device
    n = int(train_data[0].shape[0])

    def epoch():
        perm = torch.randperm(n, generator=generator, device=dev)
        model.train()
        train_sum = _loss_sum(
            model, loss_fn,
            _resident_batches(tuple(d[perm] for d in train_data), batch_size),
            dev, generator, True, optimizer)
        if val_data is None:
            return train_sum, torch.zeros((), device=dev)
        model.eval()
        val_sum = _loss_sum(model, loss_fn,
                            _resident_batches(val_data, batch_size), dev,
                            generator, False)
        return train_sum, val_sum

    return epoch


def _release(optimizer, *runs) -> None:
    """At the end of a loop, also on an error: its graphs and the gradients
    that live in their memory pools go, and the pools with them."""
    graphed = [r for r in runs if isinstance(r, graphs.CapturedGraph)]
    if graphed:
        optimizer.zero_grad(set_to_none=True)
        for run in graphed:
            run.close()


class _StreamSteps:
    """The host_stream epoch's steps as functions of static device inputs
    (counterpart of ``tpuvae/train/loop.py:260-314``: ``jax.jit(train_step)``
    and ``_val_batch_loss``): one training step and one validation batch
    for each batch shape (the full batch and the ragged remainder), each a
    CUDA graph on a card after its first call (:func:`graphs.runner`).  A
    call copies the staged batch into its shape's static inputs on the
    caller's stream, then runs the step, which adds the batch's loss to
    :attr:`train_sum` or :attr:`val_sum` on the device."""

    def __init__(self, model, optimizer, loss_fn, generator: torch.Generator,
                 device: torch.device, batch_size: int):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.generator = generator
        self.device = device
        self.batch_size = batch_size
        self.train_sum = torch.zeros((), device=device)
        self.val_sum = torch.zeros((), device=device)
        self.steps: dict = {}       # (train, rows) -> (static inputs, run)

    def begin_epoch(self) -> None:
        self.train_sum.zero_()
        self.val_sum.zero_()

    def __call__(self, batch, train: bool) -> None:
        key = (train, int(batch[0].shape[0]))
        if key not in self.steps:
            static = tuple(torch.empty_like(b) for b in batch)
            step = self._train if train else self._val
            self.steps[key] = (static, graphs.runner(
                lambda: step(static), self.device, generator=self.generator,
                reserve_batch=self.batch_size, what="the host_stream step"))
        static, run = self.steps[key]
        for s, b in zip(static, batch):
            s.copy_(b)
        run()

    def _train(self, batch) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.loss_fn(self.model, batch, self.generator, True)
        loss.backward()
        self.optimizer.step()
        self.train_sum.add_(loss.detach())

    def _val(self, batch) -> None:
        with torch.no_grad():
            loss, _ = self.loss_fn(self.model, batch, self.generator, False)
        self.val_sum.add_(loss)

    def runs(self) -> list:
        return [run for _, run in self.steps.values()]


def _dp_graph_choice(group, device: torch.device) -> tuple[bool, str]:
    """Whether the data-parallel epoch runs as a CUDA graph, and why: on a
    card whose backend in ``group`` is NCCL (a capture takes its
    collectives once the communicator exists); gloo's pass through the
    host, which a capture cannot take."""
    if device.type != "cuda":
        return False, f"data on {device.type}"
    backend = str(dist.get_backend(group))
    if ":" in backend:      # one backend per device type: 'cpu:gloo,cuda:nccl'
        backend = dict(b.split(":") for b in backend.split(","))["cuda"]
    if backend != "nccl":
        return False, (f"{backend} on cuda: its collectives pass through "
                       "the host")
    return True, "nccl on cuda"


def dp_epoch_runner(dp_epoch: DPEpoch, state: TrainState, data,
                    device: torch.device, logger: RunLogger | None = None):
    """``run() -> (train_sum, val_sum)``: ``dp_epoch``'s body on this rank's
    blocks ``data`` (:meth:`DPEpoch.run`), as a CUDA graph where
    :func:`_dp_graph_choice` allows and eagerly elsewhere; the choice and
    its reason are logged once (``dp_epoch_graph``).  The caller seeds the
    epoch (:meth:`DPEpoch.seed`) before each call; the generator it seeds
    is the graph's."""
    graphed, reason = _dp_graph_choice(dp_epoch.group, device)
    if logger is not None:
        logger.log("dp_epoch_graph", graph=graphed, reason=reason)
    body = functools.partial(dp_epoch.run, state, *data)
    if not graphed:
        return body
    return graphs.CapturedGraph(
        body, device, generator=dp_epoch.generator(device),
        reserve_batch=dp_epoch.local_batch, what="the data-parallel epoch")


class _DeviceControl:
    """Early stopping, ReduceLROnPlateau and best-weights tracking on the
    device (``tpuvae/train/loop.py:513-593``), around a resident epoch.

    The counters are 0-d tensors: ``best`` and ``plateau_best`` float32
    (the monitored loss is compared in float32 on the device, where the
    host loop compares float64: they part only on exact float32 ties),
    ``best_epoch``, the patience and plateau counters int64, ``stopped``
    bool, and the learning rate the optimizer's own float64 tensor.  A call
    runs one epoch and updates them with ``torch.where`` in the JAX order,
    plateau first, then early stop; it writes the epoch's row of ``rows``
    (train loss, val loss, lr used, ran, stopped, best epoch) at ``slot``.

    An epoch that starts stopped changes nothing: the first call (which
    runs only when the host knows the run is live) records what an epoch
    updates (parameters, BatchNorm buffers, Adam's moments and step), and
    every later call copies them first and puts the copies back when the
    run had stopped, as ``lax.cond`` skips the epoch in the JAX package.
    The frozen epoch's draws still advance the generator.
    """

    def __init__(self, cfg: "FitConfig", state: TrainState, epoch, *,
                 denom: int, vdenom: int, best: float, best_epoch: int,
                 patience: int, plateau_best: float, plateau_counter: int,
                 snapshot: dict | None):
        model = state.model
        self.cfg = cfg
        self.state = state
        self.epoch_fn = epoch
        self.lr = traced_learning_rate(state)
        dev = self.lr.device
        self.denom, self.vdenom = float(denom), float(vdenom or 1)
        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        self.best = torch.tensor(best, **f32)
        self.best_epoch = torch.tensor(best_epoch, **i64)
        self.patience = torch.tensor(patience, **i64)
        self.plateau_best = torch.tensor(plateau_best, **f32)
        self.plateau_cnt = torch.tensor(plateau_counter, **i64)
        # a resumed run that had stopped never calls this
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.epoch = torch.zeros((), **i64)
        self.slot = torch.zeros((), **i64)
        k = max(int(cfg.scan_epochs), 1)
        self.rows = torch.zeros((k, 6), dtype=torch.float64, device=dev)
        self.row_ids = torch.arange(k, **i64)[:, None]
        self.keys = list(model.state_dict().keys())
        self.live_state = list(model.state_dict().values())
        self.snap = None
        if cfg.restore_best:
            self.snap = [(snapshot[k] if snapshot is not None else v)
                         .detach().clone()
                         for k, v in zip(self.keys, self.live_state)]
        self.frozen = None
        self.saved = None

    def begin_chunk(self, first_epoch: int) -> None:
        self.slot.zero_()
        self.epoch.fill_(first_epoch)

    def __call__(self) -> torch.Tensor:
        if self.frozen is not None:
            for s, t in zip(self.saved, self.frozen):
                s.copy_(t)
        live = ~self.stopped
        train_sum, val_sum = self.epoch_fn()
        if self.frozen is None:
            opt_state = self.state.optimizer.state
            self.frozen = self.live_state + [
                t for p in self.state.model.parameters() if p in opt_state
                for t in opt_state[p].values() if isinstance(t, torch.Tensor)]
            self.saved = [torch.empty_like(t) for t in self.frozen]
        else:
            for t, s in zip(self.frozen, self.saved):
                t.copy_(torch.where(live, t, s))
        self._control(live, train_sum / self.denom, val_sum / self.vdenom)
        return self.rows

    def _control(self, live, train_loss, val_loss) -> None:
        cfg = self.cfg
        monitored = train_loss if cfg.monitor == "train" else val_loss
        lr_used = self.lr.clone()
        if cfg.plateau_patience is not None:
            p_imp = monitored < self.plateau_best
            p_best = torch.minimum(monitored, self.plateau_best)
            p_cnt = torch.where(p_imp, 0, self.plateau_cnt + 1)
            reduce_now = p_cnt > cfg.plateau_patience
            new_lr = torch.where(reduce_now, lr_used * cfg.plateau_factor,
                                 lr_used)
            p_cnt = torch.where(reduce_now, 0, p_cnt)
            self.plateau_best.copy_(torch.where(live, p_best,
                                                self.plateau_best))
            self.plateau_cnt.copy_(torch.where(live, p_cnt, self.plateau_cnt))
            self.lr.copy_(torch.where(live, new_lr, lr_used))
        imp = live & (monitored < self.best)
        self.best.copy_(torch.where(imp, monitored, self.best))
        self.best_epoch.copy_(torch.where(imp, self.epoch, self.best_epoch))
        self.patience.copy_(torch.where(
            live, torch.where(imp, 0, self.patience + 1), self.patience))
        self.stopped.copy_(self.patience >= cfg.patience)
        if self.snap is not None:
            for s, t in zip(self.snap, self.live_state):
                s.copy_(torch.where(imp, t, s))
        zero = torch.zeros((), dtype=torch.float64, device=live.device)
        row = torch.stack([
            torch.where(live, train_loss.double(), zero),
            torch.where(live, val_loss.double(), zero),
            torch.where(live, lr_used, zero),
            live.double(), self.stopped.double(),
            self.best_epoch.double()])
        self.rows.copy_(torch.where(self.row_ids == self.slot, row, self.rows))
        self.slot.add_(1)
        self.epoch.add_(1)

    def counters(self) -> dict:
        """The counters as the checkpoint's metadata takes them (one host
        read)."""
        with span("fit.host_read"):
            v = torch.stack([
                self.best.double(), self.best_epoch.double(),
                self.patience.double(), self.plateau_best.double(),
                self.plateau_cnt.double()]).cpu().tolist()
        return {"best": v[0], "best_epoch": int(v[1]),
                "patience_counter": int(v[2]), "plateau_best": v[3],
                "plateau_counter": int(v[4])}

    def best_state(self) -> dict:
        return dict(zip(self.keys, self.snap))


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
    """Train ``state``; the control runs between epochs on the host, or
    with ``cfg.scan_epochs > 1`` on the device, K epochs per host read.

    ``train_data``/``val_data`` are tuples of equal-length tensors on the
    model's device — or, with ``cfg.host_stream``, of host arrays (numpy,
    ``np.memmap``, ``RowView``); batches index dim 0.  The shuffles,
    dropout masks and reparameterisation noise come from one
    ``torch.Generator`` on the model's device, seeded with ``cfg.seed``.
    On a card the resident epoch, the data-parallel epoch over NCCL and
    each host_stream step are CUDA graph replays after their first call
    (:class:`tpuvae_torch.graphs.CapturedGraph`); ``loss_fn`` must then
    read nothing on the host, or the capture raises.

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

    ``history["epoch_seconds"]`` (the port's own) holds each epoch's wall
    time up to its host read; under ``scan_epochs > 1`` an epoch gets its
    chunk's wall time over the epochs that ran in the chunk.  The call is
    the span ``fit`` and each host read of the losses the span
    ``fit.host_read`` (:func:`tpuvae_torch.utils.logging.span`).
    """
    with span("fit"):
        return _fit(state, loss_fn, train_data, cfg, val_data, logger, mesh,
                    loss_reduction)


def _fit(state: TrainState, loss_fn: LossFn,
         train_data: Sequence[torch.Tensor], cfg: FitConfig,
         val_data: Sequence[torch.Tensor] | None, logger: RunLogger | None,
         mesh, loss_reduction: str) -> FitResult:
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
    n_val = val_batches = 0
    if val_data is not None:
        val_data = tuple(val_data)
        n_val = int(val_data[0].shape[0])
        val_batches = -(-n_val // bs)
        if dp:
            n_val, val_data, val_batches = _dp_blocks(
                mesh, dp_axis, val_data, bs, logger, "dropped_val_rows")
    # rank 0 of a process group writes the checkpoints, also where the
    # ranks train unsharded copies (a batch that does not divide over D)
    writer = not dist.is_initialized() or dist.get_rank() == 0
    if cfg.scan_epochs > 1 and (dp or stream) and logger is not None:
        logger.log("scan_epochs_ignored",
                   reason="dp mesh epoch active" if dp
                   else "host_stream epoch active")

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
    stopped = epoch >= 0 and patience_counter >= cfg.patience
    denom = n_batches if cfg.loss_normalizer == "per_batch" else n
    vdenom = val_batches if cfg.loss_normalizer == "per_batch" else n_val
    run_epoch = steps = None
    if dp:
        dp_epoch = make_dp_epoch(
            loss_fn, mesh, batch_size=bs, n_local=n // n_dev,
            n_train_arrays=len(train_data),
            n_val_arrays=len(val_data) if val_data is not None else 0,
            n_val_local=n_val // n_dev if val_data is not None else 0,
            loss_reduction=loss_reduction, axis=dp_axis)
        run_epoch = dp_epoch_runner(dp_epoch, state,
                                    (*train_data, *(val_data or ())), dev,
                                    logger)
    elif stream:
        steps = _StreamSteps(model, optimizer, loss_fn, gen, dev, bs)
    else:
        run_epoch = resident_epoch(model, optimizer, loss_fn, train_data,
                                   val_data, bs, gen)
        if cfg.scan_epochs > 1:
            ctl = _DeviceControl(
                cfg, state, run_epoch, denom=denom, vdenom=vdenom,
                best=best, best_epoch=best_epoch, patience=patience_counter,
                plateau_best=plateau_best, plateau_counter=plateau_counter,
                snapshot=best_snapshot)
            return _fit_chunked(
                state, cfg, ctl, gen, dev, history, start_epoch=epoch + 1,
                stopped=stopped, best_epoch=best_epoch,
                had_snapshot=best_snapshot is not None, n_batches=n_batches,
                has_val=val_data is not None, logger=logger, writer=writer,
                t0=t0)
        run_epoch = graphs.runner(run_epoch, dev, generator=gen,
                                  reserve_batch=bs)

    total_steps = 0
    host_reads = 0
    try:
        for epoch in range(cfg.epochs if stopped else epoch + 1, cfg.epochs):
            t_epoch = time.perf_counter()
            if stream:
                perm = torch.randperm(n, generator=gen, device=dev)
                steps.begin_epoch()
                model.train()
                for batch in _host_batches(stager, train_data, bs,
                                           perm.cpu().numpy()):
                    steps(batch, True)
                if val_data is not None:
                    model.eval()
                    for batch in _host_batches(stager, val_data, bs):
                        steps(batch, False)
                loss_sum, val_total = steps.train_sum, steps.val_sum
            else:
                if dp:
                    dp_epoch.seed(cfg.seed * 1_000_003 + epoch, dev)
                loss_sum, val_total = run_epoch()
            total_steps += n_batches

            # ONE host read for both sums
            with span("fit.host_read"):
                sums = (torch.stack([loss_sum, val_total]).double().cpu()
                        .tolist())
            host_reads += 1
            train_loss = sums[0] / denom
            history["train_loss"].append(train_loss)
            history["lr"].append(lr)
            if val_data is not None:
                val_loss = sums[1] / vdenom
                history["val_loss"].append(val_loss)
            monitored = train_loss if cfg.monitor == "train" else val_loss
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
                                        {"epoch": epoch,
                                         "monitored": monitored})
            else:
                patience_counter += 1

            if logger is not None and (epoch + 1) % cfg.log_every == 0:
                logger.log(
                    "epoch", epoch=epoch + 1, train_loss=train_loss,
                    val_loss=(history["val_loss"][-1]
                              if val_data is not None else None),
                    lr=lr,
                )
            if cfg.checkpoint_dir and (epoch + 1) % cfg.checkpoint_every == 0:
                _save(cfg, state, gen, logger, writer, dp, epoch,
                      {"best": best, "best_epoch": best_epoch,
                       "patience_counter": patience_counter,
                       "plateau_best": plateau_best,
                       "plateau_counter": plateau_counter, "lr": lr,
                       "history": history})
            if patience_counter >= cfg.patience:
                break
    finally:
        _release(optimizer, run_epoch, *(steps.runs() if stream else ()))

    if cfg.restore_best and best_snapshot is not None:
        model.load_state_dict(best_snapshot)

    elapsed = time.time() - t0
    return FitResult(
        state=state,
        history=history,
        best_epoch=best_epoch,
        stopped_epoch=epoch,
        steps_per_sec=total_steps / max(elapsed, 1e-9),
        host_reads=host_reads,
    )


def _save(cfg: FitConfig, state: TrainState, gen, logger, writer: bool,
          dp: bool, epoch: int, meta: dict) -> None:
    """The rotation checkpoint of ``epoch`` (``meta``: the loop's counters
    and history), written by rank 0; every rank of a mesh waits for it."""
    t_save = time.perf_counter()
    if writer:
        saved = CheckpointManager(
            cfg.checkpoint_dir, cfg.checkpoint_keep).save(
            state, {"epoch": epoch, **meta}, step=epoch, generator=gen)
        if logger is not None:
            logger.log("checkpoint_saved", dir=str(saved), epoch=epoch,
                       seconds=time.perf_counter() - t_save)
    if dp:
        dist.barrier()      # every rank sees the checkpoint


def _fit_chunked(state: TrainState, cfg: FitConfig, ctl: _DeviceControl,
                 gen, dev, history, *, start_epoch: int, stopped: bool,
                 best_epoch: int, had_snapshot: bool, n_batches: int,
                 has_val: bool, logger, writer: bool, t0: float) -> FitResult:
    """``cfg.scan_epochs`` epochs per host read (counterpart of
    ``tpuvae/train/loop.py:483-663``): each epoch is one call of ``ctl`` (a
    CUDA graph replay on a card), the K epochs of a chunk run back to back,
    or fewer in the budget's last chunk, and the host reads the chunk's
    rows once.  Epochs past the stop point change nothing, so the state
    returned is the state at the stopping epoch."""
    k_chunk = int(cfg.scan_epochs)
    initial_best_epoch = best_epoch
    run = graphs.runner(ctl, dev, generator=gen, reserve_batch=cfg.batch_size)
    total_steps = 0
    host_reads = 0
    epoch = start_epoch - 1
    next_epoch = start_epoch
    written_best = best_epoch
    try:
        while next_epoch < cfg.epochs and not stopped:
            t_chunk = time.perf_counter()
            k_run = min(k_chunk, cfg.epochs - next_epoch)
            ctl.begin_chunk(next_epoch)
            for _ in range(k_run):
                rows = run()
            with span("fit.host_read"):
                rows = rows[:k_run].cpu().tolist()  # ONE host read / chunk
            host_reads += 1
            ran = 0
            for i, (tl, vl, lr, live, stf, _) in enumerate(rows):
                if not live:
                    break
                ran += 1
                epoch = next_epoch + i
                history["train_loss"].append(tl)
                history["lr"].append(lr)
                if has_val:
                    history["val_loss"].append(vl)
                total_steps += n_batches
                if logger is not None and (epoch + 1) % cfg.log_every == 0:
                    logger.log("epoch", epoch=epoch + 1, train_loss=tl,
                               val_loss=vl if has_val else None, lr=lr)
                if stf:
                    stopped = True
                    break
            best_epoch = int(rows[-1][5])
            chunk_s = time.perf_counter() - t_chunk
            history["epoch_seconds"].extend([chunk_s / max(ran, 1)] * ran)
            if cfg.checkpoint_dir and ((epoch + 1) // cfg.checkpoint_every
                                       > next_epoch // cfg.checkpoint_every):
                counters = ctl.counters()
                host_reads += 1
                _save(cfg, state, gen, logger, writer, False, epoch,
                      {**counters, "lr": get_learning_rate(state),
                       "history": history})
                moved = counters["best_epoch"] > written_best
                if ctl.snap is not None and moved:
                    written_best = counters["best_epoch"]
                    if writer:
                        save_checkpoint(Path(cfg.checkpoint_dir) / "best",
                                        ctl.best_state(),
                                        {"epoch": written_best,
                                         "monitored": counters["best"]})
            next_epoch += k_chunk
    finally:
        _release(state.optimizer, run)

    if ctl.snap is not None and (had_snapshot
                                 or best_epoch > initial_best_epoch):
        state.model.load_state_dict(ctl.best_state())
    elapsed = time.time() - t0
    return FitResult(
        state=state,
        history=history,
        best_epoch=best_epoch,
        stopped_epoch=epoch,
        steps_per_sec=total_steps / max(elapsed, 1e-9),
        host_reads=host_reads,
    )


def train_val_split(n: int, val_fraction: float,
                    seed: int) -> tuple[np.ndarray, np.ndarray]:
    """85/15-style random split (ref ``Conditional_VAE.py:381-383``): the
    JAX package's, row for row (``numpy.random.default_rng(seed)``)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int((1.0 - val_fraction) * n)
    return perm[:n_train], perm[n_train:]
