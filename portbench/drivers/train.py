"""A training cell: set-up, the measured ``fit`` calls, and the check.

Set-up makes the data and the initial weights on the device from the
seed, builds the port's model, Adam state, objective and ``FitConfig``
(``portbench/models/<family>.py``), then drives that same state through
one ``fit`` of two epochs at the cell's shapes: its eager first epoch,
whose first three optimizer steps the plain reference follows afterwards
(:class:`FirstSteps`), and the capture of the epoch as a CUDA graph with
its first replay.

The window is a fixed amount of work: as many epochs as fill
``--seconds`` at the cell's nominal epoch time
(``portbench/windows/<cell>.json``), in as few ``fit`` calls as hold
them with none longer than the configuration's own job (its ``epochs``;
:func:`window_plan`); a later fit goes on from the state the one before
left.  A fit's first chunk (the eager epoch, the capture, K - 1 replays)
is in the window, as every user's fit pays it; then one replay an epoch,
K per host read.  ``patience`` is a fit's epoch count, so the work is
fixed (and so is a plateau's patience, where the configuration has one:
``portbench/models/simple.py`` says why).  With ``--trace 1`` the
profiler records one steady stretch of whole chunks from the middle fit
(:mod:`portbench.profiling`), started and stopped by the fit's logger
between two chunks.

Each fit's epoch count is one more than a multiple of K, so the last
fit's last chunk is one replayed epoch.  Its logger copies the state
(weights, BatchNorm's statistics, Adam's moments, step and rate) after
the chunk before it and the weights after it (:class:`ReplayCheck`).

After the window the program's state is freed and the reference, in
float32 with TF32 off, takes (a) the same first three steps from the same
weights on the same rows with the same draws, and (b) the same replayed
epoch from the copied state, with the draws of that epoch worked out
again from the seed; :mod:`portbench.correct` compares both.
"""

from __future__ import annotations

import gc
import importlib
import math
import time
from types import SimpleNamespace

import torch

from portbench import correct, data, profiling
from portbench.reference import common

CHECKED_STEPS = 3
ADAM_BETA1 = 0.9


class Probe:
    """The fit's logger.  In a traced run it starts the profiler after the
    chunk in which epoch ``start_at`` ran and stops it after the next
    chunk that logs; the chunks between are the traced ones."""

    def __init__(self, k: int, start_at: int | None):
        self.k = k
        self.start_at = start_at
        self.window = profiling.SubWindow() if start_at is not None else None
        self.first_chunk = self.last_chunk = None

    def log(self, event: str, **fields) -> None:
        if event != "epoch" or self.window is None or self.window.done:
            return
        epoch = int(fields["epoch"]) - 1
        chunk = epoch // self.k
        if self.first_chunk is None and epoch >= self.start_at:
            self.first_chunk = chunk
            self.window.start()
        elif self.first_chunk is not None and chunk > self.first_chunk:
            self.last_chunk = chunk
            self.window.stop()

    def _epochs_from(self, chunk: int, epochs: int) -> range:
        end = epochs if self.last_chunk is None else min(
            epochs, (self.last_chunk + 1) * self.k)
        return range(chunk * self.k, end)

    def traced_epochs(self, epochs: int) -> range | None:
        """The epochs that ran while the profiler was on, or None."""
        if self.first_chunk is None:
            return None
        return self._epochs_from(self.first_chunk + 1, epochs)

    def touched_epochs(self, epochs: int) -> range:
        """The epochs whose chunk timing holds a start or a stop."""
        if self.first_chunk is None:
            return range(0)
        return self._epochs_from(self.first_chunk, epochs)


class FirstSteps:
    """What the set-up ``fit`` produces in its first ``CHECKED_STEPS``
    optimizer steps (its eager first epoch): each step's loss as the
    objective returns it, each parameter's first gradient as Adam's state
    holds it after one step (``exp_avg = (1 - beta1) g``), and each
    parameter's change over the steps, as norms by leaf.  The objective is
    wrapped to note the losses and Adam given a step hook; neither does
    anything once the steps are noted, so the graph captured later in the
    same ``fit`` is the unwrapped one."""

    def __init__(self, job: dict, init: dict):
        self.loss_fn = job["loss_fn"]
        self.names = {p: k for k, p in job["model"].named_parameters()}
        self.init = init
        self.losses: list = []
        self.steps = 0
        self.first_grad = self.change = None

    def objective(self, model, batch, generator, train):
        loss, aux = self.loss_fn(model, batch, generator, train)
        if train and len(self.losses) < CHECKED_STEPS:
            self.losses.append(loss.detach().clone())
        return loss, aux

    def after_step(self, opt, args, kwargs) -> None:
        if self.steps >= CHECKED_STEPS:
            return
        self.steps += 1
        if self.steps == 1:
            self.first_grad = {
                name: torch.linalg.vector_norm(
                    opt.state[p]["exp_avg"], dtype=torch.float64)
                / (1 - ADAM_BETA1) if p in opt.state else
                torch.zeros((), dtype=torch.float64, device=p.device)
                for p, name in self.names.items()}
        if self.steps == CHECKED_STEPS:
            self.change = {name: torch.linalg.vector_norm(
                p.detach() - self.init[name], dtype=torch.float64)
                for p, name in self.names.items()}
            self.init = None

    def readings(self) -> dict:
        """The noted values on the host (one read); a side that never took
        its steps gives none."""
        if self.change is None or self.first_grad is None:
            return {"losses": [], "first_grad": None, "change": {}}

        def host(d):
            keys = list(d)
            return dict(zip(keys, torch.stack([d[k] for k in keys])
                            .cpu().tolist()))

        return {"losses": torch.stack(self.losses).double().cpu().tolist(),
                "first_grad": host(self.first_grad),
                "change": host(self.change)}


def set_up_fit(job: dict, init: dict, epochs: int = 2):
    """The set-up ``fit`` of ``epochs`` epochs on the job's state (the eager
    epoch, then the capture and its replay), its first steps noted;
    returns ``(FitResult, readings)``."""
    from tpuvae_torch.train.loop import fit

    first = FirstSteps(job, init)
    handle = job["state"].optimizer.register_step_post_hook(first.after_step)
    try:
        res = fit(job["state"], first.objective, job["train"],
                  job["fit_config"](epochs), val_data=job["val"])
    finally:
        handle.remove()
    return res, first.readings()


def reference_data(dat: dict, precision: str) -> dict:
    """The shared inputs in the reference's precision."""
    dtype = common.DTYPES[precision]
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in dat.items()}


def reference_steps(ref, cfg: dict, dat: dict, seed: int, device,
                    precision: str = "fp32", fault: str | None = None) -> dict:
    """The same first steps in the plain reference, from the same initial
    weights made again from the seed."""
    model = ref.make_model(cfg, device, precision)
    model.load_state_dict(common.initial_state(model, seed, device))
    train, val = ref.splits(cfg, reference_data(dat, precision), seed)
    with common.precision_scope(precision, device):
        return common.train_steps(model, ref.objective(cfg), train, val,
                                  fit=ref.fit_settings(cfg),
                                  steps=CHECKED_STEPS, seed=seed, fault=fault)


class ReplayCheck:
    """The fit's logger for the checked epoch, the last of a fit of
    ``epochs`` epochs, which is one graph replay alone in its chunk: after
    the chunk before it (the log of epoch ``epochs - 1``) it copies the
    state an epoch starts from (every floating entry of the model's state
    dict, Adam's moments, step and rate); after the epoch (the log of epoch
    ``epochs``, before any restore of the best weights) the model's state
    dict again.  Copies on the device, no host read."""

    def __init__(self, job: dict, epochs: int):
        self.model = job["model"]
        self.opt = job["state"].optimizer
        self.epochs = epochs
        self.before = self.after = None

    def log(self, event: str, **fields) -> None:
        if event != "epoch":
            return
        epoch = int(fields["epoch"])
        if epoch == self.epochs - 1:
            self.before = self._copy(adam=True)
        elif epoch == self.epochs:
            self.after = self._copy(adam=False)

    def _copy(self, adam: bool) -> dict:
        out = {"state": {k: v.detach().clone() for k, v in
                         common.floating(self.model.state_dict()).items()}}
        if adam:
            st = self.opt.state
            params = list(self.model.named_parameters())
            out["m"] = {k: st[p]["exp_avg"].clone() for k, p in params}
            out["v"] = {k: st[p]["exp_avg_sq"].clone() for k, p in params}
            out["step"] = torch.as_tensor(st[params[0][1]]["step"]).clone()
            out["lr"] = torch.as_tensor(
                self.opt.param_groups[0]["lr"]).clone()
        return out

    def program(self, history: dict) -> dict | None:
        """What the program's replayed epoch produced: its losses as the
        fit reports them and each state entry's change over it."""
        if self.before is None or self.after is None:
            return None
        b, a = self.before["state"], self.after["state"]
        return {"train_loss": history["train_loss"][-1],
                "val_loss": (history["val_loss"][-1] if history["val_loss"]
                             else None),
                "change": common.leaf_norms({k: a[k] - b[k] for k in b})}


def reference_replay(ref, cfg: dict, dat: dict, seed: int, device,
                     before: dict, epochs_before: int,
                     precision: str = "fp32", fault: str | None = None
                     ) -> dict:
    """The checked epoch in the plain reference: from the program's state
    before it (``before``, a :class:`ReplayCheck` copy), with the draws of
    the fit's epoch ``epochs_before`` (counted from 0) worked out again
    from the seed.  ``fault`` as :func:`common.train_epoch`, or
    ``'frozen'``: the draws of epoch 1, the first replay's, as a graph
    that replays its captured draws would make."""
    model = ref.make_model(cfg, device, precision)
    train, val = ref.splits(cfg, reference_data(dat, precision), seed)
    fit_set = ref.fit_settings(cfg)
    loss_fn = ref.objective(cfg)
    names = [k for k, _ in model.named_parameters()]
    state = dict(model.state_dict())
    state.update(before["state"])
    with common.precision_scope(precision, device):
        model.load_state_dict(state)
        gen = common.generator_at(
            seed, 1 if fault == "frozen" else epochs_before,
            lambda g: common.epoch_draws(model, loss_fn, train, val,
                                         int(fit_set["batch_size"]), g),
            device)
        model.load_state_dict(state)
        opt = common.Adam(model.parameters(), float(before["lr"]))
        opt.load([before["m"][k] for k in names],
                 [before["v"][k] for k in names], int(before["step"]))
        out = common.train_epoch(model, opt, loss_fn, train, val,
                                 fit=fit_set, gen=gen,
                                 fault=fault if fault != "frozen" else None)
        after = common.floating(model.state_dict())
        out["change"] = common.leaf_norms(
            {k: after[k] - before["state"][k].to(after[k].dtype)
             for k in before["state"]})
    return out


def families(cfg: dict):
    """The config's port adapter and plain reference, found by name."""
    fam = cfg["family"]
    return (importlib.import_module(f"portbench.models.{fam}"),
            importlib.import_module(f"portbench.reference.{fam}"))


def set_up(spec: dict, seed: int, device):
    """The data, the initial weights and the port's job for the cell; a
    configuration whose ``dtype`` no reference computes in is refused
    first."""
    cfg = spec["config"]
    fam, ref = families(cfg)
    ref.precision_of(cfg)
    dat = data.make(cfg["inputs"], spec["traffic"], seed, device)
    names = ref.make_model(cfg, "meta")
    init = common.initial_state(names, seed, device)
    job = fam.build(cfg, spec["traffic"], init, dat, seed, device)
    return fam, ref, dat, init, job


def window_plan(seconds: float, epoch_s: float, k: int, cap: int) -> list[int]:
    """Epochs of each ``fit`` of the window: as many epochs as fill
    ``seconds`` at the nominal ``epoch_s``, in as few fits as hold them
    with none over ``cap`` (the configuration's job), all of one length,
    one more than a multiple of ``k`` (at least ``k + 1``), so that each
    fit's last chunk is one replayed epoch.  The same work in every run,
    whatever the host's clock reads in set-up."""
    total = max(k + 1, round(seconds / epoch_s))
    fits = -(-total // cap)
    per = max(k + 1, 1 + k * ((total // fits - 1) // k))
    return [per] * fits


class Tee:
    """One logger that passes every event to each of several."""

    def __init__(self, *loggers):
        self.loggers = [x for x in loggers if x is not None]

    def log(self, event: str, **fields) -> None:
        for x in self.loggers:
            x.log(event, **fields)


def measure(spec: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> SimpleNamespace:
    """Set-up and the window; the program's state freed after it.  Returns
    the record the metric readers take and what the check compares: the
    first steps' readings (``prog``), the replayed epoch's
    (``replay_prog``) and the state it started from (``before``)."""
    from tpuvae_torch.train.loop import fit

    cfg = spec["config"]
    stages = {"imports": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    fam, ref, dat, init, job = set_up(spec, seed, device)
    _sync(device)
    stages["data_weights_model"] = time.perf_counter() - t0
    del dat                 # the job holds its own rows; made again below
    k = job["scan_epochs"]
    t0 = time.perf_counter()
    warm, prog = set_up_fit(job, init)
    stages["set_up_fit"] = time.perf_counter() - t0
    del init, warm
    plan = window_plan(seconds, spec["window"]["epoch_s"], k,
                       int(cfg["epochs"]))
    traced_fit = len(plan) // 2 if trace else None
    probe = Probe(k, plan[traced_fit] // 2 if trace else None)
    check = ReplayCheck(job, plan[-1])
    results = []
    _sync(device)
    t_window = time.perf_counter()
    for i, epochs in enumerate(plan):
        logger = Tee(probe if i == traced_fit else None,
                     check if i == len(plan) - 1 else None)
        results.append(fit(job["state"], job["loss_fn"], job["train"],
                           job["fit_config"](epochs), val_data=job["val"],
                           logger=logger))
    _sync(device)
    t_end = time.perf_counter()
    if probe.window is not None:
        probe.window.stop()
    hists = [r.history for r in results]
    ran = sum(len(h["train_loss"]) for h in hists)
    failed = sum(not math.isfinite(x) for h in hists
                 for x in h["train_loss"] + h["val_loss"])
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    summary = probe.window.summary() if probe.window is not None else None
    traced_len = len(hists[traced_fit]["train_loss"]) if trace else 0
    record = SimpleNamespace(
        config=cfg, setup_s=t_window - t_start, window_s=t_end - t_window,
        stages=stages,
        epochs=ran, k=k, n_train=job["n_train"], n_val=job["n_val"],
        fits=[list(h["epoch_seconds"]) for h in hists],
        traced_fit=traced_fit,
        work=fam.work(cfg, job["n_train"], job["n_val"]),
        traced_epochs=probe.traced_epochs(traced_len),
        touched_epochs=probe.touched_epochs(traced_len),
        profile=summary,
        profile_overhead_s=probe.window.overhead_s if probe.window else 0.0,
        kind=(torch.cuda.get_device_name(device)
              if device.type == "cuda" else "cpu"))
    out = SimpleNamespace(
        record=record, ref=ref, prog=prog, replay_prog=check.program(hists[-1]),
        before=check.before, epochs_before=plan[-1] - 1, ran=ran,
        failed=failed, memory_peak=memory_peak, profile=summary)
    del results, hists, job, probe, check
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of the cell; returns what the harness prints and reads."""
    cfg = spec["config"]
    m = measure(spec, seed, seconds, trace, device, t_start)
    ref = m.ref
    dat = data.make(cfg["inputs"], spec["traffic"], seed, device)
    precision = ref.precision_of(cfg)
    t0 = time.perf_counter()
    refs = reference_steps(ref, cfg, dat, seed, device, precision)
    replay_ref = (reference_replay(ref, cfg, dat, seed, device, m.before,
                                   m.epochs_before, precision)
                  if m.replay_prog is not None else None)
    m.record.stages["reference_after_window"] = time.perf_counter() - t0
    exclude = spec["limits"]["exclude_below"]
    values = correct.readings(m.prog, refs, exclude)
    values.update(correct.replay_readings(m.replay_prog, replay_ref, exclude))
    ok, compared = correct.judge(values, spec["limits"])
    return {"record": m.record, "correct": ok and m.failed == 0,
            "attempted": m.ran, "failed": m.failed, "compared": compared,
            "memory_peak_bytes": m.memory_peak, "profile": m.profile}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
