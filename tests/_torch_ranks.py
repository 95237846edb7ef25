"""Rank workers for the port's mesh tests (imported by
``tests/test_torch_{mesh,dp,long}.py``; pytest does not collect it).

:func:`run_ranks` starts ``world_size`` fresh interpreters of this file
(``cwd`` and ``PYTHONPATH`` the repository root).  Each joins one gloo
process group on a ``FileStore`` under the test's temporary directory,
runs the named cases in order with one CPU thread, and pickles its
``{case: result}`` for the test to read.  Every child and every
collective has a timeout, and a rank that dies or hangs fails the run:
the other ranks are killed and the failure's output is raised.

The children import torch and ``tpuvae_torch`` only; the JAX side of each
comparison runs in the test process.
"""

from __future__ import annotations

import io
import os
import pickle
import subprocess
import sys
import time
from contextlib import redirect_stdout
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
COLLECTIVE_TIMEOUT_S = 60
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def run_ranks(tmp_path: Path, world_size: int, cases: list, *,
              timeout: float = 240.0) -> list[dict]:
    """Run ``cases`` (``[(name, kwargs), ...]``) on ``world_size`` ranks;
    returns each rank's ``{name: result}``, rank 0 first."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    spec = tmp_path / "cases.pkl"
    spec.write_bytes(pickle.dumps(cases))
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for key in ("TPUVAE_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    logs = [tmp_path / f"rank{r}.log" for r in range(world_size)]
    procs = []
    for r in range(world_size):
        with open(logs[r], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(world_size),
                 str(store), str(spec), str(tmp_path)],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout} s"
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n"
                          + logs[r].read_text(errors="replace")[-4000:]
                          for r in range(world_size))
        raise AssertionError(f"{failed}\n{tails}")
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
            for r in range(world_size)]


def _np(t):
    """A tensor (or DTensor) as a host array."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy().copy()


def _state(model) -> dict:
    return {k: _np(v) for k, v in model.state_dict().items()}


class _Log:
    """A logger that keeps its events."""

    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


def _count_calls(module, names, counts):
    """Wrap ``module.<name>`` for each name so each call is counted."""
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(module, name, wrapped)


# -- test_torch_mesh.py ----------------------------------------------------------

@case
def mesh_basics(rank, ws):
    from tpuvae_torch.parallel import make_mesh

    full = make_mesh((-1,), ("data",), device="cpu")
    one = make_mesh((1,), ("data",), device="cpu")
    grid = make_mesh((1, -1), ("data", "model"), device="cpu")
    try:
        make_mesh((16,), ("data",), device="cpu")
        err = None
    except ValueError as e:
        err = str(e)
    return {"full": full.size(), "one": one.size(),
            "one_coordinate": one.get_coordinate(),
            "grid": tuple(grid.shape), "grid_names": grid.mesh_dim_names,
            "error": err}


@case
def roundtrip(rank, ws, x):
    from torch.distributed.tensor import Replicate, Shard

    from tpuvae_torch.parallel import MeshContext, all_gather_latents

    ctx = MeshContext.create(device="cpu")
    arr, n = ctx.shard(x)
    rep = ctx.replicate({"w": np.ones(3, np.float32)})["w"]
    return {"n": n, "shape": tuple(arr.shape),
            "local": _np(arr.to_local()),
            "placements": arr.placements == (Shard(0),),
            "back": all_gather_latents(arr, n),
            "replicated": rep.placements == (Replicate(),)
            and tuple(rep.to_local().shape) == (3,)}


@case
def silhouette(rank, ws, x, labels):
    from tpuvae_torch.metrics import compact_labels, silhouette_sharded
    from tpuvae_torch.parallel import make_mesh

    mesh = make_mesh((-1,), ("data",), device="cpu")
    out = []
    for lab in labels:
        lab, k = compact_labels(lab)
        out.append(silhouette_sharded(x, lab, k, mesh))
    return out


@case
def preprocess(rank, ws, cfg):
    from tpuvae_torch import pipelines
    from tpuvae_torch.io import resume
    from tpuvae_torch.parallel import MeshContext

    counts = {}
    _count_calls(pipelines, ["save_basic"], counts)
    _count_calls(resume.ExtractionManifest, ["add_shard", "cleanup"], counts)
    out = pipelines.preprocess_basic(
        cfg, device="cpu", logger=_Log(),
        mesh=MeshContext.create(device="cpu"))
    return {"n": out["n"], "failed": out["failed"], "writes": counts}


@case
def encode(rank, ws, results_dir, data_dir, paths):
    from tpuvae_torch.infer import ClipEncoder
    from tpuvae_torch.parallel import MeshContext

    ctx = MeshContext.create(device="cpu")
    enc = ClipEncoder.load("simple", results_dir=results_dir,
                           data_dir=data_dir, device="cpu")
    sharded = enc.encode_paths(paths, batch_size=3, mesh=ctx)
    # batches of 2: the rows each rank's block of a sharded batch holds
    plain = enc.encode_paths(paths, batch_size=2)
    return {"sharded": (sharded.latents, sharded.clusters, sharded.paths),
            "plain": (plain.latents, plain.clusters, plain.paths)}


@case
def cli_encode_mesh(rank, ws, argv):
    from tpuvae_torch import cli

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(list(argv))
    return {"rc": rc, "stdout": buf.getvalue()}


@case
def conditional_vae(rank, ws, data_dir, results_dir):
    from tpuvae_torch import infer, pipelines
    from tpuvae_torch.config import ClusterConfig, ConditionalVAEConfig
    from tpuvae_torch.parallel import MeshContext
    from tpuvae_torch.train import loop

    counts = {}
    _count_calls(pipelines, ["save_serving_model", "consolidate_metrics"],
                 counts)
    _count_calls(infer, ["save_checkpoint"], counts)
    _count_calls(loop.CheckpointManager, ["save"], counts)
    log = _Log()
    cfg = ConditionalVAEConfig(epochs=2, batch_size=8, latent_dim=8,
                               checkpoint_every=1)
    df = pipelines.run_conditional_vae(
        data_dir, results_dir, cfg, ClusterConfig(), log, make_plots=False,
        device="cpu", mesh=MeshContext.create(device="cpu"))
    fit = next(f for e, f in log.events if e == "fit")
    return {"df": df, "writes": counts,
            "events": [e for e, _ in log.events],
            "train_loss": fit["train_loss"], "val_loss": fit["val_loss"]}


# -- test_torch_dp.py ------------------------------------------------------------

def _sum_ae_objective():
    def loss_fn(model, batch, generator, train):
        (x,) = batch
        recon, _ = model(x)
        return ((recon - x) ** 2).sum(), {}

    return loss_fn


def _ae(flat, lr):
    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.models import SimpleAutoencoder
    from tpuvae_torch.train import create_state

    model = SimpleAutoencoder(input_dim=12, latent_dim=4)
    model.load_state_dict(from_flax(flat))
    return create_state(model, lr)


@case
def ae_fullbatch(rank, ws, x, flat, reduction, lr):
    import torch

    from tpuvae_torch.parallel import make_mesh
    from tpuvae_torch.train import FitConfig, autoencoder_objective, fit

    obj = (autoencoder_objective() if reduction == "mean"
           else _sum_ae_objective())
    cfg = FitConfig(epochs=3, batch_size=64, patience=99, seed=0)
    mesh = make_mesh((ws,), ("data",), device="cpu")
    res_dp = fit(_ae(flat, lr), obj, (torch.from_numpy(x),), cfg,
                 mesh=mesh, loss_reduction=reduction)
    res_1 = fit(_ae(flat, lr), obj, (torch.from_numpy(x),), cfg)
    return {"dp": (res_dp.history["train_loss"], _state(res_dp.state.model)),
            "single": (res_1.history["train_loss"],
                       _state(res_1.state.model))}


@case
def ae_fullbatch_sum(rank, ws, x, flat, lr):
    return ae_fullbatch(rank, ws, x, flat, "sum", lr)


@case
def val_remainder(rank, ws, x, v, flat):
    import torch

    from tpuvae_torch.parallel import make_dp_epoch, make_mesh
    from tpuvae_torch.train import autoencoder_objective

    mesh = make_mesh((ws,), ("data",), device="cpu")
    state = _ae(flat, 1e-3)
    before = _state(state.model)
    n, nv = len(x) // ws, len(v) // ws
    epoch = make_dp_epoch(autoencoder_objective(), mesh, batch_size=4,
                          n_local=n, n_train_arrays=1, n_val_arrays=1,
                          n_val_local=nv, loss_reduction="mean")
    xs, vs = torch.from_numpy(x), torch.from_numpy(v)
    state, loss, val = epoch(state, 7, xs[rank * n:(rank + 1) * n],
                             vs[rank * nv:(rank + 1) * nv])
    return {"loss": float(loss), "val": float(val), "before": before,
            "after": _state(state.model)}


@case
def batch_norm(rank, ws, x, v, x_one):
    import torch

    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.parallel import make_dp_epoch, make_mesh
    from tpuvae_torch.train import (
        FitConfig,
        create_state,
        fit,
        simple_vae_objective,
    )

    mesh = make_mesh((ws,), ("data",), device="cpu")

    def model():
        return SimpleVAE(input_dim=12, hidden_dims=(8, 6), latent_dim=4,
                         generator=torch.Generator().manual_seed(0))

    # one step over one local batch: the running statistics are the old
    # ones moved by the mean of the ranks' batch statistics
    state = create_state(model(), 1e-3)
    n = len(x_one) // ws
    local = torch.from_numpy(x_one[rank * n:(rank + 1) * n])
    with torch.no_grad():
        h = state.model.encoder.dense[0](local)
    local_stats = (_np(h.mean(0)), _np(h.var(0, unbiased=False)))
    epoch = make_dp_epoch(simple_vae_objective(), mesh, batch_size=ws * n,
                          n_local=n, n_train_arrays=1, loss_reduction="mean")
    state, _, _ = epoch(state, 3, local)
    norm = state.model.encoder.norm[0]
    one_step = {"local_stats": local_stats,
                "running": (_np(norm.running_mean), _np(norm.running_var))}

    # fit over the mesh: rows beyond a multiple of D trimmed and logged,
    # the statistics updated and the same on every rank
    log = _Log()
    state = create_state(model(), 1e-3)
    stats0 = {k: v_ for k, v_ in _state(state.model).items()
              if "running" in k}
    res = fit(state, simple_vae_objective(), (torch.from_numpy(x),),
              FitConfig(epochs=2, batch_size=4, patience=99, monitor="val",
                        seed=0),
              val_data=(torch.from_numpy(v),), logger=log, mesh=mesh,
              loss_reduction="mean")
    stats2 = {k: v_ for k, v_ in _state(res.state.model).items()
              if "running" in k}
    return {"one_step": one_step, "stats0": stats0, "stats2": stats2,
            "val_loss": res.history["val_loss"],
            "trims": [f for e, f in log.events if e == "dp_trim"]}


@case
def dp_errors(rank, ws):
    from tpuvae_torch import pipelines
    from tpuvae_torch.parallel import MeshContext, make_dp_epoch
    from tpuvae_torch.train import autoencoder_objective

    ctx = MeshContext.create(device="cpu")
    errors = []
    for kw in ({"batch_size": 4, "loss_reduction": "avg"},
               {"batch_size": 3}):
        try:
            make_dp_epoch(autoencoder_objective(), ctx.mesh, n_local=8,
                          n_train_arrays=1, **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    log = _Log()
    disabled = pipelines._fit_mesh(ctx, 5, log)
    enabled = pipelines._fit_mesh(ctx, 4, log)
    return {"errors": errors, "disabled": disabled is None,
            "enabled": enabled is ctx.mesh, "events": log.events}


def _hybrid(seed=0):
    import torch

    from tpuvae_torch.models import HybridVAE

    return HybridVAE(latent_dim=16, text_dim=32, input_hw=(64, 64),
                     generator=torch.Generator().manual_seed(seed))


@case
def tp_dp(rank, ws, audio, text):
    import copy

    import torch
    from torch.distributed.tensor import DTensor

    from tpuvae_torch.parallel import make_mesh, make_tp_dp_train_step
    from tpuvae_torch.parallel.dp import rank_seed
    from tpuvae_torch.parallel.tp import tp_state_sharding
    from tpuvae_torch.train import TrainState, create_state, hybrid_objective

    mesh = make_mesh((1, ws), ("data", "model"), device="cpu")
    obj = hybrid_objective()
    batch = (torch.from_numpy(audio), torch.from_numpy(text))
    base = _hybrid()

    # the plain single-rank step: SGD, as the JAX test (Adam's first step
    # is lr x sign(g), which flips on rounding-level gradients)
    single = copy.deepcopy(base)
    opt = torch.optim.SGD(single.parameters(), lr=1e-3)
    single.train()
    opt.zero_grad()
    gen = torch.Generator().manual_seed(rank_seed(0, 0))
    loss_1, _ = obj(single, batch, gen, True)
    loss_1.backward()
    opt.step()

    tp_model = copy.deepcopy(base)
    state = TrainState(tp_model, torch.optim.SGD(tp_model.parameters(),
                                                 lr=1e-3))
    step = make_tp_dp_train_step(obj, mesh, big=512, loss_reduction="sum")
    state, loss_tp = step(state, batch, 0)
    w = state.model.audio_decoder_fc.weight

    # Adam's moments follow the placed parameters
    adam = create_state(copy.deepcopy(base), 1e-3)
    adam_step = make_tp_dp_train_step(obj, mesh, big=512,
                                      loss_reduction="sum")
    adam, _ = adam_step(adam, batch, 0)
    aw = adam.model.audio_decoder_fc.weight
    moments = adam.optimizer.state[aw]
    return {"loss_tp": float(loss_tp), "loss_1": float(loss_1.detach()),
            "tp": {k: _np(v) for k, v in state.model.state_dict().items()},
            "single": _state(single),
            "weight": (isinstance(w, DTensor), tuple(w.to_local().shape),
                       str(w.placements)),
            "moments": [(isinstance(moments[k], DTensor),
                         str(moments[k].placements),
                         tuple(moments[k].to_local().shape))
                        for k in ("exp_avg", "exp_avg_sq")],
            "rule": {k: [str(p) for p in v] for k, v in tp_state_sharding(
                create_state(_hybrid(), 1e-3), mesh, big=512).items()}}


@case
def tp_indivisible(rank, ws):
    import torch

    from tpuvae_torch.parallel import make_mesh, tp_state_sharding
    from tpuvae_torch.train import create_state

    mesh = make_mesh((1, ws), ("data", "model"), device="cpu")
    try:
        tp_state_sharding(create_state(torch.nn.Linear(513, 4), 1e-3), mesh,
                          big=512)
        return None
    except ValueError as e:
        return str(e)


# -- test_torch_long.py ----------------------------------------------------------

@case
def framesharded(rank, ws, y, geometries, sr):
    import torch

    from tpuvae_torch.dsp import mel_image_framesharded, stft_power_framesharded
    from tpuvae_torch.parallel import MeshContext

    ctx = MeshContext.create(device="cpu")
    yt = torch.from_numpy(y)
    out = {}
    for n_fft, hop in geometries:
        for method in ("fft", "dft"):
            s, n = stft_power_framesharded(yt, ctx.mesh, n_fft, hop,
                                           method=method)
            out[(n_fft, hop, method)] = {
                "n": n, "global": tuple(s.shape), "local": tuple(
                    s.to_local().shape), "placements": str(s.placements),
                "power": _np(s)[..., :n]}
        mel, n = mel_image_framesharded(yt, ctx, sr, n_fft, hop, 32)
        out[(n_fft, hop, "mel")] = {"n": n, "placements": str(mel.placements),
                                    "mel": _np(mel)[..., :n]}
    return out


if __name__ == "__main__":
    import torch
    import torch.distributed as dist

    rank, world_size = int(sys.argv[1]), int(sys.argv[2])
    store, spec, out_dir = sys.argv[3], Path(sys.argv[4]), Path(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world_size), rank=rank,
        world_size=world_size,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    results = {}
    for name, kwargs in pickle.loads(spec.read_bytes()):
        results[name] = CASES[name](rank, world_size, **kwargs)
    (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.destroy_process_group()
