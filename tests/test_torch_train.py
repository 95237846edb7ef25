"""The port's training path against the JAX package's, with carried weights.

A flax ``SimpleVAE(dropout=0.0)`` at full width is initialised through
``tpuvae.train.create_state`` and converted with
``tpuvae_torch.convert.simple_vae_from_flax``; both take the same batch
(16, 370) and the same reparameterisation noise, ``jax.random.normal`` of
the second half of ``jax.random.split(rng)`` (``tpuvae/train/objectives.py:15``).

Tolerances: loss, recon and KL 1e-6 relative and gradients atol 1e-5 (fp32
with another summation order); BatchNorm running statistics rtol 1e-6 (the
port stores flax's biased variance), the running means also atol 1e-8:
they are 0.01 x batch means of Dense outputs with zero bias, ~1e-3, whose
fp32 rounding (~1e-7 of the unit-scale activations) no relative bound
covers; parameters after three Adam steps atol 1e-6 against optax.

The Adam test hands both optimizers the JAX package's gradients.  Each
gradient computed on its own side would not do: the bias of a Dense layer
followed by BatchNorm has a gradient that is exactly 0 in exact arithmetic
and fp32 noise (~1e-10) in either framework, and Adam normalises that
noise into steps of up to the learning rate, so trained weights of the two
packages part by ~lr within a few steps.  They are held to each other
through the quality floors instead (``tpuvae/parity.py:157``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

BATCH = 16
LR = 1e-4
BETA = 0.8


def _flat(tree) -> dict:
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def _eps(rng, shape):
    return np.asarray(jax.random.normal(jax.random.split(rng)[1], shape))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's first training step and three steps after it."""
    from tpuvae.models import SimpleVAE
    from tpuvae.train import create_state, simple_vae_objective

    model = SimpleVAE(dropout=0.0)
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(0).normal(size=(BATCH, 370)).astype(np.float32)
    state = create_state(model, key, (jnp.asarray(x[:2]), key), LR, train=True)
    loss_fn = simple_vae_objective(BETA)

    def step(state, rng):
        def compute(params):
            variables = {"params": params, "batch_stats": state.batch_stats}
            loss, aux, new_ms = loss_fn(state, variables, (jnp.asarray(x),),
                                        rng, True)
            return loss, (aux, new_ms)

        (loss, (aux, new_ms)), grads = jax.value_and_grad(
            compute, has_aux=True)(state.params)
        new = state.apply_gradients(grads=grads).replace(
            batch_stats=new_ms["batch_stats"])
        return new, float(loss), {k: float(v) for k, v in aux.items()}, grads

    init = _flat({"params": state.params, "batch_stats": state.batch_stats})
    rngs = [jax.random.PRNGKey(10 + i) for i in range(3)]
    after1, loss, aux, grads = step(state, rngs[0])
    st, grad_seq = after1, [_flat({"params": grads})]
    for r in rngs[1:]:
        st, _, _, g = step(st, r)
        grad_seq.append(_flat({"params": g}))
    return {
        "x": x, "init": init, "loss": loss, "aux": aux,
        "grads": grad_seq[0], "grad_seq": grad_seq,
        "stats1": _flat({"batch_stats": after1.batch_stats}),
        "after3": _flat({"params": st.params}),
        "eps": _eps(rngs[0], (BATCH, 32)),
    }


def _port(flat):
    from tpuvae_torch.convert import simple_vae_from_flax
    from tpuvae_torch.models import SimpleVAE

    model = SimpleVAE(dropout=0.0)
    model.load_state_dict(simple_vae_from_flax(flat))
    return model.train()


def _port_step(model, x, eps):
    from tpuvae_torch.models import simple_vae_loss

    x = torch.tensor(x)
    recon, mu, logvar, _ = model(x, torch.tensor(eps))
    loss, rec, kl = simple_vae_loss(recon, x, mu, logvar, BETA)
    loss.backward()
    return loss, rec, kl


def test_one_step_loss_matches_flax(jax_run):
    model = _port(jax_run["init"])
    loss, rec, kl = _port_step(model, jax_run["x"], jax_run["eps"])
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-6)
    np.testing.assert_allclose(rec.item(), jax_run["aux"]["recon"], rtol=1e-6)
    np.testing.assert_allclose(kl.item(), jax_run["aux"]["kl"], rtol=1e-6)


def test_one_step_gradients_match_flax(jax_run):
    from tpuvae_torch.convert import simple_vae_to_flax

    model = _port(jax_run["init"])
    _port_step(model, jax_run["x"], jax_run["eps"])
    got = simple_vae_to_flax({n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(jax_run["grads"])
    for k, want in jax_run["grads"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5, err_msg=k)


def test_one_step_batchnorm_statistics_match_flax(jax_run):
    """The running variance moves with the batch's BIASED variance, as
    flax stores it (torch.nn.BatchNorm1d would use the unbiased one, a
    factor n / (n - 1) = 16/15 here)."""
    from tpuvae_torch.convert import simple_vae_to_flax

    model = _port(jax_run["init"])
    _port_step(model, jax_run["x"], jax_run["eps"])
    got = simple_vae_to_flax(model.state_dict())
    assert len(jax_run["stats1"]) == 12
    for k, want in jax_run["stats1"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                   atol=1e-8 if k.endswith("mean") else 0,
                                   err_msg=k)


def test_three_adam_steps_match_optax(jax_run):
    from tpuvae_torch.convert import simple_vae_from_flax, simple_vae_to_flax
    from tpuvae_torch.train.state import (
        create_state,
        get_learning_rate,
        param_count,
        set_learning_rate,
    )

    model = _port(jax_run["init"])
    state = create_state(model, 1.0)
    assert get_learning_rate(set_learning_rate(state, LR)) == LR
    assert param_count(model) == sum(v.size for v in jax_run["grads"].values())
    params = dict(model.named_parameters())
    for grads in jax_run["grad_seq"]:
        for name, g in simple_vae_from_flax(grads).items():
            params[name].grad = g
        state.optimizer.step()
    got = simple_vae_to_flax(dict(model.named_parameters()))
    assert set(got) == set(jax_run["after3"])
    for k, want in jax_run["after3"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-6, err_msg=k)


def test_init_follows_flax_distributions():
    """lecun_normal: each Dense kernel has mean ~0 and std 1/sqrt(fan_in)
    (within 5% of it), bounded by two pre-scaling standard deviations;
    biases are exactly 0; BatchNorm starts at scale 1, bias 0."""
    from tpuvae_torch.models import SimpleVAE

    model = SimpleVAE(generator=torch.Generator().manual_seed(3))
    linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    assert len(linears) == 9
    for m in linears:
        w = m.weight.detach().double()
        target = m.in_features ** -0.5
        assert abs(w.mean().item()) <= 0.05 * target, m
        assert abs(w.std().item() - target) <= 0.05 * target, m
        assert w.abs().max().item() <= 2 * target / 0.87962566103423978 + 1e-7
        assert torch.equal(m.bias, torch.zeros_like(m.bias))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
    again = SimpleVAE(generator=torch.Generator().manual_seed(3))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_dropout_masks_come_from_the_generator():
    from tpuvae_torch.models import SimpleVAE

    model = SimpleVAE(generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(8, 370)).astype(np.float32))
    a = model(x, generator=torch.Generator().manual_seed(5))[0]
    b = model(x, generator=torch.Generator().manual_seed(5))[0]
    c = model(x, generator=torch.Generator().manual_seed(6))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# ---------------------------------------------------------------- fit -------

class _Scripted(torch.nn.Module):
    """One parameter ``w``; the objective's loss in epoch e is ``script[e]``
    with a constant gradient 1e-3 in ``w``, so that every Adam step moves
    ``w`` by about -lr."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))


def _scripted_objective(script, n_batches):
    calls = {"n": 0}

    def loss_fn(model, batch, generator, train):
        epoch = calls["n"] // n_batches
        calls["n"] += 1
        return script[epoch] + 1e-3 * (model.w - model.w.detach()), {}

    return loss_fn


def _reference_control(script, patience, plateau_patience, factor, lr):
    """The rules of ``tpuvae/train/loop.py:410-471``, written out."""
    best, best_epoch, pat, p_best, p_cnt = float("inf"), -1, 0, float("inf"), 0
    lrs, epoch = [], -1
    for epoch, loss in enumerate(script):
        lrs.append(lr)
        if loss < p_best:
            p_best, p_cnt = loss, 0
        else:
            p_cnt += 1
            if p_cnt > plateau_patience:
                lr *= factor
                p_cnt = 0
        if loss < best:
            best, best_epoch, pat = loss, epoch, 0
        else:
            pat += 1
        if pat >= patience:
            break
    return lrs, best_epoch, epoch, lr


@pytest.mark.parametrize("scan_epochs", [1, 4])
@pytest.mark.parametrize("restore_best", [True, False])
def test_fit_control_semantics(restore_best, scan_epochs):
    from tpuvae_torch.train.loop import FitConfig, fit
    from tpuvae_torch.train.state import create_state, get_learning_rate

    script = [5.0, 4.0, 4.5, 4.2, 3.0, 3.5, 3.4, 3.3, 3.2, 3.1, 3.05, 3.01,
              3.0, 3.0, 2.0]
    n, bs = 10, 4                     # two full batches and a remainder
    lr0 = 0.01
    model = _Scripted()
    state = create_state(model, lr0)
    cfg = FitConfig(epochs=len(script), batch_size=bs, patience=6,
                    plateau_patience=1, plateau_factor=0.5,
                    restore_best=restore_best, log_every=1,
                    scan_epochs=scan_epochs)
    res = fit(state, _scripted_objective(script, 3),
              (torch.zeros((n, 2)),), cfg)
    lrs, best_epoch, stopped, lr_end = _reference_control(script, 6, 1, 0.5,
                                                          lr0)
    assert (best_epoch, stopped) == (4, 10)
    assert res.best_epoch == best_epoch and res.stopped_epoch == stopped
    np.testing.assert_allclose(res.history["train_loss"],
                               script[:stopped + 1], rtol=1e-6)
    assert res.history["lr"] == lrs and len(lrs) == stopped + 1
    assert res.history["val_loss"] == []
    assert lrs[-1] == lr0 / 8 and get_learning_rate(state) == lr_end == lr0 / 16
    # every Adam step with a constant gradient moves w by lr * g/(|g|+eps)
    step = 1e-3 / (1e-3 + 1e-8)
    upto = best_epoch + 1 if restore_best else stopped + 1
    want_w = -sum(lr * 3 * step for lr in lrs[:upto])
    np.testing.assert_allclose(model.w.item(), want_w, rtol=1e-5)
    assert res.steps_per_sec > 0


def test_fit_val_monitor_and_per_dataset_normaliser():
    from tpuvae_torch.train.loop import FitConfig, fit
    from tpuvae_torch.train.state import create_state

    class Mean(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.b = torch.nn.Parameter(torch.zeros(()))

    def loss_fn(model, batch, generator, train):
        (x,) = batch
        return ((x - model.b) ** 2).sum(), {}

    x = torch.arange(10, dtype=torch.float32)[:, None]
    v = torch.ones((5, 1))
    state = create_state(Mean(), 0.0)
    res = fit(state, loss_fn, (x,), FitConfig(
        epochs=2, batch_size=4, monitor="val", loss_normalizer="per_dataset"),
        val_data=(v,))
    np.testing.assert_allclose(res.history["train_loss"],
                               [float((x ** 2).sum()) / 10] * 2)
    np.testing.assert_allclose(res.history["val_loss"], [1.0, 1.0])
    with pytest.raises(ValueError, match="val_data"):
        fit(state, loss_fn, (x,), FitConfig(epochs=1, monitor="val"))


def test_fit_rejects_what_is_not_ported_and_ignores_scan_epochs(tmp_path):
    from tpuvae_torch.train.loop import FitConfig, fit
    from tpuvae_torch.train.state import create_state

    state = create_state(_Scripted(), 0.01)
    loss_fn = _scripted_objective([1.0] * 4, 1)
    data = (torch.zeros((4, 1)),)
    # checkpoints are ported: one rotated step directory per epoch
    fit(create_state(_Scripted(), 0.01), _scripted_objective([1.0] * 4, 1),
        data, FitConfig(epochs=2, batch_size=4, checkpoint_every=1,
                        checkpoint_dir=str(tmp_path / "ck")))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "latest", "step_00000001"]
    # a mesh is ported (tests/test_torch_dp.py runs two ranks): a mesh of
    # one rank runs the single-device epoch; host_stream with a mesh is
    # refused, as in the JAX package
    from tpuvae_torch.parallel import make_mesh

    mesh = make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="host_stream"):
        fit(state, loss_fn, data, FitConfig(epochs=1, host_stream=True),
            mesh=mesh)
    # host_stream is ported: host arrays in, the same loss as resident data
    streamed = fit(create_state(_Scripted(), 0.01),
                   _scripted_objective([1.0] * 4, 1), (np.zeros((4, 1), np.float32),),
                   FitConfig(epochs=1, batch_size=4, host_stream=True))
    resident = fit(create_state(_Scripted(), 0.01),
                   _scripted_objective([1.0] * 4, 1), data,
                   FitConfig(epochs=1, batch_size=4))
    assert streamed.history["train_loss"] == resident.history["train_loss"]
    on_mesh = fit(create_state(_Scripted(), 0.01),
                  _scripted_objective([1.0] * 4, 1), data,
                  FitConfig(epochs=1, batch_size=4), mesh=mesh,
                  loss_reduction="sum")
    assert on_mesh.history["train_loss"] == resident.history["train_loss"]

    class Log:
        def __init__(self):
            self.events, self.fields = [], []

        def log(self, event, **fields):
            self.events.append(event)
            self.fields.append(fields)

    # scan_epochs_ignored is logged only where the JAX package ignores K
    # (tpuvae/train/loop.py:383-386): with host_stream, and on a mesh of
    # more than one rank; a resident epoch on one rank honours K
    log = Log()
    fit(state, loss_fn, data, FitConfig(epochs=1, batch_size=4,
                                        scan_epochs=8), logger=log)
    fit(create_state(_Scripted(), 0.01), _scripted_objective([1.0] * 4, 1),
        data, FitConfig(epochs=1, batch_size=4, scan_epochs=8), mesh=mesh,
        loss_reduction="sum", logger=log)
    assert "scan_epochs_ignored" not in log.events
    log = Log()
    fit(create_state(_Scripted(), 0.01), _scripted_objective([1.0] * 4, 1),
        (np.zeros((4, 1), np.float32),),
        FitConfig(epochs=1, batch_size=4, host_stream=True, scan_epochs=8),
        logger=log)
    assert log.events[0] == "scan_epochs_ignored"
    assert log.fields[0] == {"reason": "host_stream epoch active"}
    from _torch_ranks import run_ranks

    ranks = run_ranks(tmp_path / "ranks", 2, [("scan_epochs_on_mesh", {})])
    for r in ranks:
        got = r["scan_epochs_on_mesh"]
        assert ("scan_epochs_ignored", {"reason": "dp mesh epoch active"}) \
            in got["events"]
        assert got["history"][4]["train_loss"] == \
            got["history"][1]["train_loss"]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port's ``save_checkpoint`` writes what
    ``tpuvae.train.checkpoint.load_checkpoint`` reads, and the reverse."""
    from tpuvae.models import SimpleVAE as FlaxVAE
    from tpuvae.train.checkpoint import load_checkpoint as jax_load
    from tpuvae.train.checkpoint import save_checkpoint as jax_save

    from tpuvae_torch.convert import simple_vae_from_flax
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train.checkpoint import load_checkpoint, save_checkpoint

    model = SimpleVAE(generator=torch.Generator().manual_seed(9)).train()
    x = torch.from_numpy(
        np.random.default_rng(2).normal(size=(12, 370)).astype(np.float32))
    model(x, generator=torch.Generator().manual_seed(1))   # move BN stats
    model.eval()
    save_checkpoint(tmp_path / "port", model, {"best_epoch": 3})
    params, stats, meta = jax_load(tmp_path / "port")
    assert meta == {"best_epoch": 3}
    want = np.asarray(FlaxVAE().apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(x.numpy()),
                                      method=FlaxVAE.latent))
    with torch.no_grad():
        np.testing.assert_allclose(model.latent(x).numpy(), want, rtol=0,
                                   atol=1e-5)
    jax_save(tmp_path / "jax", params, stats, {"k": 1})
    flat, meta = load_checkpoint(tmp_path / "jax")
    back = SimpleVAE()
    back.load_state_dict(simple_vae_from_flax(flat))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)
