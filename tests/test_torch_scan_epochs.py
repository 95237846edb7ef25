"""The port's scanned epochs (``FitConfig.scan_epochs > 1``: early
stopping, ReduceLROnPlateau and best-weights tracking on the device, one
host read per K epochs) against its per-epoch loop and the JAX package's
``_fit_chunked`` (``tpuvae/train/loop.py:483-663``).

The first three tests mirror ``tests/test_train.py:105-197`` on the port,
with its sizes and tolerances: histories rtol 1e-6, the learning rates
rtol 1e-7, weights rtol 1e-5 / atol 1e-7.  Both loops draw the same
permutations, masks and noise from the fit's ``torch.Generator``; they
part only where the chunked loop compares the monitored loss in float32
on the device and divides the sums in float32.  The last test holds the
port's chunked ``fit`` to the JAX package's on the same weights (carried
over by ``convert``) and a deterministic objective with one batch covering
every row, so neither package's permutation matters: a linear regression
under mean squared error.  Its gradients are far from 0, so the two
frameworks' fp32 sums stay within rtol 1e-5 of each other; the
autoencoder's reconstruction loss does not (elements whose gradient
cancels to rounding level take Adam steps of up to lr in either
direction, and its histories part by 6e-5 within 18 epochs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_conv_models import _flat

torch.set_num_threads(1)


def _chunk_equiv_run(scan_epochs, *, monitor, restore, plateau, val_noise,
                     epochs=40, patience=2):
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train import FitConfig, create_state, fit
    from tpuvae_torch.train import simple_vae_objective

    rng = np.random.default_rng(7)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    v = rng.normal(size=(16, 12)).astype(np.float32) * val_noise
    model = SimpleVAE(input_dim=12, hidden_dims=(8,), latent_dim=4,
                      generator=torch.Generator().manual_seed(0))
    cfg = FitConfig(epochs=epochs, batch_size=16, patience=patience,
                    monitor=monitor, restore_best=restore,
                    plateau_patience=plateau, seed=0,
                    scan_epochs=scan_epochs)
    vd = (torch.from_numpy(v),) if monitor == "val" else None
    return fit(create_state(model, 1e-2), simple_vae_objective(0.5),
               (torch.from_numpy(x),), cfg, val_data=vd)


def _assert_same_weights(a, b):
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_scan_epochs_matches_per_epoch_loop():
    """K = 5 reproduces the per-epoch host loop: the same histories, LR
    schedule, stop and best epochs and final (best-restored) weights, with
    one host read per chunk where the host loop reads once per epoch."""
    a = _chunk_equiv_run(1, monitor="train", restore=True, plateau=2,
                         epochs=14, patience=4, val_noise=1.0)
    b = _chunk_equiv_run(5, monitor="train", restore=True, plateau=2,
                         epochs=14, patience=4, val_noise=1.0)
    np.testing.assert_allclose(a.history["train_loss"],
                               b.history["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(a.history["lr"], b.history["lr"], rtol=1e-7)
    assert len(set(a.history["lr"])) > 1          # the plateau halved it
    assert (a.best_epoch, a.stopped_epoch) == (b.best_epoch, b.stopped_epoch)
    _assert_same_weights(a, b)
    ran = len(a.history["train_loss"])
    assert a.host_reads == ran and b.host_reads == -(-ran // 5)
    assert len(b.history["epoch_seconds"]) == ran


def test_scan_epochs_early_stop_mid_chunk():
    """A noisy val monitor stops the run inside a chunk of 7: the epochs
    frozen past the stop point change nothing, and the best-weights
    restore picks the same epoch."""
    a = _chunk_equiv_run(1, monitor="val", restore=True, plateau=1,
                         val_noise=3.0)
    b = _chunk_equiv_run(7, monitor="val", restore=True, plateau=1,
                         val_noise=3.0)
    assert a.stopped_epoch == b.stopped_epoch
    assert a.stopped_epoch % 7 != 6 and a.stopped_epoch < 39   # mid-chunk
    assert a.best_epoch == b.best_epoch
    np.testing.assert_allclose(a.history["val_loss"],
                               b.history["val_loss"], rtol=1e-6)
    np.testing.assert_allclose(a.history["lr"], b.history["lr"], rtol=1e-7)
    _assert_same_weights(a, b)


def test_scan_epochs_frozen_epochs_leave_the_whole_state():
    """Without a best-weights restore the state returned is the one at the
    stopping epoch: weights, BatchNorm buffers, Adam's moments and step,
    and the learning rate, all as the per-epoch loop leaves them."""
    a = _chunk_equiv_run(1, monitor="val", restore=False, plateau=1,
                         val_noise=3.0)
    b = _chunk_equiv_run(7, monitor="val", restore=False, plateau=1,
                         val_noise=3.0)
    assert a.stopped_epoch == b.stopped_epoch and a.stopped_epoch % 7 != 6
    _assert_same_weights(a, b)
    oa, ob = a.state.optimizer, b.state.optimizer
    assert float(oa.param_groups[0]["lr"]) == pytest.approx(
        float(ob.param_groups[0]["lr"]), rel=1e-7)
    for pa, pb in zip(a.state.model.parameters(), b.state.model.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(oa.state[pa][key].numpy(),
                                       ob.state[pb][key].numpy(),
                                       rtol=1e-5, atol=1e-9, err_msg=key)


def test_scan_epochs_checkpoints_and_resumes(tmp_path):
    """Checkpoints at chunk ends: a run interrupted after 6 epochs and
    resumed from its rotation checkpoint lands on the same final weights
    and history tail as one uninterrupted run, and ``best/`` holds the
    best epoch."""
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train import (FitConfig, create_state, fit,
                                    load_checkpoint, simple_vae_objective)

    x = torch.from_numpy(
        np.random.default_rng(9).normal(size=(48, 12)).astype(np.float32))

    def run(epochs, ck, resume):
        model = SimpleVAE(input_dim=12, hidden_dims=(8,), latent_dim=4,
                          generator=torch.Generator().manual_seed(1))
        cfg = FitConfig(epochs=epochs, batch_size=16, patience=100,
                        monitor="train", restore_best=True, seed=0,
                        scan_epochs=3, checkpoint_dir=ck,
                        checkpoint_every=2, checkpoint_keep=2, resume=resume)
        return fit(create_state(model, 1e-2), simple_vae_objective(0.3),
                   (x,), cfg)

    full = run(10, str(tmp_path / "full"), resume=False)
    run(6, str(tmp_path / "split"), resume=False)      # interrupted at 6
    assert sorted(p.name for p in (tmp_path / "split").iterdir()) == [
        "best", "latest", "step_00000002", "step_00000005"]
    resumed = run(10, str(tmp_path / "split"), resume=True)

    assert resumed.stopped_epoch == full.stopped_epoch == 9
    assert resumed.best_epoch == full.best_epoch
    np.testing.assert_allclose(resumed.history["train_loss"][-4:],
                               full.history["train_loss"][-4:], rtol=1e-5)
    assert len(resumed.history["train_loss"]) == 10
    _assert_same_weights(full, resumed)
    _, meta = load_checkpoint(tmp_path / "split" / "best")
    assert meta["epoch"] == full.best_epoch


# -- against the JAX package --------------------------------------------------

N_ROWS, DIM, OUT = 24, 12, 4
JAX_CASE = dict(epochs=30, patience=4, plateau_patience=1, lr=0.1)


def _regression_data():
    """A linear regression whose validation rows follow another map, so
    the validation loss falls, turns and rises: a plateau halving, then an
    early stop inside a chunk of 4."""
    rng = np.random.default_rng(31)
    a = rng.normal(size=(DIM, OUT)).astype(np.float32)
    b = (a + rng.normal(size=(DIM, OUT)) * 0.7).astype(np.float32)
    x = rng.normal(size=(N_ROWS, DIM)).astype(np.float32)
    y = (x @ a + 0.1 * rng.normal(size=(N_ROWS, OUT))).astype(np.float32)
    xv = rng.normal(size=(8, DIM)).astype(np.float32)
    return (x, y), (xv, (xv @ b).astype(np.float32))


class _Linear(torch.nn.Module):
    """flax ``nn.Dense(OUT)`` under the port's name for it (``dense.0``)."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.ModuleList([torch.nn.Linear(DIM, OUT)])

    def forward(self, x):
        return self.dense[0](x)


def _cfg(fit_config, scan_epochs):
    return fit_config(epochs=JAX_CASE["epochs"], batch_size=N_ROWS,
                      patience=JAX_CASE["patience"], monitor="val",
                      restore_best=True,
                      plateau_patience=JAX_CASE["plateau_patience"],
                      seed=0, scan_epochs=scan_epochs)


@pytest.fixture(scope="module")
def jax_chunked():
    import flax.linen as nn

    from tpuvae.train import FitConfig, create_state, fit

    class Linear(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(OUT)(x)

    def loss_fn(state, variables, batch, rng, train):
        x, y = batch
        return jnp.mean((state.apply_fn(variables, x) - y) ** 2), {}, {}

    train, val = _regression_data()
    state = create_state(Linear(), jax.random.PRNGKey(3),
                         (jnp.asarray(train[0][:2]),), JAX_CASE["lr"])
    res = fit(state, loss_fn, train, _cfg(FitConfig, 4), val_data=val)
    return state, res


@pytest.mark.parametrize("scan_epochs", [4, 1])
def test_chunked_fit_matches_the_jax_package(jax_chunked, scan_epochs):
    """The port's ``fit`` at K = 4 (and its per-epoch loop) against the JAX
    package's chunked ``fit`` at K = 4 from the same weights: the
    learning-rate schedule and the best and stopped epochs are equal, the
    histories agree to rtol 1e-5."""
    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.train import FitConfig, create_state, fit

    def loss_fn(model, batch, generator, train):
        x, y = batch
        return torch.mean((model(x) - y) ** 2), {}

    state, want = jax_chunked
    train, val = _regression_data()
    model = _Linear()
    model.load_state_dict(from_flax(
        {"params/" + k: a for k, a in _flat(state.params).items()}))
    got = fit(create_state(model, JAX_CASE["lr"]), loss_fn,
              tuple(torch.from_numpy(a) for a in train),
              _cfg(FitConfig, scan_epochs),
              val_data=tuple(torch.from_numpy(a) for a in val))
    assert want.stopped_epoch < JAX_CASE["epochs"] - 1     # stopped early
    assert want.stopped_epoch % 4 != 3                      # inside a chunk
    assert len(set(want.history["lr"])) > 1                 # halved
    assert (got.best_epoch, got.stopped_epoch) == (want.best_epoch,
                                                   want.stopped_epoch)
    np.testing.assert_array_equal(np.float32(got.history["lr"]),
                                  np.float32(want.history["lr"]))
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key],
                                   rtol=1e-5, err_msg=key)
    with torch.no_grad():                # the best epoch's weights restored
        np.testing.assert_allclose(
            model.dense[0].weight.numpy().T,
            np.asarray(want.state.params["Dense_0"]["kernel"]),
            rtol=1e-5, atol=1e-6)
