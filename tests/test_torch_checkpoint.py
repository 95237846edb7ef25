"""Mid-train checkpoints and resume of the port, on the CPU (the JAX
package's cases, ``tests/test_resume_eda_parity.py``, on the port's
``train_state.pt``).

A resumed run equals an uninterrupted one only if the checkpoint carries
the fit loop's ``torch.Generator`` (permutations, dropout masks and
reparameterisation noise all come from it) and the plateau LR: held here
at rtol 1e-6 on the CPU, where the two runs do the same float operations
in the same order (they come out bit-equal).
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_cvae_pipeline import _write_processed_data2

torch.set_num_threads(2)


def _x(n=64, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=(n, 10)).astype(np.float32))


def _build():
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train.state import create_state

    return create_state(SimpleVAE(input_dim=10, hidden_dims=(8,), latent_dim=4,
                                  generator=torch.Generator().manual_seed(0)),
                        0.1)


def _fit(data, ck=None, **kw):
    from tpuvae_torch.train.loop import FitConfig, fit
    from tpuvae_torch.train.objectives import simple_vae_objective

    cfg = dict(batch_size=24, patience=100, seed=0, plateau_patience=0,
               plateau_factor=0.5)
    cfg.update(kw)
    if ck is not None:
        cfg.update(checkpoint_dir=str(ck), checkpoint_every=1)
    return fit(_build(), simple_vae_objective(beta=0.2), data, FitConfig(**cfg))


def _assert_same_weights(a, b, rtol=1e-6, atol=0.0):
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("host_stream", [False, True],
                         ids=["resident", "host_stream"])
def test_resumed_fit_equals_an_uninterrupted_one(tmp_path, host_stream):
    x = _x()
    data = (x.numpy(),) if host_stream else (x,)
    full = _fit(data, epochs=8, host_stream=host_stream)
    _fit(data, tmp_path / "ck", epochs=5, host_stream=host_stream)
    resumed = _fit(data, tmp_path / "ck", epochs=8, host_stream=host_stream)
    assert len(resumed.history["train_loss"]) == 8
    np.testing.assert_allclose(resumed.history["train_loss"],
                               full.history["train_loss"], rtol=1e-6)
    # the plateau LR was halved at the interrupted run's last epoch and
    # carried over (then halved twice more)
    assert resumed.history["lr"] == full.history["lr"]
    assert full.history["lr"][4:] == [0.1, 0.05, 0.025, 0.0125]
    _assert_same_weights(full, resumed)
    opt_a = full.state.optimizer.state_dict()["state"]
    opt_b = resumed.state.optimizer.state_dict()["state"]
    for k in opt_a:
        for name in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(opt_b[k][name].numpy(),
                                       opt_a[k][name].numpy(), rtol=1e-6)
    assert resumed.stopped_epoch == full.stopped_epoch == 7


def test_resume_needs_the_generator_state(tmp_path):
    """The checkpoint's generator has moved on from the seed; restoring
    weights without it would draw epoch 4's shuffles from epoch 1's
    stream."""
    from tpuvae_torch.train.checkpoint import latest_train_state_dir

    _fit((_x(),), tmp_path / "ck", epochs=3)
    saved = torch.load(latest_train_state_dir(tmp_path / "ck")
                       / "train_state.pt", weights_only=True)
    fresh = torch.Generator().manual_seed(0).get_state()
    assert saved["generator"].dtype == torch.uint8
    assert not torch.equal(saved["generator"], fresh)
    assert saved["step"] == 3 * 3            # 64 rows at 24: 3 steps an epoch
    meta = json.loads((tmp_path / "ck" / "latest" / "metadata.json").read_text())
    assert set(meta) == {"epoch", "best", "best_epoch", "patience_counter",
                         "plateau_best", "plateau_counter", "lr", "history"}
    assert meta["epoch"] == 2 and len(meta["history"]["train_loss"]) == 3


def test_checkpoint_manager_rotation(tmp_path):
    from tpuvae_torch.train.checkpoint import (
        CheckpointManager,
        latest_train_state_dir,
        restore_train_state,
        save_train_state,
    )

    state = _build()
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2)
    for step in (1, 2, 3, 4):
        with torch.no_grad():
            state.model.fc_mu.bias.fill_(float(step))
        mgr.save(state, {"epoch": step}, step=step)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4
    latest = latest_train_state_dir(tmp_path / "ck")
    assert latest is not None and latest.resolve().name == "step_00000004"
    fresh = _build()
    restored, meta = mgr.restore(fresh)
    assert meta["epoch"] == 4 and restored is fresh
    _assert_same_weights(type("R", (), {"state": state}),
                         type("R", (), {"state": restored}), rtol=0)
    _, meta3 = mgr.restore(_build(), step=3)
    assert meta3["epoch"] == 3
    # a real 'latest' directory still resolves, and the next save replaces
    # it with the rotation symlink
    legacy = tmp_path / "legacy"
    save_train_state(legacy / "latest", state, {"epoch": 7})
    found = latest_train_state_dir(legacy)
    assert found is not None and found.name == "latest"
    CheckpointManager(legacy, max_to_keep=1).save(state, {"epoch": 8}, step=8)
    found = latest_train_state_dir(legacy)
    assert found is not None and (legacy / "latest").is_symlink()
    _, meta8 = restore_train_state(found, _build())
    assert meta8["epoch"] == 8


def test_fit_resume_with_rotation(tmp_path):
    x = _x(seed=3)
    full = _fit((x,), epochs=6)
    _fit((x,), tmp_path / "ck", epochs=3, checkpoint_keep=3)
    assert sorted(d for d in os.listdir(tmp_path / "ck")
                  if d.startswith("step_")) == [
        "step_00000000", "step_00000001", "step_00000002"]
    resumed = _fit((x,), tmp_path / "ck", epochs=6, checkpoint_keep=3)
    np.testing.assert_allclose(resumed.history["train_loss"],
                               full.history["train_loss"], rtol=1e-6)
    assert sorted(d for d in os.listdir(tmp_path / "ck")
                  if d.startswith("step_")) == [
        "step_00000003", "step_00000004", "step_00000005"]


def test_restore_best_survives_checkpoint_resume(tmp_path):
    """After a resume with no epoch left to run, ``restore_best`` returns
    the best weights of the interrupted run, read back from ``best/`` (the
    flax layout the JAX package reads too)."""
    from tpuvae.train.checkpoint import load_checkpoint as jax_load

    from tpuvae_torch.convert import to_flax

    x = _x()
    a = _fit((x,), tmp_path / "ck", epochs=4, restore_best=True,
             plateau_patience=None)
    b = _fit((x,), tmp_path / "ck", epochs=4, restore_best=True,
             plateau_patience=None)
    params = {k: v for k, v in a.state.model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    got = b.state.model.state_dict()
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert b.best_epoch == a.best_epoch
    p, s, meta = jax_load(tmp_path / "ck" / "best")
    assert meta["epoch"] == a.best_epoch
    flat = to_flax(params)
    assert np.array_equal(p["fc_mu"]["kernel"], flat["params/fc_mu/kernel"])
    assert np.array_equal(s["encoder"]["BatchNorm_0"]["mean"],
                          flat["batch_stats/encoder/BatchNorm_0/mean"])


def test_checkpoint_manager_edge_paths(tmp_path, monkeypatch):
    """Crash safety and the layout fallbacks of the checkpoint store."""
    from tpuvae_torch.train.checkpoint import (
        CheckpointManager,
        latest_train_state_dir,
    )

    state = _build()
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(tmp_path / "bad", max_to_keep=0)
    mgr = CheckpointManager(tmp_path / "ck")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(state)
    # malformed step directories are skipped, not fatal
    (tmp_path / "ck" / "step_bogus").mkdir()
    (tmp_path / "ck" / "step_bogus" / "train_state.pt").write_bytes(b"")
    assert mgr.steps() == []
    # a stale temporary directory of a crashed save is cleared; saving a
    # step again replaces its contents
    stale = tmp_path / "ck" / ".tmp_step_00000001"
    stale.mkdir()
    (stale / "junk").write_text("x")
    mgr.save(state, {"epoch": 1}, step=1)
    mgr.save(state, {"epoch": 11}, step=1)
    _, meta = mgr.restore(_build(), step=1)
    assert meta["epoch"] == 11 and not stale.exists()

    # without symlinks: the LATEST pointer file, which the resolver reads
    def no_symlink(*a, **k):
        raise OSError("symlinks unsupported")

    monkeypatch.setattr(os, "symlink", no_symlink)
    CheckpointManager(tmp_path / "nolink").save(state, {"epoch": 2}, step=2)
    assert (tmp_path / "nolink" / "LATEST").read_text() == "step_00000002"
    found = latest_train_state_dir(tmp_path / "nolink")
    assert found is not None and found.name == "step_00000002"
    monkeypatch.undo()

    # a real 'latest' directory that is not a checkpoint is left alone
    legacy = tmp_path / "legacy2"
    mgr3 = CheckpointManager(legacy)
    (legacy / "latest").mkdir()
    (legacy / "latest" / "user_data.txt").write_text("keep me")
    mgr3.save(state, {"epoch": 3}, step=3)
    assert (legacy / "latest" / "user_data.txt").exists()
    assert (legacy / "LATEST").read_text() == "step_00000003"

    # with neither symlink nor pointer, the highest step directory wins
    plain = tmp_path / "plain"
    CheckpointManager(plain, max_to_keep=9).save(state, {}, step=1)
    CheckpointManager(plain, max_to_keep=9).save(state, {}, step=5)
    (plain / "latest").unlink(missing_ok=True)
    (plain / "LATEST").unlink(missing_ok=True)
    found = latest_train_state_dir(plain)
    assert found is not None and found.name == "step_00000005"
    assert latest_train_state_dir(tmp_path / "nothing_here") is None


def test_a_resumed_run_that_had_stopped_stays_stopped(tmp_path):
    x = _x()
    first = _fit((x,), tmp_path / "ck", epochs=8, patience=1,
                 plateau_patience=None)
    assert first.stopped_epoch == 4
    again = _fit((x,), tmp_path / "ck", epochs=8, patience=1,
                 plateau_patience=None)
    assert again.history["train_loss"] == first.history["train_loss"]
    assert again.stopped_epoch == first.stopped_epoch
    _assert_same_weights(first, again, rtol=0)


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt") / "processed_data2"
    _write_processed_data2(out)
    return out


def test_run_conditional_vae_writes_checkpoints_and_resumes(data2, tmp_path):
    """``checkpoint_every=1``: ``Conditional_VAE/checkpoints/`` rotates one
    step directory; a 3-epoch run resumed from its 2-epoch checkpoint ends
    where an uninterrupted 3-epoch run does."""
    from tpuvae_torch.config import ConditionalVAEConfig
    from tpuvae_torch.pipelines import run_conditional_vae
    from tpuvae_torch.train.checkpoint import load_checkpoint
    from tpuvae_torch.utils.logging import RunLogger

    def run(results, epochs, every):
        return run_conditional_vae(
            str(data2), str(results),
            ConditionalVAEConfig(epochs=epochs, batch_size=8,
                                 checkpoint_every=every),
            logger=RunLogger(echo=False), make_plots=False, device="cpu")

    whole = run(tmp_path / "whole", 3, 0)
    assert not (tmp_path / "whole" / "Conditional_VAE" / "checkpoints").exists()
    run(tmp_path / "cut", 2, 1)
    ck = tmp_path / "cut" / "Conditional_VAE" / "checkpoints"
    assert sorted(p.name for p in ck.iterdir()) == ["latest", "step_00000001"]
    resumed = run(tmp_path / "cut", 3, 1)
    assert sorted(p.name for p in ck.iterdir()) == ["latest", "step_00000002"]
    cols = ["Silhouette", "NMI", "ARI", "Purity"]
    np.testing.assert_allclose(resumed[cols].to_numpy(),
                               whole[cols].to_numpy(), rtol=1e-6)
    a, _ = load_checkpoint(tmp_path / "whole" / "Conditional_VAE" / "serving"
                           / "model")
    b, _ = load_checkpoint(tmp_path / "cut" / "Conditional_VAE" / "serving"
                           / "model")
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
