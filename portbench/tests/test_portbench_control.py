"""The check that decides ``correct`` fails what it must, at a size a test
run holds, on the CPU.

* The control: the plain reference in the nearest precision below the
  configuration's (TF32 for float32; here each product's operands rounded
  to TF32) put in the program's place, in the first steps and in the
  replayed epoch, fails the cell's limits.
* A whole run of each cell, the look for a card skipped, with the timed
  path broken underneath, comes out not correct: once with Adam's step
  leaving the state unchanged, once with half of each batch left out and
  the loss taken over the rest, once with every epoch after the first
  drawing the first epoch's permutation and noise again (the fault of a
  replay that repeats its captured draws), which the replayed epoch's
  numbers fail.
  A run of the same cell unbroken comes out correct.  (One card: no
  exchange between chips to leave out; training produces no tokens.)
"""

from __future__ import annotations

import importlib
import time

import pytest
import torch

from portbench import correct
from portbench.drivers import train
from portbench.tests.tiny import tiny_spec

CELLS = ["hybrid_vae.train", "simple_vae.train"]
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 2_147_483_659])
def test_control_fails_the_limits(cell, seed):
    spec = tiny_spec(cell)
    ref = train.families(spec["config"])[1]
    _, _, dat, _, _ = train.set_up(spec, seed, CPU)
    base = train.reference_steps(ref, spec["config"], dat, seed, CPU)
    low = train.reference_steps(ref, spec["config"], dat, seed, CPU,
                                precision="tf32")
    exclude = spec["limits"]["exclude_below"]
    values = correct.readings(low, base, exclude)
    before = _state_after_an_epoch(spec, ref, dat, seed)
    replay = [train.reference_replay(ref, spec["config"], dat, seed, CPU,
                                     before, 1, precision)
              for precision in ("tf32", "fp32")]
    values.update(correct.replay_readings(*replay, exclude))
    ok, compared = correct.judge(values, spec["limits"])
    assert not ok, compared


def _state_after_an_epoch(spec, ref, dat, seed) -> dict:
    """A state to start a replayed epoch from, as the check copies it: the
    reference's own after one epoch of training from the seed's weights."""
    from portbench.reference import common

    cfg = spec["config"]
    model = ref.make_model(cfg, CPU)
    model.load_state_dict(common.initial_state(model, seed, CPU))
    train_, val = ref.splits(cfg, dat, seed)
    opt = common.Adam(model.parameters(), cfg["learning_rate"])
    common.train_epoch(model, opt, ref.objective(cfg), train_, val,
                       fit=ref.fit_settings(cfg),
                       gen=torch.Generator().manual_seed(seed))
    names = [k for k, _ in model.named_parameters()]
    return {"state": {k: v.clone() for k, v in
                      common.floating(model.state_dict()).items()},
            "m": dict(zip(names, opt.m)), "v": dict(zip(names, opt.v)),
            "step": torch.tensor(opt.t), "lr": torch.tensor(opt.lr)}


def _run(cell: str) -> dict:
    return train.run(tiny_spec(cell), 9, 0.2, False, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_step_that_leaves_the_state_unchanged_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"), "adam",
                        lambda *a, **k: None)
    out = _run(cell)
    assert not out["correct"]
    assert out["compared"]["change_gap"]["value"] == pytest.approx(1.0)
    assert out["compared"]["replay_change_gap"]["value"] >= 0.99


def _half_batch(objective, reduction):
    def make(*args):
        loss_fn = objective(*args)

        def half(model, batch, generator, train_):
            b = batch[0].shape[0]
            keep = -(-b // 2)
            loss, aux = loss_fn(model, tuple(a[:keep] for a in batch),
                                generator, train_)
            return (loss * (b / keep) if reduction == "sum" else loss), aux

        return half

    return make


@pytest.mark.parametrize("cell", CELLS)
def test_replays_that_repeat_their_draws_are_not_correct(cell, monkeypatch):
    from tpuvae_torch.train import loop

    made = loop.resident_epoch

    def frozen(model, optimizer, loss_fn, train_data, val_data, bs, gen):
        epoch = made(model, optimizer, loss_fn, train_data, val_data, bs, gen)
        seed = gen.initial_seed()

        def again():
            gen.manual_seed(seed)
            return epoch()

        return again

    monkeypatch.setattr(loop, "resident_epoch", frozen)
    out = _run(cell)
    assert not out["correct"], out["compared"]
    replay = [out["compared"][k] for k in correct.REPLAY]
    assert any(c["value"] > c["limit"] for c in replay), replay


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(cell, monkeypatch):
    from tpuvae_torch.train import objectives

    name, reduction = (("hybrid_objective", "sum") if cell.startswith("hybrid")
                       else ("simple_vae_objective", "mean"))
    monkeypatch.setattr(objectives, name,
                        _half_batch(getattr(objectives, name), reduction))
    out = _run(cell)
    assert not out["correct"], out["compared"]


def test_a_traffic_mix_sets_the_fit():
    """A mix's ``fit`` entry reaches ``FitConfig``: under ``host_stream`` the
    rows stay on the host, every epoch is its own chunk, and the run is
    checked as any other."""
    spec = tiny_spec("hybrid_vae.train")
    spec["traffic"]["fit"] = {"host_stream": True}
    job = train.set_up(spec, 3, CPU)[4]
    assert job["fit_config"](5).host_stream and job["scan_epochs"] == 1
    assert not isinstance(job["train"][0], torch.Tensor)
    out = train.run(spec, 3, 0.2, False, CPU, time.perf_counter())
    assert out["correct"], out["compared"]
