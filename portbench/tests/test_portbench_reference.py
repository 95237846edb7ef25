"""The plain references against the port at a tiny size on the CPU: the
same initial weights, rows and draws, the first three optimizer steps
each, compared as a run compares them, within the cells' limits.  Also: each reference's forward
pass against the port's on shared weights, in both BatchNorm modes, and
TF32's rounding."""

from __future__ import annotations

import pytest
import torch

from portbench import correct
from portbench.drivers import train
from portbench.reference import common
from portbench.tests.tiny import tiny_spec

CELLS = ["hybrid_vae.train", "simple_vae.train"]
CPU = torch.device("cpu")


def _first_epochs(cell: str, seed: int):
    spec = tiny_spec(cell)
    fam, ref, dat, init, job = train.set_up(spec, seed, CPU)
    prog = train.set_up_fit(job, init, job["scan_epochs"] + 1)[1]
    refs = train.reference_steps(ref, spec["config"], dat, seed, CPU)
    return spec, prog, refs


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [7, 3_000_000_019])
def test_port_within_the_cells_limits_of_the_reference(cell, seed):
    spec, prog, refs = _first_epochs(cell, seed)
    values = correct.readings(prog, refs, spec["limits"]["exclude_below"])
    ok, compared = correct.judge(values, spec["limits"], correct.START)
    assert ok, compared
    assert len(prog["losses"]) == len(refs["losses"]) == train.CHECKED_STEPS


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_equals_the_ports_on_shared_weights(cell, mode):
    spec = tiny_spec(cell)
    fam, ref, dat, init, job = train.set_up(spec, 5, CPU)
    state = {k: v.clone() for k, v in init.items()}
    g = torch.Generator().manual_seed(0)
    for k in state:              # running statistics away from 0 and 1
        if k.endswith("running_var"):
            state[k] = torch.rand(state[k].shape, generator=g) + 0.5
        elif k.endswith("running_mean"):
            state[k] = 0.3 * torch.randn(state[k].shape, generator=g)
    job["model"].load_state_dict(state)
    model = ref.make_model(spec["config"], CPU)
    model.load_state_dict(state)
    batch = tuple(a[:16] for a in job["train"])
    getattr(job["model"], mode)()
    getattr(model, mode)()
    with torch.no_grad():
        port, _ = job["loss_fn"](job["model"], batch,
                                 torch.Generator().manual_seed(1), mode == "train")
        plain = ref.objective(spec["config"])(
            model, batch, torch.Generator().manual_seed(1), mode == "train")
    assert float(port) == pytest.approx(float(plain), rel=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_float64_reference_agrees_with_float32(cell):
    spec = tiny_spec(cell)
    _, ref, dat, _, _ = train.set_up(spec, 4, CPU)
    a = train.reference_steps(ref, spec["config"], dat, 4, CPU)
    b = train.reference_steps(ref, spec["config"], dat, 4, CPU, "fp64")
    assert a["losses"] == pytest.approx(b["losses"], rel=1e-5)
    assert a["losses"] != b["losses"]


def test_generator_at_makes_the_draws_again():
    def draws(g):
        torch.randperm(10, generator=g)
        torch.randn(3, 4, generator=g)

    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        draws(g)
    at = common.generator_at(9, 3, draws, CPU)
    assert torch.equal(torch.randn(5, generator=g), torch.randn(5, generator=at))


def test_a_dtype_without_a_reference_is_refused():
    spec = tiny_spec("hybrid_vae.train")
    spec["config"]["dtype"] = "bfloat16"
    with pytest.raises(ValueError, match="no plain reference"):
        train.set_up(spec, 1, CPU)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 3 * 2 ** -12), 3.0e-39])
    r = common.round_tf32(x)
    assert r[0] == 1.0
    assert r[1] == 1.0                         # a tie goes to even
    assert r[2] == 1.0 + 2 ** -9               # a tie goes to even, up
    assert r[3] == -(1.0 + 2 ** -10)           # sign-magnitude rounding
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_initial_state_is_the_seeds():
    spec = tiny_spec("simple_vae.train")
    ref = train.families(spec["config"])[1]
    meta = ref.make_model(spec["config"], "meta")
    a = common.initial_state(meta, 11, CPU)
    b = common.initial_state(meta, 11, CPU)
    c = common.initial_state(meta, 12, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["out.weight"], c["out.weight"])
    fan_in = a["encoder.dense.0.weight"].shape[1]
    std = float(a["encoder.dense.0.weight"].std())
    assert std == pytest.approx(fan_in ** -0.5, rel=0.05)
