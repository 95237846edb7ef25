"""The port's compiled loops on the CPU: the bodies that a card captures as
CUDA graphs (``tpuvae_torch.graphs``) — t-SNE's perplexity search and
descent, the data-parallel epoch, the host_stream steps — read nothing on
the host, and the loops built from them agree with the eager loops and the
JAX package.

``no_host_reads()`` (``tests/_torch_host_reads.py``) fails on any
operation that a capture cannot take: a read of a value on the host, an
output whose shape depends on the data, a copy between devices.  On the
CPU ``graphs.runner`` returns the function it is given, so these tests
run the graphs' plain version; ``tests/test_torch_cuda.py`` holds the
graphs to it on the card.  The data-parallel cases run on two gloo ranks
(``tests/_torch_ranks.py``).  Tolerances: t-SNE's 20 steps against the
JAX ``_tsne_optimize`` within ``test_tsne_optimize_matches_jax_for_20_
steps``'s rtol 1e-4 / atol 1e-6; the data-parallel and host_stream fits
against the JAX package within ``tests/test_torch_dp.py``'s rtol 1e-5 on
the losses and rtol 2e-3 / atol 1e-4 on the parameters; the chunked
loops against the step-by-step loops and the static-input steps against
``_loss_sum`` bit-equal (the same operations on the same inputs).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_host_reads import HostRead, no_host_reads
from _torch_ranks import run_ranks
from test_torch_conv_models import _flat

torch.set_num_threads(2)

jax_tsne = importlib.import_module("tpuvae.viz.tsne")
port_tsne = importlib.import_module("tpuvae_torch.viz.tsne")

WS = 2
LR = 1e-3


def test_no_host_reads_catches_what_a_capture_cannot_take():
    x = torch.randn(6)
    for op in (lambda: x.sum().item(), lambda: float(x[0]),
               lambda: bool(x[0] > 0), lambda: x[x > 0], x.nonzero,
               lambda: torch.masked_select(x, x > 0),
               lambda: torch.equal(x, x), lambda: x.to("meta")):
        with pytest.raises(HostRead), no_host_reads():
            op()
    with no_host_reads():
        torch.where(x > 0, x, -x).add_(x[torch.tensor([0, 2])].sum())


# -- t-SNE ---------------------------------------------------------------------

def _p_and_y0(n=64, seed=1):
    from tpuvae.metrics.pairwise import squared_distances

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    d2 = np.array(squared_distances(jnp.asarray(x), jnp.asarray(x)))
    p = np.array(jax_tsne._calibrated_p(jnp.asarray(d2), 10.0))
    return d2, p, rng.normal(size=(n, 2)).astype(np.float32)


def test_tsne_step_functions_read_nothing_on_the_host():
    d2, p, y0 = _p_and_y0(32)
    with no_host_reads():
        cal = port_tsne._Calibration(torch.from_numpy(d2), 10.0)
        cal.step()
        cal.p()
        port_tsne._calibrated_p(torch.from_numpy(d2), 10.0)
        desc = port_tsne._Descent(torch.from_numpy(p), torch.from_numpy(y0),
                                  1.0)
        desc.phase(True)
        desc.step()
        port_tsne._tsne_optimize(torch.from_numpy(p), torch.from_numpy(y0),
                                 1.0, n_iter=7, exaggeration_iters=3)


@pytest.mark.parametrize("per_graph", [50, 4, 3])
def test_chunked_tsne_matches_jax_for_20_steps(monkeypatch, per_graph):
    """20 steps that cross the phase boundary (10 exaggerated) in chunks of
    ``per_graph`` steps and single steps (10 = 2 x 4 + 2 = 3 x 3 + 1):
    exactly 20 steps, against the JAX ``_tsne_optimize`` within its 20-step
    test's tolerance and bit-equal to the step-by-step loop."""
    _, p, y0 = _p_and_y0()
    want = np.asarray(jax_tsne._tsne_optimize(
        jnp.asarray(p), jnp.asarray(y0), jnp.float32(1.0), n_iter=20,
        exaggeration_iters=10))
    monkeypatch.setattr(port_tsne, "STEPS_PER_GRAPH", per_graph)
    steps = []
    step = port_tsne._Descent.step

    def counted(self):
        steps.append(float(self.exaggeration))
        step(self)

    monkeypatch.setattr(port_tsne._Descent, "step", counted)
    got = port_tsne._tsne_optimize(torch.from_numpy(p), torch.from_numpy(y0),
                                   1.0, n_iter=20, exaggeration_iters=10)
    assert steps == [12.0] * 10 + [1.0] * 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    monkeypatch.setattr(port_tsne._Descent, "step", step)
    desc = port_tsne._Descent(torch.from_numpy(p), torch.from_numpy(y0), 1.0)
    for i in range(20):
        desc.phase(i < 10)
        desc.step()
    assert torch.equal(got, desc.y)


def test_calibrated_p_equals_its_step_by_step_search():
    d2, _, _ = _p_and_y0()
    cal = port_tsne._Calibration(torch.from_numpy(d2), 10.0)
    for _ in range(port_tsne.BISECTION_STEPS):
        cal.step()
    assert torch.equal(port_tsne._calibrated_p(torch.from_numpy(d2), 10.0),
                       cal.p())


# -- the data-parallel epoch on two gloo ranks --------------------------------

def _ae_init():
    from tpuvae.models import SimpleAutoencoder
    from tpuvae.train import create_state

    x = np.random.default_rng(3).normal(size=(64, 12)).astype(np.float32)
    model = SimpleAutoencoder(input_dim=12, latent_dim=4)
    state = create_state(model, jax.random.PRNGKey(0), (jnp.asarray(x[:2]),),
                         LR)
    return x, state


def _jax_sum_ae_objective():
    def loss_fn(state, variables, batch, rng, train):
        (x,) = batch
        recon, _ = state.apply_fn(variables, x)
        return jnp.sum((recon - x) ** 2), {}, {}

    return loss_fn


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, state = _ae_init()
    flat = {"params/" + k: v for k, v in _flat(state.params).items()}
    rng = np.random.default_rng(13)
    xs = rng.normal(size=(18, 12)).astype(np.float32)   # 9 a rank: 4 + 4 + 1
    vs = rng.normal(size=(6, 12)).astype(np.float32)    # 3 a rank: 2 + 1
    cases = [("dp_runner", {"x": x, "flat": flat, "lr": LR}),
             ("dp_epoch_static", {"x": xs, "v": vs})]
    results = run_ranks(tmp_path_factory.mktemp("graph_ranks"), WS, cases)
    return {"results": results, "x": x}


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_dp_epoch_runner_matches_the_jax_mesh(ranks, reduction):
    """The restructured epoch (one generator re-seeded each epoch, the body
    a function of device tensors) through ``dp_epoch_runner`` for 3
    epochs against the JAX package's ``fit`` on a 2-device mesh, both
    objectives: the AE's full batch, so neither package's shuffle matters
    (the JAX test's setting).  On the CPU it runs eagerly and says so."""
    from tpuvae.parallel import make_mesh
    from tpuvae.train import FitConfig, autoencoder_objective, fit

    from tpuvae_torch.convert import to_flax

    obj = (autoencoder_objective() if reduction == "mean"
           else _jax_sum_ae_objective())
    _, state = _ae_init()
    jres = fit(state, obj, (ranks["x"],),
               FitConfig(epochs=3, batch_size=64, patience=99, seed=0),
               mesh=make_mesh((WS,), ("data",)), loss_reduction=reduction)
    want = {"params/" + k: v for k, v in _flat(jres.state.params).items()}
    res = [r["dp_runner"][reduction] for r in ranks["results"]]
    for r in res:
        assert r["events"] == [("dp_epoch_graph", {"graph": False,
                                                   "reason": "data on cpu"})]
        np.testing.assert_allclose(r["losses"], jres.history["train_loss"],
                                   rtol=1e-5)
        if reduction == "mean":
            got = to_flax({k: torch.from_numpy(v)
                           for k, v in r["params"].items()})
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=2e-3,
                                           atol=1e-4, err_msg=k)
    for k, v in res[0]["params"].items():
        np.testing.assert_array_equal(v, res[1]["params"][k])


def test_dp_epoch_reads_nothing_on_the_host_and_reseeds_as_new(ranks):
    """One epoch (micro-batches of 2, a 1-row remainder step, a validation
    batch and its remainder) under ``no_host_reads`` on each rank; the
    generator that lives across the epochs, re-seeded at epochs 0 and 3,
    holds and draws what a new one seeded with ``rank_seed`` does; the
    replicas' totals agree."""
    res = [r["dp_epoch_static"] for r in ranks["results"]]
    for r in res:
        assert r["same"] == {0: True, 3: True}
        assert np.isfinite(r["sums"]).all()
    assert res[0]["sums"] == res[1]["sums"]


def test_dp_fit_logs_its_epoch_choice_once_before_the_first_epoch(ranks):
    """``fit(mesh=)`` decides before its first epoch whether the epoch runs
    as a graph and logs it once: on the CPU it runs eagerly."""
    for r in ranks["results"]:
        events = r["dp_epoch_static"]["fit_events"]
        names = [e for e, _ in events]
        assert names.count("dp_epoch_graph") == 1
        assert names.index("dp_epoch_graph") < names.index("epoch")
        assert events[names.index("dp_epoch_graph")][1] == {
            "graph": False, "reason": "data on cpu"}


# -- the host_stream steps ----------------------------------------------------

def _vae(seed=0):
    from tpuvae_torch.models import SimpleVAE

    return SimpleVAE(input_dim=12, hidden_dims=(8,), latent_dim=4,
                     generator=torch.Generator().manual_seed(seed))


def _host_batches(x, bs, rows):
    return [(torch.from_numpy(np.array(x[rows[i:i + bs]])),)
            for i in range(0, len(rows), bs)]


def test_static_input_steps_equal_the_eager_loss_sum():
    """``_StreamSteps`` (the staged batch copied into its shape's static
    inputs, then the step that a card captures) over full batches, the
    ragged remainder and a validation pass, against ``_loss_sum`` on the
    same batches from a copy of the model, optimizer and generator: the
    sums, the weights and the generator bit-equal; one step function per
    batch shape and pass."""
    import copy

    from tpuvae_torch.train import create_state, simple_vae_objective
    from tpuvae_torch.train.loop import _loss_sum, _StreamSteps

    rng = np.random.default_rng(5)
    x = rng.normal(size=(20, 12)).astype(np.float32)
    v = rng.normal(size=(11, 12)).astype(np.float32)
    rows = rng.permutation(20)
    obj = simple_vae_objective(0.5)
    cpu = torch.device("cpu")
    a = create_state(_vae(), 1e-2)
    b = create_state(copy.deepcopy(a.model), 1e-2)
    ga, gb = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    steps = _StreamSteps(a.model, a.optimizer, obj, ga, cpu, 8)
    for _ in range(2):
        steps.begin_epoch()
        a.model.train()
        for batch in _host_batches(x, 8, rows):
            steps(batch, True)
        a.model.eval()
        for batch in _host_batches(v, 8, np.arange(11)):
            steps(batch, False)
        b.model.train()
        want_t = _loss_sum(b.model, obj, _host_batches(x, 8, rows), cpu, gb,
                           True, b.optimizer)
        b.model.eval()
        want_v = _loss_sum(b.model, obj, _host_batches(v, 8, np.arange(11)),
                           cpu, gb, False)
        assert torch.equal(steps.train_sum, want_t)
        assert torch.equal(steps.val_sum, want_v)
    assert sorted(steps.steps) == [(False, 3), (False, 8), (True, 4),
                                   (True, 8)]
    assert torch.equal(ga.get_state(), gb.get_state())
    for (k, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), k


def test_a_host_stream_step_reads_nothing_on_the_host():
    """A training step and a validation batch of ``_StreamSteps`` under
    ``no_host_reads`` (SGD: torch's CPU Adam reads its step count on the
    host, a card's capturable Adam does not)."""
    from tpuvae_torch.train import TrainState, simple_vae_objective
    from tpuvae_torch.train.loop import _StreamSteps

    model = _vae()
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-2))
    steps = _StreamSteps(model, state.optimizer, simple_vae_objective(0.5),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), 8)
    batch = (torch.randn(8, 12),)
    model.train()
    with no_host_reads():
        steps.begin_epoch()
        steps(batch, True)
        model.eval()
        steps(batch, False)


def test_host_stream_fit_matches_the_jax_host_stream_fit():
    """``fit(host_stream=True)`` against the JAX package's on the same flax
    initialisation: the AE's full training batch (so neither package's
    shuffle matters) and a validation set of a full batch and a remainder,
    3 epochs; losses rtol 1e-5, parameters rtol 2e-3 / atol 1e-4."""
    from tpuvae.train import FitConfig as JaxFitConfig
    from tpuvae.train import autoencoder_objective as jax_objective
    from tpuvae.train import fit as jax_fit

    from tpuvae_torch.convert import to_flax
    from tpuvae_torch.train import FitConfig, autoencoder_objective, fit

    import _torch_ranks

    x, state = _ae_init()
    flat = {"params/" + k: v for k, v in _flat(state.params).items()}
    v = np.random.default_rng(8).normal(size=(80, 12)).astype(np.float32)
    jres = jax_fit(state, jax_objective(), (x,),
                   JaxFitConfig(epochs=3, batch_size=64, patience=99,
                                seed=0, monitor="val", host_stream=True),
                   val_data=(v,))
    port = _torch_ranks._ae(flat, LR)
    res = fit(port, autoencoder_objective(), (x,),
              FitConfig(epochs=3, batch_size=64, patience=99, seed=0,
                        monitor="val", host_stream=True), val_data=(v,))
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(res.history[key], jres.history[key],
                                   rtol=1e-5, err_msg=key)
    want = {"params/" + k: np.asarray(t)
            for k, t in _flat(jres.state.params).items()}
    got = to_flax({k: t.detach() for k, t in
                   res.state.model.state_dict().items()})
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=2e-3,
                                   atol=1e-4, err_msg=k)
