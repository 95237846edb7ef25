"""Data- and tensor-parallel training of the port over ``torch.distributed``
(``tpuvae_torch.parallel.{dp, tp}``, ``fit(mesh=, loss_reduction=)``)
against its single-rank run and the JAX package on a 2-device mesh.

The port's ranks are two fresh interpreters joined by gloo on the CPU
(``tests/_torch_ranks.py``), started once for the whole file; the JAX side
runs here on the suite's virtual-device CPU mesh, as
``tests/test_distributed.py`` does.  Tolerances are the JAX tests' own:
loss histories rtol 1e-5; parameters rtol 2e-3 / atol 1e-4 (a reduction
in another order, which Adam's normalisation of near-zero gradients
amplifies).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import run_ranks
from test_torch_conv_models import _flat

WS = 2
# the JAX test's 1e-2 makes the AE's second Adam step overshoot (loss 1.06
# -> 1,335), after which the third epoch's loss moves by 1.4e-5 with the
# order of the batch's rows alone (the port's full-batch fit: 316.1191 in
# file order, 316.1148 shuffled), beyond rtol 1e-5 for any two orders of
# summation; at 1e-3 the fit descends and the comparison is conditioned
LR = 1e-3


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
    rng = np.random.default_rng(11)
    xv = rng.normal(size=(18, 12)).astype(np.float32)
    vv = rng.normal(size=(6, 12)).astype(np.float32)
    rng = np.random.default_rng(12)
    xb = rng.normal(size=(17, 12)).astype(np.float32)     # 17 % 2 -> 1 trimmed
    vb = rng.normal(size=(5, 12)).astype(np.float32)      # 5 % 2 -> 1 trimmed
    x_one = rng.normal(size=(2 * 8, 12)).astype(np.float32)
    rng = np.random.default_rng(7)
    audio = rng.normal(size=(8, 64, 64, 1)).astype(np.float32)
    text = rng.normal(size=(8, 32)).astype(np.float32)
    cases = [
        ("ae_fullbatch", {"x": x, "flat": flat, "reduction": "mean",
                          "lr": LR}),
        ("ae_fullbatch_sum", {"x": x, "flat": flat, "lr": LR}),
        ("val_remainder", {"x": xv, "v": vv, "flat": flat}),
        ("batch_norm", {"x": xb, "v": vb, "x_one": x_one}),
        ("dp_errors", {}),
        ("tp_indivisible", {}),
        ("tp_dp", {"audio": audio, "text": text}),
    ]
    results = run_ranks(tmp_path_factory.mktemp("dp_ranks"), WS, cases)
    return {"results": results, "x": x, "flat": flat, "xv": xv, "vv": vv,
            "audio": audio, "text": text}


def _assert_params_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_dp_fit_matches_single_rank_and_jax(ranks, reduction):
    """The AE full-batch fit over two ranks equals the port's single-rank
    fit and the JAX package's fit(mesh=make_mesh((2,))) from the same flax
    initialisation: the global full-batch gradient is the reduction of
    the ranks' local gradients and the loss is order-invariant, so the
    ranks' shuffles cannot change it.  Under the 'sum' objective the
    parameters are held to the single-rank fit and the losses to JAX's:
    its gradients are ~800x the mean's, and three Adam steps then part
    torch's fp32 arithmetic from XLA's on a few elements whose gradient
    is rounding-level (three in ``Dense_1``'s kernel and three in
    ``Dense_4``'s, by up to 4.6e-4; the port's single-rank fit against
    JAX's single-device fit shows the same six), which no reduction over
    ranks causes."""
    from tpuvae.parallel import make_mesh
    from tpuvae.train import FitConfig, autoencoder_objective, fit

    from tpuvae_torch.convert import to_flax

    key = "ae_fullbatch" if reduction == "mean" else "ae_fullbatch_sum"
    res = [r[key] for r in ranks["results"]]
    obj = (autoencoder_objective() if reduction == "mean"
           else _jax_sum_ae_objective())
    _, state = _ae_init()
    jres = fit(state, obj, (ranks["x"],),
               FitConfig(epochs=3, batch_size=64, patience=99, seed=0),
               mesh=make_mesh((WS,), ("data",)), loss_reduction=reduction)
    want = {"params/" + k: v for k, v in _flat(jres.state.params).items()}
    for r in res:
        hist, params = r["dp"]
        np.testing.assert_allclose(hist, r["single"][0], rtol=1e-5)
        np.testing.assert_allclose(hist, jres.history["train_loss"],
                                   rtol=1e-5)
        _assert_params_close(params, r["single"][1])
        if reduction == "mean":
            got = to_flax({k: torch.from_numpy(v) for k, v in params.items()})
            _assert_params_close(got, want)
    # the replicas stay bit-equal
    for k, v in res[0]["dp"][1].items():
        np.testing.assert_array_equal(v, res[1]["dp"][1][k])


def test_dp_epoch_val_total_and_remainder_batches(ranks):
    """batch_size 4 over 2 ranks -> micro-batches of 2; 9 rows a rank -> 4
    steps and a 1-row remainder; 3 validation rows a rank -> one batch of
    2 and a 1-row remainder.  The deterministic AE's validation total is
    the same grouping recomputed from per-row losses on the host: the mean
    over ranks of (mean loss of each local batch, summed)."""
    from tpuvae_torch.models import SimpleAutoencoder

    res = [r["val_remainder"] for r in ranks["results"]]
    assert res[0]["val"] == res[1]["val"] and res[0]["loss"] == res[1]["loss"]
    assert np.isfinite(res[0]["loss"])
    changed = [k for k in res[0]["before"]
               if not np.array_equal(res[0]["before"][k], res[0]["after"][k])]
    assert changed, "the epoch did not update the parameters"
    for k, v in res[0]["after"].items():
        np.testing.assert_array_equal(v, res[1]["after"][k])
    model = SimpleAutoencoder(input_dim=12, latent_dim=4)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in res[0]["after"].items()})
    v = ranks["vv"]
    with torch.no_grad():
        recon = model(torch.from_numpy(v))[0].numpy()
    r = ((recon - v) ** 2).mean(axis=1)
    per_rank = [r[3 * i:3 * i + 2].mean() + r[3 * i + 2] for i in range(WS)]
    np.testing.assert_allclose(res[0]["val"], np.mean(per_rank), rtol=1e-5)


def test_dp_batch_norm_buffers_are_synced(ranks):
    """After a step every rank's BatchNorm buffers hold the same bits: the
    old statistics moved by the mean of the ranks' local batch statistics
    (flax's momentum 0.99, biased variance).  fit(mesh=) trims the rows
    beyond a multiple of D of both sets, logs ``dp_trim``, and moves the
    statistics."""
    res = [r["batch_norm"] for r in ranks["results"]]
    one = [r["one_step"] for r in res]
    for a, b in zip(one[0]["running"], one[1]["running"]):
        np.testing.assert_array_equal(a, b)
    means = np.mean([o["local_stats"][0] for o in one], axis=0)
    variances = np.mean([o["local_stats"][1] for o in one], axis=0)
    np.testing.assert_allclose(one[0]["running"][0], 0.01 * means,
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(one[0]["running"][1], 0.99 + 0.01 * variances,
                               rtol=1e-6)
    assert res[0]["trims"] == [{"dropped_train_rows": 1},
                               {"dropped_val_rows": 1}]
    assert len(res[0]["val_loss"]) == 2 and np.isfinite(res[0]["val_loss"]).all()
    assert any(not np.allclose(res[0]["stats0"][k], res[0]["stats2"][k])
               for k in res[0]["stats0"])
    for k, v in res[0]["stats2"].items():
        np.testing.assert_array_equal(v, res[1]["stats2"][k])


def test_make_dp_epoch_rejects_bad_config_and_pipelines_log_dp_disabled(ranks):
    for r in ranks["results"]:
        res = r["dp_errors"]
        assert "loss_reduction" in res["errors"][0]
        assert "divide" in res["errors"][1]
        assert res["disabled"] and res["enabled"]
        assert res["events"] == [("dp_disabled", {
            "reason": "batch_size % n_devices != 0", "batch_size": 5,
            "n_devices": WS})]


def test_fit_refuses_host_stream_with_a_mesh():
    from tpuvae_torch.parallel import make_mesh
    from tpuvae_torch.train import (
        FitConfig,
        autoencoder_objective,
        create_state,
        fit,
    )
    from tpuvae_torch.models import SimpleAutoencoder

    mesh = make_mesh((1,), ("data",), device="cpu")
    state = create_state(SimpleAutoencoder(input_dim=12, latent_dim=4), 1e-3)
    with pytest.raises(ValueError, match="host_stream"):
        fit(state, autoencoder_objective(), (np.zeros((4, 12), np.float32),),
            FitConfig(epochs=1, host_stream=True), mesh=mesh)
    with pytest.raises(ValueError, match="loss_reduction"):
        from tpuvae_torch.parallel import make_dp_epoch

        make_dp_epoch(autoencoder_objective(), mesh, batch_size=4,
                      n_local=4, n_train_arrays=1, loss_reduction="avg")


def test_tp_rule_gives_the_logical_dimension_jax_shards():
    """``tp_spec_for`` on every parameter of the small Hybrid VAE at
    big = 512 shards the dimension JAX's rule shards on the flax leaf
    (torch's (out, in) weight is flax's (in, out) kernel transposed); a
    square matrix shards its input dimension, as in flax."""
    from tpuvae.parallel.tp import tp_spec_for as jax_spec

    from tpuvae_torch.convert import to_flax
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.parallel import tp_spec_for

    model = HybridVAE(latent_dim=16, text_dim=32, input_hw=(64, 64))
    sharded = 0
    for name, p in model.named_parameters():
        (key, leaf), = to_flax({name: p.detach()}).items()
        want = tuple(jax_spec(jnp.zeros(leaf.shape), big=512))
        got = tp_spec_for(p, big=512)
        assert (got[::-1] if p.ndim == 2 else got) == want, (name, got, want)
        sharded += bool(got)
    assert sharded >= 10
    square = torch.empty(512, 512)
    assert tp_spec_for(square, big=512) == (None, "model")
    assert tuple(jax_spec(jnp.zeros((512, 512)), big=512)) == ("model", None)
    assert tp_spec_for(torch.empty(16, 16), big=512) == ()


def test_tp_dp_step_matches_single_rank_step(ranks):
    """One DP x TP step on a (1, 2) (data, model) mesh equals the plain
    single-rank step (SGD; loss rtol 1e-5, parameters rtol 2e-3 / atol
    1e-4), with ``audio_decoder_fc``'s (512, 1024) weight really split on
    its input dimension (a (512, 512) half on each rank) and Adam's
    moments placed like it.  The model axis must divide every sharded
    dimension."""
    for r in ranks["results"]:
        res = r["tp_dp"]
        np.testing.assert_allclose(res["loss_tp"], res["loss_1"], rtol=1e-5)
        _assert_params_close(
            {k: v for k, v in res["tp"].items()},
            {k: v for k, v in res["single"].items()})
        assert res["weight"] == (True, (512, 512), "(Shard(dim=1),)")
        assert res["moments"] == [(True, "(Shard(dim=1),)", (512, 512))] * 2
        assert res["rule"]["audio_decoder_fc.weight"] == ["R", "S(1)"]
        assert res["rule"]["audio_fc.weight"] == ["R", "S(0)"]
        assert res["rule"]["audio_fc.bias"] == ["R", "S(0)"]
        assert res["rule"]["audio_encoder.conv.0.weight"] == ["R", "R"]
        assert "does not divide sharded dimension 513" in r["tp_indivisible"]
