"""The Conditional VAE pipeline of the port, on the CPU, against the JAX
package: external metrics, the train/val split, host-streamed training,
``evaluate_clustering``, ``run_conditional_vae`` / ``cli train-cvae`` on a
tiny ``processed_data2`` (24 clips, mel 64 x 128, written with the port's
``save_advanced`` from seeded arrays), and the stubs of what waits.

Tolerances: NMI / ARI / purity 1e-6 absolute (float64 in the port, float32
in the JAX package); silhouette on separated blobs 1e-5; latents of the
port's trained weights through the flax model rtol 1e-4 / atol 1e-5 (twelve
fp32 conv layers in two libraries); host-streamed losses equal to the
resident epoch's bit for bit (the same batches, noise and op order).
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

HW = (64, 128)
N = 24
GENRES = ("classical", "pop", "rock")


def _write_processed_data2(out, seed=0):
    from tpuvae_torch.io.artifacts import save_advanced
    from tpuvae_torch.io.normalize import impute_and_scale, normalize_mel_images

    rng = np.random.default_rng(seed)
    g = np.arange(N) % len(GENRES)
    mel = (rng.normal(size=(N, *HW)) + 0.5 * g[:, None, None]).astype(np.float32)
    feats = (rng.normal(size=(N, 290)) + 2.0 * g[:, None]).astype(np.float32)
    text = rng.normal(size=(N, 768)).astype(np.float32)
    mel_norm, mel_scaler = normalize_mel_images(mel)
    feats_norm, imputer, flat_scaler = impute_and_scale(feats)
    labels = np.array(GENRES)[g]
    meta = pd.DataFrame({"file_id": [f"clip_{i:03d}" for i in range(N)],
                         "genre": labels,
                         "language": np.where(np.arange(N) % 2, "bangla",
                                              "english")})
    save_advanced(out, mel_raw=mel, mel_normalized=mel_norm,
                  features_raw=feats, features_normalized=feats_norm,
                  lyrics_embeddings=text, labels=labels, metadata=meta,
                  mel_scaler=mel_scaler, flat_scaler=flat_scaler,
                  imputer=imputer, config={"fixed_time_steps": HW[1]})
    return g


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One ``run_conditional_vae(device='cpu')`` on the tiny corpus."""
    from tpuvae_torch.config import ClusterConfig, ConditionalVAEConfig
    from tpuvae_torch.pipelines import run_conditional_vae
    from tpuvae_torch.utils.logging import RunLogger

    root = tmp_path_factory.mktemp("cvae")
    data, results = root / "processed_data2", root / "results"
    genres = _write_processed_data2(data)
    log = root / "run.jsonl"
    logger = RunLogger(log, echo=False)
    cfg = ConditionalVAEConfig(epochs=2, batch_size=8)
    try:
        df = run_conditional_vae(str(data), str(results), cfg, ClusterConfig(),
                                 logger, make_plots=False, device="cpu")
    finally:
        logger.close()
    events = [json.loads(line) for line in log.read_text().splitlines()]
    return {"root": root, "data": data, "results": results, "df": df,
            "cfg": cfg, "genres": genres,
            "events": {e["event"]: e for e in events}}


# -- metrics/external, split, host stream -------------------------------------------

_LABEL_CASES = {
    "random": (lambda r: r.integers(0, 4, 60), lambda r: r.integers(0, 5, 60), 4, 5),
    "equal": (lambda r: np.arange(60) % 3, lambda r: np.arange(60) % 3, 3, 3),
    "permuted": (lambda r: np.arange(60) % 3, lambda r: (np.arange(60) + 1) % 3, 3, 3),
    "one_cluster": (lambda r: np.arange(60) % 3, lambda r: np.zeros(60, int), 3, 1),
    "both_trivial": (lambda r: np.zeros(60, int), lambda r: np.zeros(60, int), 1, 1),
    "empty_slot": (lambda r: r.integers(0, 3, 60), lambda r: r.integers(0, 2, 60) * 2, 3, 3),
}


@pytest.mark.parametrize("case", sorted(_LABEL_CASES))
def test_external_metrics_match_jax(case):
    from tpuvae.metrics import external as jx

    from tpuvae_torch.metrics import external as ex

    rng = np.random.default_rng(3)
    mk_t, mk_p, nt, npred = _LABEL_CASES[case]
    yt, yp = np.asarray(mk_t(rng), np.int32), np.asarray(mk_p(rng), np.int32)
    np.testing.assert_array_equal(
        ex.contingency(yt, yp, nt, npred).numpy(),
        np.asarray(jx.contingency(jnp.asarray(yt), jnp.asarray(yp), nt, npred)))
    for name in ("purity_score", "adjusted_rand_score", "normalized_mutual_info"):
        got = getattr(ex, name)(yt, yp, nt, npred)
        want = float(getattr(jx, name)(jnp.asarray(yt), jnp.asarray(yp), nt, npred))
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n,frac,seed", [(24, 0.15, 42), (1336, 0.15, 42),
                                         (100, 0.3, 7)])
def test_train_val_split_equals_jax(n, frac, seed):
    from tpuvae.train import train_val_split as jax_split

    from tpuvae_torch.train.loop import train_val_split

    tr, va = train_val_split(n, frac, seed)
    jtr, jva = jax_split(n, frac, seed)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    assert len(tr) == int((1 - frac) * n) and len(tr) + len(va) == n


def test_one_hot_and_row_view_match_jax(tmp_path):
    from tpuvae.metrics.labels import one_hot_np as jax_one_hot
    from tpuvae.utils import RowView as JaxRowView

    from tpuvae_torch.metrics.labels import one_hot_np
    from tpuvae_torch.utils.batching import RowView

    codes = np.array([2, 0, 1, 2])
    np.testing.assert_array_equal(one_hot_np(codes), jax_one_hot(codes))
    np.testing.assert_array_equal(one_hot_np(codes, 5), jax_one_hot(codes, 5))
    base = np.random.default_rng(0).normal(size=(10, 4, 6)).astype(np.float32)
    np.save(tmp_path / "m.npy", base)
    mm = np.load(tmp_path / "m.npy", mmap_mode="r")
    rows = np.array([7, 2, 9, 0])
    for kw in ({}, {"rows": rows}, {"rows": rows, "add_channel": True}):
        a, b = RowView(mm, **kw), JaxRowView(mm, **kw)
        assert a.shape == b.shape and len(a) == len(b)
        for key in (slice(1, 3), np.array([3, 0]), slice(None)):
            got, want = a[key], b[key]
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["array", "memmap_rowview"])
def test_host_stream_gives_the_resident_epochs_losses(tmp_path, source):
    from tpuvae_torch.models import ConditionalVAE
    from tpuvae_torch.train.loop import FitConfig, fit, train_val_split
    from tpuvae_torch.train.objectives import cvae_objective
    from tpuvae_torch.train.state import create_state
    from tpuvae_torch.utils.batching import RowView

    rng = np.random.default_rng(1)
    n = 11
    mel = rng.normal(size=(n, *HW)).astype(np.float32)
    text = rng.normal(size=(n, 768)).astype(np.float32)
    cond = np.eye(3, dtype=np.float32)[np.arange(n) % 3]
    tr, va = train_val_split(n, 0.3, 5)      # 7 train (4 + ragged 3), 4 val

    def run(stream: bool):
        model = ConditionalVAE(num_classes=3, input_hw=HW,
                               generator=torch.Generator().manual_seed(0))
        cfg = FitConfig(epochs=2, batch_size=4, monitor="val",
                        host_stream=stream, seed=3)
        if not stream:
            data = [tuple(torch.from_numpy(a[r]) for a in
                          (mel[..., None], text, cond)) for r in (tr, va)]
        elif source == "array":
            data = [(mel[r][..., None], text[r], cond[r]) for r in (tr, va)]
        else:
            np.save(tmp_path / "mel.npy", mel)
            mm = np.load(tmp_path / "mel.npy", mmap_mode="r")
            data = [(RowView(mm, r, add_channel=True), text[r], cond[r])
                    for r in (tr, va)]
        res = fit(create_state(model, 1e-4), cvae_objective(), data[0], cfg,
                  val_data=data[1])
        return res.history, model.state_dict()

    hist_r, sd_r = run(False)
    hist_s, sd_s = run(True)
    assert hist_s["train_loss"] == hist_r["train_loss"]
    assert hist_s["val_loss"] == hist_r["val_loss"]
    assert len(hist_s["epoch_seconds"]) == 2
    for k in sd_r:
        assert torch.equal(sd_r[k], sd_s[k]), k


def test_evaluate_clustering_matches_jax_on_separated_blobs():
    from tpuvae.pipelines import evaluate_clustering as jax_eval

    from tpuvae_torch.pipelines import evaluate_clustering

    rng = np.random.default_rng(2)
    y = np.arange(90) % 3
    x = (rng.normal(size=(90, 8)) + 8.0 * np.eye(3)[y] @ rng.normal(size=(3, 8))
         ).astype(np.float32)
    got = evaluate_clustering(torch.from_numpy(x), y, 3, seed=42)
    want = jax_eval(x, y, 3, seed=42)
    assert list(got) == list(want) == ["Silhouette", "NMI", "ARI", "Purity"]
    np.testing.assert_allclose(got["Silhouette"], want["Silhouette"], atol=1e-5)
    for k in ("NMI", "ARI", "Purity"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    assert got["Purity"] == 1.0


# -- the pipeline ------------------------------------------------------------------

def test_run_conditional_vae_writes_the_jax_pipelines_artifacts(trained):
    results, df = trained["results"], trained["df"]
    assert df["Method"].tolist() == [
        "CVAE (Multi-Modal)", "PCA + K-Means", "Autoencoder + K-Means",
        "Direct Spectral"]
    assert list(df.columns) == ["Silhouette", "NMI", "ARI", "Purity", "Method"]
    assert np.isfinite(df[["Silhouette", "NMI", "ARI", "Purity"]].to_numpy()).all()
    for path in (results / "clustering_metrics.csv",
                 results / "Conditional_VAE" / "clustering_metrics.csv"):
        csv = pd.read_csv(path)
        assert list(csv.columns) == ["Silhouette", "NMI", "ARI", "Purity",
                                     "Method", "Architecture"]
        assert (csv["Architecture"] == "Conditional VAE").all() and len(csv) == 4
    # the planted genres separate in the handcrafted features
    assert float(df.loc[df["Method"] == "Direct Spectral", "Purity"].iloc[0]) == 1.0
    serving = results / "Conditional_VAE" / "serving"
    meta = json.loads((serving / "model" / "metadata.json").read_text())
    assert meta["arch"] == "cvae" and meta["input_hw"] == list(HW)
    assert meta["num_classes"] == 3 and meta["genre_names"] == list(GENRES)
    assert meta["latent_dim"] == 64 and meta["compute_dtype"] == "float32"
    assert np.load(serving / "kmeans_centers.npy").shape == (3, 64)
    ev = trained["events"]
    assert ev["fit_start"]["n_train"] == 20 and ev["fit_start"]["n_val"] == 4
    assert ev["fit"]["epochs"] == 2 and len(ev["fit"]["val_loss"]) == 2
    assert ev["latents"]["shape"] == [N, 64]
    assert ev["evaluate_clustering"]["rows"] == 4


def test_trained_weights_load_into_the_flax_model_with_equal_latents(trained):
    from tpuvae.models import ConditionalVAE as JaxCVAE
    from tpuvae.train.checkpoint import load_checkpoint as jax_load

    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.io.artifacts import load_advanced
    from tpuvae_torch.models import ConditionalVAE
    from tpuvae_torch.train.checkpoint import load_checkpoint

    ckpt = trained["results"] / "Conditional_VAE" / "serving" / "model"
    params, batch_stats, meta = jax_load(ckpt)
    data = load_advanced(trained["data"])
    mel = np.asarray(data["mel"], np.float32)[:6, ..., None]
    text = np.asarray(data["text"], np.float32)[:6]
    cond = np.eye(3, dtype=np.float32)[trained["genres"][:6]]
    jm = JaxCVAE(latent_dim=64, num_classes=3, input_hw=HW)
    want = jm.apply({"params": params, "batch_stats": batch_stats},
                    jnp.asarray(mel), jnp.asarray(text), jnp.asarray(cond),
                    method=JaxCVAE.latent)
    flat, meta2 = load_checkpoint(ckpt)
    assert meta2 == meta
    model = ConditionalVAE(num_classes=3, input_hw=HW)
    model.load_state_dict(from_flax(flat))
    model.eval()
    with torch.no_grad():
        got = model.latent(torch.from_numpy(mel), torch.from_numpy(text),
                           torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # trained: BatchNorm statistics have left their initial values
    assert not np.allclose(flat["batch_stats/audio_encoder/BatchNorm_0/var"], 1.0)


def test_cli_train_cvae_on_cpu_with_host_stream(trained, capsys):
    from tpuvae_torch import cli

    results = trained["root"] / "results_cli"
    rc = cli.main(["train-cvae", "--device=cpu", "--epochs=2", "--batch_size=8",
                   "--host_stream=true", f"--data_dir={trained['data']}",
                   f"--results_dir={results}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "CVAE (Multi-Modal)" in out and "Direct Spectral" in out
    csv = pd.read_csv(results / "clustering_metrics.csv")
    # the same seeds, batches and noise as the resident run of the fixture
    want = trained["df"]
    np.testing.assert_allclose(
        csv[["Silhouette", "NMI", "ARI", "Purity"]].to_numpy(),
        want[["Silhouette", "NMI", "ARI", "Purity"]].to_numpy(), atol=1e-6)
    assert cli.main(["train-cvae", "--device=cpu", "--bogus=1"]) == 2


@pytest.mark.parametrize("what", ["bfloat16", "make_plots", "trunk_bfloat16"])
def test_what_waits_raises_naming_its_roadmap_item(what, tmp_path, trained,
                                                   monkeypatch):
    """Once waiting, now ported.  ``bfloat16``: a 1-epoch run in bf16
    writes ``compute_dtype: "bfloat16"`` in the bundle's meta and finite
    rows.  ``trunk_bfloat16``: the bf16 trunk returns bf16 in both modes
    without calling kernel 6's wrapper.  ``make_plots``: the three figures
    of the JAX pipeline are drawn under ``Conditional_VAE/``."""
    from tpuvae_torch import pipelines
    from tpuvae_torch.config import ConditionalVAEConfig
    from tpuvae_torch.train.checkpoint import load_checkpoint
    from tpuvae_torch.utils.logging import RunLogger

    if what == "make_plots":
        pipelines.run_conditional_vae(
            str(trained["data"]), str(tmp_path / "r"),
            ConditionalVAEConfig(epochs=1, batch_size=8), logger=RunLogger(
                echo=False), make_plots=True, device="cpu")
        out = tmp_path / "r" / "Conditional_VAE"
        for png in ("reconstruction.png", "cvae_latent_tsne_genre.png",
                    "cluster_lang_distribution.png"):
            assert (out / png).stat().st_size > 0, png
        return
    from tpuvae_torch.models import layers

    def no_kernel6(*args, **kwargs):
        raise AssertionError("kernel 6 called under bfloat16")

    monkeypatch.setattr(layers, "fused_trunk2", no_kernel6)
    if what == "bfloat16":
        df = pipelines.run_conditional_vae(
            str(trained["data"]), str(tmp_path / "r"),
            ConditionalVAEConfig(epochs=1, batch_size=8,
                                 compute_dtype="bfloat16"),
            logger=RunLogger(echo=False), make_plots=False, device="cpu")
        _, meta = load_checkpoint(tmp_path / "r" / "Conditional_VAE"
                                  / "serving" / "model")
        assert meta["compute_dtype"] == "bfloat16"
        assert df["Method"].tolist()[0] == "CVAE (Multi-Modal)"
        assert np.isfinite(df[["Silhouette", "NMI", "ARI",
                               "Purity"]].to_numpy()).all()
        return
    gen = torch.Generator().manual_seed(0)
    trunk = layers.lecun_init_(layers.ConvEncoderTrunk(dtype=torch.bfloat16),
                               gen)
    x = torch.randn((2, 64, 64, 1), generator=gen)
    for mode in (True, False):
        out = trunk.train(mode)(x)
        assert out.dtype == torch.bfloat16 and out.shape == (2, 512)
        assert bool(torch.isfinite(out.float()).all())


def test_conv_configs_match_jax_defaults():
    from tpuvae import config as jc

    from tpuvae_torch import config as pc

    for name in ("ConditionalVAEConfig", "HybridVAEConfig", "TrainConfig"):
        assert getattr(pc, name)().to_dict() == getattr(jc, name)().to_dict()
    args = ["--epochs=3", "--host_stream=true", "latent_dim=16"]
    assert (pc.ConditionalVAEConfig().override(args).to_dict()
            == jc.ConditionalVAEConfig().override(args).to_dict())
    assert set(pc.DEFAULTS) == set(jc.DEFAULTS)
    assert pc.DEFAULTS["conditional_vae"] is pc.ConditionalVAEConfig
    with pytest.raises(KeyError):
        pc.HybridVAEConfig().override(["--bogus=1"])
