"""The slice as a whole: ``run_simple_vae`` of the JAX package and of the
port on the same ``processed_data1``, on the CPU.

The directory is written here with numpy and pandas (through the port's
``save_basic``): 96 rows of 370-d seeded blobs from 4 planted groups,
``labels.npy`` and a ``metadata.csv`` with a ``language`` column.  Both
pipelines train 3 epochs at batch 16 and sweep k in (2, 3, 4).  Trained
metrics cannot match across the two RNGs; the checks are the CSV's shape,
finite values, the quality floor, and that the JAX package reads the
port's checkpoint (latents within atol 1e-5).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

N_ROWS = 96
K_SWEEP = (2, 3, 4)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.io.artifacts import load_basic, save_basic
    from tpuvae_torch.io.normalize import impute_and_scale

    rng = np.random.default_rng(21)
    groups = np.repeat(np.arange(4), N_ROWS // 4)
    centres = rng.normal(0.0, 3.0, (4, 370))
    raw = (centres[groups] + rng.normal(size=(N_ROWS, 370))).astype(np.float32)
    raw[3, 7] = np.inf                          # the imputer's inf -> mean
    normed, imputer, scaler = impute_and_scale(raw)
    genres = np.array(["pop", "rock", "jazz", "folk"])[groups]
    meta = pd.DataFrame({"path": [f"clip_{i}.wav" for i in range(N_ROWS)],
                         "genre": genres,
                         "language": np.where(groups % 2, "bangla", "english")})
    out = tmp_path_factory.mktemp("processed_data1")
    save_basic(out, features_raw=raw, features_normalized=normed,
               labels=genres, metadata=meta, scaler=scaler, imputer=imputer,
               config=PreprocessConfig(duration=2.0))
    back = load_basic(out)
    np.testing.assert_array_equal(back["features"], normed)
    assert list(back["metadata"].columns) == ["path", "genre", "language"]
    return out


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):
    from tpuvae.config import ClusterConfig as JaxCluster
    from tpuvae.config import SimpleVAEConfig as JaxSimple
    from tpuvae.pipelines import run_simple_vae as jax_run
    from tpuvae.utils.logging import RunLogger as JaxLogger

    from tpuvae_torch.config import ClusterConfig, SimpleVAEConfig
    from tpuvae_torch.pipelines import run_simple_vae
    from tpuvae_torch.utils.logging import RunLogger

    out = tmp_path_factory.mktemp("results")
    jax_df = jax_run(str(data_dir), str(out / "jax"),
                     JaxSimple(epochs=3, batch_size=16),
                     JaxCluster(simple_k_sweep=K_SWEEP),
                     logger=JaxLogger(echo=False), make_plots=False)
    log = out / "port.jsonl"
    port_df = run_simple_vae(str(data_dir), str(out / "port"),
                             SimpleVAEConfig(epochs=3, batch_size=16),
                             ClusterConfig(simple_k_sweep=K_SWEEP),
                             logger=RunLogger(log, echo=False),
                             make_plots=False, device="cpu")
    return out, jax_df, port_df, log


def test_run_simple_vae_writes_the_jax_csv_shape(runs):
    from tpuvae.parity import quality_floors

    out, jax_df, port_df, _ = runs
    jax_csv = pd.read_csv(out / "jax" / "clustering_metrics.csv")
    port_csv = pd.read_csv(out / "port" / "clustering_metrics.csv")
    assert list(port_csv.columns) == list(jax_csv.columns)
    assert port_csv["Method"].tolist() == jax_csv["Method"].tolist() == [
        "VAE + KMeans", "PCA + KMeans"]
    assert (port_csv["Architecture"] == jax_csv["Architecture"]).all()
    assert list(port_df.columns) == list(jax_df.columns)
    vals = port_csv[["Silhouette", "Calinski-Harabasz"]].to_numpy()
    assert np.isfinite(vals).all()
    assert port_csv["Silhouette"][0] >= quality_floors()["silhouette"]


def test_run_simple_vae_sweeps_and_logs_its_stages(runs):
    import json

    out, _, _, log = runs
    events = [json.loads(line) for line in log.read_text().splitlines()]
    by_name = {e["event"]: e for e in events}
    assert by_name["scan_epochs_ignored"]
    assert by_name["fit"]["epochs"] == 3
    assert sorted(int(k) for k in by_name["k_sweep"]["scores"]) == list(K_SWEEP)
    assert by_name["k_sweep"]["best_k"] in K_SWEEP
    assert by_name["pca_row"]["seconds"] > 0
    meta = json.loads((out / "port" / "Simple_VAE" / "serving" / "model" /
                       "metadata.json").read_text())
    assert meta["best_k"] == by_name["k_sweep"]["best_k"]
    centres = np.load(out / "port" / "Simple_VAE" / "serving" /
                      "kmeans_centers.npy")
    assert centres.shape == (meta["best_k"], 32)


def test_jax_package_reads_the_ports_checkpoint(runs, data_dir):
    from tpuvae.models import SimpleVAE as FlaxVAE
    from tpuvae.train.checkpoint import load_checkpoint as jax_load

    from tpuvae_torch.convert import simple_vae_from_flax
    from tpuvae_torch.infer import ClipEncoder
    from tpuvae_torch.models import SimpleVAE
    from tpuvae_torch.train.checkpoint import load_checkpoint

    out, _, _, _ = runs
    x = np.load(data_dir / "features_normalized.npy")
    best = out / "port" / "Simple_VAE" / "best_vae_model"
    params, stats, meta = jax_load(best)
    assert meta["best_epoch"] in (0, 1, 2)
    want = np.asarray(FlaxVAE().apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(x), method=FlaxVAE.latent))
    model = SimpleVAE()
    model.load_state_dict(simple_vae_from_flax(load_checkpoint(best)[0]))
    with torch.no_grad():
        got = model.eval().latent(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    enc = ClipEncoder.load("simple", results_dir=str(out / "port"),
                           device="cpu")
    assert enc.meta["data_dir"] == str(data_dir)
    assert enc.pre_cfg.duration == 2.0 and enc.centers.shape[1] == 32
    np.testing.assert_allclose(enc.apply_latent(x).numpy(), got, rtol=0,
                               atol=1e-6)


def test_cli_train_simple_on_the_cpu(data_dir, tmp_path, capsys):
    from tpuvae_torch import cli

    res = tmp_path / "results"
    assert cli.main(["train-simple", f"--data_dir={data_dir}",
                     f"--results_dir={res}", "--device=cpu", "--epochs=1",
                     "--batch_size=32", "--hidden_dims=[64, 32]",
                     "--latent_dim=8"]) == 0
    assert "VAE + KMeans" in capsys.readouterr().out
    csv = pd.read_csv(res / "clustering_metrics.csv")
    assert csv["Architecture"].tolist() == ["Simple VAE"] * 2
    assert cli.main(["train-simple", f"--data_dir={data_dir}",
                     f"--results_dir={res}", "--device=cpu",
                     "--bogus=1"]) == 2
    # mid-train checkpoints: every 2 epochs, the newest kept, plots off
    ck = res / "Simple_VAE" / "checkpoints"
    assert cli.main(["train-simple", f"--data_dir={data_dir}",
                     f"--results_dir={res}", "--device=cpu", "--plots=0",
                     "--epochs=4", "--checkpoint_every=2",
                     "--hidden_dims=[64, 32]", "--latent_dim=8"]) == 0
    assert sorted(p.name for p in ck.iterdir()) == [
        "best", "latest", "step_00000003"]
    assert (ck / "latest").resolve().name == "step_00000003"


def test_run_simple_vae_refuses_plots(data_dir, tmp_path, monkeypatch):
    """``make_plots`` draws the t-SNE figure; without matplotlib the run
    is refused before it trains or writes anything."""
    import sys

    from tpuvae_torch.config import ClusterConfig, SimpleVAEConfig
    from tpuvae_torch.pipelines import run_simple_vae
    from tpuvae_torch.utils.logging import RunLogger

    cfg = SimpleVAEConfig(epochs=1, batch_size=32, hidden_dims=(64, 32),
                          latent_dim=8)
    run_simple_vae(str(data_dir), str(tmp_path / "r"), cfg,
                   ClusterConfig(simple_k_sweep=K_SWEEP),
                   RunLogger(echo=False), make_plots=True, device="cpu")
    png = tmp_path / "r" / "Simple_VAE" / "tsne_visualization_simplified.png"
    assert png.stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        run_simple_vae(str(data_dir), str(tmp_path / "none"), cfg,
                       make_plots=True, device="cpu")
    assert not (tmp_path / "none").exists()
