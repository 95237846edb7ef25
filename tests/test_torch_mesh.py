"""The port's mesh over ``torch.distributed`` (``tpuvae_torch.parallel.mesh``,
``metrics.silhouette_sharded``, the sharded preprocess / encode / CLI and
the training pipelines' ``mesh=``) against ``tests/test_distributed.py``'s
cases and the JAX package, at world size 2.

The port's two ranks are fresh interpreters joined by gloo on the CPU
(``tests/_torch_ranks.py``), started once for the whole file; the JAX side
runs here on the suite's virtual-device CPU mesh.  Tolerances: the
silhouette within 1e-5 absolute of JAX's and of the port's unsharded
``silhouette_score`` (fp32 sums in another grouping); sharded encoding
bit-equal to the unsharded run's where the batches group the same rows;
sharded preprocess features within fp32 rounding of another batch split
(rtol 1e-5 / atol 1e-6), carried through the normalizers.
"""

import json
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from _torch_ranks import run_ranks
from test_torch_cvae_pipeline import _write_processed_data2

WS = 2
SR = 22050


def _silhouette_data():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.normal(-2, 0.6, (45, 6)), rng.normal(2, 0.6, (50, 6)),
        rng.normal((0, 5, 0, 0, 0, 0), 0.6, (32, 6)),
    ]).astype(np.float32)                      # 127 rows: not mesh-divisible
    labels = np.concatenate([np.zeros(45), np.ones(50), np.full(32, 2)])
    labels2 = labels.copy()
    labels2[0] = 3                             # a singleton cluster
    return x, [labels, labels2]


def _bundle(root):
    """Five 1 s clips and a simple-arch serving bundle written by the port."""
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp import extract_basic_features
    from tpuvae_torch.infer import save_serving_bundle
    from tpuvae_torch.io.normalize import impute_and_scale
    from tpuvae_torch.io.wav import load_audio
    from tpuvae_torch.models import SimpleVAE
    from test_torch_infer import _write_wav

    rng = np.random.default_rng(9)
    t = np.arange(SR) / SR
    paths = []
    for i in range(5):
        y = (0.3 * np.sin(2 * np.pi * 110 * 2 ** rng.uniform(0, 3) * t)
             + 0.03 * rng.normal(size=t.shape))
        paths.append(root / f"clip_{i}.wav")
        _write_wav(paths[-1], y)
    cfg = PreprocessConfig(duration=1.0)
    waves = np.stack([load_audio(p, SR, 1.0) for p in paths])
    feats = extract_basic_features(torch.from_numpy(waves), cfg).numpy()
    _, imputer, scaler = impute_and_scale(feats)
    model = SimpleVAE(input_dim=feats.shape[1], latent_dim=8,
                      generator=torch.Generator().manual_seed(0))
    centers = rng.normal(size=(3, 8)).astype(np.float32)
    save_serving_bundle(root / "results", root / "data", model, centers,
                        pre_cfg=cfg, imputer=imputer, scaler=scaler,
                        meta={"arch": "simple", "input_dim": feats.shape[1],
                              "hidden_dims": [128, 64, 32], "latent_dim": 8,
                              "dropout": 0.2, "data_dir": str(root / "data")})
    return [str(p) for p in paths]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.io.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("mesh")
    datasets = root / "Datasets"
    generate_dataset(datasets, clips_per_genre_lang=1, duration=1.0, seed=3)
    # one clip that fails to decode: skipped and tallied on every rank
    sorted(datasets.rglob("*.wav"))[0].write_bytes(b"RIFF not a wave file")
    cfg = dict(duration=1.0, extract_batch=3, dataset_root=str(datasets),
               metadata_csv=str(datasets / "updated_metadata.csv"))
    paths = _bundle(root)
    _write_processed_data2(root / "processed_data2")
    x, labels = _silhouette_data()
    cases = [
        ("mesh_basics", {}),
        ("roundtrip", {"x": np.arange(27, dtype=np.float32).reshape(9, 3)}),
        ("silhouette", {"x": x, "labels": labels}),
        ("preprocess", {"cfg": PreprocessConfig(
            output_dir=str(root / "pd1_mesh"), **cfg)}),
        ("encode", {"results_dir": str(root / "results"),
                    "data_dir": str(root / "data"), "paths": paths}),
        ("cli_encode_mesh", {"argv": [
            "encode", "--arch=simple", f"--results_dir={root / 'results'}",
            f"--data_dir={root / 'data'}", "--device=cpu", "--mesh=1",
            "--batch_size=3", f"--out={root / 'mesh.npz'}", *paths]}),
        ("conditional_vae", {"data_dir": str(root / "processed_data2"),
                             "results_dir": str(root / "cvae_mesh")}),
    ]
    results = run_ranks(root / "ranks", WS, cases)
    return {"root": root, "results": results, "cfg": cfg, "paths": paths,
            "x": x, "labels": labels}


def _each(ranks, name):
    return [r[name] for r in ranks["results"]]


def test_mesh_size_the_minus_one_shape_and_too_few_devices(ranks):
    from tpuvae.parallel import make_mesh as jax_make_mesh

    for rank, res in enumerate(_each(ranks, "mesh_basics")):
        assert res["full"] == WS and res["one"] == 1
        assert res["one_coordinate"] == ((0,) if rank == 0 else None)
        assert res["grid"] == (1, WS)
        assert res["grid_names"] == ("data", "model")
        assert "requested 16 devices" in res["error"]
        assert f"found {WS}" in res["error"]
    # the JAX package's rule on its virtual devices
    assert jax_make_mesh((-1,), ("data",)).size == jax.device_count()
    assert jax_make_mesh((1, -1), ("data", "model")).shape == {
        "data": 1, "model": jax.device_count()}


def test_pad_shard_gather_roundtrip(ranks):
    from tpuvae.parallel import pad_to_multiple as jax_pad

    from tpuvae_torch.parallel import pad_to_multiple

    x = np.arange(27, dtype=np.float32).reshape(9, 3)
    for rank, res in enumerate(_each(ranks, "roundtrip")):
        assert res["n"] == 9 and res["shape"] == (10, 3)
        assert res["placements"] and res["replicated"]
        padded, _ = pad_to_multiple(x, WS)
        np.testing.assert_array_equal(res["local"],
                                      padded[5 * rank:5 * rank + 5])
        np.testing.assert_array_equal(res["back"], x)
    for multiple in (1, 2, 4, 8):
        np.testing.assert_array_equal(pad_to_multiple(x, multiple)[0],
                                      jax_pad(x, multiple)[0])


def test_maybe_init_distributed_gate(monkeypatch):
    """Off by default; on, it forwards the coordinator variables as a
    ``tcp://`` init, else ``env://`` (torchrun's variables)."""
    import tpuvae_torch.parallel.mesh as M

    calls = []
    monkeypatch.setattr(M.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(M.dist, "is_initialized", lambda: False)

    monkeypatch.delenv("TPUVAE_DISTRIBUTED", raising=False)
    assert M.maybe_init_distributed() is False and calls == []

    monkeypatch.setenv("TPUVAE_DISTRIBUTED", "1")
    monkeypatch.setenv("TPUVAE_COORDINATOR", "localhost:9911")
    monkeypatch.setenv("TPUVAE_NUM_PROCESSES", "4")
    monkeypatch.setenv("TPUVAE_PROCESS_ID", "2")
    assert M.maybe_init_distributed() is True
    (args, kw), = calls
    assert args == ("gloo",)
    assert kw["init_method"] == "tcp://localhost:9911"
    assert (kw["world_size"], kw["rank"]) == (4, 2)

    monkeypatch.delenv("TPUVAE_COORDINATOR")
    assert M.maybe_init_distributed() is True
    assert calls[-1][1]["init_method"] == "env://"

    # idempotent once a group exists
    monkeypatch.setattr(M.dist, "is_initialized", lambda: True)
    assert M.maybe_init_distributed() is False and len(calls) == 2


def test_mesh_context_without_a_distributed_environment(tmp_path):
    """A plain interpreter with no environment: one rank, on an in-memory
    store (no network), within seconds."""
    import os
    import subprocess
    import sys

    from _torch_ranks import REPO

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPUVAE_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK"))}
    env["PYTHONPATH"] = str(REPO)
    code = ("from tpuvae_torch.parallel import MeshContext\n"
            "ctx = MeshContext.create(device='cpu')\n"
            "print(ctx.n_devices, ctx.rank, ctx.is_writer, ctx.device)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "0", "True", "cpu"]


def test_silhouette_sharded_matches_jax_and_the_unsharded_score(ranks):
    from tpuvae.metrics import compact_labels as jax_compact
    from tpuvae.metrics import silhouette_sharded as jax_sharded
    from tpuvae.parallel import make_mesh

    from tpuvae_torch.metrics import compact_labels, silhouette_score

    x, labels = ranks["x"], ranks["labels"]
    res = _each(ranks, "silhouette")
    assert res[0] == res[1]                  # the same float on every rank
    for got, lab in zip(res[0], labels):
        jl, jk = jax_compact(lab)
        want = jax_sharded(x, jl, jk, make_mesh((WS,), ("data",)))
        tl, tk = compact_labels(lab)
        plain = float(silhouette_score(torch.from_numpy(x), tl, tk))
        assert abs(got - want) < 1e-5, (got, want)
        assert abs(got - plain) < 1e-5, (got, plain)


def test_preprocess_basic_on_a_mesh_equals_one_rank(ranks, tmp_path):
    """Every rank decodes, skips the bad clip and returns the same counts;
    rank 0 alone writes the shards and the artifacts, which equal a
    world-size-1 run's."""
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.pipelines import preprocess_basic

    from _torch_ranks import _Log

    one = tmp_path / "pd1_one"
    want = preprocess_basic(PreprocessConfig(output_dir=str(one),
                                             **ranks["cfg"]),
                            device="cpu", logger=_Log())
    res = _each(ranks, "preprocess")
    for r in res:
        assert r["n"] == want["n"] == 5
        assert [p for p, _ in r["failed"]] == [p for p, _ in want["failed"]]
    assert res[0]["writes"] == {"add_shard": 2, "save_basic": 1,
                                "cleanup": 1}
    assert res[1]["writes"] == {}
    mesh_dir = ranks["root"] / "pd1_mesh"
    assert sorted(p.name for p in mesh_dir.iterdir()) == sorted(
        p.name for p in one.iterdir())
    np.testing.assert_array_equal(np.load(mesh_dir / "labels.npy"),
                                  np.load(one / "labels.npy"))
    pd.testing.assert_frame_equal(pd.read_csv(mesh_dir / "metadata.csv"),
                                  pd.read_csv(one / "metadata.csv"))
    runs = {}
    for d in (mesh_dir, one):
        with open(d / "imputer.pkl", "rb") as a, open(d / "scaler.pkl", "rb") as b:
            imputer, scaler = pickle.load(a), pickle.load(b)
        raw = np.load(d / "features_raw.npy")
        norm = np.load(d / "features_normalized.npy")
        # each run's artifacts are its normalizers applied to its features
        np.testing.assert_array_equal(
            norm, scaler.transform(imputer.transform(raw)).astype(np.float32))
        runs[d] = (raw, norm, imputer, scaler)
    (raw_m, norm_m, imp_m, sc_m), (raw_1, norm_1, imp_1, sc_1) = runs.values()
    # the features: fp32 rounding of another batch split (2 rows a rank
    # against 3 a batch); carried through the normalizers over 5 rows,
    # |d mean| and |d std| <= the column's largest |d x|, and
    # |d normalized| * std <= |d x| + |d mean| + |normalized| |d std|
    # with |normalized| <= 2
    np.testing.assert_allclose(raw_m, raw_1, rtol=1e-5, atol=1e-6)
    dx = 1e-5 * np.abs(raw_1).max(axis=0) + 1e-6
    for got, want in ((imp_m.means, imp_1.means), (sc_m.mean, sc_1.mean),
                      (sc_m.scale, sc_1.scale)):
        assert (np.abs(np.asarray(got) - want) <= dx).all()
    err = np.abs(norm_m.astype(np.float64) - norm_1) * sc_1.scale
    assert (err <= 4 * dx + 1e-6 * np.abs(norm_1) * sc_1.scale).all()


def test_encode_paths_on_a_mesh_equals_mesh_none(ranks):
    """batch_size 3 rounds up to 4 over two ranks; 5 clips make a full and
    a ragged batch, each split in two and gathered back in order.  Each
    rank's block holds the rows that ``mesh=None`` at batch_size 2 runs
    together, so the latents are bit-equal."""
    for r in _each(ranks, "encode"):
        lat, clusters, paths = r["sharded"]
        want_lat, want_clusters, want_paths = r["plain"]
        np.testing.assert_array_equal(lat, want_lat)
        np.testing.assert_array_equal(clusters, want_clusters)
        assert paths == want_paths == ranks["paths"]


def test_cli_encode_mesh_flag(ranks, tmp_path, capsys):
    """``--mesh=1`` shards over both ranks (rank 0 prints and writes);
    ``--mesh=0`` encodes on this process's device, as the JAX CLI; here a
    world of one rank, at batch_size 2 (the rows of a rank's block in the
    two-rank run at 3).  This process runs BLAS with another thread count
    than the ranks, so its float32 sums run in another order: latents
    within 1e-5 x max(1, max |latent|) of the ranks' (measured: 9.2e-7)."""
    from tpuvae_torch import cli

    root = ranks["root"]
    res = _each(ranks, "cli_encode_mesh")
    assert res[0]["rc"] == res[1]["rc"] == 0
    assert res[0]["stdout"].count("cluster=") == 5 and res[1]["stdout"] == ""
    argv = ["encode", "--arch=simple", f"--results_dir={root / 'results'}",
            f"--data_dir={root / 'data'}", "--device=cpu", "--batch_size=2",
            *ranks["paths"]]
    for flag in ("--mesh=0", "--mesh=1"):
        out = tmp_path / f"{flag[-1]}.npz"
        assert cli.main([*argv[:-5], flag, f"--out={out}", *argv[-5:]]) == 0
        want = np.load(root / "mesh.npz")["latents"]
        np.testing.assert_allclose(
            np.load(out)["latents"], want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    assert capsys.readouterr().out.count("cluster=") == 10


def test_run_conditional_vae_on_a_mesh(ranks):
    """Both ranks train the data-parallel epoch, see the same losses and
    return the same frame; rank 0 alone writes the checkpoints, the bundle
    and the CSV."""
    res = _each(ranks, "conditional_vae")
    pd.testing.assert_frame_equal(res[0]["df"], res[1]["df"])
    assert res[0]["train_loss"] == res[1]["train_loss"]
    assert res[0]["val_loss"] == res[1]["val_loss"]
    assert np.isfinite(res[0]["train_loss"] + res[0]["val_loss"]).all()
    assert res[0]["writes"] == {"save": 2, "save_serving_model": 1,
                                "save_checkpoint": 1,
                                "consolidate_metrics": 1}
    assert res[1]["writes"] == {}
    assert "dp_disabled" not in res[0]["events"]
    out = ranks["root"] / "cvae_mesh"
    assert (out / "Conditional_VAE" / "serving" / "model" / "weights.npz").exists()
    csv = pd.read_csv(out / "clustering_metrics.csv")
    assert len(csv) == 4


def test_pipelines_accept_mesh_none():
    """Every entry point that takes ``mesh`` in the JAX package takes it
    here, defaulting to None."""
    import inspect

    from tpuvae_torch import pipelines
    from tpuvae_torch.infer import ClipEncoder

    for fn in (pipelines.run_simple_vae, pipelines.run_conditional_vae,
               pipelines.run_hybrid_vae, pipelines.preprocess_basic,
               pipelines.preprocess_advanced, ClipEncoder.encode_waveforms,
               ClipEncoder.encode_paths):
        assert inspect.signature(fn).parameters["mesh"].default is None, fn


def test_run_simple_vae_with_mesh_none(tmp_path):
    from tpuvae_torch.config import ClusterConfig, SimpleVAEConfig
    from tpuvae_torch.io.artifacts import save_basic
    from tpuvae_torch.io.normalize import impute_and_scale
    from tpuvae_torch.pipelines import run_simple_vae

    from _torch_ranks import _Log

    rng = np.random.default_rng(0)
    feats = (rng.normal(size=(40, 20))
             + 3.0 * (np.arange(40) % 2)[:, None]).astype(np.float32)
    normed, imputer, scaler = impute_and_scale(feats)
    labels = np.array(["pop", "rock"] * 20)
    save_basic(tmp_path / "pd1", features_raw=feats,
               features_normalized=normed, labels=labels,
               metadata=pd.DataFrame({"language": ["english"] * 40,
                                      "genre": labels,
                                      "filename": [f"{i}.wav" for i in range(40)],
                                      "label": labels}),
               scaler=scaler, imputer=imputer, config={})
    df = run_simple_vae(str(tmp_path / "pd1"), str(tmp_path / "results"),
                        SimpleVAEConfig(epochs=2, batch_size=8, latent_dim=4),
                        ClusterConfig(simple_k_sweep=[2, 3]), _Log(),
                        make_plots=False, device="cpu", mesh=None)
    assert len(df) == 2 and np.isfinite(df["Silhouette"]).all()
    meta = json.loads((tmp_path / "results" / "Simple_VAE" / "serving"
                       / "model" / "metadata.json").read_text())
    assert meta["arch"] == "simple"
