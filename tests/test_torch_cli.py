"""The port's train commands take the JAX CLI's flags.

Both packages' ``main`` run on one argv with the training pipeline
replaced by a recorder: both must accept it (or both refuse it) and resolve
the same data directory, results directory and config.  The JAX CLI's
rules (``tpuvae/cli.py:56-64``, ``:134-145``): ``--data_dir``,
``--data1_dir``, ``--data2_dir`` and ``--results_dir`` are taken by every
train command, ``train-simple`` reads ``data1_dir`` then ``data_dir``,
``train-cvae`` reads ``data2_dir`` then ``data_dir``, and a bare flag reads
as ``"1"``.
"""

import os

import pandas as pd
import pytest

import tpuvae.cli as jax_cli
import tpuvae.pipelines as jax_pipelines
import tpuvae_torch.cli as torch_cli
import tpuvae_torch.pipelines as torch_pipelines

_RUNNERS = {"train-simple": "run_simple_vae",
            "train-cvae": "run_conditional_vae"}


def _recorder(calls):
    def run(data_dir, results_dir, cfg, *args, **kwargs):
        calls.append((data_dir, results_dir, cfg.to_dict()))
        return pd.DataFrame({"Method": ["x"], "Silhouette": [0.0]})
    return run


def _run_both(monkeypatch, argv):
    monkeypatch.setenv("TPUVAE_COMPILE_CACHE", "off")
    name = _RUNNERS[argv[0]]
    jax_calls, torch_calls = [], []
    monkeypatch.setattr(jax_pipelines, name, _recorder(jax_calls))
    monkeypatch.setattr(torch_pipelines, name, _recorder(torch_calls))
    rc_jax = jax_cli.main(list(argv))
    rc_torch = torch_cli.main(list(argv))
    return (rc_jax, jax_calls), (rc_torch, torch_calls)


@pytest.mark.parametrize("argv,data_dir,results_dir", [
    (["train-simple", "--data_dir=A", "--results_dir=R", "--epochs=3"],
     "A", "R"),
    (["train-simple", "--data1_dir=B", "--data_dir=A"], "B", "results"),
    (["train-simple", "--data2_dir=C", "--batch_size=8"], "processed_data1",
     "results"),
    (["train-simple", "--data_dir", "--results_dir=R"], "1", "R"),
    (["train-cvae", "--data_dir=A", "--epochs=2"], "A", "results"),
    (["train-cvae", "--data2_dir=C", "--data_dir=A", "--results_dir=R"],
     "C", "R"),
    (["train-cvae", "--data1_dir=B", "--fast", "--host_stream=true"],
     "processed_data2", "results"),
    (["train-cvae", "--results_dir"], "processed_data2", "1"),
], ids=["simple-data_dir", "simple-data1-first", "simple-ignores-data2",
        "simple-bare-flag", "cvae-data_dir", "cvae-data2-first",
        "cvae-ignores-data1", "cvae-bare-flag"])
def test_train_commands_resolve_flags_as_the_jax_cli(monkeypatch, argv,
                                                     data_dir, results_dir):
    (rc_jax, jax_calls), (rc_torch, torch_calls) = _run_both(monkeypatch, argv)
    assert rc_jax == rc_torch == 0
    assert len(jax_calls) == len(torch_calls) == 1
    (jd, jr, jcfg), (td, tr, tcfg) = jax_calls[0], torch_calls[0]
    assert (jd, jr) == (td, tr) == (data_dir, results_dir)
    assert jcfg == {k: v for k, v in tcfg.items() if k in jcfg}


@pytest.mark.parametrize("argv", [
    ["train-simple", "--bogus=1"],
    ["train-cvae", "--data_dir=A", "--bogus"],
], ids=["simple", "cvae-bare"])
def test_train_commands_refuse_an_unknown_field_as_the_jax_cli(monkeypatch,
                                                               argv):
    (rc_jax, jax_calls), (rc_torch, torch_calls) = _run_both(monkeypatch, argv)
    assert rc_jax == rc_torch == 2
    assert jax_calls == torch_calls == []


# -- the whole workflow: all, report, eda, parity, quality --------------------
#
# `all` runs for real through both CLIs on one 2 s synthetic corpus (3 clips
# per genre and language with jazz, seed 1), each in a directory of its own:
# the same argv, the port's with its own --device=cpu.

ALL_ARGV = ["all", "--duration=2.0", "--fixed_time_steps=64",
            "--extract_batch=8", "--epochs=1", "--batch_size=8"]
PNGS = {"Simple_VAE/tsne_visualization_simplified.png",
        "Conditional_VAE/reconstruction.png",
        "Conditional_VAE/cvae_latent_tsne_genre.png",
        "Conditional_VAE/cluster_lang_distribution.png",
        "Convolutional_VAE/training_loss.png",
        "Convolutional_VAE/tsne_clusters_v2.png"}


def _tree(root):
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    import shutil

    from tpuvae_torch.io.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("workflow")
    generate_dataset(root / "jax" / "Datasets", clips_per_genre_lang=3,
                     duration=2.0, include_jazz=True, seed=1)
    shutil.copytree(root / "jax" / "Datasets", root / "port" / "Datasets")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TPUVAE_COMPILE_CACHE", "off")
        mp.chdir(root / "jax")
        rc_jax = jax_cli.main(list(ALL_ARGV))
        mp.chdir(root / "port")
        rc_port = torch_cli.main(ALL_ARGV + ["--device=cpu"])
    finally:
        mp.undo()
    return root, rc_jax, rc_port


def test_all_writes_the_jax_clis_files(workflow):
    root, rc_jax, rc_port = workflow
    assert rc_jax == rc_port == 0
    jax_results, port_results = root / "jax" / "results", root / "port" / "results"
    assert PNGS <= _tree(port_results)
    assert {p for p in _tree(jax_results) if p.endswith((".png", ".csv"))} == {
        p for p in _tree(port_results) if p.endswith((".png", ".csv"))}
    for name in ("processed_data1", "processed_data2"):
        assert _tree(root / "jax" / name) == _tree(root / "port" / name)
    port = pd.read_csv(port_results / "clustering_metrics.csv")
    jax = pd.read_csv(jax_results / "clustering_metrics.csv")
    assert list(port.columns) == list(jax.columns)
    assert set(port["Architecture"]) == {"Simple VAE", "Conditional VAE",
                                         "Convolutional VAE"}
    assert (port["Architecture"].tolist() == jax["Architecture"].tolist())


def test_all_refuses_a_field_no_stage_has_as_the_jax_cli(monkeypatch, capsys):
    argv = ["all", "--not_a_real_field=3"]
    monkeypatch.setenv("TPUVAE_COMPILE_CACHE", "off")
    assert jax_cli.main(list(argv)) == torch_cli.main(list(argv)) == 2
    assert capsys.readouterr().err.count("not_a_real_field") == 2


@pytest.mark.parametrize("results", ["jax", "absent"])
def test_report_prints_the_jax_clis_text(workflow, results, monkeypatch,
                                         capsys):
    root, _, _ = workflow
    monkeypatch.chdir(root)
    argv = ["report", f"--results_dir={results}/results"]
    rc_jax = jax_cli.main(list(argv))
    jax_out = capsys.readouterr().out
    rc_port = torch_cli.main(list(argv))
    assert capsys.readouterr().out == jax_out
    assert (rc_jax, rc_port) == ((0, 0) if results == "jax" else (1, 1))
    if results == "jax":
        assert "Convolutional VAE" in jax_out


def test_eda_through_both_clis(workflow, monkeypatch, capsys):
    import json

    root, _, _ = workflow
    monkeypatch.chdir(root)
    monkeypatch.setenv("TPUVAE_COMPILE_CACHE", "off")
    data = "--data_dir=jax/processed_data2"
    assert jax_cli.main(["eda", data, "--out_dir=eda_jax"]) == 0
    jax_summary = json.loads(capsys.readouterr().out)
    assert torch_cli.main(["eda", data, "--out_dir=eda_port",
                           "--device=cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == jax_summary
    assert _tree(root / "eda_jax") == _tree(root / "eda_port") == {
        "distributions.png", "sample_spectrograms.png",
        "tsne_raw_features.png", "feature_correlation.png",
        "feature_summary.csv"}


def _gate_recorder(calls, ok, values=None):
    def run(**kwargs):
        calls.append(kwargs)
        res = {"ok": ok, "problems": [] if ok else ["Silhouette[0]: 0.5 vs 0.7"]}
        if values is not None:
            res["values"] = values
        return res
    return run


@pytest.mark.parametrize("cmd", ["parity", "quality"])
@pytest.mark.parametrize("ok", [True, False], ids=["ok", "fails"])
@pytest.mark.parametrize("argv", [
    [],
    ["--data1_dir=A", "--data2_dir=B", "--out_dir=W", "--tol=0.02",
     "--fast=0", "--separation=0.75"],
    ["--hybrid_ari=0.42", "--direct_ari=0.1", "--epochs=2"],
], ids=["defaults", "flags", "floors"])
def test_gates_route_and_report_as_the_jax_cli(cmd, ok, argv, monkeypatch,
                                               capsys):
    """Both CLIs hand the gate the same directories, tolerance, floors and
    ``fast``, print the same verdict and exit alike (the gates themselves
    run in ``tests/test_torch_parity.py``)."""
    import tpuvae.parity as jax_parity
    import tpuvae_torch.parity as torch_parity

    name = "run_parity" if cmd == "parity" else "run_quality"
    values = None if cmd == "parity" else {"direct370_ari": 0.9}
    jax_calls, torch_calls = [], []
    monkeypatch.setattr(jax_parity, name, _gate_recorder(jax_calls, ok, values))
    monkeypatch.setattr(torch_parity, name,
                        _gate_recorder(torch_calls, ok, values))
    monkeypatch.setenv("TPUVAE_COMPILE_CACHE", "off")
    rc_jax = jax_cli.main([cmd, *argv])
    jax_out = capsys.readouterr().out
    rc_torch = torch_cli.main([cmd, *argv, "--device=cpu"])
    assert capsys.readouterr().out == jax_out
    assert rc_jax == rc_torch == (0 if ok else 1)
    (want,), (got,) = jax_calls, torch_calls
    assert got.pop("device") == "cpu"
    assert got == want


def test_debug_nans_and_profile_are_accepted(workflow, tmp_path, monkeypatch,
                                             capsys):
    """``--debug-nans`` runs the command under autograd's anomaly mode (and
    only it); ``--profile`` sets ``$TPUVAE_PROFILE_DIR`` (default
    ``profiles``) and each preprocess stage is traced there."""
    import torch

    monkeypatch.setenv("TPUVAE_PROFILE_DIR", "unset")
    monkeypatch.delenv("TPUVAE_PROFILE_DIR")
    assert torch_cli.main(["--debug-nans", "--profile"]) == 0   # help
    assert os.environ["TPUVAE_PROFILE_DIR"] == "profiles"
    assert not torch.is_anomaly_enabled()

    seen = []

    def recorder(*args, **kwargs):
        seen.append(torch.is_anomaly_enabled())
        return pd.DataFrame({"Method": ["x"]})

    monkeypatch.setattr(torch_pipelines, "run_simple_vae", recorder)
    assert torch_cli.main(["train-simple", "--debug-nans", "--device=cpu"]) == 0
    assert torch_cli.main(["train-simple", "--device=cpu"]) == 0
    assert seen == [True, False] and not torch.is_anomaly_enabled()

    root, _, _ = workflow
    prof = tmp_path / "traces"
    monkeypatch.setenv("TPUVAE_PROFILE_DIR", str(prof))
    datasets = root / "port" / "Datasets"
    assert torch_cli.main([
        "preprocess", "--profile", "--device=cpu", "--duration=2.0",
        "--extract_batch=8", f"--dataset_root={datasets}",
        f"--metadata_csv={datasets / 'updated_metadata.csv'}",
        f"--output_dir={tmp_path / 'pd1'}"]) == 0
    stages = {p.name.rsplit("-", 2)[0] for p in prof.glob("*.json")}
    assert stages == {"catalog", "extract_basic", "normalize",
                      "save_artifacts"}
    capsys.readouterr()
