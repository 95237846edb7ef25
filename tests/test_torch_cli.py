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
