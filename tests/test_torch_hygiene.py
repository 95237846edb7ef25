"""Rules of the PyTorch port that hold whatever the numbers:

* no module of ``tpuvae_torch`` (and not ``chip_smoke.py``) imports JAX,
  flax or the JAX package — checked on the source, by AST;
* entry points default to the card and raise without one; nothing drops
  to the CPU by itself;
* every kernel entry's ``argtypes`` match the ``extern "C"`` prototype of
  its symbol in ``csrc/`` (a mismatch shows only as corrupt arguments on
  the card);
* serving bundles unpickle only the normalizer classes and numpy arrays;
* the WAV decoder reproduces the JAX package's.
"""

import ast
import ctypes
import pickle
import re
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpuvae"}


def _port_sources():
    files = sorted((REPO / "tpuvae_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 20 and all(f.exists() for f in files)
    # the workflow's modules keep their own copies of the JAX package's
    # JAX-free tpuvae/parity.py and tpuvae/viz/plots.py
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"tpuvae_torch/parity.py", "tpuvae_torch/viz/tsne.py",
            "tpuvae_torch/viz/plots.py", "tpuvae_torch/viz/eda.py",
            "tpuvae_torch/viz/__init__.py"} <= names
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_import_scan_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom tpuvae.io import wav\nimport jax.numpy\n"
                 "from tpuvae_torch import ops\n")
    mods = [m for _, m in _imported_roots(p)]
    assert [m for m in mods if m in FORBIDDEN] == ["tpuvae", "jax"]


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from tpuvae_torch import cli
    from tpuvae_torch.device import resolve_device
    from tpuvae_torch.infer import ClipEncoder
    from tpuvae_torch.config import AdvancedPreprocessConfig, PreprocessConfig
    from tpuvae_torch.pipelines import (
        preprocess_advanced,
        preprocess_basic,
        run_conditional_vae,
        run_hybrid_vae,
        run_simple_vae,
    )
    from tpuvae_torch.serve import serve

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        ClipEncoder.load("simple", results_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        serve("simple", results_dir=str(tmp_path), warmup=False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_simple_vae(str(tmp_path), str(tmp_path / "results"))
    with pytest.raises(RuntimeError, match="cuda"):
        run_conditional_vae(str(tmp_path), str(tmp_path / "results"))
    with pytest.raises(RuntimeError, match="cuda"):
        run_hybrid_vae(str(tmp_path), str(tmp_path / "results"))
    with pytest.raises(RuntimeError, match="cuda"):
        ClipEncoder.load("hybrid", results_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        serve(results_dir=str(tmp_path), warmup=False)
    with pytest.raises(RuntimeError, match="cuda"):
        preprocess_basic(PreprocessConfig(output_dir=str(tmp_path / "d1")))
    with pytest.raises(RuntimeError, match="cuda"):
        preprocess_advanced(
            AdvancedPreprocessConfig(output_dir=str(tmp_path / "d2")))
    assert not (tmp_path / "d1").exists() and not (tmp_path / "d2").exists()
    assert cli.main(["encode", f"--results_dir={tmp_path}", "x.wav"]) == 2
    assert cli.main(["train-simple", f"--data_dir={tmp_path}",
                     f"--results_dir={tmp_path / 'results'}",
                     "--epochs=1"]) == 2
    assert cli.main(["train-cvae", f"--data_dir={tmp_path}",
                     f"--results_dir={tmp_path / 'results'}",
                     "--epochs=1"]) == 2
    assert cli.main(["train-hybrid", f"--data_dir={tmp_path}",
                     f"--results_dir={tmp_path / 'results'}",
                     "--epochs=1"]) == 2
    assert not (tmp_path / "results").exists()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="device"):
        resolve_device("meta")


def test_kernel_library_is_not_built_on_import():
    """Importing every module of the port builds nothing and loads no
    library (checked in a fresh interpreter): the CPU tests import them."""
    import subprocess
    import sys

    code = (
        "import ctypes, sys\n"
        "import tpuvae_torch.cli, tpuvae_torch.serve, tpuvae_torch.ops as ops\n"
        "from tpuvae_torch.ops import _build\n"
        "assert not _build._LIBS and all(k._fn is None for k in _build.kernels())\n"
        "print(sorted(ops.launch_counts().items()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # eight kernels; kernel 6 counts its two halves apart, BatchNorm +
    # LeakyReLU its four passes
    assert out.stdout.strip() == ("[('bn_leaky_grad_input', 0), "
                                  "('bn_leaky_grad_sums', 0), "
                                  "('bn_leaky_norm', 0), "
                                  "('bn_leaky_stats', 0), "
                                  "('fusedconv_conv0', 0), "
                                  "('fusedconv_conv1', 0), "
                                  "('masked_median_select', 0), "
                                  "('pairwise', 0), ('s2_dgrad', 0), "
                                  "('stft_dense', 0), "
                                  "('stft_features', 0), ('tuning', 0)]")


def _kernel_entries():
    from tpuvae_torch.ops import _build

    return _build.kernels()


def _c_prototypes() -> dict:
    """``{symbol: [ctypes type of each parameter]}`` of every ``extern "C"
    int`` entry in ``tpuvae_torch/csrc/``: a pointer is ``c_void_p``."""
    scalars = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
               "float": ctypes.c_float}
    protos = {}
    for src in sorted((REPO / "tpuvae_torch" / "csrc").glob("*.cu*")):
        for symbol, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                         src.read_text()):
            kinds = []
            for param in params.split(","):
                decl = " ".join(param.replace("const ", "").split())
                kinds.append(ctypes.c_void_p if "*" in decl
                             else scalars[decl.rsplit(" ", 1)[0]])
            assert symbol not in protos, f"{symbol} defined twice"
            protos[symbol] = kinds
    return protos


@pytest.mark.parametrize("kernel", _kernel_entries(),
                         ids=lambda k: k.symbol)
def test_kernel_argtypes_match_the_c_prototype(kernel):
    want = _c_prototypes()[kernel.symbol]
    assert len(kernel.argtypes) == len(want), kernel.symbol
    for i, (got, c_type) in enumerate(zip(kernel.argtypes, want)):
        assert got is c_type, (kernel.symbol, i, got, c_type)


def test_matplotlib_is_imported_only_to_draw(tmp_path):
    """Importing the port, its CLI and its plot modules imports no
    matplotlib (a machine without it runs everything but the figures);
    drawing one does (checked in a fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import tpuvae_torch.cli, tpuvae_torch.pipelines, tpuvae_torch.parity\n"
        "import tpuvae_torch.viz.eda, tpuvae_torch.viz as viz\n"
        "assert 'matplotlib' not in sys.modules\n"
        "viz.loss_curve([1.0, 0.5], sys.argv[1])\n"
        "assert 'matplotlib.pyplot' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "loss.png")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "loss.png").stat().st_size > 0


def test_bundle_unpickler_maps_jax_classes_and_refuses_others(tmp_path):
    from tpuvae.io import normalize as jax_norm

    from tpuvae_torch.io import normalize as norm

    x = np.random.default_rng(1).normal(size=(8, 5)).astype(np.float32)
    x[0, 1] = np.inf
    _, jimp, jsc = jax_norm.impute_and_scale(x)
    for name, obj in (("imputer", jimp), ("scaler", jsc)):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)
    imp = norm.load_normalizer(tmp_path / "imputer.pkl")
    sc = norm.load_normalizer(tmp_path / "scaler.pkl")
    assert type(imp) is norm.MeanImputer and type(sc) is norm.StandardScaler
    np.testing.assert_array_equal(sc.transform(imp.transform(x)),
                                  jsc.transform(jimp.transform(x)))
    normed, imp2, sc2 = norm.impute_and_scale(x)
    np.testing.assert_array_equal(normed,
                                  jax_norm.impute_and_scale(x)[0])

    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    with open(tmp_path / "evil.pkl", "wb") as f:
        pickle.dump(Evil(), f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        norm.load_normalizer(tmp_path / "evil.pkl")


@pytest.mark.parametrize("channels,sr,width", [(1, 22050, 2), (2, 22050, 2),
                                               (1, 16000, 2), (2, 44100, 3)])
def test_load_audio_matches_jax(tmp_path, channels, sr, width):
    from tpuvae.io.wav import load_audio as jax_load

    from tpuvae_torch.io.wav import load_audio

    rng = np.random.default_rng(channels * sr + width)
    n = int(sr * 1.3)
    y = (0.4 * rng.uniform(-1, 1, (n, channels))).astype(np.float32)
    scale = 2 ** (8 * width - 1) - 1
    ints = np.round(y * scale).astype(np.int32)
    if width == 2:
        raw = ints.astype("<i2").tobytes()
    else:
        raw = b"".join(int(v).to_bytes(3, "little", signed=True)
                       for v in ints.reshape(-1))
    p = tmp_path / "clip.wav"
    with wave.open(str(p), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)
    got = load_audio(p, 22050, 1.0, prefer_native=False)
    want = jax_load(p, 22050, 1.0, prefer_native=False)
    assert got.shape == (22050,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the native loader (the default) resamples in float: within 1e-5, as
    # the JAX package's own native test holds it
    native = load_audio(p, 22050, 1.0)
    np.testing.assert_allclose(native, want, atol=1e-5)


def test_load_audio_rejects_non_wav(tmp_path):
    """A FLAC decodes (by its magic, whatever the suffix), as the JAX
    package's does; an unknown container, or a corrupt FLAC, raises the
    Python decoder's ValueError on both paths."""
    from tpuvae.io.flac import write_flac as jax_write_flac
    from tpuvae.io.wav import load_audio as jax_load

    from tpuvae_torch.io.wav import load_audio

    pcm = np.random.default_rng(5).integers(-9000, 9000, (30000, 2))
    p = tmp_path / "x.wav"                  # a FLAC stream, a WAV name
    jax_write_flac(p, pcm, 22050, 16, stereo="mid_side")
    want = jax_load(p, 22050, 1.0, prefer_native=False)
    for native in (True, False):
        np.testing.assert_array_equal(
            load_audio(p, 22050, 1.0, prefer_native=native), want)
    for name, raw in (("x.ogg", b"OggS" + b"\0" * 64),
                      ("bad.flac", b"fLaC" + b"\0" * 64)):
        bad = tmp_path / name
        bad.write_bytes(raw)
        for native in (True, False):
            with pytest.raises(ValueError, match="RIFF/WAVE|STREAMINFO"):
                load_audio(bad, prefer_native=native)


def test_config_matches_jax_defaults():
    from tpuvae.config import ClusterConfig as JaxCluster
    from tpuvae.config import PreprocessConfig as JaxConfig
    from tpuvae.config import SimpleVAEConfig as JaxSimple

    from tpuvae_torch.config import (
        ClusterConfig,
        PreprocessConfig,
        SimpleVAEConfig,
    )

    assert PreprocessConfig().to_dict() == JaxConfig().to_dict()
    assert SimpleVAEConfig().to_dict() == JaxSimple().to_dict()
    assert ClusterConfig().to_dict() == JaxCluster().to_dict()
    args = ["--epochs=3", "hidden_dims=[64, 32]", "--dropout=0.1"]
    assert (SimpleVAEConfig().override(args).to_dict()
            == JaxSimple().override(args).to_dict())
    assert (ClusterConfig().override(["simple_k_sweep=[2, 3]"]).to_dict()
            == JaxCluster().override(["simple_k_sweep=[2, 3]"]).to_dict())
    with pytest.raises(KeyError):
        SimpleVAEConfig().override(["--bogus=1"])
    cfg = PreprocessConfig.from_dict(dict(JaxConfig(duration=2.0,
                                                    n_mels=16).to_dict()))
    assert cfg.num_samples == 44100 and cfg.feature_dim == 146
    with pytest.raises(KeyError):
        PreprocessConfig.from_dict({"bogus": 1})


# the JAX package's public names with no counterpart of the same name in
# the port, each with its reason (ROADMAP.md items where one is open)
NAMESPACE_EXCEPTIONS = {
    "dsp.jit_extractor": "ported as dsp.make_extractor (PyTorch runs "
                         "eagerly: there is nothing to jit)",
    "train.adam_with_adjustable_lr": "an optax chain; the port's is the "
                                     "torch.optim.Adam of train.create_state "
                                     "with train.set_learning_rate",
    "utils.enable_compilation_cache": "the XLA compilation cache; not "
                                      "ported by design: the kernels' hashed "
                                      "build directory (ops/_build.py) is "
                                      "the port's cache",
    "ops.squared_distances_pallas": "kernel 5 is ops.pairwise."
                                    "squared_distances in the port",
    "ops.self_distances_pallas": "kernel 5 is ops.pairwise.self_distances "
                                 "in the port",
    "ops.stft_power_pallas": "kernel 4 is ops.stft.stft_power_dense in "
                             "the port",
}


def _jax_namespace(sub: str) -> list[str]:
    """The names ``tpuvae/<sub>/__init__.py`` re-exports, read from its
    source (importing the JAX package is not needed for that)."""
    path = REPO / "tpuvae" / sub / "__init__.py"
    tree = ast.parse(path.read_text())
    return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("sub", ["", "dsp", "io", "metrics", "train", "utils",
                                 "models", "cluster", "text", "viz", "ops",
                                 "parallel"])
def test_port_namespaces_export_what_the_jax_package_does(sub):
    import importlib

    names = _jax_namespace(sub)
    assert names, sub
    if sub in NAMESPACE_EXCEPTIONS:
        reason = NAMESPACE_EXCEPTIONS[sub]
        assert "ROADMAP" in reason
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"tpuvae_torch.{sub}")
        return
    mod = importlib.import_module("tpuvae_torch" + (f".{sub}" if sub else ""))
    missing = [n for n in names if not hasattr(mod, n)
               and f"{sub}.{n}" not in NAMESPACE_EXCEPTIONS]
    assert not missing, f"tpuvae_torch.{sub} lacks {missing}"
    # an exception is only kept while the name is really missing
    stale = [k for k in NAMESPACE_EXCEPTIONS
             if k.startswith(f"{sub}.") and hasattr(mod, k.split(".", 1)[1])]
    assert not stale, stale


def test_every_namespace_exception_names_a_jax_export():
    exported = {f"{sub}.{n}" for sub in ("dsp", "io", "metrics", "train",
                                         "utils", "models", "ops")
                for n in _jax_namespace(sub)}
    for key, reason in NAMESPACE_EXCEPTIONS.items():
        assert key in exported, key
        assert len(reason) > 20, key


def test_quickstart_imports_under_the_ports_names(tmp_path):
    """``examples/quickstart.py`` with ``tpuvae`` replaced by
    ``tpuvae_torch`` in its imports (a copy in ``tmp_path``; the example
    stays as it is) imports everything it names from the port."""
    import runpy
    import sys

    src = (REPO / "examples" / "quickstart.py").read_text()
    lines = [ln.replace("from tpuvae.", "from tpuvae_torch.", 1)
             if ln.startswith("from tpuvae.") else ln
             for ln in src.splitlines()]
    assert sum(ln.startswith("from tpuvae_torch.") for ln in lines) >= 5
    copy = tmp_path / "quickstart_port.py"
    copy.write_text("\n".join(lines) + "\n")
    sys.path.insert(0, str(REPO))
    try:
        ns = runpy.run_path(str(copy), run_name="quickstart_port")
    finally:
        sys.path.remove(str(REPO))
    for name in ("kmeans_k_sweep", "pca_transform", "PreprocessConfig",
                 "SimpleVAEConfig", "generate_dataset", "compact_labels",
                 "silhouette_score", "preprocess_basic", "run_simple_vae"):
        assert ns[name].__module__.startswith("tpuvae_torch"), name
    assert callable(ns["main"])


def test_train_config_matches_jax():
    from tpuvae.config import TrainConfig as JaxTrain

    from tpuvae_torch import TrainConfig

    assert TrainConfig().to_dict() == JaxTrain().to_dict()
    args = ["--log_every=3", "profile=true"]
    assert (TrainConfig().override(args).to_dict()
            == JaxTrain().override(args).to_dict())
