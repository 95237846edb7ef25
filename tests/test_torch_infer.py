"""The slice as a whole: serving bundles, ClipEncoder, the HTTP server and
the CLI of ``tpuvae_torch``, on the CPU (``device='cpu'`` everywhere).

A bundle is written by the JAX code (flax init with random BatchNorm
statistics, ``save_checkpoint``, ``impute_and_scale`` pickles, numpy
centres, config duration 2.0 in exact mode) and loaded by both
``tpuvae.infer.ClipEncoder`` and the port's.  Exact mode keeps both
packages' spectrograms in fp32, so the 370-d features agree to ~1e-4
relative, from summation order alone; through the standardisation and the
370->128->64->32 encoder the latents (|z| ~ 2) are held to atol 1e-5
(measured 2e-6 on this corpus).  Cluster ids must be equal.
"""

import base64
import json
import threading
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

SR = 22050
LATENT_ATOL = 1e-5


def _write_wav(path: Path, y: np.ndarray, sr: int = SR) -> None:
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """Six 2 s WAV clips plus a simple-arch bundle written by the JAX code."""
    from flax import traverse_util

    from tpuvae.config import PreprocessConfig
    from tpuvae.dsp.features import extract_basic_features
    from tpuvae.io.normalize import impute_and_scale
    from tpuvae.models import SimpleVAE
    from tpuvae.train.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("torch_bundle")
    rng = np.random.default_rng(9)
    t = np.arange(2 * SR) / SR
    paths = []
    for i in range(6):
        f0 = 110 * 2 ** rng.uniform(0, 3)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(1 + i % 4))
        y = 0.25 * sig / (1 + i % 4) + 0.03 * rng.normal(size=t.shape)
        p = root / f"clip_{i}.wav"
        _write_wav(p, y)
        paths.append(p)

    from tpuvae.io import load_audio

    cfg = PreprocessConfig(duration=2.0, precision_mode="exact",
                           output_dir=str(root / "processed_data1"))
    waves = np.stack([load_audio(p, SR, 2.0) for p in paths])
    feats = np.asarray(jax.jit(lambda y: extract_basic_features(y, cfg))(
        jnp.asarray(waves)))
    normed, imputer, scaler = impute_and_scale(feats)
    data = root / "processed_data1"
    data.mkdir()
    import pickle

    for name, obj in (("config", cfg.to_dict()), ("imputer", imputer),
                      ("scaler", scaler)):
        with open(data / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)

    model = SimpleVAE()
    variables = model.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        jnp.zeros((2, 370)), jax.random.PRNGKey(5), train=False)
    flat = traverse_util.flatten_dict(variables, sep="/")
    for k in list(flat):
        if k[-1] == "var":
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, flat[k].shape),
                                  jnp.float32)
    variables = traverse_util.unflatten_dict(flat, sep="/")
    serving = root / "results" / "Simple_VAE" / "serving"
    meta = {"arch": "simple", "input_dim": 370, "hidden_dims": [128, 64, 32],
            "latent_dim": 32, "dropout": 0.2, "data_dir": str(data)}
    save_checkpoint(serving / "model", variables["params"],
                    variables["batch_stats"], meta)
    mu = np.asarray(model.apply(variables, jnp.asarray(normed),
                                method=SimpleVAE.latent))
    np.save(serving / "kmeans_centers.npy", mu[[0, 2, 3, 5]])
    return root, paths


@pytest.fixture(scope="module")
def encoders(jax_bundle):
    from tpuvae.infer import ClipEncoder as JaxEncoder

    from tpuvae_torch.infer import ClipEncoder

    root, _ = jax_bundle
    results = str(root / "results")
    return (JaxEncoder.load("simple", results_dir=results),
            ClipEncoder.load("simple", results_dir=results, device="cpu"))


def test_port_encoder_matches_jax_encoder(jax_bundle, encoders):
    _, paths = jax_bundle
    jax_enc, enc = encoders
    want = jax_enc.encode_paths(paths)
    got = enc.encode_paths(paths, batch_size=4)   # a ragged last batch
    assert got.latents.shape == (6, 32)
    np.testing.assert_allclose(got.latents, want.latents, rtol=0,
                               atol=LATENT_ATOL)
    np.testing.assert_array_equal(got.clusters, want.clusters)
    assert got.paths == [str(p) for p in paths]
    assert set(got.clusters[[0, 2, 3, 5]]) == {0, 1, 2, 3}


def test_port_bundle_loads_in_both_packages(jax_bundle, encoders, tmp_path):
    """A bundle written by the port (save_serving_bundle) reproduces the
    same encoder in both packages."""
    from tpuvae.infer import ClipEncoder as JaxEncoder

    from tpuvae_torch.infer import ClipEncoder, save_serving_bundle

    _, paths = jax_bundle
    _, enc = encoders
    save_serving_bundle(tmp_path / "results", tmp_path / "data", enc.model,
                        enc.centers, pre_cfg=enc.pre_cfg,
                        imputer=enc.normalizers["imputer"],
                        scaler=enc.normalizers["scaler"],
                        meta=dict(enc.meta, data_dir=str(tmp_path / "data")))
    again = ClipEncoder.load("simple", results_dir=str(tmp_path / "results"),
                             device="cpu")
    a = enc.encode_paths(paths[:3])
    b = again.encode_paths(paths[:3])
    np.testing.assert_array_equal(b.latents, a.latents)
    jax_again = JaxEncoder.load("simple",
                                results_dir=str(tmp_path / "results"))
    c = jax_again.encode_paths(paths[:3])
    np.testing.assert_allclose(c.latents, a.latents, rtol=0, atol=LATENT_ATOL)
    np.testing.assert_array_equal(c.clusters, a.clusters)


def test_unknown_arch_raises_value_error(jax_bundle):
    from tpuvae.infer import ClipEncoder as JaxEncoder

    from tpuvae_torch.infer import ClipEncoder

    root, _ = jax_bundle
    for load in (JaxEncoder.load,
                 lambda arch, **kw: ClipEncoder.load(arch, device="cpu", **kw)):
        with pytest.raises(ValueError, match="arch must be one of"):
            load("nope", results_dir=str(root / "results"))
    # the simple bundle is there; the conv archs have none in this root
    for arch in ("cvae", "hybrid"):
        with pytest.raises(FileNotFoundError, match=f"train-{arch}"):
            ClipEncoder.load(arch, results_dir=str(root / "results"),
                             device="cpu")


def test_simple_arch_rejects_lyrics(encoders):
    _, enc = encoders
    with pytest.raises(ValueError, match="lyrics"):
        enc.encode_waveforms(np.zeros((1, 2 * SR), np.float32),
                             lyrics=["la"])


# -- HTTP server ----------------------------------------------------------

@pytest.fixture(scope="module", params=[0.0, 20.0], ids=["locked", "batched"])
def server(request, encoders):
    from tpuvae_torch.serve import make_server

    _, enc = encoders
    srv = make_server(enc, port=0, quiet=True, batch_wait_ms=request.param,
                      max_batch=4)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", request.param
    srv.shutdown()
    srv.server_close()
    srv.app.close()
    thread.join(timeout=5)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_health_and_info(server):
    url, wait = server
    h = _get(url + "/healthz")
    assert h["status"] == "ok" and h["arch"] == "simple"
    assert h["device"] == "cpu" and h["latent_dim"] == 32
    assert ("microbatch" in h) == (wait > 0)
    info = _get(url + "/info")
    assert info["n_centers"] == 4 and info["num_samples"] == 2 * SR


def test_server_encode_paths_and_b64(server, jax_bundle, encoders):
    url, _ = server
    _, paths = jax_bundle
    _, enc = encoders
    direct = enc.encode_paths(paths[:2])
    status, out = _post(url + "/encode", {"paths": [str(p) for p in paths[:2]]})
    assert status == 200, out
    np.testing.assert_allclose(out["latents"], direct.latents, atol=1e-6)
    assert out["clusters"] == [int(c) for c in direct.clusters]
    blobs = [base64.b64encode(Path(p).read_bytes()).decode() for p in paths[:2]]
    status, out2 = _post(url + "/encode", {"audio_b64": blobs})
    assert status == 200, out2
    np.testing.assert_allclose(out2["latents"], direct.latents, atol=1e-6)


def test_server_concurrent_requests(server, jax_bundle, encoders):
    url, _ = server
    _, paths = jax_bundle
    _, enc = encoders
    direct = enc.encode_paths(paths)
    results = [None] * len(paths)

    def one(i):
        results[i] = _post(url + "/encode", {"paths": [str(paths[i])]})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(paths))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    for i, (status, out) in enumerate(results):
        assert status == 200, out
        np.testing.assert_allclose(out["latents"][0], direct.latents[i],
                                   atol=1e-5)


def test_server_client_errors(server, tmp_path):
    url, _ = server
    # FLAC uploads are decoded (tests/test_torch_decode.py); a corrupt one
    # is the client's error, as is a container that is neither WAV nor FLAC
    flac = base64.b64encode(b"fLaC" + b"\0" * 64).decode()
    status, out = _post(url + "/encode", {"audio_b64": [flac]})
    assert status == 400 and "STREAMINFO" in out["error"], out
    ogg = base64.b64encode(b"OggS" + b"\0" * 64).decode()
    status, out = _post(url + "/encode", {"audio_b64": [ogg]})
    assert status == 400 and "WAV/FLAC" in out["error"], out
    assert _post(url + "/encode", {"paths": []})[0] == 400
    assert _post(url + "/encode", {"paths": [str(tmp_path / "x.wav")]})[0] == 404
    assert _post(url + "/encode", {"bogus": 1})[0] == 400


# -- CLI ------------------------------------------------------------------

def test_cli_encode_on_cpu(jax_bundle, encoders, tmp_path, capsys):
    from tpuvae_torch import cli

    root, paths = jax_bundle
    out = tmp_path / "lat.npz"
    rc = cli.main(["encode", "--arch=simple",
                   f"--results_dir={root / 'results'}", "--device=cpu",
                   f"--out={out}", *[str(p) for p in paths[:2]]])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "cluster=" in printed
    z = np.load(out)
    np.testing.assert_array_equal(
        z["latents"], encoders[1].encode_paths(paths[:2]).latents)
    assert cli.main(["encode", "--bogus=1", "x.wav"]) == 2
    assert cli.main(["train-simple"]) == 2
