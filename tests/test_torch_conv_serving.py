"""Serving the Conditional and Hybrid VAEs with the port, on the CPU,
against the JAX package: ``ClipEncoder`` for ``arch="hybrid"`` and
``"cvae"`` on bundles written by the JAX pipelines, its argument checks,
``/encode`` with lyrics and genres through ``make_server``, ``cli
encode --lyrics_file --genres`` and both CLIs' default architecture.

The corpus: twelve 2 s WAV clips of three genres, a ``processed_data2``
written by the JAX package (mel images in exact mode through the dense-DFT
STFT, ``stft_method="pallas"``, 128 x 64; hashed lyrics embeddings), and
the bundles of one-epoch runs of the JAX ``run_hybrid_vae`` and
``run_conditional_vae`` on it.  The port serves the same WAVs and lyrics
through its plain kernel versions (``device="cpu"``).  Tolerances: latents
within ``LATENT_ATOL`` = 1e-5 of the JAX encoder's (mel-dB images agree to
~1e-3 dB, fp32 sums in two orders, then a per-pixel scaler and the conv
trunk); cluster ids equal.
"""

import dataclasses
import inspect
import json
import threading
import urllib.error
import urllib.request
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_infer import LATENT_ATOL, SR, _write_wav

torch.set_num_threads(2)

DURATION = 2.0
FTS = 64
GENRES = ("classical", "pop", "rock")
N_CLIPS = 12


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """WAVs + lyrics + genres, a JAX-written ``processed_data2`` and the
    serving bundles of the JAX hybrid and cvae pipelines."""
    return write_jax_bundles(tmp_path_factory.mktemp("conv_serving"))


def write_jax_bundles(root, compute_dtype: str = "float32") -> dict:
    """The corpus of this module under ``root`` and the bundles of one-epoch
    JAX hybrid and cvae runs on it at ``compute_dtype``."""
    from tpuvae.config import AdvancedPreprocessConfig, ClusterConfig
    from tpuvae.config import ConditionalVAEConfig, HybridVAEConfig
    from tpuvae.dsp.features import extract_mel_image
    from tpuvae.io import load_audio
    from tpuvae.io.artifacts import save_advanced
    from tpuvae.io.normalize import impute_and_scale, normalize_mel_images
    from tpuvae.pipelines import run_conditional_vae, run_hybrid_vae
    from tpuvae.text import embed_lyrics
    from tpuvae.utils import RunLogger

    rng = np.random.default_rng(21)
    t = np.arange(int(DURATION * SR)) / SR
    g = np.arange(N_CLIPS) % len(GENRES)
    paths = []
    for i in range(N_CLIPS):
        f0 = 110 * 2 ** (g[i] + rng.uniform(0, 1))
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
                  / (k + 1) for k in range(1 + g[i]))
        p = root / f"clip_{i:02d}.wav"
        _write_wav(p, 0.25 * sig / (1 + g[i]) + 0.03 * rng.normal(size=t.shape))
        paths.append(p)
    lyrics = [f"la la {GENRES[g[i]]} song number {i} " * (1 + i % 3)
              for i in range(N_CLIPS)]
    lyrics[3] = ""                                   # coerced to " "
    genres = [GENRES[k] for k in g]

    cfg = AdvancedPreprocessConfig(duration=DURATION, fixed_time_steps=FTS,
                                   precision_mode="exact",
                                   stft_method="pallas")
    waves = np.stack([load_audio(p, SR, DURATION) for p in paths])
    mel = np.asarray(jax.jit(lambda y: extract_mel_image(y, cfg))(
        jnp.asarray(waves)))
    mel_norm, mel_scaler = normalize_mel_images(mel)
    feats = (rng.normal(size=(N_CLIPS, 290)) + 2.0 * g[:, None]).astype(np.float32)
    feats_norm, imputer, flat_scaler = impute_and_scale(feats)
    text, backend = embed_lyrics(lyrics)
    data = root / "processed_data2"
    save_advanced(
        data, mel_raw=mel, mel_normalized=mel_norm, features_raw=feats,
        features_normalized=feats_norm, lyrics_embeddings=text,
        labels=np.array(genres),
        metadata=pd.DataFrame({"file_id": [p.stem for p in paths],
                               "genre": genres,
                               "language": np.where(g % 2, "bangla", "english")}),
        mel_scaler=mel_scaler, flat_scaler=flat_scaler, imputer=imputer,
        config={**cfg.to_dict(), "lyrics_embedder_backend": backend})
    results = root / "results"
    quiet = RunLogger(echo=False)
    run_hybrid_vae(str(data), str(results),
                   HybridVAEConfig(epochs=1, batch_size=8,
                                   compute_dtype=compute_dtype),
                   ClusterConfig(), quiet, make_plots=False)
    run_conditional_vae(str(data), str(results),
                        ConditionalVAEConfig(epochs=1, batch_size=8,
                                             compute_dtype=compute_dtype),
                        ClusterConfig(), quiet, make_plots=False)
    return {"root": root, "paths": paths, "lyrics": lyrics, "genres": genres,
            "results": results, "data": data, "backend": backend}


@pytest.fixture(scope="module")
def encoders(bundles):
    from tpuvae.infer import ClipEncoder as JaxEncoder

    from tpuvae_torch.infer import ClipEncoder

    res = str(bundles["results"])
    return {arch: (JaxEncoder.load(arch, results_dir=res),
                   ClipEncoder.load(arch, results_dir=res, device="cpu"))
            for arch in ("hybrid", "cvae")}


def _kwargs(bundles, arch, sl=slice(None)):
    kw = {"lyrics": bundles["lyrics"][sl]}
    if arch == "cvae":
        kw["genres"] = bundles["genres"][sl]
    return kw


@pytest.mark.parametrize("arch", ["hybrid", "cvae"])
def test_port_encoder_matches_jax_encoder(bundles, encoders, arch):
    jax_enc, enc = encoders[arch]
    assert enc.arch == arch and enc.device == torch.device("cpu")
    assert enc.pre_cfg.stft_method == "pallas"
    assert enc.embed_backend == bundles["backend"] == "hashed-ngram"
    assert set(enc.normalizers) == {"mel_scaler"}
    kw = _kwargs(bundles, arch)
    got = enc.encode_paths(bundles["paths"], batch_size=5, **kw)
    want = jax_enc.encode_paths(bundles["paths"], batch_size=5, **kw)
    latent = 128 if arch == "hybrid" else 64
    assert got.latents.shape == (N_CLIPS, latent)
    assert got.latents.dtype == np.float32 and np.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents, want.latents, rtol=0,
                               atol=LATENT_ATOL)
    np.testing.assert_array_equal(got.clusters, want.clusters)
    assert got.paths == [str(p) for p in bundles["paths"]]
    # the two passes batch: one call per batch of 5 equals one of 12
    whole = enc.encode_paths(bundles["paths"], batch_size=32, **kw)
    np.testing.assert_allclose(whole.latents, got.latents, rtol=1e-6,
                               atol=1e-6)


def test_mel_image_and_normalize_match_jax(bundles, encoders):
    jax_enc, enc = encoders["hybrid"]
    waves = enc.load_waveforms(bundles["paths"][:4])
    raw = enc.extract(waves)
    assert tuple(raw.shape) == (4, 128, FTS)
    want = np.asarray(jax_enc._extract(jnp.asarray(waves)))
    np.testing.assert_allclose(raw.numpy(), want, rtol=1e-5, atol=2e-3)
    x = enc.normalize(raw.numpy())
    assert x.shape == (4, 128, FTS, 1) and x.dtype == np.float32
    np.testing.assert_allclose(x, jax_enc._normalize(raw.numpy()), rtol=1e-6,
                               atol=1e-6)


def test_cvae_without_genres_warns_and_uses_a_zero_condition(bundles, encoders):
    jax_enc, enc = encoders["cvae"]
    paths, lyrics = bundles["paths"][:3], bundles["lyrics"][:3]
    with pytest.warns(UserWarning, match="all-zero condition"):
        got = enc.encode_paths(paths, lyrics=lyrics)
    with pytest.warns(UserWarning, match="all-zero condition"):
        want = jax_enc.encode_paths(paths, lyrics=lyrics)
    np.testing.assert_allclose(got.latents, want.latents, rtol=0,
                               atol=LATENT_ATOL)
    assert np.array_equal(enc._condition(None, 3), np.zeros((3, 3), np.float32))
    # a None genre leaves its row zero too
    cond = enc._condition(["pop", None, "rock"], 3)
    np.testing.assert_array_equal(cond, [[0, 1, 0], [0, 0, 0], [0, 0, 1]])


def test_missing_lyrics_embed_as_a_space(bundles, encoders):
    jax_enc, enc = encoders["hybrid"]
    paths = bundles["paths"][:2]
    got = enc.encode_paths(paths)
    np.testing.assert_array_equal(
        got.latents, enc.encode_paths(paths, lyrics=[" ", ""]).latents)
    np.testing.assert_allclose(got.latents, jax_enc.encode_paths(paths).latents,
                               rtol=0, atol=LATENT_ATOL)


def test_embedder_backend_mismatch_warns(encoders):
    _, enc = encoders["hybrid"]
    other = dataclasses.replace(enc, embed_backend="xlmr-checkpoint")
    with pytest.warns(UserWarning, match="backend"):
        other._embed_texts(["la"], 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        enc._embed_texts(["la"], 1)


_BAD_ARGS = {
    "lyrics_on_simple": ("simple", dict(lyrics=["a", "b"])),
    "genres_on_simple": ("simple", dict(genres=["pop", "pop"])),
    "genres_on_hybrid": ("hybrid", dict(genres=["pop", "pop"])),
    "lyric_count": ("hybrid", dict(lyrics=["a"])),
    "genre_count": ("cvae", dict(genres=["pop"])),
    "unknown_genre": ("cvae", dict(genres=["pop", "jazz"])),
}


@pytest.mark.parametrize("case", sorted(_BAD_ARGS))
def test_validate_args_raises_each_jax_error(encoders, case):
    arch, kw = _BAD_ARGS[case]
    base = "hybrid" if arch == "simple" else arch
    jax_enc, enc = (dataclasses.replace(e, arch=arch)
                    for e in encoders[base])
    with pytest.raises(ValueError) as want:
        jax_enc.validate_args(2, **kw)
    with pytest.raises(ValueError) as got:
        enc.validate_args(2, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=str(want.value)[:12]):
        enc.encode_waveforms(np.zeros((2, int(DURATION * SR)), np.float32),
                             **kw)


# -- HTTP server ---------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("arch", ["hybrid", "cvae"])
@pytest.mark.parametrize("batch_wait_ms", [0.0, 20.0], ids=["locked", "batched"])
def test_server_encodes_with_lyrics_and_genres(bundles, encoders, arch,
                                               batch_wait_ms):
    from tpuvae_torch.serve import make_server

    _, enc = encoders[arch]
    srv = make_server(enc, port=0, quiet=True, batch_wait_ms=batch_wait_ms,
                      max_batch=8)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/info", timeout=60) as r:
            info = json.loads(r.read())
        assert info["arch"] == arch and info["lyrics_embedder_backend"] == \
            "hashed-ngram"
        assert info["genre_names"] == (list(GENRES) if arch == "cvae" else [])
        paths = [str(p) for p in bundles["paths"][:6]]
        bodies = [{"paths": paths[:3], **_kwargs(bundles, arch, slice(0, 3))},
                  {"paths": paths[3:], **_kwargs(bundles, arch, slice(3, 6))}]
        replies = [None, None]

        def one(i):
            replies[i] = _post(url + "/encode", bodies[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        direct = enc.encode_paths(paths, **_kwargs(bundles, arch, slice(0, 6)))
        got = np.concatenate([np.asarray(r[1]["latents"]) for r in replies])
        assert [r[0] for r in replies] == [200, 200]
        np.testing.assert_allclose(got, direct.latents, rtol=0, atol=1e-6)
        assert sum((r[1]["clusters"] for r in replies), []) == \
            direct.clusters.tolist()
        assert all(r[1]["warnings"] == [] for r in replies)
        if arch == "cvae":
            status, out = _post(url + "/encode", {"paths": paths[:1],
                                                  "lyrics": ["x"]})
            assert status == 200 and "all-zero condition" in out["warnings"][0]
            status, out = _post(url + "/encode", {
                "paths": paths[:1], "lyrics": ["x"], "genres": ["jazz"]})
            assert status == 400 and "unknown genre" in out["error"]
        else:
            status, out = _post(url + "/encode", {
                "paths": paths[:1], "genres": ["pop"]})
            assert status == 400 and "unconditioned" in out["error"]
        status, out = _post(url + "/encode", {"paths": paths[:2],
                                              "lyrics": ["x"]})
        assert status == 400 and "got 1 lyrics for 2 clips" in out["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        srv.app.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_warms_up_a_conv_bundle_with_lyrics(bundles, monkeypatch):
    from tpuvae_torch import serve as serve_mod

    served = []

    class _Server:
        server_address = ("127.0.0.1", 0)

        def __init__(self, encoder):
            self.app = self
            served.append(encoder)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

        def close(self):
            pass

    monkeypatch.setattr(serve_mod, "make_server",
                        lambda enc, **kw: _Server(enc))
    calls = []
    real = serve_mod.ClipEncoder.encode_waveforms

    def spy(self, waveforms, **kw):
        calls.append((self.arch, waveforms.shape, kw))
        return real(self, waveforms, **kw)

    monkeypatch.setattr(serve_mod.ClipEncoder, "encode_waveforms", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        serve_mod.serve("cvae", results_dir=str(bundles["results"]),
                        device="cpu")
    assert calls == [("cvae", (1, int(DURATION * SR)), {"lyrics": [" "]})]
    assert served[0].arch == "cvae"


# -- CLI ----------------------------------------------------------------------

def test_cli_encode_with_lyrics_file_and_genres(bundles, encoders, tmp_path,
                                                capsys):
    from tpuvae_torch import cli

    _, enc = encoders["cvae"]
    # one lyric per line (clip 3's empty lyric would be no line at all)
    sl = slice(4, 8)
    paths = [str(p) for p in bundles["paths"][sl]]
    lyrics, genres = bundles["lyrics"][sl], bundles["genres"][sl]
    lyrics_file = tmp_path / "lyrics.txt"
    lyrics_file.write_text("\n".join(lyrics) + "\n")
    out = tmp_path / "z.npz"
    rc = cli.main(["encode", "--arch=cvae", "--device=cpu",
                   f"--results_dir={bundles['results']}",
                   f"--lyrics_file={lyrics_file}",
                   "--genres=" + ",".join(genres), f"--out={out}", *paths])
    assert rc == 0
    assert capsys.readouterr().out.count("cluster=") == 4
    want = enc.encode_paths(paths, lyrics=lyrics, genres=genres)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["latents"], want.latents)
        np.testing.assert_array_equal(z["clusters"], want.clusters)
    # no --arch: the hybrid bundle, --lyrics for every clip
    out2 = tmp_path / "h.npz"
    assert cli.main(["encode", "--device=cpu", "--lyrics=la la",
                     f"--results_dir={bundles['results']}", f"--out={out2}",
                     *paths[:2]]) == 0
    hybrid = encoders["hybrid"][1].encode_paths(paths[:2],
                                                lyrics=["la la"] * 2)
    with np.load(out2) as z:
        np.testing.assert_array_equal(z["latents"], hybrid.latents)
    assert cli.main(["encode", "--device=cpu", "--genres=pop",
                     f"--results_dir={bundles['results']}", paths[0]]) == 2
    assert "unconditioned" in capsys.readouterr().err


def test_both_clis_default_to_hybrid(monkeypatch, tmp_path):
    import tpuvae.cli as jax_cli
    import tpuvae.infer
    import tpuvae.serve

    import tpuvae_torch.infer
    import tpuvae_torch.serve
    from tpuvae_torch import cli

    archs = []

    def fake_load(arch, *args, **kwargs):
        archs.append(arch)
        raise FileNotFoundError("stop here")

    def fake_serve(arch, **kwargs):
        archs.append(arch)

    for mod in (tpuvae.infer, tpuvae_torch.infer):
        monkeypatch.setattr(mod.ClipEncoder, "load", staticmethod(fake_load))
    for mod in (tpuvae.serve, tpuvae_torch.serve):
        monkeypatch.setattr(mod, "serve", fake_serve)
    for main in (jax_cli.main, cli.main):
        assert main(["encode", str(tmp_path / "x.wav")]) == 2
        assert main(["serve"]) == 0
    assert archs == ["hybrid"] * 4
    monkeypatch.undo()
    for fn in (tpuvae.serve.serve, tpuvae_torch.serve.serve):
        assert inspect.signature(fn).parameters["arch"].default == "hybrid"
