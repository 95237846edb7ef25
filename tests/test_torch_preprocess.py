"""The port's preprocess slice against the JAX package, on the CPU.

One synthetic corpus (2 s clips) goes through both packages' modules and
pipelines.  What is plain host code in both (the synthetic corpus, the
catalog, the shard manifest, the streaming scaler and assembly, the hashed
lyrics embedder, ``metadata.csv``, labels) must be equal; what goes
through the DSP agrees within stated tolerances:

* the extractors at the same ``stft_method`` in exact mode: rtol 1e-4 /
  atol 1e-3, as the 370-d vector in tests/test_torch_features.py — fp32
  everywhere, the two differ in summation order only.  The two rolloff
  columns get an atol of one bin (sr / n_fft Hz): a frame's rolloff moves
  by one bin where the two prefix sums straddle the 85% threshold
  differently, and the mean over T frames moves by at most that;
* mel-dB images: atol 2e-3 dB (fp32 log of sums in two orders);
* normalized artifacts: atol 2e-2, since the scaler divides a raw
  difference by a column's standard deviation over a dozen clips.

The Pallas kernels of the JAX package run in interpret mode; the port runs
each kernel's plain version (``device="cpu"``).
"""

import dataclasses
import filecmp
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

SR = 22050
N_FFT = 2048
DURATION = 2.0
FTS = 64                      # fixed_time_steps of the small advanced runs
ROLLOFF_BIN = SR / N_FFT


# -- fixtures ----------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A reference-layout corpus written by the port: 3 genres + jazz, 2
    languages, 2 clips each (the second lyricless) = 16 WAVs of 2 s."""
    from tpuvae_torch.io.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("corpus") / "Datasets"
    meta = generate_dataset(root, clips_per_genre_lang=2, duration=DURATION,
                            include_jazz=True, seed=7)
    return root, meta


@pytest.fixture(scope="module")
def clips(corpus):
    from tpuvae_torch.io.wav import load_audio

    root, _ = corpus
    files = sorted(root.rglob("*.wav"))[:4]
    return np.stack([load_audio(f, SR, DURATION) for f in files])


@pytest.fixture(autouse=True)
def two_loader_threads(monkeypatch):
    monkeypatch.setenv("TPUVAE_LOADER_THREADS", "2")


def _quiet(package):
    if package == "jax":
        from tpuvae.utils import RunLogger
    else:
        from tpuvae_torch.utils.logging import RunLogger
    return RunLogger(echo=False)


def _configs(package):
    if package == "jax":
        from tpuvae import config
    else:
        from tpuvae_torch import config
    return config.PreprocessConfig, config.AdvancedPreprocessConfig


def _common(corpus, out, **kw):
    root, meta = corpus
    return dict(duration=DURATION, dataset_root=str(root),
                metadata_csv=str(meta), output_dir=str(out), extract_batch=4,
                precision_mode="exact", **kw)


def _assert_flat_close(got, want, rolloff_cols):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rest = np.ones(got.shape[1], bool)
    rest[list(rolloff_cols)] = False
    np.testing.assert_allclose(got[:, rest], want[:, rest], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got[:, ~rest], want[:, ~rest], rtol=1e-4,
                               atol=ROLLOFF_BIN * 1.0001)


# -- host modules: equal to the JAX package's ----------------------------------

def test_synth_data_is_byte_identical(tmp_path, corpus):
    from tpuvae.io import synthetic as jsyn

    from tpuvae_torch.io import synthetic as tsyn

    root, _ = corpus
    jsyn.generate_dataset(tmp_path / "Datasets", clips_per_genre_lang=2,
                          duration=DURATION, include_jazz=True, seed=7)

    def same(c):
        return (not c.diff_files and not c.left_only and not c.right_only
                and not c.funny_files
                and all(same(s) for s in c.subdirs.values()))

    cmp = filecmp.dircmp(root, tmp_path / "Datasets")
    assert same(cmp) and len(list(root.rglob("*.wav"))) == 16
    wav = sorted(root.rglob("*.wav"))[0]
    assert filecmp.cmp(wav, tmp_path / "Datasets" / wav.relative_to(root),
                       shallow=False)
    a, la = tsyn.generate_memory_batch(2, duration=0.5, seed=3)
    b, lb = jsyn.generate_memory_batch(2, duration=0.5, seed=3)
    np.testing.assert_array_equal(a, b)
    assert la.tolist() == lb.tolist()
    np.testing.assert_array_equal(
        tsyn.synth_clip("metal", np.random.default_rng(1), SR, 0.5, 0.4),
        jsyn.synth_clip("metal", np.random.default_rng(1), SR, 0.5, 0.4))


@pytest.mark.parametrize("container", ["flac", "mixed"])
def test_synth_data_flac_containers_raise(tmp_path, container):
    """The FLAC containers are written byte for byte as the JAX package
    writes them (files and ``metadata.csv``); an unknown container still
    raises ``ValueError``."""
    from tpuvae.io.synthetic import generate_dataset as jax_generate

    from tpuvae_torch.io.synthetic import generate_dataset

    kw = dict(clips_per_genre_lang=2, duration=0.5, seed=9, container=container)
    meta = generate_dataset(tmp_path / "D", **kw)
    jax_generate(tmp_path / "J", **kw)
    files = sorted(f.relative_to(tmp_path / "D")
                   for f in (tmp_path / "D").rglob("*") if f.is_file())
    assert files == sorted(f.relative_to(tmp_path / "J")
                           for f in (tmp_path / "J").rglob("*") if f.is_file())
    suffixes = [f.suffix for f in files if f.suffix != ".csv"]
    assert suffixes.count(".flac") == (12 if container == "flac" else 6)
    for f in files:
        assert filecmp.cmp(tmp_path / "D" / f, tmp_path / "J" / f,
                           shallow=False), f
    assert meta == tmp_path / "D" / "updated_metadata.csv"
    with pytest.raises(ValueError, match="container"):
        generate_dataset(tmp_path / "E", container="ogg")
    assert not (tmp_path / "E").exists()


@pytest.mark.parametrize("kw", [
    dict(strict=False), dict(strict=True),
    dict(strict=True, exclude_genres=("rock", "Pop ")),
    dict(strict=True, min_lyrics_chars=200),
    dict(strict=False, max_per_class=1)],
    ids=["basic", "strict", "exclude", "short-lyrics", "cap"])
def test_catalog_matches_jax(corpus, kw):
    from tpuvae.io.catalog import collect_audio_files as jcollect

    from tpuvae_torch.io.catalog import collect_audio_files

    root, meta = corpus
    got, got_skipped = collect_audio_files(root, meta, **kw)
    want, want_skipped = jcollect(root, meta, **kw)
    assert [dataclasses.asdict(e) for e in got] == [
        dataclasses.asdict(e) for e in want]
    assert got_skipped == want_skipped
    if kw == dict(strict=True):
        assert len(got) == 6 and got_skipped["jazz_excluded"] == 4
        assert got_skipped["empty_lyrics"] == 6


def test_catalog_skips_files_missing_from_the_metadata(tmp_path, corpus):
    from tpuvae_torch.io.catalog import collect_audio_files, load_metadata

    root, meta = corpus
    df = pd.read_csv(meta)
    df[df["genre"] != "pop"].drop(columns="lyrics").to_csv(
        tmp_path / "m.csv", index=False)
    entries, skipped = collect_audio_files(root, tmp_path / "m.csv")
    assert skipped["not_in_metadata"] == 4 and len(entries) == 12
    assert all(e.lyrics == "" for e in entries)
    assert load_metadata(tmp_path / "m.csv")[1] == {}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_written_by_one_package_is_read_by_the_other(tmp_path,
                                                               writer):
    from tpuvae.io.resume import ExtractionManifest as JaxManifest

    from tpuvae_torch.io.resume import ExtractionManifest

    W, R = ((JaxManifest, ExtractionManifest) if writer == "jax"
            else (ExtractionManifest, JaxManifest))
    rng = np.random.default_rng(0)
    w = W(tmp_path)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(2, 5)).astype(np.float32)
    w.add_shard(["x", "y", "z"], {"features": a})
    w.add_shard(["u", "v"], {"features": b})
    r = R(tmp_path)
    assert r.total_rows() == 5 and r.shards == w.shards

    @dataclasses.dataclass
    class E:
        file_id: str

    assert [e.file_id for e in r.filter_pending([E("x"), E("q"), E("v")])] == ["q"]
    ids, arrays = r.load_all()
    assert ids == ["x", "y", "z", "u", "v"]
    np.testing.assert_array_equal(arrays["features"], np.concatenate([a, b]))
    r.cleanup()
    assert not (tmp_path / "shards").exists()


def test_streaming_scaler_and_mel_normalizer_match_jax():
    from tpuvae.io import normalize as jnorm

    from tpuvae_torch.io import normalize as tnorm

    rng = np.random.default_rng(2)
    mels = (rng.normal(-40, 12, (9, 6, 5))).astype(np.float32)
    mels[:, 0, 0] = -80.0                         # a pixel without variance
    tfit, jfit = tnorm.StreamingScalerFit(), jnorm.StreamingScalerFit()
    for lo, hi in ((0, 4), (4, 9)):
        tfit.update(mels[lo:hi])
        jfit.update(mels[lo:hi])
    ts, js = tfit.finalize(), jfit.finalize()
    np.testing.assert_array_equal(ts.mean, js.mean)
    np.testing.assert_array_equal(ts.scale, js.scale)
    assert ts.scale[0] == 1.0
    tn, tsc = tnorm.normalize_mel_images(mels)
    jn, jsc = jnorm.normalize_mel_images(mels)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tsc.mean, jsc.mean)
    # the streamed fit agrees with the full-array one (float64 sums)
    np.testing.assert_allclose(ts.mean, tsc.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.scale, tsc.scale, rtol=1e-4)
    with pytest.raises(ValueError, match="no rows"):
        tnorm.StreamingScalerFit().finalize()


def test_streaming_assembly_matches_jax(tmp_path):
    from tpuvae.io.assembly import assemble_advanced_streaming as jassemble
    from tpuvae.io.resume import ExtractionManifest as JaxManifest

    from tpuvae_torch.io.assembly import assemble_advanced_streaming
    from tpuvae_torch.io.resume import ExtractionManifest

    rng = np.random.default_rng(4)
    for M, d in ((ExtractionManifest, tmp_path / "t"),
                 (JaxManifest, tmp_path / "j")):
        m = M(d)
        r = np.random.default_rng(4)
        for i, n in enumerate((3, 2, 4)):
            m.add_shard([f"s{i}_{k}" for k in range(n)], {
                "mel": r.normal(-40, 10, (n, 4, 6)).astype(np.float32),
                "flat": r.normal(size=(n, 7)).astype(np.float32)})
    ids, flats, scaler = assemble_advanced_streaming(
        ExtractionManifest(tmp_path / "t"), tmp_path / "t", (4, 6), 7,
        chunk_rows=4)
    jids, jflats, jscaler = jassemble(JaxManifest(tmp_path / "j"),
                                      tmp_path / "j", (4, 6), 7, chunk_rows=4)
    assert ids == jids and len(ids) == 9
    np.testing.assert_array_equal(flats, jflats)
    np.testing.assert_array_equal(scaler.mean, jscaler.mean)
    for name in ("mel_spectrograms_raw.npy", "mel_spectrograms_normalized.npy"):
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False)
    norm = np.load(tmp_path / "t" / "mel_spectrograms_normalized.npy")
    np.testing.assert_allclose(norm.mean(axis=0), 0.0, atol=1e-5)
    with pytest.raises(ValueError, match="shape"):
        assemble_advanced_streaming(ExtractionManifest(tmp_path / "t"),
                                    tmp_path / "t", (4, 7), 7)
    with pytest.raises(ValueError, match="empty"):
        assemble_advanced_streaming(ExtractionManifest(tmp_path / "e"),
                                    tmp_path / "e", (4, 6), 7)
    del rng


def test_hashed_embedder_matches_jax():
    from tpuvae.text import embed_lyrics as jembed
    from tpuvae.text.hashing import embed_texts as jtexts

    from tpuvae_torch.text.embedder import embed_lyrics
    from tpuvae_torch.text.hashing import embed_texts

    texts = ["amar sonar bangla ami tomay bhalobashi", "the road goes ever on",
             "আমার সোনার বাংলা", "", None, "  "]
    got, backend = embed_lyrics(texts)
    want, jbackend = jembed(texts)
    assert backend == jbackend == "hashed-ngram"
    assert got.shape == (6, 768) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(embed_texts(texts[:3], dim=64),
                                  jtexts(texts[:3], dim=64))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


def test_lyrics_checkpoint_is_never_silently_ignored(tmp_path, monkeypatch):
    from tpuvae_torch.text.embedder import embed_lyrics

    with pytest.raises(FileNotFoundError, match="does not exist"):
        embed_lyrics(["a"], checkpoint=str(tmp_path / "missing"))
    # a real checkpoint directory embeds, by argument or from the
    # environment (tests/test_torch_text.py holds the values to the JAX
    # package's)
    from test_torch_text import write_checkpoint

    ckpt = write_checkpoint(tmp_path / "ckpt")
    emb, backend = embed_lyrics(["a", ""], checkpoint=str(ckpt), device="cpu")
    assert backend == "xlmr-checkpoint:ckpt" and emb.shape == (2, 64)
    assert np.isfinite(emb).all()
    monkeypatch.setenv("TPUVAE_TEXT_CHECKPOINT", str(ckpt))
    emb_env, backend_env = embed_lyrics(["a", ""], device="cpu")
    assert backend_env == backend
    np.testing.assert_array_equal(emb_env, emb)
    monkeypatch.setenv("TPUVAE_TEXT_CHECKPOINT", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        embed_lyrics(["a"])


def test_configs_match_jax_and_stft_method_is_read():
    from tpuvae.config import AdvancedPreprocessConfig as JaxAdv

    from tpuvae_torch.config import AdvancedPreprocessConfig, PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features, resolve_numerics

    assert AdvancedPreprocessConfig().to_dict() == JaxAdv().to_dict()
    args = ["--duration=2.0", "fixed_time_steps=64", "exclude_genres=[\"pop\"]"]
    cfg = AdvancedPreprocessConfig().override(args)
    assert cfg.to_dict() == JaxAdv().override(args).to_dict()
    assert cfg.num_samples == 44100 and cfg.flat_feature_dim == 290
    assert resolve_numerics(PreprocessConfig()) == (False, "ct_pallas")
    assert resolve_numerics(PreprocessConfig(precision_mode="exact",
                                             stft_method="pallas")) == (
        True, "pallas")
    assert resolve_numerics(cfg, "fft") == (False, "fft")
    y = torch.zeros((1, 4096))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        extract_basic_features(y, PreprocessConfig(stft_method="ct"))
    with pytest.raises(ValueError, match="stft_method"):
        extract_basic_features(y, PreprocessConfig(stft_method="bogus"))
    with pytest.raises(ValueError, match="precision_mode"):
        resolve_numerics(PreprocessConfig(precision_mode="sloppy"))


def test_run_logger_echoes_to_the_current_stderr():
    """The default stream is looked up when an event is logged: a logger
    made by an entry point must not write to a stream that was current
    (and has since been closed) when the module was first imported."""
    import contextlib
    import io

    from tpuvae_torch.utils.logging import RunLogger

    first, second = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(first):
        logger = RunLogger()
        logger.log("one", n=1)
    with contextlib.redirect_stderr(second):
        logger.log("two")
        RunLogger(stream=first).log("three")
    assert '"event": "one"' in first.getvalue()
    assert '"event": "two"' in second.getvalue()
    assert '"event": "three"' in first.getvalue()
    assert "three" not in second.getvalue()


def test_stage_timer_records_seconds_and_rates():
    from tpuvae_torch.utils.logging import StageTimer

    timer = StageTimer()
    with timer.stage("a", items=10):
        pass
    with timer.stage("b"):
        pass
    assert set(timer.stages["a"]) == {"seconds", "items", "items_per_sec"}
    assert set(timer.stages["b"]) == {"seconds"}
    assert timer.stages["a"]["items_per_sec"] > 0


# -- extractors ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("method", ["fft", "pallas"])
def test_advanced_extractors_match_jax(clips, method, mode):
    """``extract_mel_image``, ``extract_flat_features`` and
    ``extract_advanced`` at one ``stft_method``.  The staged front end keeps
    fp32 power in fast mode too, and on its CPU backend the JAX package's
    DEFAULT matmul precision is fp32, so fast mode is held as tightly as
    exact mode here."""
    from tpuvae.config import AdvancedPreprocessConfig as JaxAdv
    from tpuvae.dsp import features as jfeat

    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.dsp import features as tfeat

    kw = dict(duration=DURATION, fixed_time_steps=FTS, precision_mode=mode,
              stft_method=method)
    jcfg, tcfg = JaxAdv(**kw), AdvancedPreprocessConfig(**kw)
    y = torch.from_numpy(clips)
    jmel, jflat = jax.jit(lambda a: jfeat.extract_advanced(a, jcfg))(
        jnp.asarray(clips))
    mel, flat = tfeat.extract_advanced(y, tcfg)
    assert tuple(mel.shape) == (4, 128, FTS) and tuple(flat.shape) == (4, 290)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), rtol=1e-5,
                               atol=2e-3)
    _assert_flat_close(flat.numpy(), jflat, rolloff_cols=(260, 261))
    torch.testing.assert_close(tfeat.extract_mel_image(y, tcfg), mel,
                               rtol=0, atol=0)
    torch.testing.assert_close(tfeat.extract_flat_features(y, tcfg), flat,
                               rtol=0, atol=0)


def test_mel_image_pads_short_clips_with_the_min(clips):
    from tpuvae.config import AdvancedPreprocessConfig as JaxAdv
    from tpuvae.dsp import features as jfeat

    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.dsp.features import extract_mel_image

    kw = dict(duration=DURATION, fixed_time_steps=128, precision_mode="exact",
              stft_method="fft")              # 87 frames < 128
    img = extract_mel_image(torch.from_numpy(clips[:2]),
                            AdvancedPreprocessConfig(**kw))
    want = np.asarray(jfeat.extract_mel_image(jnp.asarray(clips[:2]),
                                              JaxAdv(**kw)))
    assert tuple(img.shape) == (2, 128, 128)
    np.testing.assert_allclose(img.numpy(), want, rtol=1e-5, atol=2e-3)
    assert (img[:, :, 87:] == img[:, :, :87].amin(dim=(1, 2), keepdim=True)).all()


@pytest.mark.parametrize("method", ["fft", "dft", "pallas"])
def test_basic_extractor_staged_methods_match_jax(clips, method):
    from tpuvae.config import PreprocessConfig as JaxConfig
    from tpuvae.dsp.features import extract_basic_features as jextract

    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features

    kw = dict(duration=DURATION, precision_mode="exact", stft_method=method)
    want = jax.jit(lambda a: jextract(a, JaxConfig(**kw)))(jnp.asarray(clips))
    got = extract_basic_features(torch.from_numpy(clips), PreprocessConfig(**kw))
    _assert_flat_close(got.numpy(), want, rolloff_cols=(340, 341))
    # the stft_method argument wins over the config's
    via_arg = extract_basic_features(
        torch.from_numpy(clips), PreprocessConfig(duration=DURATION,
                                                  precision_mode="exact"),
        stft_method=method)
    torch.testing.assert_close(via_arg, got, rtol=0, atol=0)


def test_staged_front_end_keeps_fp32_power_and_filterbank_in_fast_mode(clips):
    """bf16 power exists only on the fused route: under a staged method
    fast mode computes what exact mode computes, chroma included."""
    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.dsp import features as tfeat

    y = torch.from_numpy(clips[:2])
    out = {}
    for mode in ("fast", "exact"):
        cfg = AdvancedPreprocessConfig(duration=DURATION, precision_mode=mode,
                                       stft_method="pallas")
        fe = tfeat._spectral_front_end(y, cfg, *tfeat.resolve_numerics(cfg))
        assert fe.power.dtype == torch.float32 and fe.colmax is None
        out[mode] = tfeat.extract_flat_features(y, cfg)
    torch.testing.assert_close(out["fast"], out["exact"], rtol=0, atol=0)
    fused = tfeat._spectral_front_end(
        y, AdvancedPreprocessConfig(duration=DURATION), False, "ct_pallas")
    assert fused.power.dtype == torch.bfloat16 and fused.colmax is not None


def test_auto_and_pallas_agree_within_the_fast_contract(clips):
    """Two spectra, one set of features: kernel 1's route (bf16 power) and
    the dense-DFT route (fp32) are held to each other only by the
    fast-mode contract, 2% rtol / 1.0 atol (tpuvae/dsp/features.py:75-76)."""
    from tpuvae_torch.config import PreprocessConfig
    from tpuvae_torch.dsp.features import extract_basic_features

    y = torch.from_numpy(clips)
    auto = extract_basic_features(y, PreprocessConfig(duration=DURATION))
    dense = extract_basic_features(
        y, PreprocessConfig(duration=DURATION, stft_method="pallas"))
    np.testing.assert_allclose(dense.numpy(), auto.numpy(), rtol=0.02, atol=1.0)


@pytest.mark.parametrize("route", ["fused", "staged"])
def test_tuning_without_colmax_equals_jax_on_shared_power(clips, route):
    """A staged front end hands the tuning stage no per-frame max; both
    routes take it from the power and give the JAX package's tunings
    exactly (no tie in these clips forces a one-bin allowance)."""
    from tpuvae.dsp.chroma import estimate_tuning_batch as jtuning
    from tpuvae.dsp import stft_power as jax_stft_power

    from tpuvae_torch.dsp.chroma import chroma_batch, estimate_tuning_batch

    power = np.array(jax_stft_power(jnp.asarray(clips), method="pallas"))
    want = np.asarray(jtuning(jnp.asarray(power), SR, N_FFT))
    p = torch.from_numpy(power)
    got = estimate_tuning_batch(p, SR, N_FFT, None, route=route)
    np.testing.assert_array_equal(got.numpy(), want)
    with_max = estimate_tuning_batch(p, SR, N_FFT, p.amax(dim=1), route=route)
    torch.testing.assert_close(got, with_max, rtol=0, atol=0)
    torch.testing.assert_close(
        chroma_batch(p, SR, N_FFT, None, tuning_route=route),
        chroma_batch(p, SR, N_FFT, p.amax(dim=1), tuning_route="fused"),
        rtol=0, atol=0)


def test_make_extractor_takes_a_tensor_or_a_numpy_batch(clips):
    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.dsp.features import extract_advanced, make_extractor

    cfg = AdvancedPreprocessConfig(duration=DURATION, fixed_time_steps=FTS)
    fn = make_extractor(extract_advanced, cfg, torch.device("cpu"))
    pcm = np.clip(np.rint(clips[:2] * 32768.0), -32768, 32767).astype(np.int16)
    a = fn(pcm)
    b = fn(torch.from_numpy(pcm))
    c = fn(pcm.astype(np.float32) / 32768.0)
    for x, y, z in zip(a, b, c):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(x, z, rtol=0, atol=0)
    with pytest.raises(ValueError, match="batched"):
        fn(torch.from_numpy(pcm[0]))


# -- pipelines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_basic(corpus, tmp_path_factory):
    """``processed_data1`` of the JAX pipeline per stft_method (computed
    once per method)."""
    from tpuvae.pipelines import preprocess_basic

    done = {}

    def run(method):
        if method not in done:
            out = tmp_path_factory.mktemp(f"jax1_{method}") / "processed_data1"
            cfg = _configs("jax")[0](**_common(corpus, out, stft_method=method))
            res = preprocess_basic(cfg, logger=_quiet("jax"))
            done[method] = (out, res)
        return done[method]

    return run


@pytest.mark.parametrize("method", ["fft", "pallas"])
def test_preprocess_basic_matches_jax(corpus, tmp_path, jax_basic, method):
    from tpuvae.io.artifacts import load_basic as jload

    from tpuvae_torch.io.artifacts import load_basic
    from tpuvae_torch.io.normalize import load_normalizer
    from tpuvae_torch.pipelines import preprocess_basic

    jout, jres = jax_basic(method)
    out = tmp_path / "processed_data1"
    cfg = _configs("torch")[0](**_common(corpus, out, stft_method=method))
    res = preprocess_basic(cfg, device="cpu", logger=_quiet("torch"))
    assert res["n"] == jres["n"] == 16 and res["failed"] == []
    # the JAX ledger's keys, plus the buffer set-up the port times apart
    # and the clips each decoder read (all by the native loader here)
    assert set(res["extract_detail"]) == set(jres["extract_detail"]) | {
        "setup_s", "decodes_native", "decodes_python"}
    assert res["extract_detail"]["decodes_native"] == 16
    assert res["extract_detail"]["decodes_python"] == 0
    assert {"catalog", "extract_basic", "assemble", "normalize",
            "save_artifacts"} <= set(res["stages"])
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in jout.iterdir())          # shards cleaned up too
    # each package loads the other's directory
    got, want = jload(out), load_basic(jout)
    assert got["features"].shape == (16, 370)
    _assert_flat_close(got["features_raw"], want["features_raw"], (340, 341))
    np.testing.assert_allclose(got["features"], want["features"], atol=2e-2)
    assert got["labels"].tolist() == want["labels"].tolist()
    assert (out / "metadata.csv").read_bytes() == (
        jout / "metadata.csv").read_bytes()
    assert load_normalizer(out / "config.pkl") == {
        **load_normalizer(jout / "config.pkl"), "output_dir": str(out)}
    with open(out / "scaler.pkl", "rb") as f:
        scaler = pickle.load(f)
    np.testing.assert_allclose(scaler.mean,
                               load_normalizer(jout / "scaler.pkl").mean,
                               rtol=1e-4, atol=ROLLOFF_BIN)


@pytest.mark.parametrize("assembly_mode", ["inmem", "stream"])
def test_preprocess_advanced_matches_jax(corpus, tmp_path, assembly_mode):
    from tpuvae.io.artifacts import load_advanced as jload
    from tpuvae.pipelines import preprocess_advanced as jpreprocess

    from tpuvae_torch.io.artifacts import load_advanced
    from tpuvae_torch.io.normalize import load_normalizer
    from tpuvae_torch.pipelines import preprocess_advanced

    kw = dict(stft_method="pallas", fixed_time_steps=FTS,
              assembly_mode=assembly_mode)
    jout, out = tmp_path / "j" / "processed_data2", tmp_path / "processed_data2"
    jres = jpreprocess(_configs("jax")[1](**_common(corpus, jout, **kw)),
                       logger=_quiet("jax"))
    res = preprocess_advanced(
        _configs("torch")[1](**_common(corpus, out, **kw)), device="cpu",
        logger=_quiet("torch"))
    # the strict catalog drops jazz (4) and the lyricless clips (6)
    assert res["n"] == jres["n"] == 6 and res["failed"] == []
    assert ("assemble_stream" in res["stages"]) == (assembly_mode == "stream")
    assert set(res["stages"]) == set(jres["stages"])
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in jout.iterdir())
    got, want = jload(out), load_advanced(jout, mmap=True)
    assert got["mel"].shape == (6, 128, FTS) and got["mel"].dtype == np.float32
    np.testing.assert_array_equal(got["text"], want["text"])
    assert got["text"].shape == (6, 768)
    np.testing.assert_allclose(got["mel"], want["mel"], atol=2e-2)
    np.testing.assert_allclose(got["handcrafted"], want["handcrafted"],
                               atol=2e-2)
    np.testing.assert_allclose(np.load(out / "mel_spectrograms_raw.npy"),
                               np.load(jout / "mel_spectrograms_raw.npy"),
                               rtol=1e-5, atol=2e-3)
    _assert_flat_close(np.load(out / "features_raw.npy"),
                       np.load(jout / "features_raw.npy"), (260, 261))
    assert got["labels"].tolist() == want["labels"].tolist()
    assert (out / "metadata.csv").read_bytes() == (
        jout / "metadata.csv").read_bytes()
    cfg_dict = load_normalizer(out / "config.pkl")
    assert cfg_dict["lyrics_embedder_backend"] == "hashed-ngram"
    assert cfg_dict == {**load_normalizer(jout / "config.pkl"),
                        "output_dir": str(out)}
    mel_scaler = load_normalizer(out / "mel_scaler.pkl")
    assert mel_scaler.mean.shape == (128 * FTS,)


def test_preprocess_advanced_refuses_bad_assembly_settings(corpus, tmp_path):
    from tpuvae_torch.pipelines import preprocess_advanced

    Adv = _configs("torch")[1]
    with pytest.raises(ValueError, match="assembly_mode"):
        preprocess_advanced(Adv(assembly_mode="bogus"), device="cpu")
    with pytest.raises(ValueError, match="resume=True"):
        preprocess_advanced(Adv(assembly_mode="stream"), device="cpu",
                            resume=False)
    with pytest.raises(ValueError, match="No audio files"):
        preprocess_advanced(
            Adv(**_common(corpus, tmp_path / "o", min_lyrics_chars=500)),
            device="cpu", logger=_quiet("torch"))


def test_preprocess_without_resume_keeps_no_shards(corpus, tmp_path):
    from tpuvae_torch.pipelines import preprocess_advanced, preprocess_basic

    P, A = _configs("torch")
    kw = dict(stft_method="fft", max_samples_per_class=1)
    r1 = preprocess_basic(P(**_common(corpus, tmp_path / "d1", **kw)),
                          device="cpu", logger=_quiet("torch"), resume=False)
    r2 = preprocess_advanced(
        A(**_common(corpus, tmp_path / "d2", fixed_time_steps=FTS, **kw)),
        device="cpu", logger=_quiet("torch"), resume=False)
    assert r1["n"] == 8 and r2["n"] == 6
    assert not (tmp_path / "d1" / "shards").exists()
    assert np.load(tmp_path / "d2" / "mel_spectrograms_raw.npy").shape == (
        6, 128, FTS)
    # the resumable run of the same corpus writes the same features
    r3 = preprocess_basic(P(**_common(corpus, tmp_path / "d3", **kw)),
                          device="cpu", logger=_quiet("torch"))
    np.testing.assert_array_equal(np.load(tmp_path / "d1" / "features_raw.npy"),
                                  np.load(tmp_path / "d3" / "features_raw.npy"))
    assert r3["n"] == 8


def test_failed_decodes_are_skipped_and_tallied(corpus, tmp_path):
    """The reference's skip-and-tally contract: a file that does not
    decode is returned in ``failed`` and the rest of its batch goes on."""
    import shutil

    from tpuvae_torch.pipelines import preprocess_basic

    root, meta = corpus
    mine = tmp_path / "Datasets"
    shutil.copytree(root, mine)
    victims = sorted((mine / "Bangla_Datasets" / "pop").glob("*.wav"))
    victims[0].write_bytes(victims[0].read_bytes()[:16])        # truncated
    whole = sorted((mine / "English_Datasets" / "rock").glob("*.wav"))
    for f in whole:                       # a batch in which every clip fails
        f.write_bytes(b"not audio")
    cfg = _configs("torch")[0](**{
        **_common(corpus, tmp_path / "out", stft_method="fft"),
        "dataset_root": str(mine), "extract_batch": 2})
    events = []

    class Log:
        def log(self, event, **fields):
            events.append((event, fields))

    res = preprocess_basic(cfg, device="cpu", logger=Log())
    assert res["n"] == 13
    logged = [f["path"] for e, f in events if e == "decode_failed"]
    assert sorted(logged) == sorted(p for p, _ in res["failed"])
    assert sorted(p for p, _ in res["failed"]) == sorted(
        str(f) for f in [victims[0], *whole])
    assert all(isinstance(msg, str) and msg for _, msg in res["failed"])
    names = pd.read_csv(tmp_path / "out" / "metadata.csv")["filename"].tolist()
    assert victims[0].name not in names and victims[1].name in names
    assert np.isfinite(np.load(tmp_path / "out" / "features_raw.npy")).all()


class _Cut(BaseException):
    """Ends a run in the middle, as a kill would (not an ``Exception``: the
    skip-and-tally handler must not swallow it)."""


def test_resume_after_a_run_cut_short(corpus, tmp_path, monkeypatch):
    from tpuvae_torch import pipelines
    from tpuvae_torch.io.resume import ExtractionManifest

    cfg = _configs("torch")[0](**_common(corpus, tmp_path / "out",
                                         stft_method="fft"))
    entries, _ = pipelines.collect_audio_files(cfg.dataset_root,
                                               cfg.metadata_csv)
    real_load = pipelines.load_audio

    def cut_in_third_batch(path, *a, **kw):
        if path == entries[9].path:
            raise _Cut()
        return real_load(path, *a, **kw)

    monkeypatch.setattr(pipelines, "load_audio", cut_in_third_batch)
    with pytest.raises(_Cut):
        pipelines.preprocess_basic(cfg, device="cpu", logger=_quiet("torch"))
    monkeypatch.setattr(pipelines, "load_audio", real_load)
    left = ExtractionManifest(cfg.output_dir)
    assert left.total_rows() == 8 and len(left.shards) == 2
    assert not (tmp_path / "out" / "features_raw.npy").exists()

    events = []

    class Log:
        def log(self, event, **fields):
            events.append((event, fields))

    res = pipelines.preprocess_basic(cfg, device="cpu", logger=Log())
    assert ("resume", {"already_done": 8}) in events
    assert res["n"] == 16 and res["stages"]["extract_basic"]["items"] == 8
    whole = _configs("torch")[0](**_common(corpus, tmp_path / "whole",
                                           stft_method="fft"))
    pipelines.preprocess_basic(whole, device="cpu", logger=_quiet("torch"))
    for name in ("features_raw.npy", "features_normalized.npy", "labels.npy",
                 "metadata.csv"):
        assert filecmp.cmp(tmp_path / "out" / name, tmp_path / "whole" / name,
                           shallow=False), name
    # a changed catalog is refused, not silently mixed
    pipelines.ExtractionManifest(tmp_path / "stale").add_shard(
        ["ghost"], {"features": np.zeros((1, 370), np.float32)})
    stale = _configs("torch")[0](**_common(corpus, tmp_path / "stale",
                                           stft_method="fft"))
    with pytest.raises(ValueError, match="not in the current catalog"):
        pipelines.preprocess_basic(stale, device="cpu", logger=_quiet("torch"))


@pytest.mark.parametrize("begun_by", ["jax", "torch"])
def test_one_package_resumes_the_others_interrupted_run(corpus, tmp_path,
                                                        jax_basic, begun_by):
    """The state an interrupted run leaves — shards of its first batches and
    the manifest — written by one package's ``_extract_batched``; the other
    package's ``preprocess_basic`` resumes it."""
    from tpuvae import pipelines as jpipe
    from tpuvae.io.resume import ExtractionManifest as JaxManifest
    from tpuvae.parallel import MeshContext

    from tpuvae_torch import pipelines as tpipe
    from tpuvae_torch.io.resume import ExtractionManifest

    out = tmp_path / "processed_data1"
    P = _configs(begun_by)[0]
    cfg = P(**_common(corpus, out, stft_method="fft"))
    if begun_by == "jax":
        entries, _ = jpipe.collect_audio_files(cfg.dataset_root,
                                               cfg.metadata_csv)
        extract, row_shape, offset = jpipe._extraction_setup(
            jpipe.extract_basic_features, cfg)
        jpipe._extract_batched(entries[:8], extract, cfg, MeshContext.create(),
                               manifest=JaxManifest(out),
                               shard_keys=("features",), row_shape=row_shape,
                               sample_offset=offset)
    else:
        entries, _ = tpipe.collect_audio_files(cfg.dataset_root,
                                               cfg.metadata_csv)
        dev = torch.device("cpu")
        extract = tpipe.make_extractor(tpipe.extract_basic_features, cfg, dev)
        tpipe._extract_batched(entries[:8], extract, cfg, dev,
                               manifest=ExtractionManifest(out),
                               shard_keys=("features",))
    assert ExtractionManifest(out).total_rows() == 8

    other = "torch" if begun_by == "jax" else "jax"
    ocfg = _configs(other)[0](**_common(corpus, out, stft_method="fft"))
    if other == "torch":
        res = tpipe.preprocess_basic(ocfg, device="cpu", logger=_quiet("torch"))
    else:
        res = jpipe.preprocess_basic(ocfg, logger=_quiet("jax"))
    assert res["n"] == 16 and res["stages"]["extract_basic"]["items"] == 8
    assert not (out / "shards").exists()
    jout, _ = jax_basic("fft")
    _assert_flat_close(np.load(out / "features_raw.npy"),
                       np.load(jout / "features_raw.npy"), (340, 341))
    assert (out / "metadata.csv").read_bytes() == (
        jout / "metadata.csv").read_bytes()


# -- entry points ----------------------------------------------------------------

def test_cli_synth_data_preprocess_and_preprocess_advanced(tmp_path, capsys):
    from tpuvae_torch import cli
    from tpuvae_torch.io.artifacts import load_advanced, load_basic

    root = tmp_path / "Datasets"
    assert cli.main(["synth-data", f"--root={root}", "--clips_per_genre_lang=2",
                     "--seed_data=3"]) == 0
    assert "metadata" in capsys.readouterr().out
    # the CLI writes 30 s clips; the preprocess commands cut them to 1 s
    common = [f"--dataset_root={root}",
              f"--metadata_csv={root / 'updated_metadata.csv'}",
              "--duration=1.0", "--extract_batch=8", "--device=cpu"]
    d1, d2 = tmp_path / "processed_data1", tmp_path / "processed_data2"
    assert cli.main(["preprocess", f"--output_dir={d1}", *common]) == 0
    assert cli.main(["preprocess-advanced", f"--output_dir={d2}",
                     "--fixed_time_steps=32", "--stft_method=pallas",
                     *common]) == 0
    assert load_basic(d1)["features"].shape == (12, 370)
    adv = load_advanced(d2, mmap=True)
    assert adv["mel"].shape == (6, 128, 32) and adv["text"].shape == (6, 768)
    capsys.readouterr()
    assert cli.main(["preprocess", "--bogus=1"]) == 2
    assert cli.main(["synth-data", "extra"]) == 2
    assert cli.main(["synth-data", f"--root={tmp_path / 'F'}",
                     "--container=ogg"]) == 2
    assert cli.main(["synth-data", f"--root={tmp_path / 'M'}",
                     "--container=mixed", "--clips_per_genre_lang=1"]) == 0
    assert len(list((tmp_path / "M").rglob("*.flac"))) == 3
    assert cli.main(["preprocess-advanced", "--stft_method=ct", *common,
                     f"--output_dir={tmp_path / 'x'}"]) == 2
    err = capsys.readouterr().err
    assert "bogus" in err and "ROADMAP" in err
    assert cli.main(["nonsense"]) == 2
    assert "preprocess-advanced" in capsys.readouterr().err


def test_preprocess_entry_points_raise_without_cuda(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from tpuvae_torch import cli
    from tpuvae_torch.pipelines import preprocess_advanced, preprocess_basic

    P, A = _configs("torch")
    with pytest.raises(RuntimeError, match="cuda"):
        preprocess_basic(P(**_common(corpus, tmp_path / "d1")))
    with pytest.raises(RuntimeError, match="cuda"):
        preprocess_advanced(A(**_common(corpus, tmp_path / "d2")))
    root, meta = corpus
    for cmd in ("preprocess", "preprocess-advanced"):
        assert cli.main([cmd, f"--dataset_root={root}",
                         f"--metadata_csv={meta}",
                         f"--output_dir={tmp_path / 'd3'}"]) == 2
    assert not any((tmp_path / d).exists() for d in ("d1", "d2", "d3"))
