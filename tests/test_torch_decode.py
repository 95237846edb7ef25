"""The port's decoders and native loader against the JAX package's, on the
CPU, and the input front end as a whole.

* ``read_flac`` returns the JAX package's arrays bit for bit, and the port's
  (vectorised) ``write_flac`` the JAX package's bytes, on streams of every
  subframe type and stereo mode;
* the port's own build of the C++ loader decodes within atol 1e-5 of the
  JAX package's numpy path (``load_audio(prefer_native=False)``, as
  ``tests/test_native.py``); its rows and rows-i16 entry points agree with
  each other exactly (the int16 wire is the float row rounded to nearest);
* MP3 through libmpg123, skipped where it is missing (``tests/test_mp3.py``);
* the slice: a mixed WAV / FLAC corpus through ``preprocess_advanced`` with
  a tiny XLM-R checkpoint in both packages (lyrics embeddings within rtol
  1e-4 / atol 1e-5, the backend recorded alike, every clip decoded
  natively), then a hybrid bundle serving a FLAC upload with lyrics: the
  same latent as the WAV upload of the same samples, no backend warning.
"""

import base64
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SR = 22050
STEREO_MODES = ["independent", "left_side", "right_side", "mid_side"]
SUBFRAMES = [None, "verbatim", "lpc", "fixed"]


def _stereo(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    base = (np.sin(2 * np.pi * 220 * t) * 12000
            + rng.normal(0, 300, n)).astype(np.int64)
    left = np.clip(base, -32768, 32767)
    right = np.clip(base // 2 + rng.integers(-200, 200, n), -32768, 32767)
    return np.stack([left, right], 1)


# -- FLAC ------------------------------------------------------------------------

@pytest.mark.parametrize("stereo", STEREO_MODES)
@pytest.mark.parametrize("subframe", SUBFRAMES, ids=str)
def test_flac_codec_is_the_jax_packages(tmp_path, stereo, subframe):
    from tpuvae.io.flac import read_flac as jax_read
    from tpuvae.io.flac import write_flac as jax_write

    from tpuvae_torch.io.flac import read_flac, write_flac

    x = _stereo(seed=len(stereo))
    x[:2048] = x[0]                          # a constant block in each mode
    kw = dict(block_size=2048, stereo=stereo, subframe=subframe)
    write_flac(tmp_path / "t.flac", x, SR, 16, **kw)
    jax_write(tmp_path / "j.flac", x, SR, 16, **kw)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    y, sr = read_flac(tmp_path / "t.flac")
    jy, jsr = jax_read(tmp_path / "t.flac")
    assert sr == jsr == SR and y.dtype == jy.dtype
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(np.round(y * 32768).astype(np.int64), x)


@pytest.mark.parametrize("depth,sr,channels", [(16, 8000, 1), (24, 44100, 2),
                                               (8, 16000, 1)])
def test_flac_depths_and_rates_are_the_jax_packages(tmp_path, depth, sr,
                                                    channels):
    from tpuvae.io.flac import read_flac as jax_read
    from tpuvae.io.flac import write_flac as jax_write

    from tpuvae_torch.io.flac import read_flac, write_flac

    rng = np.random.default_rng(depth)
    lim = 1 << (depth - 1)
    x = rng.integers(-lim, lim, (5001, channels))
    write_flac(tmp_path / "t.flac", x, sr, depth, block_size=1024)
    jax_write(tmp_path / "j.flac", x, sr, depth, block_size=1024)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    y, got_sr = read_flac(tmp_path / "t.flac")
    np.testing.assert_array_equal(y, jax_read(tmp_path / "t.flac")[0])
    assert got_sr == sr and y.shape == (5001, channels)
    with pytest.raises(ValueError, match="bits_per_sample"):
        write_flac(tmp_path / "x.flac", x * 4, sr, depth)


def test_corrupt_flac_raises_like_jax(tmp_path):
    from tpuvae.io.flac import read_flac as jax_read
    from tpuvae.io.flac import write_flac as jax_write

    from tpuvae_torch.io.flac import read_flac

    jax_write(tmp_path / "ok.flac", _stereo(3000), SR, 16)
    raw = bytearray((tmp_path / "ok.flac").read_bytes())
    raw[-40] ^= 0xFF                          # break a frame's CRC
    bad = tmp_path / "bad.flac"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError) as got:
        read_flac(bad)
    with pytest.raises(ValueError) as want:
        jax_read(bad)
    assert str(got.value) == str(want.value)


# -- the native loader ------------------------------------------------------------

def _wav(path, y, sr, width=2, channels=1):
    import wave

    scale = 2 ** (8 * width - 1) - 1
    ints = np.round(np.clip(y, -1, 1) * scale).astype(np.int64).reshape(-1)
    raw = (ints.astype("<i2").tobytes() if width == 2 else
           b"".join(int(v).to_bytes(3, "little", signed=True) for v in ints))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """One clip in each container the native loader reads."""
    from tpuvae_torch.io.flac import write_flac

    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    t = np.arange(int(1.7 * 44100)) / 44100
    y = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(len(t))
    st = _stereo(30000, seed=2)
    write_flac(d / "stereo.flac", st, SR, 16, stereo="mid_side")
    write_flac(d / "mono16k.flac", st[:, 0], 16000, 16)
    return {
        "wav44k": _wav(d / "a.wav", y, 44100),
        "wav22k": _wav(d / "b.wav", y[::2], SR),
        "wav24bit_stereo": _wav(d / "c.wav", np.repeat(y[:, None] * 0.8, 2, 1),
                                48000, width=3, channels=2),
        "flac_stereo": d / "stereo.flac",
        "flac_16k": d / "mono16k.flac",
    }


@pytest.mark.parametrize("name", ["wav44k", "wav22k", "wav24bit_stereo",
                                  "flac_stereo", "flac_16k"])
@pytest.mark.parametrize("duration", [1.0, 3.0], ids=["cut", "padded"])
def test_native_loader_matches_the_jax_numpy_path(clips, name, duration):
    from tpuvae.io.wav import load_audio as jax_load

    from tpuvae_torch.io import native_loader
    from tpuvae_torch.io.wav import load_audio

    want = jax_load(clips[name], SR, duration, prefer_native=False)
    native_loader.reset_decode_counts()
    got = native_loader.load_audio_native(clips[name], SR, duration)
    via = load_audio(clips[name], SR, duration)
    assert native_loader.decode_counts() == {"native": 2, "python": 0}
    assert got.shape == want.shape == (int(SR * duration),)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(via, got)
    py = load_audio(clips[name], SR, duration, prefer_native=False)
    np.testing.assert_array_equal(py, want)
    assert native_loader.decode_counts() == {"native": 2, "python": 1}
    if name in ("wav22k", "flac_stereo"):    # no resampling: same numbers
        np.testing.assert_allclose(got, want, atol=2e-7)


@pytest.mark.parametrize("name", ["wav44k", "flac_stereo"])
def test_rows_and_rows_i16_agree_exactly(clips, name):
    from tpuvae_torch.io import native_loader
    from tpuvae_torch.io.wav import load_audio

    n, offset, total = SR, 1024, SR + 3000
    f32 = np.full(total, np.nan, np.float32)
    i16 = np.full(total, 7, np.int16)
    native_loader.load_audio_into_native(clips[name], f32, SR, 1.0, offset)
    native_loader.load_audio_into_native(clips[name], i16, SR, 1.0, offset)
    assert np.isfinite(f32).all()
    assert (f32[:offset] == 0).all() and (f32[offset + n:] == 0).all()
    np.testing.assert_array_equal(f32[offset:offset + n],
                                  load_audio(clips[name], SR, 1.0))
    want = np.clip(np.rint(f32 * np.float32(32768)), -32768, 32767)
    np.testing.assert_array_equal(i16, want.astype(np.int16))
    # load_audio(out=...) is the rows path at offset 0, on either wire,
    # and the Python path fills the same wire the same way
    for dtype in (np.float32, np.int16):
        dest = np.full(n, 3, dtype)
        py = np.full(n, 3, dtype)
        assert load_audio(clips[name], SR, 1.0, out=dest) is dest
        load_audio(clips[name], SR, 1.0, out=py, prefer_native=False)
        ref = f32 if dtype == np.float32 else i16
        np.testing.assert_array_equal(dest, ref[offset:offset + n])
        if name == "flac_stereo":            # no resampling: bit-equal
            np.testing.assert_array_equal(py, dest)
    with pytest.raises(ValueError, match="dtype"):
        native_loader.load_audio_into_native(clips[name],
                                             np.empty(n, np.float64))


def test_native_loader_errors_and_the_batch_api(clips, tmp_path):
    from tpuvae_torch.io import native_loader
    from tpuvae_torch.io.wav import load_audio

    missing = tmp_path / "missing.wav"
    with pytest.raises(IOError):
        native_loader.load_audio_native(missing, SR, 1.0)
    with pytest.raises(IOError):
        native_loader.load_audio_into_native(missing, np.empty(SR, np.float32))
    with pytest.raises(FileNotFoundError):     # falls through, then Python
        load_audio(missing, SR, 1.0)
    out, status = native_loader.load_audio_batch_native(
        [clips["wav22k"], missing, clips["flac_stereo"]], SR, 1.0)
    assert status.tolist() == [0, 1, 0] and (out[1] == 0).all()
    np.testing.assert_array_equal(out[2], load_audio(clips["flac_stereo"],
                                                     SR, 1.0))


def test_decode_counts_lose_no_update_under_threads(clips):
    """Loader threads add to the decode counts at once (as the pipelines'
    pool does): with more threads than cores and a short switch interval,
    every decode is counted."""
    import threading

    from tpuvae_torch.io import native_loader
    from tpuvae_torch.io.wav import load_audio

    native_loader.reset_decode_counts()
    n_threads, per_thread = 24, 6
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            dest = np.empty(SR // 4, np.int16)
            for _ in range(per_thread):
                load_audio(clips["wav22k"], SR, 0.25, out=dest,
                           prefer_native=i % 3 != 0)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert native_loader.decode_counts() == {
        "native": 16 * per_thread, "python": 8 * per_thread}


def test_native_loader_build_is_hashed_and_atomic(tmp_path):
    """The library's name carries the sources' and flags' hash; two
    processes building into one empty directory at once both load it, and
    no temporary file is left."""
    from tpuvae_torch.io import native_loader

    path = native_loader.library_path()
    assert path.parent == native_loader.BUILD_DIR
    assert path.name.startswith("libwavload-") and len(path.stem) == 27
    assert "-march" not in " ".join(native_loader.CXX_FLAGS)
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from pathlib import Path\n"
        "from tpuvae_torch.io import native_loader as nl\n"
        "nl.BUILD_DIR = Path(sys.argv[2])\n"
        "assert nl.native_available()\n"
        "print(nl.library_path().name)\n")
    repo = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", script, repo,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert {o.strip() for o, _ in outs} == {path.name}
    assert sorted(f.name for f in tmp_path.iterdir()) == [path.name]


def test_disabling_the_native_loader_is_explicit(clips, monkeypatch):
    from tpuvae_torch.io import native_loader
    from tpuvae_torch.io.wav import load_audio

    monkeypatch.setenv("TPUVAE_DISABLE_NATIVE", "1")
    assert not native_loader.native_available()
    native_loader.reset_decode_counts()
    load_audio(clips["flac_stereo"], SR, 1.0)
    assert native_loader.decode_counts() == {"native": 0, "python": 1}


# -- MP3 ------------------------------------------------------------------------

def _mp3_asset():
    try:
        import pygame
    except Exception:
        return None
    p = Path(pygame.__file__).parent / "examples" / "data" / "house_lo.mp3"
    return p if p.exists() else None


def _mp3_available():
    from tpuvae.io import mp3 as jax_mp3

    return jax_mp3.mp3_available() and _mp3_asset() is not None


needs_mp3 = pytest.mark.skipif(
    not _mp3_available(),
    reason="libmpg123 or the pygame golden asset is unavailable")


def test_mp3_sniffing_is_the_jax_packages():
    from tpuvae.io import mp3 as jax_mp3

    from tpuvae_torch.io import mp3

    for magic in (b"ID3\x04", bytes([0xFF, 0xFB, 0x90, 0]), b"RIFF", b"fLaC",
                  bytes([0xFF, 0xE2, 0, 0]), bytes([0xFF, 0xF9, 0, 0])):
        assert mp3.looks_like_mp3(magic) == jax_mp3.looks_like_mp3(magic)


@needs_mp3
def test_mp3_decodes_as_the_jax_package_does(tmp_path, monkeypatch):
    from tpuvae.io import mp3 as jax_mp3
    from tpuvae.io.wav import load_audio as jax_load

    from tpuvae_torch.io import mp3, native_loader
    from tpuvae_torch.io.wav import load_audio

    asset = _mp3_asset()
    y, sr = mp3.read_mp3(asset)
    jy, jsr = jax_mp3.read_mp3(asset)
    assert sr == jsr == 11025
    np.testing.assert_array_equal(y, jy)
    # the C++ loader does not read MP3: its IOError falls through to mpg123
    native_loader.reset_decode_counts()
    got = load_audio(asset, SR, 2.0)
    assert native_loader.decode_counts() == {"native": 0, "python": 1}
    np.testing.assert_array_equal(got, jax_load(asset, SR, 2.0,
                                                prefer_native=False))
    # $TPUVAE_MPG123 is the first candidate
    monkeypatch.setenv("TPUVAE_MPG123", str(tmp_path / "libmpg123.so"))
    assert mp3._candidate_paths()[0] == str(tmp_path / "libmpg123.so")


# -- the slice: mixed corpus -> preprocess_advanced -> a FLAC /encode ----------------

@pytest.fixture(scope="module")
def front_end(tmp_path_factory):
    """A mixed WAV / FLAC corpus (2 s clips) through both packages'
    ``preprocess_advanced`` with a tiny XLM-R checkpoint."""
    from test_torch_text import write_checkpoint

    from tpuvae.config import AdvancedPreprocessConfig as JaxAdv
    from tpuvae.pipelines import preprocess_advanced as jax_preprocess
    from tpuvae.utils import RunLogger as JaxLogger

    from tpuvae_torch.config import AdvancedPreprocessConfig
    from tpuvae_torch.io import native_loader
    from tpuvae_torch.io.synthetic import generate_dataset
    from tpuvae_torch.pipelines import preprocess_advanced
    from tpuvae_torch.utils.logging import RunLogger

    root = tmp_path_factory.mktemp("front_end")
    meta = generate_dataset(root / "Datasets", clips_per_genre_lang=3,
                            duration=2.0, seed=5, container="mixed")
    ckpt = write_checkpoint(root / "tiny-xlmr")
    kw = dict(duration=2.0, fixed_time_steps=64, precision_mode="exact",
              stft_method="fft", extract_batch=4,
              dataset_root=str(root / "Datasets"), metadata_csv=str(meta))
    jax_preprocess(JaxAdv(output_dir=str(root / "j"), **kw),
                   logger=JaxLogger(echo=False), text_checkpoint=str(ckpt))
    native_loader.reset_decode_counts()
    res = preprocess_advanced(
        AdvancedPreprocessConfig(output_dir=str(root / "t"), **kw),
        device="cpu", logger=RunLogger(echo=False), text_checkpoint=str(ckpt))
    return {"root": root, "ckpt": ckpt, "res": res,
            "decodes": native_loader.decode_counts()}


def test_preprocess_advanced_on_a_mixed_corpus_with_a_checkpoint(front_end):
    from tpuvae_torch.io.normalize import load_normalizer

    root, res = front_end["root"], front_end["res"]
    files = sorted((root / "Datasets").rglob("*.*"))
    assert {f.suffix for f in files} == {".wav", ".flac", ".csv"}
    # the strict catalog drops the lyricless clip of each genre and language
    assert res["n"] == 12 and res["failed"] == []
    detail = res["extract_detail"]
    assert detail["decodes_native"] == 12 and detail["decodes_python"] == 0
    assert front_end["decodes"] == {"native": 12, "python": 0}
    got = np.load(root / "t" / "lyrics_embeddings.npy")
    want = np.load(root / "j" / "lyrics_embeddings.npy")
    assert got.shape == (12, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    backend = load_normalizer(root / "t" / "config.pkl")[
        "lyrics_embedder_backend"]
    assert backend == "xlmr-checkpoint:tiny-xlmr" == load_normalizer(
        root / "j" / "config.pkl")["lyrics_embedder_backend"]
    np.testing.assert_allclose(np.load(root / "t" / "mel_spectrograms_raw.npy"),
                               np.load(root / "j" / "mel_spectrograms_raw.npy"),
                               rtol=1e-5, atol=2e-3)
    assert (root / "t" / "metadata.csv").read_bytes() == (
        root / "j" / "metadata.csv").read_bytes()


def test_flac_upload_encodes_as_its_wav_twin(front_end, tmp_path, monkeypatch):
    from tpuvae_torch.infer import ClipEncoder, save_serving_model
    from tpuvae_torch.io.flac import write_flac
    from tpuvae_torch.io.synthetic import write_wav
    from tpuvae_torch.models import HybridVAE
    from tpuvae_torch.serve import ServingApp

    model = HybridVAE(latent_dim=16, text_dim=64, input_hw=(128, 64),
                      generator=torch.Generator().manual_seed(0))
    save_serving_model(tmp_path, model, np.zeros((2, 16), np.float32),
                       meta={"arch": "hybrid", "latent_dim": 16,
                             "text_dim": 64, "input_hw": [128, 64],
                             "compute_dtype": "float32",
                             "data_dir": str(front_end["root"] / "t")})
    monkeypatch.setenv("TPUVAE_TEXT_CHECKPOINT", str(front_end["ckpt"]))
    enc = ClipEncoder.load("hybrid", results_dir=str(tmp_path), device="cpu")
    assert enc.embed_backend == "xlmr-checkpoint:tiny-xlmr"
    rng = np.random.default_rng(8)
    y = (0.3 * np.sin(2 * np.pi * 330 * np.arange(2 * SR) / SR)
         + 0.02 * rng.standard_normal(2 * SR)).astype(np.float32)
    write_wav(tmp_path / "clip.wav", y, SR)
    pcm = np.clip(np.round(y * 32767.0), -32768, 32767).astype(np.int64)
    write_flac(tmp_path / "clip.flac", pcm, SR, 16)
    app = ServingApp(enc)
    try:
        info = app.info()
        assert info["lyrics_embedder_backend"] == "xlmr-checkpoint:tiny-xlmr"
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            replies = [app.encode({"audio_b64": [base64.b64encode(
                (tmp_path / f"clip.{ext}").read_bytes()).decode()],
                "lyrics": ["the road goes ever on"]}) for ext in ("flac", "wav")]
    finally:
        app.close()
    assert [r["warnings"] for r in replies] == [[], []]
    assert replies[0]["latents"] == replies[1]["latents"]
    direct = enc.encode_paths([tmp_path / "clip.flac"],
                              lyrics=["the road goes ever on"])
    np.testing.assert_allclose(replies[0]["latents"], direct.latents, atol=1e-6)
    # without the checkpoint the lyrics go through the hashed embedder,
    # which the bundle was not trained on: a warning, as in the JAX package
    monkeypatch.delenv("TPUVAE_TEXT_CHECKPOINT")
    with pytest.warns(UserWarning, match="TPUVAE_TEXT_CHECKPOINT"):
        assert enc._embed_texts(["la"], 1).shape == (1, 768)
