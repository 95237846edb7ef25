"""The port's lyrics encoder against the JAX package's, on the CPU.

Tokenizer ids and masks are EQUAL to ``tpuvae.text.tokenizer``'s on the
same sentencepiece models.  The encoder runs at a small size (2 layers,
hidden 64, 4 heads, intermediate 128, vocab 100, 40 positions) on shared
seeded weights; the flax model under ``jax.default_matmul_precision(
"highest")`` and the port's ``SentenceEncoder`` agree to rtol 1e-4 /
atol 1e-5 (as ``tests/test_text_converter.py``), padded rows included:
fp32 in both, sums in other orders.  The weight converters carry every
array across exactly, both ways.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
S = "▁"
SMALL = dict(vocab_size=100, hidden=64, layers=2, heads=4, intermediate=128,
             max_positions=40)
LYRICS = ["the road goes ever on and on", "আমার সোনার বাংলা আমি তোমায় ভালোবাসি",
          "", None, "Ｆｕｌｌ　ｗｉｄｔｈ  ｔｅｘｔ", "la " * 60, "∯ unknown ☃ chars",
          "amar sonar bangla"]


# -- fixtures ----------------------------------------------------------------

def _hand_model(path):
    """The hand-built unigram model of tests/test_tokenizer.py."""
    from tpuvae_torch.text.tokenizer import write_sentencepiece_model

    pieces = [
        ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
        (S, -3.0), (f"{S}hello", -1.0), (f"{S}he", -2.0), ("llo", -2.0),
        (f"{S}world", -1.0), ("l", -4.0), ("o", -4.0), ("he", -4.5),
        ("w", -6.0), ("é", -2.5),
    ]
    return write_sentencepiece_model(path, pieces)


def _corpus_model(path, n_pieces=90):
    """A unigram model counted from the test lyrics (Bangla included)."""
    from tpuvae_torch.text.tokenizer import unigram_pieces, write_sentencepiece_model

    texts = [t for t in LYRICS if t] + ["hello world", "verse one two three"]
    return write_sentencepiece_model(path, unigram_pieces(texts, n_pieces, 6))


def hf_state_dict(cfg: dict, seed: int, prefix: str = "") -> dict:
    """Seeded XLM-R weights in HuggingFace naming (torch tensors)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=0.1, loc=0.0):
        return loc + scale * torch.randn(*shape, generator=g)

    h, inter = cfg["hidden"], cfg["intermediate"]
    sd = {
        "embeddings.word_embeddings.weight": rnd(cfg["vocab_size"], h),
        "embeddings.position_embeddings.weight": rnd(cfg["max_positions"], h),
        "embeddings.token_type_embeddings.weight": rnd(1, h),
        "embeddings.LayerNorm.weight": rnd(h, loc=1.0),
        "embeddings.LayerNorm.bias": rnd(h),
    }
    for i in range(cfg["layers"]):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[p + f"attention.self.{name}.weight"] = rnd(h, h)
            sd[p + f"attention.self.{name}.bias"] = rnd(h)
        sd[p + "attention.output.dense.weight"] = rnd(h, h)
        sd[p + "attention.output.dense.bias"] = rnd(h)
        sd[p + "attention.output.LayerNorm.weight"] = rnd(h, loc=1.0)
        sd[p + "attention.output.LayerNorm.bias"] = rnd(h)
        sd[p + "intermediate.dense.weight"] = rnd(inter, h)
        sd[p + "intermediate.dense.bias"] = rnd(inter)
        sd[p + "output.dense.weight"] = rnd(h, inter)
        sd[p + "output.dense.bias"] = rnd(h)
        sd[p + "output.LayerNorm.weight"] = rnd(h, loc=1.0)
        sd[p + "output.LayerNorm.bias"] = rnd(h)
    return {prefix + k: v for k, v in sd.items()}


def write_checkpoint(path, seed: int = 3, with_config: bool = True,
                     cfg: dict = SMALL):
    """A checkpoint directory as the embedders read it: ``pytorch_model.bin``
    (seeded, small), ``config.json`` and a unigram sentencepiece model."""
    path.mkdir(parents=True, exist_ok=True)
    torch.save(hf_state_dict(cfg, seed), path / "pytorch_model.bin")
    if with_config:
        (path / "config.json").write_text(
            json.dumps({"num_attention_heads": cfg["heads"]}))
    _corpus_model(path / "sentencepiece.bpe.model")
    return path


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("xlmr") / "tiny-xlmr")


def _batch(seed=0, rows=4, t=12, vocab=100):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (rows, t)).astype(np.int32)
    mask = np.ones((rows, t), np.int32)
    mask[1, 8:] = 0
    mask[2, 3:] = 0
    mask[-1, 1:] = 0                      # only <s>
    return np.where(mask, ids, 1).astype(np.int32), mask


# -- tokenizer ---------------------------------------------------------------

@pytest.mark.parametrize("model", ["hand", "corpus"])
@pytest.mark.parametrize("max_length,pad_to", [(128, None), (8, None),
                                               (16, 24)],
                         ids=["plain", "truncated", "pad_to"])
def test_tokenizer_ids_equal_jax(tmp_path, model, max_length, pad_to):
    from tpuvae.text.tokenizer import XlmRobertaTokenizer as JaxTok
    from tpuvae.text.tokenizer import load_sentencepiece_model as jax_load

    from tpuvae_torch.text.tokenizer import (
        XlmRobertaTokenizer,
        load_sentencepiece_model,
        normalize,
    )
    from tpuvae.text.tokenizer import normalize as jax_normalize

    path = (_hand_model if model == "hand" else _corpus_model)(
        tmp_path / "sentencepiece.bpe.model")
    assert [(p.piece, p.score, p.type) for p in load_sentencepiece_model(path)] \
        == [(p.piece, p.score, p.type) for p in jax_load(path)]
    texts = [str(t) for t in LYRICS] + ["hello world", "Ｈｅｌｌｏ\tworld\n"]
    for t in texts:
        assert normalize(t) == jax_normalize(t)
    got = XlmRobertaTokenizer(path)(texts, max_length=max_length, pad_to=pad_to)
    want = JaxTok(path)(texts, max_length=max_length, pad_to=pad_to)
    for k in ("input_ids", "attention_mask"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["attention_mask"].sum(1) >= 2).all()      # <s> ... </s>
    if model == "hand":       # unknown characters map to <unk>
        assert XlmRobertaTokenizer.UNK in got["input_ids"][6].tolist()


def test_sentencepiece_writer_reads_back_in_both_packages(tmp_path):
    from tpuvae.text.tokenizer import find_sentencepiece_model as jax_find
    from tpuvae.text.tokenizer import load_sentencepiece_model as jax_load

    from tpuvae_torch.text.tokenizer import (
        TYPE_CONTROL,
        TYPE_UNKNOWN,
        find_sentencepiece_model,
        unigram_pieces,
        write_sentencepiece_model,
    )

    pieces = unigram_pieces(["la la la", "ভালোবাসি"] * 3, n_pieces=20)
    assert len(pieces) == 20 and pieces[0].type == TYPE_UNKNOWN
    assert pieces[1].type == pieces[2].type == TYPE_CONTROL
    assert unigram_pieces(["la la la", "ভালোবাসি"] * 3, n_pieces=20) == pieces
    # a piece longer than 127 bytes needs a two-byte length varint
    pieces.append(type(pieces[0])("ক" * 50, -20.0))
    p = write_sentencepiece_model(tmp_path / "m.model", pieces)
    back = jax_load(p)
    assert [(q.piece, q.type) for q in back] == [(q.piece, q.type)
                                                 for q in pieces]
    np.testing.assert_array_equal([q.score for q in back],
                                  np.float32([q.score for q in pieces]))
    assert find_sentencepiece_model(tmp_path) == jax_find(tmp_path) == p


# -- encoder -----------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_and_port():
    """Shared seeded weights: flax's init, perturbed so every LayerNorm
    scale and bias is off its default; the port loads them converted."""
    from tpuvae.text import EncoderConfig as JaxConfig
    from tpuvae.text import SentenceEncoder as JaxEncoder

    from tpuvae_torch.convert import encoder_from_flax
    from tpuvae_torch.text.encoder import EncoderConfig, SentenceEncoder

    cfg = EncoderConfig(**SMALL)
    ids, mask = _batch()
    jmodel = JaxEncoder(JaxConfig(**SMALL))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                            jnp.asarray(mask))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), variables)
    model = SentenceEncoder(cfg).eval()
    model.load_state_dict(encoder_from_flax(variables))
    return jmodel, variables, model


def _flax_apply(jmodel, variables, ids, mask):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jmodel.apply(variables, jnp.asarray(ids),
                                       jnp.asarray(mask)))


@pytest.mark.parametrize("rows,t", [(4, 12), (3, 38)])
def test_sentence_encoder_matches_flax(flax_and_port, rows, t):
    jmodel, variables, model = flax_and_port
    ids, mask = _batch(seed=rows * t, rows=rows, t=t)
    want = _flax_apply(jmodel, variables, ids, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (rows, SMALL["hidden"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_padded_tokens_do_not_reach_the_pooled_embedding(flax_and_port):
    """Every query attends to the valid keys only and pooling is masked:
    the ids under the mask change nothing, and a row's embedding does not
    depend on how far the batch is padded."""
    _, _, model = flax_and_port
    ids, mask = _batch(seed=9)
    other = np.where(mask, ids, 77).astype(np.int32)
    wide_ids = np.pad(ids, ((0, 0), (0, 20)), constant_values=1)
    wide_mask = np.pad(mask, ((0, 0), (0, 20)))
    with torch.no_grad():
        a = model(torch.from_numpy(ids), torch.from_numpy(mask))
        b = model(torch.from_numpy(other), torch.from_numpy(mask))
        c = model(torch.from_numpy(wide_ids), torch.from_numpy(wide_mask))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("offset", [0.5, 40.0])
def test_layer_norm_uses_flax_statistics(offset):
    """flax's E[x^2] - E[x]^2 loses digits to cancellation where the mean
    is large against the spread, in whatever order it sums; at the large
    offset the samples are multiples of 1/8 below 2^7, so every sum is
    exact in both packages and the two must agree to rounding."""
    from flax import linen as nn

    from tpuvae_torch.text.encoder import LayerNorm

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)) * 2 + offset
    if offset > 1:
        x = np.round(x * 8) / 8
    x = x.astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(nn.LayerNorm(epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias}}, x))
    ln = LayerNorm(64, 1e-5)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- converters ----------------------------------------------------------------

def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_flax_port_converters_round_trip_exactly(flax_and_port):
    from tpuvae_torch.convert import encoder_from_flax, encoder_to_flax

    _, variables, model = flax_and_port
    back = _leaves(encoder_to_flax(model.state_dict(), SMALL["heads"]))
    want = _leaves(variables)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    again = encoder_from_flax(encoder_to_flax(model.state_dict(),
                                              SMALL["heads"]))
    sd = model.state_dict()
    assert again.keys() == sd.keys()
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


@pytest.mark.parametrize("prefix", ["", "roberta.", "0.auto_model."])
def test_hf_state_dict_converts_like_jax(prefix):
    from tpuvae.text import EncoderConfig as JaxConfig
    from tpuvae.text import SentenceEncoder as JaxEncoder
    from tpuvae.text import convert_hf_state_dict as jax_convert

    from tpuvae_torch.convert import encoder_to_flax
    from tpuvae_torch.text.encoder import (
        EncoderConfig,
        SentenceEncoder,
        convert_hf_state_dict,
    )

    sd = hf_state_dict(SMALL, seed=5, prefix=prefix)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    port_sd = convert_hf_state_dict(sd, EncoderConfig(**SMALL))
    model = SentenceEncoder(EncoderConfig(**SMALL)).eval()
    model.load_state_dict(port_sd)
    want = jax_convert(sd_np, JaxConfig(**SMALL))
    got = _leaves(encoder_to_flax(port_sd, SMALL["heads"]))
    assert got.keys() == _leaves(want).keys()
    for k, v in _leaves(want).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # numpy arrays convert the same as tensors
    np_sd = convert_hf_state_dict(sd_np, EncoderConfig(**SMALL))
    assert all(torch.equal(np_sd[k], port_sd[k]) for k in port_sd)
    ids, mask = _batch(seed=2)
    with torch.no_grad():
        got_emb = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        got_emb, _flax_apply(JaxEncoder(JaxConfig(**SMALL)), want, ids, mask),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hf_config", [None, {"num_attention_heads": 4},
                                       {"num_attention_heads": 8}],
                         ids=["shapes", "config-4", "config-8"])
def test_infer_encoder_config_equals_jax(hf_config):
    from tpuvae.text import infer_encoder_config as jax_infer

    from tpuvae_torch.text.encoder import infer_encoder_config

    sd = hf_state_dict({**SMALL, "layers": 3}, seed=0, prefix="roberta.")
    got = infer_encoder_config(sd, hf_config)
    want = jax_infer({k: v.numpy() for k, v in sd.items()}, hf_config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layers == 3 and got.heads == (hf_config or {}).get(
        "num_attention_heads", 1)
    with pytest.raises(ValueError, match="config.json"):
        infer_encoder_config(sd, {"num_attention_heads": 5})


# -- embed_lyrics --------------------------------------------------------------

def test_embed_lyrics_from_a_checkpoint_matches_jax(checkpoint):
    from tpuvae.text import embed_lyrics as jax_embed

    from tpuvae_torch.text import create_lyrics_embeddings, embed_lyrics

    got, backend = embed_lyrics(LYRICS, checkpoint=str(checkpoint),
                                device="cpu")
    with jax.default_matmul_precision("highest"):
        want, jbackend = jax_embed(LYRICS, checkpoint=str(checkpoint))
    assert backend == jbackend == "xlmr-checkpoint:tiny-xlmr"
    assert got.dtype == np.float32 and got.shape == (len(LYRICS), 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the batch split changes nothing
    split = create_lyrics_embeddings(LYRICS, checkpoint=str(checkpoint),
                                     batch_size=3, device="cpu")
    np.testing.assert_allclose(split, got, rtol=1e-6, atol=1e-6)
    # empty lyrics are coerced to " ", as the hashed path does
    np.testing.assert_array_equal(got[2], got[3])


def test_checkpoint_precedence_cache_and_config_free_dir(checkpoint, tmp_path,
                                                         monkeypatch):
    from tpuvae.text import embed_lyrics as jax_embed

    from tpuvae_torch.text import embed_lyrics
    from tpuvae_torch.text.embedder import load_checkpoint_encoder

    other = write_checkpoint(tmp_path / "other", seed=11, with_config=False)
    monkeypatch.setenv("TPUVAE_TEXT_CHECKPOINT", str(other))
    from_env, b_env = embed_lyrics(LYRICS[:3], device="cpu")
    from_arg, b_arg = embed_lyrics(LYRICS[:3], checkpoint=str(checkpoint),
                                   device="cpu")
    assert b_env == "xlmr-checkpoint:other" and b_arg.endswith("tiny-xlmr")
    assert not np.allclose(from_env, from_arg)
    # without config.json the heads come from the 64-d convention (1 head)
    with jax.default_matmul_precision("highest"):
        want, _ = jax_embed(LYRICS[:3])
    np.testing.assert_allclose(from_env, want, rtol=RTOL, atol=ATOL)
    # one load per (directory, mtime, device); a rewritten file reloads
    enc = load_checkpoint_encoder(other, "cpu")
    assert load_checkpoint_encoder(str(other) + "/", "cpu") is enc
    time.sleep(0.01)
    write_checkpoint(other, seed=12, with_config=False)
    os.utime(other / "pytorch_model.bin")
    assert load_checkpoint_encoder(other, "cpu") is not enc
    assert not np.allclose(embed_lyrics(LYRICS[:3], device="cpu")[0], from_env)
    # a checkpoint without a sentencepiece model is refused
    (other / "sentencepiece.bpe.model").unlink()
    os.utime(other / "pytorch_model.bin", ns=(1, 1))
    with pytest.raises(FileNotFoundError, match="sentencepiece"):
        embed_lyrics(["x"], device="cpu")


def test_hashed_path_needs_no_device_and_checkpoints_need_one(checkpoint,
                                                              monkeypatch):
    from tpuvae_torch.text import embed_lyrics

    monkeypatch.delenv("TPUVAE_TEXT_CHECKPOINT", raising=False)
    emb, backend = embed_lyrics(["la la"], device="no-such-device")
    assert backend == "hashed-ngram" and emb.shape == (1, 768)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            embed_lyrics(["la la"], checkpoint=str(checkpoint))
