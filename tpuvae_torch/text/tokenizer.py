"""First-party SentencePiece tokenizer for the XLM-R lyric encoder (own
copy of ``tpuvae/text/tokenizer.py``, plus a model writer).

Replaces the runtime dependency on ``transformers.AutoTokenizer`` in the
checkpoint text path (reference capability: the SentenceTransformer's
tokenizer, ``1_preprocessing_advanced.py:327-341``).  Four pieces:

* :func:`load_sentencepiece_model` — a minimal protobuf wire-format reader
  for the ``sentencepiece.bpe.model`` ``ModelProto`` (repeated field 1:
  ``SentencePiece {piece: 1, score: 2, type: 3}``).  No sentencepiece or
  protobuf library needed — the wire format is stable and tiny.
* :class:`SentencePieceVocab` + Viterbi segmentation — maximum-total-score
  segmentation over the piece vocabulary (exact for unigram-LM models, the
  kind XLM-R ships; sentencepiece-BPE models encode greedily by merge rank,
  for which max-score Viterbi is a close, documented approximation).
* :class:`XlmRobertaTokenizer` — SentencePiece normalization (whitespace →
  ``▁``, NFKC), fairseq id remapping (``<s>``=0, ``<pad>``=1, ``</s>``=2,
  ``<unk>``=3, spm piece i → i+1), ``<s> … </s>`` wrapping, truncation and
  fixed-length padding with attention masks — the exact batch the
  :class:`~tpuvae_torch.text.encoder.SentenceEncoder` consumes.
* :func:`write_sentencepiece_model` / :func:`unigram_pieces` — the
  writer of the same wire format and a unigram vocabulary counted from a
  text corpus, for test fixtures and seeded checkpoints (no real
  ``sentencepiece.bpe.model`` ships with the repository).
"""

from __future__ import annotations

import dataclasses
import struct
import unicodedata
from pathlib import Path

import numpy as np

_SPACE = "▁"  # '▁' sentencepiece whitespace marker

# SentencePiece piece types (model proto enum)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_BYTE = 6


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:                      # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:                    # 64-bit
        pos += 8
    elif wire_type == 2:                    # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:                    # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


@dataclasses.dataclass
class SentencePieceDef:
    piece: str
    score: float
    type: int = TYPE_NORMAL


def _parse_piece(buf: bytes) -> SentencePieceDef:
    piece, score, typ = "", 0.0, TYPE_NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:        # piece: string
            n, pos = _read_varint(buf, pos)
            piece = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:      # score: float
            (score,) = struct.unpack("<f", buf[pos : pos + 4])
            pos += 4
        elif field == 3 and wire == 0:      # type: enum
            typ, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return SentencePieceDef(piece, score, typ)


def load_sentencepiece_model(path: str | Path) -> list[SentencePieceDef]:
    """Parse the repeated ``pieces`` field of a sentencepiece ModelProto."""
    buf = Path(path).read_bytes()
    pieces: list[SentencePieceDef] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:        # repeated SentencePiece pieces
            n, pos = _read_varint(buf, pos)
            pieces.append(_parse_piece(buf[pos : pos + n]))
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    if not pieces:
        raise ValueError(f"{path}: no sentencepiece pieces found")
    return pieces


class SentencePieceVocab:
    """Viterbi maximum-score segmentation over a sentencepiece vocabulary."""

    def __init__(self, pieces: list[SentencePieceDef]):
        self.pieces = pieces
        self.index = {p.piece: i for i, p in enumerate(pieces)}
        self.unk_id = next(
            (i for i, p in enumerate(pieces) if p.type == TYPE_UNKNOWN), 0
        )
        self.max_piece_len = max(len(p.piece) for p in pieces)
        # score an unknown character below any real segmentation
        self._unk_score = min(p.score for p in pieces) - 10.0

    def encode_ids(self, normalized: str) -> list[int]:
        """spm piece ids for an already-normalized string (▁-marked)."""
        n = len(normalized)
        if n == 0:
            return []
        best = np.full(n + 1, -np.inf)
        best[0] = 0.0
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        for end in range(1, n + 1):
            for start in range(max(0, end - self.max_piece_len), end):
                if best[start] == -np.inf:
                    continue
                pid = self.index.get(normalized[start:end])
                if pid is None or self.pieces[pid].type in (
                    TYPE_CONTROL, TYPE_UNKNOWN,
                ):
                    if end - start == 1:     # single unknown char fallback
                        pid, score = self.unk_id, self._unk_score
                    else:
                        continue
                else:
                    score = self.pieces[pid].score
                if best[start] + score > best[end]:
                    best[end] = best[start] + score
                    back[end] = (start, pid)
        ids: list[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        return ids[::-1]


def normalize(text: str) -> str:
    """SentencePiece default normalization, first-party approximation:
    NFKC, collapse whitespace runs to single spaces, strip, then prefix
    ``▁`` and replace spaces with ``▁`` (``add_dummy_prefix=True``)."""
    text = unicodedata.normalize("NFKC", text)
    text = " ".join(text.split())
    if not text:
        return ""
    return _SPACE + text.replace(" ", _SPACE)


class XlmRobertaTokenizer:
    """Checkpoint-dir tokenizer: ``sentencepiece.bpe.model`` → fixed-length
    ``(input_ids, attention_mask)`` batches with XLM-R's fairseq id layout.

    fairseq mapping (matches HuggingFace ``XLMRobertaTokenizer``):
    ``<s>``=0, ``<pad>``=1, ``</s>``=2, ``<unk>``=3, and spm piece i ≥ 1
    (skipping spm's own ``<unk>``=0 slot… spm ids shift by +1) — i.e.
    hf_id = spm_id + fairseq_offset(1), with spm ids 0..2 (``<unk>``,
    ``<s>``, ``</s>`` in the spm vocab) shadowed by the specials.
    """

    FAIRSEQ_OFFSET = 1
    BOS, PAD, EOS, UNK = 0, 1, 2, 3

    def __init__(self, model_path: str | Path):
        self.vocab = SentencePieceVocab(load_sentencepiece_model(model_path))

    @property
    def vocab_size(self) -> int:
        # spm pieces + offset + mask token (XLM-R appends <mask> at the end)
        return len(self.vocab.pieces) + self.FAIRSEQ_OFFSET + 1

    def _to_hf_id(self, spm_id: int) -> int:
        if spm_id == self.vocab.unk_id:
            return self.UNK
        return spm_id + self.FAIRSEQ_OFFSET

    def encode(self, text: str, max_length: int = 128) -> list[int]:
        ids = [self._to_hf_id(i) for i in self.vocab.encode_ids(normalize(text))]
        ids = ids[: max_length - 2]
        return [self.BOS] + ids + [self.EOS]

    def __call__(
        self, texts, max_length: int = 128, pad_to: int | None = None
    ) -> dict[str, np.ndarray]:
        pad_to = pad_to or max_length
        batch_ids = np.full((len(texts), pad_to), self.PAD, np.int32)
        mask = np.zeros((len(texts), pad_to), np.int32)
        for r, t in enumerate(texts):
            ids = self.encode(str(t), max_length=pad_to)
            batch_ids[r, : len(ids)] = ids
            mask[r, : len(ids)] = 1
        return {"input_ids": batch_ids, "attention_mask": mask}


def find_sentencepiece_model(checkpoint_dir: str | Path) -> Path | None:
    d = Path(checkpoint_dir)
    for name in ("sentencepiece.bpe.model", "sentencepiece.model",
                 "spiece.model", "tokenizer.model"):
        if (d / name).exists():
            return d / name
    hits = sorted(d.glob("*.model"))
    return hits[0] if hits else None


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def write_sentencepiece_model(path: str | Path, pieces) -> Path:
    """Write ``pieces`` (:class:`SentencePieceDef`s or ``(piece, score[,
    type])`` tuples) as the repeated ``pieces`` field of a ModelProto —
    the subset :func:`load_sentencepiece_model` reads."""
    buf = bytearray()
    for p in pieces:
        if not isinstance(p, SentencePieceDef):
            p = SentencePieceDef(*p)
        data = p.piece.encode("utf-8")
        sub = b"\x0a" + _varint(len(data)) + data
        sub += b"\x15" + struct.pack("<f", p.score)
        if p.type != TYPE_NORMAL:
            sub += b"\x18" + _varint(p.type)
        buf += b"\x0a" + _varint(len(sub)) + sub
    Path(path).write_bytes(bytes(buf))
    return Path(path)


def unigram_pieces(texts, n_pieces: int = 4000,
                   max_piece_len: int = 16) -> list[SentencePieceDef]:
    """A unigram vocabulary counted from ``texts``: ``<unk>``, ``<s>``,
    ``</s>``, every character of the normalized texts, then the most
    frequent substrings of 2..``max_piece_len`` characters up to
    ``n_pieces`` pieces in all, each scored by the log of its relative
    frequency (ties broken by the piece, so the model is deterministic)."""
    from collections import Counter

    chars: Counter = Counter()
    subs: Counter = Counter()
    for t in texts:
        s = normalize(str(t))
        chars.update(s)
        for i in range(len(s)):
            for j in range(i + 2, min(len(s), i + max_piece_len) + 1):
                subs[s[i:j]] += 1
    room = max(0, n_pieces - 3 - len(chars))
    common = sorted(subs.items(), key=lambda kv: (-kv[1], kv[0]))[:room]
    total = float(sum(chars.values()) + sum(c for _, c in common))
    pieces = [SentencePieceDef("<unk>", 0.0, TYPE_UNKNOWN),
              SentencePieceDef("<s>", 0.0, TYPE_CONTROL),
              SentencePieceDef("</s>", 0.0, TYPE_CONTROL)]
    for piece, count in sorted(chars.items()) + common:
        pieces.append(SentencePieceDef(piece, float(np.log(count / total))))
    return pieces
