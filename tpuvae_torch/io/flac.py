"""First-party FLAC codec: pure-Python decoder + fixture encoder (own copy
of ``tpuvae/io/flac.py``).

The reference loads audio through ``librosa.load`` (``src/1_preprocessing.py:
137-153``), which decodes any soundfile/audioread-supported container —
including FLAC — in third-party C.  This module gives the framework the same
capability without those libraries:

* :func:`read_flac` — a complete decoder for the FLAC subset produced by
  real encoders (CONSTANT / VERBATIM / FIXED 0-4 / LPC 1-32 subframes,
  RICE and RICE2 partitioned residuals incl. escape codes, wasted bits,
  all four stereo decorrelation modes, CRC-8/CRC-16 verification).  It is
  the *behavioral reference* for the C++ production decoder
  (``tpuvae_torch/native/flac.cpp``) and the fallback when the native library isn't
  built.  Pure Python, so decode speed is test/fallback-grade; production
  decode runs native.
* :func:`write_flac` — a minimal encoder (CONSTANT / VERBATIM / best-FIXED
  subframes, single-partition Rice, optional forced LPC and mid/side
  stereo) used to build test fixtures and synthetic FLAC corpora.  Output
  is spec-conformant: every stream it writes round-trips through both
  decoders bit-exactly.

Format reference: the FLAC format spec (RFC 9639).  No reference-repo code
exists for this — the reference has no first-party decoder at all.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

import numpy as np

_SYNC = 0b11111111111110
_CRC8_POLY = 0x07
_CRC16_POLY = 0x8005

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZE_FIXED = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                     8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                     13: 8192, 14: 16384, 15: 32768}
_SAMPLE_SIZE_BITS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_SAMPLE_RATE_FIXED = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                      6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                      11: 96000}


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC8_POLY) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC16_POLY) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def eof(self) -> bool:
        return self.byte >= len(self.data)

    def read(self, n: int) -> int:
        v = 0
        while n > 0:
            if self.byte >= len(self.data):
                raise ValueError("flac: unexpected end of stream")
            avail = 8 - self.bit
            take = min(n, avail)
            cur = self.data[self.byte]
            v = (v << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            n -= take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self) -> None:
        if self.bit:
            self.bit = 0
            self.byte += 1


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        value &= (1 << n) - 1 if n < 64 else (1 << n) - 1
        self.cur = (self.cur << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.cur >> self.nbits) & 0xFF)
        self.cur &= (1 << self.nbits) - 1

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_number(value: int) -> bytes:
    """FLAC's extended-UTF-8 coding of frame/sample numbers."""
    if value < 0x80:
        return bytes([value])
    for n_follow, lead in ((1, 0xC0), (2, 0xE0), (3, 0xF0), (4, 0xF8),
                           (5, 0xFC), (6, 0xFE)):
        if value < (1 << (5 * n_follow + 6 - (1 if n_follow == 6 else 0))) or n_follow == 6:
            out = bytearray(1 + n_follow)
            for i in range(n_follow, 0, -1):
                out[i] = 0x80 | (value & 0x3F)
                value >>= 6
            if n_follow == 6:
                out[0] = 0xFE
            else:
                out[0] = lead | value
            return bytes(out)
    raise ValueError("frame number too large")


def _read_utf8_number(r: _BitReader) -> int:
    b0 = r.read(8)
    if b0 < 0x80:
        return b0
    n_follow = 0
    for mask, lead, nf in ((0xE0, 0xC0, 1), (0xF0, 0xE0, 2), (0xF8, 0xF0, 3),
                           (0xFC, 0xF8, 4), (0xFE, 0xFC, 5), (0xFF, 0xFE, 6)):
        if (b0 & mask) == lead:
            n_follow = nf
            value = b0 & (0xFF >> (nf + 2)) if nf < 6 else 0
            break
    else:
        raise ValueError("flac: invalid UTF-8 coded number")
    for _ in range(n_follow):
        b = r.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("flac: invalid UTF-8 continuation")
        value = (value << 6) | (b & 0x3F)
    return value


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------


def _decode_residual(r: _BitReader, block_size: int, order: int) -> list[int]:
    method = r.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = r.read(4)
    n_part = 1 << po
    if block_size % n_part:
        raise ValueError("flac: partition order does not divide block size")
    res: list[int] = []
    for p in range(n_part):
        count = (block_size >> po) - (order if p == 0 else 0)
        if count < 0:
            raise ValueError("flac: invalid partition geometry")
        param = r.read(plen)
        if param == escape:
            nbits = r.read(5)
            for _ in range(count):
                res.append(r.read_signed(nbits) if nbits else 0)
        else:
            for _ in range(count):
                q = r.read_unary()
                u = (q << param) | (r.read(param) if param else 0)
                res.append((u >> 1) ^ -(u & 1))  # un-zigzag
    return res


def _decode_subframe(r: _BitReader, block_size: int, depth: int) -> list[int]:
    if r.read(1):
        raise ValueError("flac: subframe header padding bit set")
    sf_type = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = r.read_unary() + 1
    depth -= wasted
    if depth <= 0:
        raise ValueError("flac: wasted bits exceed sample depth")

    if sf_type == 0:  # CONSTANT
        v = r.read_signed(depth)
        x = [v] * block_size
    elif sf_type == 1:  # VERBATIM
        x = [r.read_signed(depth) for _ in range(block_size)]
    elif 8 <= sf_type <= 12:  # FIXED
        order = sf_type - 8
        x = [r.read_signed(depth) for _ in range(order)]
        res = _decode_residual(r, block_size, order)
        coefs = _FIXED_COEFFS[order]
        for i, e in enumerate(res):
            pred = sum(c * x[order + i - 1 - j] for j, c in enumerate(coefs))
            x.append(pred + e)
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        x = [r.read_signed(depth) for _ in range(order)]
        precision = r.read(4) + 1
        if precision == 16:
            raise ValueError("flac: invalid LPC precision")
        shift = r.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative LPC shift")
        coefs = [r.read_signed(precision) for _ in range(order)]
        res = _decode_residual(r, block_size, order)
        for i, e in enumerate(res):
            acc = sum(c * x[order + i - 1 - j] for j, c in enumerate(coefs))
            x.append((acc >> shift) + e)
    else:
        raise ValueError(f"flac: reserved subframe type {sf_type}")
    if wasted:
        x = [v << wasted for v in x]
    return x


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a FLAC file → (float32 samples (n, channels), sample_rate).

    Mirrors :func:`tpuvae_torch.io.wav.read_wav`'s contract so ``load_audio`` can
    dispatch on container magic.  Verifies frame CRC-8/CRC-16.
    """
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC file")
    pos = 4
    streaminfo = None
    while pos + 4 <= len(data):
        hdr = data[pos]
        last = hdr & 0x80
        btype = hdr & 0x7F
        size = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + size]
        if btype == 0:
            streaminfo = body
        pos += 4 + size
        if last:
            break
    if streaminfo is None or len(streaminfo) < 34:
        raise ValueError(f"{path}: missing STREAMINFO")
    si = _BitReader(streaminfo)
    si.read(16)  # min block size
    si.read(16)  # max block size
    si.read(24), si.read(24)  # min/max frame size
    sr = si.read(20)
    channels = si.read(3) + 1
    bps = si.read(5) + 1
    total = si.read(36)
    if sr == 0:
        raise ValueError(f"{path}: invalid sample rate")

    out: list[list[int]] = []
    r = _BitReader(data, pos)
    n_done = 0
    while not r.eof() and (total == 0 or n_done < total):
        frame_start = r.byte
        if r.read(14) != _SYNC:
            raise ValueError(f"{path}: lost frame sync")
        r.read(1)  # reserved
        r.read(1)  # blocking strategy
        bs_code = r.read(4)
        sr_code = r.read(4)
        ch_code = r.read(4)
        ss_code = r.read(3)
        r.read(1)  # reserved
        _read_utf8_number(r)
        if bs_code == 0:
            raise ValueError(f"{path}: reserved block size code")
        elif bs_code == 6:
            block_size = r.read(8) + 1
        elif bs_code == 7:
            block_size = r.read(16) + 1
        else:
            block_size = _BLOCK_SIZE_FIXED[bs_code]
        if sr_code == 12:
            r.read(8)
        elif sr_code in (13, 14):
            r.read(16)
        elif sr_code == 15:
            raise ValueError(f"{path}: invalid sample rate code")
        depth = _SAMPLE_SIZE_BITS.get(ss_code, bps)
        if r.bit:
            raise ValueError(f"{path}: misaligned frame header")
        if _crc8(data[frame_start : r.byte]) != r.read(8):
            raise ValueError(f"{path}: frame header CRC-8 mismatch")

        if ch_code < 8:
            n_ch = ch_code + 1
            chans = [_decode_subframe(r, block_size, depth)
                     for _ in range(n_ch)]
        elif ch_code in (8, 9, 10):
            n_ch = 2
            extra = (0, 1) if ch_code == 8 else ((1, 0) if ch_code == 9
                                                 else (0, 1))
            a = _decode_subframe(r, block_size, depth + extra[0])
            b = _decode_subframe(r, block_size, depth + extra[1])
            if ch_code == 8:      # left/side
                chans = [a, [l - s for l, s in zip(a, b)]]
            elif ch_code == 9:    # right/side (side stored first)
                chans = [[rr + s for s, rr in zip(a, b)], b]
            else:                 # mid/side
                left, right = [], []
                for m, s in zip(a, b):
                    ss = (m << 1) | (s & 1)
                    left.append((ss + s) >> 1)
                    right.append((ss - s) >> 1)
                chans = [left, right]
        else:
            raise ValueError(f"{path}: reserved channel assignment")
        if n_ch != channels:
            raise ValueError(f"{path}: frame channel count differs from "
                             "STREAMINFO")
        r.align()
        body_crc = _crc16(data[frame_start : r.byte])
        if body_crc != r.read(16):
            raise ValueError(f"{path}: frame CRC-16 mismatch")
        out.append(chans)
        n_done += block_size

    n = min(n_done, total) if total else n_done
    x = np.empty((n_done, channels), np.float32)
    row = 0
    scale = float(1 << (bps - 1))
    for chans in out:
        blk = np.asarray(chans, np.int64).T.astype(np.float32) / scale
        x[row : row + blk.shape[0]] = blk
        row += blk.shape[0]
    return x[:n], sr


# --------------------------------------------------------------------------
# Encoder (fixtures / synthetic corpora)
# --------------------------------------------------------------------------
#
# The JAX package's encoder, computed with numpy arrays: the same choices
# (constant where possible, else the fixed order 0-4 of least Rice cost,
# the first such order and parameter on ties; forced verbatim / LPC /
# stereo modes) and the same bits, byte for byte — but residuals, Rice
# costs and the bit string are whole-array operations and the CRC-16 is
# table-driven, so a 30 s clip encodes in a fraction of a second instead
# of tens of seconds of per-sample Python.

_CRC16_TABLE = [_crc16(bytes([b])) for b in range(256)]


def _crc16_fast(data: bytes) -> int:
    """:func:`_crc16` (CRC-16, poly 0x8005, init 0) a byte at a time."""
    crc, table = 0, _CRC16_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ table[(crc >> 8) ^ b]
    return crc


class _Bits:
    """An MSB-first bit string built from numpy 0/1 arrays."""

    def __init__(self):
        self.parts: list[np.ndarray] = []

    def write_array(self, values, n: int) -> None:
        """Each value as ``n`` bits (two's complement, masked), in order."""
        v = np.asarray(values, dtype=np.int64).reshape(-1) & ((1 << n) - 1)
        shifts = np.arange(n - 1, -1, -1, dtype=np.int64)
        self.parts.append(((v[:, None] >> shifts) & 1).astype(np.uint8)
                          .reshape(-1))

    def write(self, value: int, n: int) -> None:
        self.write_array([value], n)

    def write_rice(self, u: np.ndarray, param: int) -> None:
        """Rice codes of the zigzagged residuals ``u``: ``u >> param`` zeros,
        a one, then the low ``param`` bits of ``u``."""
        q = u >> param
        lengths = q + 1 + param
        starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
        bits = np.zeros(int(lengths.sum()), np.uint8)
        bits[starts + q] = 1
        for b in range(param):
            bits[starts + q + 1 + b] = (u >> (param - 1 - b)) & 1
        self.parts.append(bits)

    def tobytes(self) -> bytes:
        """The bits, zero-padded to a whole byte."""
        bits = np.concatenate(self.parts) if self.parts else np.zeros(0, np.uint8)
        return np.packbits(bits).tobytes()


def _zigzag(res: np.ndarray) -> np.ndarray:
    return np.where(res >= 0, res << 1, ((-res) << 1) - 1)


def _rice_costs(u: np.ndarray) -> list[int]:
    """Bits of ``u`` Rice-coded at each parameter 0..14."""
    return [int((u >> p).sum()) + len(u) * (1 + p) for p in range(15)]


def _write_residual(w: _Bits, res: np.ndarray, method: int) -> None:
    u = _zigzag(res)
    costs = _rice_costs(u)
    param = costs.index(min(costs))
    w.write(method, 2)
    w.write(0, 4)  # partition order 0
    w.write(param, 4 if method == 0 else 5)
    w.write_rice(u, param)


def _encode_subframe(w: _Bits, x: np.ndarray, depth: int,
                     force: str | None) -> None:
    const = bool((x == x[0]).all())
    if force is None and const:
        force = "constant"
    if force == "constant":
        if not const:
            raise ValueError("constant subframe forced on varying samples")
        w.write(0, 8)                     # pad, type CONSTANT, no wasted bits
        w.write(int(x[0]), depth)
        return
    if force == "verbatim":
        w.write(1 << 1, 8)                # type VERBATIM
        w.write_array(x, depth)
        return
    if force == "lpc":
        # order-2 quantized LPC (coefs predict 2*x[i-1] - x[i-2], shift 5):
        # exercises the decoder's coefficient/shift/64-bit-accum path
        order, precision, shift = 2, 12, 5
        coefs = [2 << shift, -(1 << shift)]
        res = x[order:] - ((coefs[0] * x[1:-1] + coefs[1] * x[:-2]) >> shift)
        w.write((32 + order - 1) << 1, 8)
        w.write_array(x[:order], depth)
        w.write(precision - 1, 4)
        w.write(shift, 5)
        w.write_array(coefs, precision)
        _write_residual(w, res, 0)
        return
    # best fixed predictor (orders 0..4): the order-k residual is the k-th
    # difference; the first order of least cost wins
    best = None
    for order in range(0, min(4, len(x) - 1) + 1):
        res = np.diff(x, n=order)
        cost = min(_rice_costs(_zigzag(res)))
        if best is None or cost < best[2]:
            best = (order, res, cost)
    order, res, _ = best
    w.write((8 + order) << 1, 8)
    w.write_array(x[:order], depth)
    _write_residual(w, res, 0)


def write_flac(
    path: str | Path,
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int = 16,
    block_size: int = 4096,
    subframe: str | None = None,
    stereo: str = "independent",
) -> None:
    """Write ``samples`` (int array (n,) or (n, channels), already scaled to
    ``bits_per_sample`` range) as a spec-conformant FLAC stream, the same
    bytes as the JAX package's ``write_flac``.

    ``subframe`` forces 'constant' | 'verbatim' | 'fixed' | 'lpc' coding
    (default: constant where possible, else best fixed predictor).
    ``stereo`` ∈ {'independent', 'left_side', 'right_side', 'mid_side'}
    (2-channel input only).
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    x = x.astype(np.int64)
    lim = 1 << (bits_per_sample - 1)
    if x.min() < -lim or x.max() >= lim:
        raise ValueError("samples exceed bits_per_sample range")
    if stereo != "independent" and channels != 2:
        raise ValueError("stereo decorrelation requires 2 channels")

    width = (bits_per_sample + 7) // 8
    # little-endian two's complement of each interleaved sample, ``width``
    # bytes of it (int.to_bytes(width, "little", signed=True))
    raw = (x.astype("<i8").reshape(-1).view(np.uint8).reshape(-1, 8)
           [:, :width].tobytes())
    md5 = hashlib.md5(raw)

    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24), si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits_per_sample - 1, 5)
    si.write(n, 36)
    si.align()
    streaminfo = si.bytes() + md5.digest()

    ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}.get(bits_per_sample, 0)
    ch_code = {"independent": channels - 1, "left_side": 8,
               "right_side": 9, "mid_side": 10}[stereo]
    frames = bytearray()
    for f_idx, start in enumerate(range(0, n, block_size)):
        blk = x[start : start + block_size]
        bs = blk.shape[0]
        hdr = _BitWriter()
        hdr.write(_SYNC, 14)
        hdr.write(0, 1)   # reserved
        hdr.write(0, 1)   # fixed blocking
        hdr.write(7, 4)   # 16-bit explicit block size follows
        hdr.write(0, 4)   # sample rate from STREAMINFO
        hdr.write(ch_code, 4)
        hdr.write(ss_code, 3)
        hdr.write(0, 1)   # reserved
        for b in _utf8_number(f_idx):
            hdr.write(b, 8)
        hdr.write(bs - 1, 16)
        hdr.align()
        hbytes = hdr.bytes()

        if stereo == "independent":
            chan_data = [(blk[:, c], bits_per_sample) for c in range(channels)]
        else:
            left, right = blk[:, 0], blk[:, 1]
            side = left - right
            if stereo == "left_side":
                chan_data = [(left, bits_per_sample),
                             (side, bits_per_sample + 1)]
            elif stereo == "right_side":
                chan_data = [(side, bits_per_sample + 1),
                             (right, bits_per_sample)]
            else:
                chan_data = [((left + right) >> 1, bits_per_sample),
                             (side, bits_per_sample + 1)]
        body = _Bits()
        for ch, depth in chan_data:
            _encode_subframe(body, np.ascontiguousarray(ch), depth, subframe)
        fbytes = hbytes + bytes([_crc8(hbytes)]) + body.tobytes()
        frames += fbytes + struct.pack(">H", _crc16_fast(fbytes))

    out = bytearray(b"fLaC")
    out.append(0x80)  # last metadata block, type 0 (STREAMINFO)
    out += len(streaminfo).to_bytes(3, "big")
    out += streaminfo
    out += frames
    Path(path).write_bytes(bytes(out))
