"""In-process FLAC decoder (RFC 9639; copied from
``synthesizer_tpu.utils.flac``) — the lossless rung of "decode
anything" with no external binary.

Layering: container/metadata/frame/subframe HEADERS parse here in Python
(a few dozen bits per frame); the per-sample hot loops (bit-serial Rice
residuals + fixed/LPC reconstruction) run in ``native/flacdec.c`` via
ctypes when a C compiler is available, with an exact pure-Python twin
fallback (same integer semantics, just slower).  FLAC is lossless and
exactly specified in integer arithmetic, so decode is bit-exact by
construction — the tests encode known PCM with an independent spec-
following encoder and require identity.

Coverage: STREAMINFO + any metadata blocks (skipped); fixed and variable
blocking; all blocksize/samplerate/bps header codes; subframe types
CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (orders 1-32); Rice/Rice2
partitions incl. escape codes; wasted bits; stereo decorrelation
(left/side, right/side, mid/side); CRC-8 (header) and CRC-16 (frame)
verification.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

from .native import build_shared

__all__ = ["read_flac", "write_flac", "probe_flac", "FlacError"]

FileLike = Union[str, BinaryIO]


class FlacError(Exception):
    pass


# ---------------------------------------------------------------------------
# Native hot-loop binding (built at first use into build/native/ by
# utils/native.build_shared)
# ---------------------------------------------------------------------------

_lib = None
_tried = False
_lock = threading.Lock()


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build_shared("flacdec", ["-O3", "-std=c11"]))
        except Exception:
            return None
        lib.flac_residual_predict.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.flac_residual_predict.restype = ctypes.c_longlong
        lib.flac_crc16.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.flac_crc16.restype = ctypes.c_uint16
        lib.flac_write_rice.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int]
        lib.flac_write_rice.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Bit reader (header-level parsing; the C side re-reads from a bit offset)
# ---------------------------------------------------------------------------

class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def uint(self, n: int) -> int:
        if self.pos + n > len(self.data) * 8:
            raise FlacError("truncated FLAC stream")
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def sint(self, n: int) -> int:
        v = self.uint(n)
        return v - (1 << n) if n and (v >> (n - 1)) else v

    def unary(self) -> int:
        q = 0
        while self.uint(1) == 0:
            q += 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def sint_array(self, n_items: int, width: int) -> np.ndarray:
        """n_items back-to-back width-bit signed ints, vectorized (the
        VERBATIM subframe path — a per-sample Python loop here would cost
        ~width interpreter iterations per sample)."""
        if width == 0:
            return np.zeros(n_items, np.int64)
        start = self.pos
        total = n_items * width
        if start + total > len(self.data) * 8:
            raise FlacError("truncated FLAC stream")
        b0 = start >> 3
        b1 = (start + total + 7) >> 3
        bits = np.unpackbits(np.frombuffer(self.data, np.uint8,
                                           count=b1 - b0, offset=b0))
        bits = bits[start - 8 * b0: start - 8 * b0 + total]             .reshape(n_items, width).astype(np.int64)
        weights = (np.int64(1) << np.arange(width - 1, -1, -1,
                                            dtype=np.int64))
        vals = bits @ weights
        vals = np.where(bits[:, 0] == 1, vals - (np.int64(1) << width),
                        vals)
        self.pos = start + total
        return vals


# ---------------------------------------------------------------------------
# CRCs (FLAC: CRC-8 poly 0x07 over the frame header, CRC-16 poly 0x8005
# over the whole frame, both init 0)
# ---------------------------------------------------------------------------

def _make_crc8():
    table = np.zeros(256, np.uint8)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07 if c & 0x80 else c << 1) & 0xFF
        table[i] = c
    return table


def _make_crc16():
    table = np.zeros(256, np.uint16)
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005 if c & 0x8000 else c << 1) & 0xFFFF
        table[i] = c
    return table


_CRC8 = _make_crc8()
_CRC16 = _make_crc16()


def crc8(data: bytes) -> int:
    c = 0
    for byte in data:
        c = int(_CRC8[c ^ byte])
    return c


def crc16(data: bytes) -> int:
    lib = _load()
    if lib is not None:
        return int(lib.flac_crc16(data, len(data)))
    c = 0
    for byte in data:
        c = int(_CRC16[((c >> 8) ^ byte) & 0xFF]) ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# Pure-Python twin of native/flacdec.c (same integer semantics)
# ---------------------------------------------------------------------------

def _residual_predict_py(data: bytes, bitpos: int, out: np.ndarray, n: int,
                         pred_order: int, method: int, part_order: int,
                         coefs, lpc_order: int, lpc_shift: int,
                         fixed_order: int) -> int:
    br = _BitReader(data, bitpos)
    nparts = 1 << part_order
    ppart = n >> part_order
    if ppart <= 0 or (ppart << part_order) != n or ppart < pred_order:
        raise FlacError("bad residual partitioning")
    idx = pred_order
    pbits = 4 if method == 0 else 5
    escape = 0xF if method == 0 else 0x1F
    res = [0] * n
    for p in range(nparts):
        count = ppart - (pred_order if p == 0 else 0)
        param = br.uint(pbits)
        if param == escape:
            rb = br.uint(5)
            for _ in range(count):
                res[idx] = br.sint(rb) if rb else 0
                idx += 1
        else:
            k = param
            for _ in range(count):
                q = br.unary()
                u = (q << k) | br.uint(k) if k else q
                res[idx] = -(u >> 1) - 1 if u & 1 else (u >> 1)
                idx += 1
    if idx != n:
        raise FlacError("residual count mismatch")
    s = out
    for i in range(pred_order, n):
        s[i] = res[i]
    if lpc_order > 0:
        for i in range(lpc_order, n):
            acc = 0
            for j in range(lpc_order):
                acc += coefs[j] * int(s[i - 1 - j])
            s[i] = int(s[i]) + (acc >> lpc_shift)
    elif fixed_order == 1:
        for i in range(1, n):
            s[i] = int(s[i]) + int(s[i - 1])
    elif fixed_order == 2:
        for i in range(2, n):
            s[i] = int(s[i]) + 2 * int(s[i - 1]) - int(s[i - 2])
    elif fixed_order == 3:
        for i in range(3, n):
            s[i] = int(s[i]) + 3 * int(s[i - 1]) - 3 * int(s[i - 2]) \
                + int(s[i - 3])
    elif fixed_order == 4:
        for i in range(4, n):
            s[i] = int(s[i]) + 4 * int(s[i - 1]) - 6 * int(s[i - 2]) \
                + 4 * int(s[i - 3]) - int(s[i - 4])
    return br.pos


def _residual_predict(data: bytes, bitpos: int, out: np.ndarray, n: int,
                      pred_order: int, method: int, part_order: int,
                      coefs, lpc_order: int, lpc_shift: int,
                      fixed_order: int) -> int:
    lib = _load()
    if lib is None:
        # the pure-Python twin works on an object array (exact bignum
        # intermediates), then narrows with int32 wrap like the C side
        buf = out.astype(object)
        pos = _residual_predict_py(data, bitpos, buf, n, pred_order,
                                   method, part_order, coefs, lpc_order,
                                   lpc_shift, fixed_order)
        out[:] = [((int(v) + 2**31) % 2**32) - 2**31 for v in buf]
        return pos
    carr = (ctypes.c_int32 * max(lpc_order, 1))(
        *(list(coefs) if lpc_order else [0]))
    new = lib.flac_residual_predict(
        data, len(data), bitpos,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        pred_order, method, part_order, carr, lpc_order, lpc_shift,
        fixed_order)
    if new < 0:
        raise FlacError("malformed FLAC residual")
    return int(new)


# ---------------------------------------------------------------------------
# Frame parsing
# ---------------------------------------------------------------------------

_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
               6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
               11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _read_coded_number(br: _BitReader) -> int:
    """The frame header's UTF-8-style frame/sample number (up to 36 bits)."""
    first = br.uint(8)
    if first < 0x80:
        return first
    nbytes = 0
    mask = 0x80
    while first & mask:
        nbytes += 1
        mask >>= 1
    if nbytes < 2 or nbytes > 7:
        raise FlacError("bad coded number")
    v = first & (0xFF >> (nbytes + 1))
    for _ in range(nbytes - 1):
        c = br.uint(8)
        if (c & 0xC0) != 0x80:
            raise FlacError("bad coded number continuation")
        v = (v << 6) | (c & 0x3F)
    return v


def _decode_subframe(data: bytes, br: _BitReader, n: int, bps: int
                     ) -> np.ndarray:
    pad = br.uint(1)
    if pad != 0:
        raise FlacError("subframe padding bit set")
    stype = br.uint(6)
    wasted = 0
    if br.uint(1):
        wasted = 1 + br.unary()
    eff = bps - wasted
    if eff <= 0:
        raise FlacError("wasted bits exceed sample size")
    if eff > 32:
        # a 32-bit stream's SIDE channel is 33 bits wide; the int32
        # decode pipeline cannot represent it — refuse loudly instead of
        # silently wrapping through the LPC arithmetic shift
        raise FlacError("33-bit side channel (32-bps decorrelated "
                        "stereo) is not supported")
    out = np.zeros(n, np.int32)
    if stype == 0:                                   # CONSTANT
        out[:] = br.sint(eff)
    elif stype == 1:                                 # VERBATIM
        out[:] = br.sint_array(n, eff)
    elif 8 <= stype <= 12:                           # FIXED order 0-4
        order = stype - 8
        if order > n:
            raise FlacError("predictor order exceeds blocksize")
        for i in range(order):
            out[i] = br.sint(eff)
        method = br.uint(2)
        if method > 1:
            raise FlacError("reserved residual method")
        part_order = br.uint(4)
        br.pos = _residual_predict(data, br.pos, out, n, order, method,
                                   part_order, None, 0, 0, order)
    elif stype >= 32:                                # LPC order 1-32
        order = (stype & 31) + 1
        if order > n:
            raise FlacError("predictor order exceeds blocksize")
        for i in range(order):
            out[i] = br.sint(eff)
        prec = br.uint(4)
        if prec == 15:
            raise FlacError("invalid LPC precision")
        prec += 1
        shift = br.sint(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [br.sint(prec) for _ in range(order)]
        method = br.uint(2)
        if method > 1:
            raise FlacError("reserved residual method")
        part_order = br.uint(4)
        br.pos = _residual_predict(data, br.pos, out, n, order, method,
                                   part_order, coefs, order, shift, 0)
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def _parse_streaminfo(data: bytes):
    br = _BitReader(data)
    br.uint(16)                     # min blocksize
    br.uint(16)                     # max blocksize
    br.uint(24)                     # min framesize
    br.uint(24)                     # max framesize
    rate = br.uint(20)
    nch = br.uint(3) + 1
    bps = br.uint(5) + 1
    total = br.uint(36)
    return rate, nch, bps, total


def _metadata_end(data: bytes) -> Tuple[int, tuple]:
    """Parse the metadata section -> (first frame byte offset, streaminfo)."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        btype = hdr & 0x7F
        last = bool(hdr & 0x80)
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:
            info = _parse_streaminfo(body)
        pos += 4 + size
        if last:
            break
    if info is None:
        raise FlacError("missing STREAMINFO")
    return pos, info


def probe_flac(file: FileLike) -> Tuple[int, int, int]:
    """Header-only probe -> (nframes, samplerate, nchannels).  Reads only
    the metadata section (grown geometrically past large embedded
    artwork blocks)."""
    def metadata(read):
        size = 65536
        while True:
            head = read(size)
            try:
                return _metadata_end(head)
            except FlacError as e:
                if "truncated metadata" not in str(e) \
                        or len(head) < size:
                    raise
                size *= 4

    if isinstance(file, str):
        with open(file, "rb") as f:
            _, (rate, nch, _bps, total) = metadata(
                lambda k: (f.seek(0), f.read(k))[1])
    else:
        file.seek(0)
        _, (rate, nch, _bps, total) = metadata(
            lambda k: (file.seek(0), file.read(k))[1])
        file.seek(0)
    return total, rate, nch


def read_flac(file: FileLike) -> Tuple[np.ndarray, int, int, int]:
    """Decode a FLAC file -> (frames [n, ch] signed int array, rate,
    width, nch) — same conventions as utils/decoders (width 1/2/4;
    bps < width*8 values are left-shifted into the width's scale, like
    24-bit WAV -> int32<<8)."""
    if isinstance(file, str):
        with open(file, "rb") as f:
            data = f.read()
    else:
        file.seek(0)
        data = file.read()
    frame_start, (rate, nch, bps, total) = _metadata_end(data)

    blocks = []
    decoded = 0
    pos = frame_start
    while pos < len(data) - 2:
        if total and decoded >= total:
            break
        br = _BitReader(data, pos * 8)
        sync = br.uint(14)
        if sync != 0x3FFE:
            raise FlacError(f"lost frame sync at byte {pos}")
        if br.uint(1):
            raise FlacError("reserved frame bit set")
        br.uint(1)                                  # blocking strategy
        bs_code = br.uint(4)
        rate_code = br.uint(4)
        chan_code = br.uint(4)
        bps_code = br.uint(3)
        if br.uint(1):
            raise FlacError("reserved frame header bit set")
        _read_coded_number(br)
        if bs_code == 0:
            raise FlacError("reserved blocksize code")
        elif bs_code == 6:
            n = br.uint(8) + 1
        elif bs_code == 7:
            n = br.uint(16) + 1
        else:
            n = _BLOCKSIZE_TABLE[bs_code]
        if rate_code == 12:
            br.uint(8)
        elif rate_code in (13, 14):
            br.uint(16)
        elif rate_code == 15:
            raise FlacError("invalid samplerate code")
        hdr_end_byte = (br.pos + 7) // 8
        if crc8(data[pos:hdr_end_byte]) != br.uint(8):
            raise FlacError("frame header CRC-8 mismatch")

        fbps = _BPS_TABLE[bps_code] if bps_code in _BPS_TABLE else bps
        if chan_code < 8:
            fch = chan_code + 1
            chans = [_decode_subframe(data, br, n, fbps)
                     for _ in range(fch)]
        elif chan_code in (8, 9, 10):
            fch = 2
            # the SIDE channel carries one extra bit
            if chan_code == 8:                      # left/side
                left = _decode_subframe(data, br, n, fbps)
                side = _decode_subframe(data, br, n, fbps + 1)
                chans = [left, left - side]
            elif chan_code == 9:                    # right/side
                side = _decode_subframe(data, br, n, fbps + 1)
                right = _decode_subframe(data, br, n, fbps)
                chans = [right + side, right]
            else:                                   # mid/side
                mid = _decode_subframe(data, br, n, fbps)
                side = _decode_subframe(data, br, n, fbps + 1)
                m2 = (mid.astype(np.int64) << 1) | (side & 1)
                chans = [((m2 + side) >> 1).astype(np.int32),
                         ((m2 - side) >> 1).astype(np.int32)]
        else:
            raise FlacError(f"reserved channel assignment {chan_code}")
        if fch != nch:
            raise FlacError("frame channel count != STREAMINFO")
        br.align()
        frame_bytes_end = br.pos // 8
        want = br.uint(16)
        if crc16(data[pos:frame_bytes_end]) != want:
            raise FlacError("frame CRC-16 mismatch")
        blocks.append(np.stack(chans, axis=1))
        decoded += n
        pos = br.pos // 8

    if not blocks:
        out = np.zeros((0, nch), np.int32)
    else:
        out = np.concatenate(blocks, axis=0)
    if total:
        out = out[:total]
    width = 1 if bps <= 8 else 2 if bps <= 16 else 4
    shift = width * 8 - bps
    if shift:
        out = out << shift
    dt = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    return out.astype(dt), rate, width, nch


# ---------------------------------------------------------------------------
# Encoder (lossless export for mixdowns/stems)
# ---------------------------------------------------------------------------

class _BitBuf:
    """Zero-initialized bit sink: Python writes headers/warmup (a few
    dozen bits per frame); the Rice residual runs hand off to the C
    writer at the current bit position."""
    __slots__ = ("buf", "pos")

    def __init__(self, cap_bytes: int):
        self.buf = np.zeros(cap_bytes, np.uint8)
        self.pos = 0

    def uint(self, v: int, n: int) -> None:
        buf = self.buf
        pos = self.pos
        for i in range(n - 1, -1, -1):
            if (v >> i) & 1:
                buf[pos >> 3] |= 0x80 >> (pos & 7)
            pos += 1
        self.pos = pos

    def sint(self, v: int, n: int) -> None:
        self.uint(v & ((1 << n) - 1), n)

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def sint_array(self, values: np.ndarray, width: int) -> None:
        """Append back-to-back width-bit signed ints, vectorized (the
        VERBATIM encode path)."""
        vals = values.astype(np.int64) & ((np.int64(1) << width) - 1)
        shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
        bits = ((vals[:, None] >> shifts[None, :]) & 1)             .astype(np.uint8).reshape(-1)
        start = self.pos
        lead = start & 7
        padded = np.concatenate([np.zeros(lead, np.uint8), bits])
        tail = (-len(padded)) % 8
        if tail:
            padded = np.concatenate([padded, np.zeros(tail, np.uint8)])
        packed = np.packbits(padded)
        b0 = start >> 3
        self.buf[b0:b0 + len(packed)] |= packed
        self.pos = start + bits.size

    def bytes_out(self) -> bytes:
        assert self.pos % 8 == 0
        return self.buf[: self.pos // 8].tobytes()


def _utf8_number(w: _BitBuf, v: int) -> None:
    """The frame header's UTF-8-style coded number (frame index)."""
    if v < 0x80:
        w.uint(v, 8)
        return
    nbytes = 2
    while v >= (1 << (6 * (nbytes - 1) + (7 - nbytes))):
        nbytes += 1
    lead = (0xFF00 >> nbytes) & 0xFF
    shifts = [(nbytes - 2 - i) * 6 for i in range(nbytes - 1)]
    w.uint(lead | (v >> (6 * (nbytes - 1))), 8)
    for i in range(nbytes - 1):
        w.uint(0x80 | ((v >> shifts[i]) & 0x3F), 8)


def _write_rice(w: _BitBuf, res: np.ndarray, k: int) -> bool:
    """Append zigzag+Rice residuals; False if the frame buffer would
    overflow (caller retries as verbatim)."""
    lib = _load()
    res32 = np.ascontiguousarray(res, np.int32)
    if lib is not None:
        new = lib.flac_write_rice(
            w.buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(w.buf), w.pos,
            res32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(res32), k)
        if new < 0:
            return False
        w.pos = int(new)
        return True
    cap = len(w.buf) * 8
    for r in res32:
        r = int(r)
        u = ((-r - 1) << 1) | 1 if r < 0 else r << 1
        q = u >> k
        if w.pos + q + 1 + k > cap:
            return False
        w.pos += q
        w.buf[w.pos >> 3] |= 0x80 >> (w.pos & 7)
        w.pos += 1
        if k:
            w.uint(u & ((1 << k) - 1), k)
    return True


def _zigzag_bits(res: np.ndarray, k: int) -> int:
    u = np.where(res < 0, ((-(res + 1)) << 1) | 1, res << 1)
    return int((u >> k).sum()) + len(res) * (1 + k)


def _best_rice_k(res: np.ndarray) -> Tuple[int, int]:
    """(k, total bits) minimizing the Rice size (k <= 14; method-0)."""
    if len(res) == 0:
        return 0, 0
    mean = float(np.mean(np.abs(res.astype(np.float64))))
    k0 = max(0, min(14, int(np.log2(mean + 1.0)) if mean > 0 else 0))
    best = (k0, _zigzag_bits(res, k0))
    for k in (k0 - 1, k0 + 1, k0 + 2):
        if 0 <= k <= 14:
            bits = _zigzag_bits(res, k)
            if bits < best[1]:
                best = (k, bits)
    return best


def write_flac(file: FileLike, frames: np.ndarray, samplerate: int,
               samplewidth: int, nchannels: int,
               blocksize: int = 4096) -> None:
    """Encode signed int frames [n, ch] (or flat) losslessly to FLAC.

    Subframe choice per channel per block: CONSTANT for flat runs, else
    the best of fixed predictors 0-2 (numpy diff residuals, Rice-coded
    via the native writer) vs VERBATIM; independent channels; single
    Rice partition.  Decode(read_flac) of the output is bit-identical to
    the input — pinned by the roundtrip tests."""
    frames = np.asarray(frames)
    if frames.ndim == 1:
        frames = frames.reshape(-1, nchannels)
    n = len(frames)
    bps = {1: 8, 2: 16, 4: 32}[samplewidth]
    bps_code = {8: 1, 16: 4, 32: 7}[bps]
    if samplerate >= (1 << 20):
        raise FlacError("samplerate too large for STREAMINFO")
    if not 1 <= nchannels <= 8:
        raise FlacError("FLAC supports 1-8 channels")
    if not 16 <= blocksize <= 65535:
        raise FlacError("blocksize must be in [16, 65535]")
    out = bytearray(b"fLaC")
    si = _BitBuf(64)
    si.uint(min(blocksize, max(n, 16)), 16)
    si.uint(min(blocksize, max(n, 16)), 16)
    si.uint(0, 24)
    si.uint(0, 24)
    si.uint(samplerate, 20)
    si.uint(nchannels - 1, 3)
    si.uint(bps - 1, 5)
    si.uint(n & ((1 << 36) - 1), 36)
    body = si.bytes_out() + b"\x00" * 16
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    cols = [np.ascontiguousarray(frames[:, c]).astype(np.int64)
            for c in range(nchannels)]
    frameno = 0
    for start in range(0, n, blocksize):
        bs = min(blocksize, n - start)
        hdr = _BitBuf(32)
        hdr.uint(0x3FFE, 14)
        hdr.uint(0, 2)                       # reserved, fixed blocking
        hdr.uint(7, 4)                       # 16-bit blocksize-1 follows
        hdr.uint(0, 4)                       # samplerate from STREAMINFO
        hdr.uint(nchannels - 1, 4)           # independent channels
        hdr.uint(bps_code, 3)
        hdr.uint(0, 1)
        _utf8_number(hdr, frameno)
        hdr.uint(bs - 1, 16)
        hdr.align()
        hbytes = hdr.bytes_out()
        hbytes += bytes([crc8(hbytes)])

        cap = len(hbytes) + nchannels * (bs * (bps + 8) // 8 + 64) + 16
        w = _BitBuf(cap)
        for c in range(nchannels):
            s = cols[c][start:start + bs]
            _encode_subframe(w, s, bs, bps)
        w.align()
        frame = hbytes + w.bytes_out()
        frame += struct.pack(">H", crc16(frame))
        out += frame
        frameno += 1
    if isinstance(file, str):
        with open(file, "wb") as f:
            f.write(out)
    else:
        file.write(bytes(out))


def _encode_subframe(w: _BitBuf, s: np.ndarray, bs: int, bps: int) -> None:
    if bs > 1 and bool(np.all(s == s[0])):
        w.uint(0, 1)
        w.uint(0, 6)                          # CONSTANT
        w.uint(0, 1)
        w.sint(int(s[0]), bps)
        return
    # candidate fixed predictors: order-o residuals are o-fold diffs
    # (length bs - o; the o warmup samples store verbatim)
    diffs = [s]
    for o in (1, 2):
        if bs > o:
            diffs.append(np.diff(diffs[-1]))
    cands = []
    for order, res in enumerate(diffs):
        if int(np.abs(res).max(initial=0)) < (1 << 30):
            k, bits = _best_rice_k(res)
            cands.append((bits + order * bps, order, k, res))
    verbatim_bits = bs * bps
    best = min(cands, default=None, key=lambda t: t[0])
    if best is not None and best[0] < verbatim_bits:
        _bits, order, k, res = best
        mark = w.pos
        w.uint(0, 1)
        w.uint(8 + order, 6)                  # FIXED
        w.uint(0, 1)
        for v in s[:order]:
            w.sint(int(v), bps)
        w.uint(0, 2)                          # method 0 (4-bit Rice)
        w.uint(0, 4)                          # partition order 0
        w.uint(k, 4)
        if _write_rice(w, res, k):
            return
        # overflow (pathological residuals): rewind to verbatim — keep
        # the earlier subframes' bits sharing the partial byte at mark
        byte0 = mark // 8
        keep = mark & 7
        if keep:
            w.buf[byte0] &= (0xFF00 >> keep) & 0xFF
            w.buf[byte0 + 1:] = 0
        else:
            w.buf[byte0:] = 0
        w.pos = mark
    w.uint(0, 1)
    w.uint(1, 6)                              # VERBATIM
    w.uint(0, 1)
    w.sint_array(np.asarray(s), bps)
