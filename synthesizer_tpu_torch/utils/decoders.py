"""Host-side decoders for spec-stable non-WAV audio formats (copied from
``synthesizer_tpu.utils.decoders``).

"Decode anything" (SURVEY.md §3.1 row 7) must not depend on an ffmpeg
binary a host may not have: these parsers make AIFF / AIFF-C, Sun
AU, FLAC (utils/flac.py — Rice/LPC hot loops in native/flacdec.c), and
the common compressed WAV codecs (G.711 u-law/A-law, IMA ADPCM)
decodable in-process, feeding the existing device convert pipeline
(AudiofileToWavStream._normalized_wav).  Pure numpy — container walking
and bit-twiddling is host work; the PCM goes to the device afterwards.
MPEG audio (mp3/mp2/mp1) and Ogg Vorbis dispatch to ctypes bindings of
the system codec libraries when present (utils/codecs.py — libmpg123 /
libvorbisfile), still in-process; only their absence falls back to
ffmpeg.

Decoding conventions match the C audioop module (the tests fuzz the G.711
expanders against ``audioop.ulaw2lin``/``alaw2lin`` and the ADPCM inner
loop against ``audioop.adpcm2lin`` — both implement the same ITU/IMA
algorithms).
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

__all__ = ["decode_audio_file", "probe_audio_file", "read_aiff",
           "read_au", "read_wav_any",
           "ulaw_decode", "alaw_decode", "ima_adpcm_decode_block",
           "DecodeError"]

FileLike = Union[str, BinaryIO]


class DecodeError(Exception):
    pass


def _malformed_as_decode_error(fn):
    """Malformed/truncated containers surface as DecodeError, not raw
    struct.error / numpy ValueError from deep inside the parser — the
    exception type callers (streaming ladder, jukebox scan) rely on."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except DecodeError:
            raise
        except (struct.error, ValueError, IndexError) as e:
            raise DecodeError(f"malformed audio file: {e}") from e
    return wrapped


def _open(file: FileLike):
    if isinstance(file, (str, bytes)):
        return open(file, "rb"), True
    return file, False


# ---------------------------------------------------------------------------
# G.711 companded telephony codecs (ITU-T; the audioop expanders)
# ---------------------------------------------------------------------------

def _build_ulaw_table() -> np.ndarray:
    u = np.arange(256, dtype=np.int32)
    c = (~u) & 0xFF
    sign = (c & 0x80) != 0
    exp = (c >> 4) & 7
    mant = c & 0x0F
    t = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(sign, -t, t).astype(np.int16)


def _build_alaw_table() -> np.ndarray:
    a = np.arange(256, dtype=np.int32)
    c = a ^ 0x55
    sign = (c & 0x80) != 0
    seg = (c & 0x70) >> 4
    mant = c & 0x0F
    t = (mant << 4) + 8
    t = np.where(seg >= 1, (t + 0x100), t)
    t = np.where(seg > 1, t << np.maximum(seg - 1, 0), t)
    # G.711 A-law: the (inverted-bits) sign bit SET means positive
    return np.where(sign, t, -t).astype(np.int16)


_ULAW_TABLE = _build_ulaw_table()
_ALAW_TABLE = _build_alaw_table()


def ulaw_decode(data: bytes) -> np.ndarray:
    """u-law bytes -> int16 samples (== audioop.ulaw2lin(data, 2))."""
    return _ULAW_TABLE[np.frombuffer(data, np.uint8)]


def alaw_decode(data: bytes) -> np.ndarray:
    """A-law bytes -> int16 samples (== audioop.alaw2lin(data, 2))."""
    return _ALAW_TABLE[np.frombuffer(data, np.uint8)]


# ---------------------------------------------------------------------------
# IMA / DVI ADPCM (the WAV 0x11 codec; same tables as audioop.adpcm2lin)
# ---------------------------------------------------------------------------

_IMA_INDEX_ADJUST = np.array([-1, -1, -1, -1, 2, 4, 6, 8] * 2, np.int32)
_IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)


def ima_adpcm_decode_block(nibbles: np.ndarray, predictor: np.ndarray,
                           index: np.ndarray) -> np.ndarray:
    """Decode IMA ADPCM nibble streams, vectorized over LANES.

    ``nibbles``: [lanes, n] uint8 (values 0..15, already unpacked in
    stream order); ``predictor``/``index``: [lanes] initial decoder state
    (the WAV block header).  Returns int16 [lanes, n].  The per-sample
    recurrence (IMA standard, == audioop's Intel/DVI tables):

        step  = steps[index]
        diff  = (step>>3) + (d&1)*(step>>2) + (d&2)/2*(step>>1) + (d&4)/4*step
        pred  = clamp(pred ± diff);  index = clamp(index + adjust[d], 0, 88)
    """
    lanes, n = nibbles.shape
    pred = predictor.astype(np.int32).copy()
    idx = np.clip(index.astype(np.int32), 0, 88)
    out = np.empty((lanes, n), np.int16)
    for i in range(n):
        d = nibbles[:, i].astype(np.int32)
        step = _IMA_STEPS[idx]
        diff = (step >> 3) + np.where(d & 1, step >> 2, 0) \
            + np.where(d & 2, step >> 1, 0) + np.where(d & 4, step, 0)
        pred = np.where(d & 8, pred - diff, pred + diff)
        pred = np.clip(pred, -32768, 32767)
        out[:, i] = pred
        idx = np.clip(idx + _IMA_INDEX_ADJUST[d], 0, 88)
    return out


def _ima_decode_wav_data(data: bytes, nchannels: int, block_align: int,
                         nframes: int) -> np.ndarray:
    """WAV IMA-ADPCM payload -> int16 [nframes, nch].

    Block layout per channel: 4-byte header (int16 predictor, uint8 index,
    reserved), then interleaved 4-byte nibble groups per channel (8
    samples each, LOW nibble first).  The header predictor IS the block's
    first output sample.  A PARTIAL final block (truncated transfer, or
    an encoder that stops at exactly nframes) decodes its present nibble
    groups instead of being dropped.
    """
    ba = block_align
    nblocks = len(data) // ba
    rem = len(data) - nblocks * ba

    def decode_blocks(raw: np.ndarray, nb: int, width: int) -> np.ndarray:
        """[nb, width] uint8 blocks -> [nb * samples, nch] int16."""
        cols = []
        for ch in range(nchannels):
            hdr = raw[:, 4 * ch: 4 * ch + 4]
            pred0 = (hdr[:, 0].astype(np.uint16)
                     | (hdr[:, 1].astype(np.uint16) << 8)).astype(np.int16)
            idx0 = hdr[:, 2].astype(np.int32)
            body = raw[:, 4 * nchannels:]
            groups = body.reshape(nb, -1, 4 * nchannels)
            chbytes = groups[:, :, 4 * ch: 4 * ch + 4].reshape(nb, -1)
            lo = chbytes & 0x0F
            hi = chbytes >> 4
            nib = np.stack([lo, hi], axis=2).reshape(nb, -1)
            # the header predictor is sample 0; nibbles decode samples 1..
            dec = ima_adpcm_decode_block(nib, pred0.astype(np.int32), idx0)
            samples = np.concatenate([pred0[:, None], dec], axis=1)
            cols.append(samples.reshape(-1))
        return np.stack(cols, axis=1)

    parts = []
    if nblocks:
        raw = np.frombuffer(data[:nblocks * ba],
                            np.uint8).reshape(nblocks, ba)
        parts.append(decode_blocks(raw, nblocks, ba))
    if rem >= 4 * nchannels:
        # short final block: keep only whole interleaved nibble groups
        body_len = (rem - 4 * nchannels) // (4 * nchannels) \
            * (4 * nchannels)
        width = 4 * nchannels + body_len
        raw_r = np.frombuffer(data[nblocks * ba:nblocks * ba + width],
                              np.uint8).reshape(1, width)
        parts.append(decode_blocks(raw_r, 1, width))
    if not parts:
        return np.zeros((0, nchannels), np.int16)
    out = np.concatenate(parts, axis=0)
    total = min(len(out), nframes if nframes > 0 else len(out))
    return out[:total]


# ---------------------------------------------------------------------------
# RIFF/WAVE with non-PCM codecs (stdlib wave rejects these)
# ---------------------------------------------------------------------------

@_malformed_as_decode_error
def read_wav_any(file: FileLike) -> Tuple[np.ndarray, int, int, int]:
    """Read a WAV file of ANY supported codec -> (frames [n, ch] signed
    int array, rate, width, nch).  Codecs: PCM (1), IEEE float (3),
    A-law (6), u-law (7), IMA ADPCM (0x11), EXTENSIBLE (0xFFFE —
    resolved through the SubFormat GUID).  Compressed codecs decode to
    int16."""
    f, own = _open(file)
    try:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise DecodeError("not a RIFF/WAVE file")
        fmt = None
        data = None
        nframes = -1
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            body = f.read(size)
            if size % 2:
                f.read(1)                      # chunks are word-aligned
            if cid == b"fmt ":
                fmt = body
            elif cid == b"fact" and len(body) >= 4:
                nframes = struct.unpack("<I", body[:4])[0]
            elif cid == b"data":
                data = body
        if fmt is None or data is None:
            raise DecodeError("WAV missing fmt/data chunk")
        (tag, nch, rate, _br, block_align,
         bits) = struct.unpack("<HHIIHH", fmt[:16])
        if tag == 0xFFFE and len(fmt) >= 26:
            tag = struct.unpack("<H", fmt[24:26])[0]
        if nch < 1:
            raise DecodeError("WAV with zero channels")
        if tag == 1:                            # integer PCM
            if bits == 8:
                a = (np.frombuffer(data, np.uint8).astype(np.int16)
                     - 128).astype(np.int8)
                return a.reshape(-1, nch), rate, 1, nch
            if bits == 16:
                a = np.frombuffer(data, "<i2").astype(np.int16)
                return a.reshape(-1, nch), rate, 2, nch
            if bits == 24:
                b = np.frombuffer(data, np.uint8).reshape(-1, 3)
                v = (b[:, 0].astype(np.uint32)
                     | (b[:, 1].astype(np.uint32) << 8)
                     | (b[:, 2].astype(np.uint32) << 16))
                return ((v << 8).astype(np.int32).reshape(-1, nch),
                        rate, 4, nch)
            if bits == 32:
                a = np.frombuffer(data, "<i4").astype(np.int32)
                return a.reshape(-1, nch), rate, 4, nch
            raise DecodeError(f"unsupported PCM bit depth {bits}")
        if tag == 3:                            # IEEE float
            dt = "<f4" if bits == 32 else "<f8" if bits == 64 else None
            if dt is None:
                raise DecodeError(f"unsupported float bit depth {bits}")
            v = np.frombuffer(data, dt).astype(np.float64)
            a = np.clip(np.rint(v * 32767.0), -32768, 32767).astype(np.int16)
            return a.reshape(-1, nch), rate, 2, nch
        if tag == 6:
            return alaw_decode(data).reshape(-1, nch), rate, 2, nch
        if tag == 7:
            return ulaw_decode(data).reshape(-1, nch), rate, 2, nch
        if tag == 0x11:
            out = _ima_decode_wav_data(data, nch, block_align, nframes)
            return out, rate, 2, nch
        raise DecodeError(f"unsupported WAV codec 0x{tag:x}")
    finally:
        if own:
            f.close()


# ---------------------------------------------------------------------------
# AIFF / AIFF-C
# ---------------------------------------------------------------------------

def _read_extended80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (the AIFF sample-rate field)."""
    se, mant_hi, mant_lo = struct.unpack(">HII", b[:10])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    mant = (mant_hi << 32) | mant_lo
    if exp == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


@_malformed_as_decode_error
def read_aiff(file: FileLike) -> Tuple[np.ndarray, int, int, int]:
    """Read AIFF / AIFF-C -> (frames [n, ch], rate, width, nch).

    Compression types: NONE (big-endian PCM 8/16/24/32), sowt
    (little-endian 16), ulaw/ULAW, alaw/ALAW (G.711, decode to int16)."""
    f, own = _open(file)
    try:
        form = f.read(12)
        if len(form) < 12 or form[:4] != b"FORM" \
                or form[8:12] not in (b"AIFF", b"AIFC"):
            raise DecodeError("not an AIFF/AIFF-C file")
        comm = None
        ssnd = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack(">4sI", hdr)
            body = f.read(size)
            if size % 2:
                f.read(1)
            if cid == b"COMM":
                comm = body
            elif cid == b"SSND":
                ssnd = body
        if comm is None or ssnd is None:
            raise DecodeError("AIFF missing COMM/SSND chunk")
        nch, nframes, bits = struct.unpack(">HIH", comm[:8])
        rate = int(round(_read_extended80(comm[8:18])))
        comp = comm[18:22] if len(comm) >= 22 else b"NONE"
        offset, _blk = struct.unpack(">II", ssnd[:8])
        data = ssnd[8 + offset:]
        if comp in (b"NONE", b"twos"):
            if bits == 8:
                a = np.frombuffer(data, np.int8).copy()
                width = 1
            elif bits == 16:
                a = np.frombuffer(data, ">i2").astype(np.int16)
                width = 2
            elif bits == 24:
                b3 = np.frombuffer(data, np.uint8).reshape(-1, 3)
                v = ((b3[:, 0].astype(np.uint32) << 16)
                     | (b3[:, 1].astype(np.uint32) << 8)
                     | b3[:, 2].astype(np.uint32))
                a = (v << 8).astype(np.int32)
                width = 4
            elif bits == 32:
                a = np.frombuffer(data, ">i4").astype(np.int32)
                width = 4
            else:
                raise DecodeError(f"unsupported AIFF bit depth {bits}")
        elif comp == b"sowt":                  # AIFF-C little-endian PCM
            a = np.frombuffer(data, "<i2").astype(np.int16)
            width = 2
        elif comp in (b"ulaw", b"ULAW"):
            a = ulaw_decode(data)
            width = 2
        elif comp in (b"alaw", b"ALAW"):
            a = alaw_decode(data)
            width = 2
        else:
            raise DecodeError(f"unsupported AIFF compression {comp!r}")
        a = a.reshape(-1, nch)
        return a[:nframes] if nframes else a, rate, width, nch
    finally:
        if own:
            f.close()


# ---------------------------------------------------------------------------
# Sun AU / SND
# ---------------------------------------------------------------------------

@_malformed_as_decode_error
def read_au(file: FileLike) -> Tuple[np.ndarray, int, int, int]:
    """Read a Sun .au/.snd file -> (frames [n, ch], rate, width, nch).

    Encodings: 1 u-law, 2 int8, 3 int16-be, 4 int24-be, 5 int32-be,
    27 A-law."""
    f, own = _open(file)
    try:
        hdr = f.read(24)
        if len(hdr) < 24 or hdr[:4] != b".snd":
            raise DecodeError("not a Sun AU file")
        offset, size, enc, rate, nch = struct.unpack(">IIIII", hdr[4:24])
        f.seek(offset)
        data = f.read(size if size != 0xFFFFFFFF else -1)
        if enc == 1:
            a, width = ulaw_decode(data), 2
        elif enc == 2:
            a, width = np.frombuffer(data, np.int8).copy(), 1
        elif enc == 3:
            a, width = np.frombuffer(data, ">i2").astype(np.int16), 2
        elif enc == 4:
            b3 = np.frombuffer(data, np.uint8).reshape(-1, 3)
            v = ((b3[:, 0].astype(np.uint32) << 16)
                 | (b3[:, 1].astype(np.uint32) << 8)
                 | b3[:, 2].astype(np.uint32))
            a, width = (v << 8).astype(np.int32), 4
        elif enc == 5:
            a, width = np.frombuffer(data, ">i4").astype(np.int32), 4
        elif enc == 27:
            a, width = alaw_decode(data), 2
        else:
            raise DecodeError(f"unsupported AU encoding {enc}")
        return a.reshape(-1, nch), rate, width, nch
    finally:
        if own:
            f.close()


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

@_malformed_as_decode_error
def probe_audio_file(filename: str) -> Tuple[int, int, int]:
    """Header-only probe -> (nframes, samplerate, nchannels) WITHOUT
    decoding any audio — the container headers carry everything (library
    indexers want metadata for directories of long files)."""
    with open(filename, "rb") as f:
        magic = f.read(12)
        f.seek(0)
        if magic[:4] == b"RIFF" and magic[8:12] == b"WAVE":
            f.read(12)
            fmt = None
            data_size = 0
            fact = -1
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, size = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    fmt = f.read(size)
                elif cid == b"fact" and size >= 4:
                    fact = struct.unpack("<I", f.read(4))[0]
                    f.seek(size - 4, 1)
                elif cid == b"data":
                    data_size = size
                    f.seek(size, 1)
                else:
                    f.seek(size, 1)
                if size % 2:
                    f.seek(1, 1)
            if fmt is None:
                raise DecodeError("WAV missing fmt chunk")
            (tag, nch, rate, _br, ba,
             bits) = struct.unpack("<HHIIHH", fmt[:16])
            if tag == 0xFFFE and len(fmt) >= 26:
                tag = struct.unpack("<H", fmt[24:26])[0]
            if nch < 1:
                raise DecodeError("WAV with zero channels")
            if fact >= 0:
                return fact, rate, nch
            if tag == 0x11:
                spb = (ba - 4 * nch) // (4 * nch) * 8 + 1
                return (data_size // max(ba, 1)) * spb, rate, nch
            if tag in (6, 7):
                return data_size // nch, rate, nch
            bytes_per_frame = max(nch * max(bits, 8) // 8, 1)
            return data_size // bytes_per_frame, rate, nch
        if magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
            f.read(12)
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, size = struct.unpack(">4sI", hdr)
                if cid == b"COMM":
                    body = f.read(size)
                    nch, nframes, _bits = struct.unpack(">HIH", body[:8])
                    rate = int(round(_read_extended80(body[8:18])))
                    return nframes, rate, nch
                f.seek(size + (size % 2), 1)
            raise DecodeError("AIFF missing COMM chunk")
        if magic[:4] == b".snd":
            hdr = f.read(24)
            _off, size, enc, rate, nch = struct.unpack(">IIIII", hdr[4:24])
            bpf = {1: 1, 2: 1, 3: 2, 4: 3, 5: 4, 27: 1}.get(enc)
            if bpf is None:
                raise DecodeError(f"unsupported AU encoding {enc}")
            if size == 0xFFFFFFFF:
                import os
                size = max(os.fstat(f.fileno()).st_size - _off, 0)
            return size // (bpf * max(nch, 1)), rate, nch
        if magic[:4] == b"fLaC":
            from .flac import FlacError, probe_flac
            try:
                return probe_flac(filename)
            except FlacError as e:
                raise DecodeError(str(e)) from e
        from . import codecs
        if codecs.looks_like_ogg(magic):
            try:
                return codecs.probe_vorbis(filename)
            except codecs.CodecError as first:
                try:
                    return codecs.probe_opus(filename)
                except codecs.CodecError:
                    raise DecodeError(str(first)) from first
        if codecs.looks_like_mpeg(magic):
            try:
                return codecs.probe_mpeg(filename)
            except codecs.CodecError as e:
                raise DecodeError(str(e)) from e
        from . import modules
        f.seek(0)
        header = f.read(1084)
        if modules.looks_like_module(header):
            try:
                return modules.probe_module(filename)
            except modules.ModuleError as e:
                raise DecodeError(str(e)) from e
    from . import libav
    if libav.have_libav():
        # universal catch-all: anything the host's libavformat knows
        try:
            return libav.probe_libav(filename)
        except libav.LibavError as e:
            raise DecodeError(str(e)) from e
    raise DecodeError(f"cannot probe {filename!r} (magic {magic[:4]!r})")


def decode_audio_file(filename: str) -> Tuple[np.ndarray, int, int, int]:
    """Decode a file by magic bytes (extension-agnostic) -> (frames
    [n, ch], rate, width, nch).  Our own parsers and direct codec
    bindings take the known formats; anything else goes to the libav
    catch-all rung (utils/libav.py) when the host has the ffmpeg
    shared libraries.  Raises DecodeError only when no rung applies."""
    with open(filename, "rb") as f:
        magic = f.read(12)
    if magic[:4] == b"RIFF" and magic[8:12] == b"WAVE":
        return read_wav_any(filename)
    if magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        return read_aiff(filename)
    if magic[:4] == b".snd":
        return read_au(filename)
    if magic[:4] == b"fLaC":
        from .flac import FlacError, read_flac
        try:
            return read_flac(filename)
        except FlacError as e:
            raise DecodeError(str(e)) from e
    from . import codecs
    if codecs.looks_like_ogg(magic):
        # Ogg container: Vorbis via libvorbisfile, Opus via libopus +
        # our libogg demux; other payloads (theora...) -> ffmpeg ladder
        try:
            return codecs.read_vorbis(filename)
        except codecs.CodecError as first:
            try:
                return codecs.read_opus(filename)
            except codecs.CodecError:
                raise DecodeError(str(first)) from first
    if codecs.looks_like_mpeg(magic):
        # MPEG audio (mp3/mp2/mp1, ID3-tagged or raw) via libmpg123
        try:
            return codecs.read_mpeg(filename)
        except codecs.CodecError as e:
            raise DecodeError(str(e)) from e
    from . import modules
    with open(filename, "rb") as f:
        header = f.read(1084)          # MOD magic sits at offset 1080
    if modules.looks_like_module(header):
        # tracker modules render through the system libopenmpt
        try:
            return modules.read_module(filename)
        except modules.ModuleError as e:
            raise DecodeError(str(e)) from e
    from . import libav
    if libav.have_libav():
        # universal catch-all (m4a/aac, wma, mka/webm, ...): the C shim
        # over the host's own libavformat/libavcodec
        try:
            return libav.read_with_libav(filename)
        except libav.LibavError as e:
            raise DecodeError(str(e)) from e
    raise DecodeError(f"cannot decode {filename!r} in-process "
                      f"(magic {magic[:4]!r})")
