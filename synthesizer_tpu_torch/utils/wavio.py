"""WAV (RIFF) file I/O (copied from ``synthesizer_tpu.utils.wavio``).

Host-side and numpy-only: audio comes from / goes to device tensors, the
RIFF container handling stays on host.  8-bit WAV is unsigned on disk and
signed int8 in memory (audioop convention), so width-1 data is rebiased
here.  What the stdlib ``wave`` parser rejects (u-law, A-law, IMA-ADPCM
and float WAVs, AIFF and AU files) falls through to the in-process
decoders (``utils.decoders``).
"""

from __future__ import annotations

import io
import wave
from typing import BinaryIO, Tuple, Union

import numpy as np

_DTYPES = {1: np.int8, 2: np.int16, 4: np.int32}

FileLike = Union[str, BinaryIO]


def read_wav(file: FileLike) -> Tuple[np.ndarray, int, int, int]:
    """Read a WAV file -> (frames [n, nch] signed int array, rate, width, nch).

    PCM WAVs go through the stdlib ``wave`` parser; anything it rejects
    (u-law/A-law/IMA-ADPCM/float WAVs, and AIFF/AU files handed to the
    Sample loader) falls through to the in-process decoders."""
    try:
        w = wave.open(file, "rb")
    except (wave.Error, EOFError):
        from . import decoders
        if isinstance(file, str):
            return decoders.decode_audio_file(file)
        file.seek(0)
        magic = file.read(12)
        file.seek(0)
        if magic[:4] == b"FORM":
            return decoders.read_aiff(file)
        if magic[:4] == b".snd":
            return decoders.read_au(file)
        return decoders.read_wav_any(file)
    with w:
        nch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
    if width == 3:
        # unpack 24-bit to int32 (values scaled: low byte zero, like lin2lin 3->4)
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = (b[:, 0].astype(np.uint32) | (b[:, 1].astype(np.uint32) << 8)
             | (b[:, 2].astype(np.uint32) << 16))
        a = (v << 8).astype(np.int32)  # sign via shift into the top byte
        width = 4
    elif width in _DTYPES:
        a = np.frombuffer(raw, dtype=np.dtype(_DTYPES[width]).newbyteorder("<")).copy()
        if width == 1:
            # 8-bit WAV is unsigned on disk
            a = (np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128).astype(np.int8)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return a.reshape(-1, nch), rate, width, nch


def write_wav(file: FileLike, frames: np.ndarray, samplerate: int,
              samplewidth: int, nchannels: int) -> None:
    """Write signed int frames [n, nch] (or flat) to a 44-byte-header WAV."""
    frames = np.asarray(frames)
    a = frames.reshape(-1).astype(_DTYPES[samplewidth], copy=False)
    if samplewidth == 1:
        raw = (a.astype(np.int16) + 128).astype(np.uint8).tobytes()
    else:
        raw = a.astype(np.dtype(_DTYPES[samplewidth]).newbyteorder("<"), copy=False).tobytes()
    with wave.open(file, "wb") as w:
        w.setnchannels(nchannels)
        w.setsampwidth(samplewidth)
        w.setframerate(samplerate)
        w.writeframes(raw)


def wav_bytes(frames: np.ndarray, samplerate: int, samplewidth: int,
              nchannels: int) -> bytes:
    """Render a complete in-memory WAV file."""
    bio = io.BytesIO()
    write_wav(bio, frames, samplerate, samplewidth, nchannels)
    return bio.getvalue()
