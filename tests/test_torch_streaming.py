"""The port's streaming layer (``synthesizer_tpu_torch.streaming``) against
``synthesizer_tpu.streaming`` on the CPU.

Tolerances: ``RateConvertFilter`` linear is bit-exact (the exact ratecv),
hq within 1 LSB (the windowed-sinc sums in f32), with the flushed tail and
across a mid-stream format change; ``VolumeFilter``, ``StreamMixer``,
``SampleStream``, ``EndlessFramesFilter`` and ``AudiofileToWavStream`` are
bit-exact (integer ops and the f32 gain of ``amplify``).
"""

import io
import struct

import numpy as np
import pytest
import torch

import synthesizer_tpu as J
import synthesizer_tpu_torch as T
from synthesizer_tpu import streaming as JS
from synthesizer_tpu_torch import streaming as TS

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def _frames(n, nch=2, seed=0, sr=44100):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    base = np.sin(2 * np.pi * 330.0 * t) * 14000 + rng.normal(0, 900, n)
    cols = [base, np.roll(base, 17) * -0.8][:nch]
    return np.clip(np.rint(np.stack(cols, 1)), -32768, 32767).astype(np.int16)


def _chunks(K, a, sizes, sr, **kw):
    """Samples of ``a`` cut at the given chunk sizes (cycled)."""
    out, i, k = [], 0, 0
    while i < len(a):
        n = sizes[k % len(sizes)]
        out.append(K.Sample.from_raw_frames(a[i:i + n].tobytes(), 2, sr,
                                            a.shape[1], **kw))
        i, k = i + n, k + 1
    return out


def _join(samples):
    return np.concatenate([np.asarray(s.get_frame_array()) for s in samples])


def _lsb(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
        if a.size else 0


@pytest.mark.parametrize("quality,chunk,n", [
    ("linear", 1, 500), ("linear", 7, 3000), ("linear", 1470, 9000),
    ("hq", 7, 2000), ("hq", 1470, 9000)])
def test_rate_convert_filter_matches_jax(quality, chunk, n):
    """44100 -> 48000 streamed: linear bit-exact, hq within 1 LSB including
    the flushed filter tail; the output lengths are equal and equal the
    offline resample's."""
    a = _frames(n)
    got = list(TS.RateConvertFilter(iter(_chunks(T, a, [chunk], 44100, **CPU)),
                                    48000, quality))
    want = list(JS.RateConvertFilter(iter(_chunks(J, a, [chunk], 44100)),
                                     48000, quality))
    assert all(s.samplerate == 48000 for s in got)
    g, w = _join(got), _join(want)
    assert _lsb(g, w) <= (0 if quality == "linear" else 1)
    whole = T.Sample.from_raw_frames(a.tobytes(), 2, 44100, 2, **CPU)
    whole.resample(48000, quality=quality)
    assert len(g) == whole.nframes
    if quality == "linear":
        np.testing.assert_array_equal(g, whole.get_frame_array())


@pytest.mark.parametrize("quality", ["linear", "hq"])
def test_rate_convert_filter_format_change(quality):
    """A stream that changes rate (22050, then 32000, then the target
    44100, then 22050 again) flushes the active resampler's tail before
    the next segment and passes target-rate chunks through."""
    segs = [(22050, _frames(1500, seed=1, sr=22050), [400]),
            (32000, _frames(1700, seed=2, sr=32000), [333]),
            (44100, _frames(900, seed=3), [450]),
            (22050, _frames(800, seed=4, sr=22050), [128])]

    def stream(K, **kw):
        out = []
        for sr, a, sizes in segs:
            out += _chunks(K, a, sizes, sr, **kw)
        return out
    got = list(TS.RateConvertFilter(iter(stream(T, **CPU)), 44100, quality))
    want = list(JS.RateConvertFilter(iter(stream(J)), 44100, quality))
    assert [s.nframes for s in got] == [s.nframes for s in want]
    assert _lsb(_join(got), _join(want)) <= (0 if quality == "linear" else 1)


def test_volume_filter_and_stream_mixer_match_jax():
    """Two decks (one with a volume, one endless and shorter) mixed into
    chunks of 1000 frames: bit-exact chunks and timestamps, the endless
    deck's silence included, and a mixer with no stream yields silence."""
    a, b = _frames(4500, seed=5), _frames(2300, seed=6)

    def run(M, K, **kw):
        mixer = M.StreamMixer(frames_per_chunk=1000, **kw)
        mixer.add_stream(M.VolumeFilter(iter(_chunks(K, a, [1000], 44100,
                                                     **kw)), 0.63))
        mixer.add_stream(iter(_chunks(K, b, [700, 300], 44100, **kw)),
                         endless=True)
        out = []
        for ts, chunk in mixer:
            out.append((ts, np.asarray(chunk.get_frame_array())))
            if len(out) == 7:
                break
        return out
    got, want = run(TS, T, **CPU), run(JS, J)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    empty = TS.StreamMixer(endless=True, frames_per_chunk=500, **CPU)
    ts, chunk = next(iter(empty))
    assert ts == 0.0 and chunk.nframes == 500 and chunk.device.type == "cpu"
    assert not np.any(chunk.get_frame_array())


def test_sample_stream_and_endless_filter(tmp_path):
    a = _frames(3100, nch=1)
    p = str(tmp_path / "m.wav")
    T.Sample.from_raw_frames(a.tobytes(), 2, 44100, 1, **CPU).write_wav(p)
    with TS.SampleStream(p, frames_per_chunk=1000, **CPU) as s:
        chunks = list(s)
    with JS.SampleStream(p, frames_per_chunk=1000) as s:
        jchunks = list(s)
    assert [c.nframes for c in chunks] == [c.nframes for c in jchunks]
    np.testing.assert_array_equal(_join(chunks), _join(jchunks))
    assert all(c.device.type == "cpu" for c in chunks)
    endless = TS.EndlessFramesFilter(TS.SampleStream(p, 1000, **CPU))
    jendless = JS.EndlessFramesFilter(JS.SampleStream(p, 1000))
    got = [next(endless) for _ in range(6)]
    want = [next(jendless) for _ in range(6)]
    assert [c.nframes for c in got] == [c.nframes for c in want] == \
        [1000, 1000, 1000, 100, 1470, 1470]
    np.testing.assert_array_equal(_join(got), _join(want))
    assert not np.any(got[5].get_frame_array()) and got[5].nchannels == 1
    assert got[5].device.type == "cpu"


def _ext80(rate):
    m, e = int(rate), 0
    while m < (1 << 63):
        m <<= 1
        e += 1
    return struct.pack(">HII", 16383 + 63 - e, m >> 32, m & 0xFFFFFFFF)


def _write_inputs(d):
    """A WAV at the target format, a mono 22050 Hz WAV, an AIFF, a u-law
    WAV and a FLAC -> {name: path}."""
    a = _frames(4000)
    paths = {}
    T.Sample.from_raw_frames(a.tobytes(), 2, 44100, 2, **CPU).write_wav(
        str(d / "pass.wav"))
    paths["passthrough"] = str(d / "pass.wav")
    m = _frames(3000, nch=1, sr=22050)
    T.Sample.from_raw_frames(m.tobytes(), 2, 22050, 1, **CPU).write_wav(
        str(d / "mono.wav"))
    paths["convert"] = str(d / "mono.wav")
    data = a.astype(">i2").tobytes()
    comm = struct.pack(">HIH", 2, len(a), 16) + _ext80(32000)
    ssnd = struct.pack(">II", 0, 0) + data
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    (d / "x.aiff").write_bytes(b"FORM" + struct.pack(">I", len(body)) + body)
    paths["aiff"] = str(d / "x.aiff")
    codes = np.random.default_rng(9).integers(0, 256, 2500, dtype=np.uint8)
    fmt = struct.pack("<HHIIHH", 7, 1, 8000, 8000, 1, 8)
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
              + struct.pack("<I", len(codes)) + codes.tobytes())
    (d / "u.wav").write_bytes(b"RIFF" + struct.pack("<I", 4 + len(chunks))
                              + b"WAVE" + chunks)
    paths["ulaw"] = str(d / "u.wav")
    T.Sample.from_raw_frames(a.tobytes(), 2, 48000, 2, **CPU).write_flac(
        str(d / "x.flac"))
    paths["flac"] = str(d / "x.flac")
    return paths


@pytest.mark.parametrize("kw", [{}, {"startfrom": 0.01, "duration": 0.03},
                                {"samplerate": 22050, "nchannels": 1}])
def test_audiofile_to_wav_stream_gives_the_reference_bytes(kw, tmp_path):
    """Every in-process rung (pass-through WAV, WAV convert, AIFF, u-law
    WAV, FLAC), with and without a clip and at another target format,
    streams the reference's WAV bytes."""
    for name, p in _write_inputs(tmp_path).items():
        with TS.AudiofileToWavStream(p, **kw, **CPU) as s:
            got = s.read()
        with JS.AudiofileToWavStream(p, **kw) as s:
            want = s.read()
        assert got == want, name
        assert got[:4] == b"RIFF"


def test_streams_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    p = str(tmp_path / "x.wav")
    T.Sample.from_raw_frames(_frames(100).tobytes(), 2, 44100, 2,
                             **CPU).write_wav(p)
    for call in (lambda: TS.SampleStream(p),
                 lambda: TS.AudiofileToWavStream(p),
                 lambda: TS.StreamMixer()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    bio = io.BytesIO(open(p, "rb").read())
    assert next(iter(TS.SampleStream(bio, **CPU))).nframes == 100
