"""The port's host codecs (``synthesizer_tpu_torch.utils``: decoders, flac,
codecs, libav, soxr, native, profiling) and the ``Sample`` writers, held
against the JAX package's on the CPU.

Tolerances: every decoder returns the reference's arrays exactly (the
formats are integer-specified); every writer gives the reference's bytes
(the encoders are deterministic), and FLAC reads back bit-exact.  The lossy
writers skip where their system library is missing, as the reference's
tests do.
"""

import io
import os
import struct
import wave

import numpy as np
import pytest
import torch

import synthesizer_tpu as J
import synthesizer_tpu_torch as T
from synthesizer_tpu.utils import decoders as jdec
from synthesizer_tpu.utils import flac as jflac
from synthesizer_tpu.utils import native as jnative
from synthesizer_tpu.utils import wavio as jwavio
from synthesizer_tpu_torch.utils import codecs as tcodecs
from synthesizer_tpu_torch.utils import decoders as tdec
from synthesizer_tpu_torch.utils import flac as tflac
from synthesizer_tpu_torch.utils import libav as tlibav
from synthesizer_tpu_torch.utils import native as tnative
from synthesizer_tpu_torch.utils import profiling, soxr, wavio

SR = 22050

needs_mpeg = pytest.mark.skipif(
    not (tcodecs.have_mpg123() and tcodecs.have_lame()),
    reason="libmpg123/libmp3lame not installed")
needs_vorbis = pytest.mark.skipif(
    not (tcodecs.have_vorbisfile() and tcodecs.have_vorbisenc()),
    reason="libvorbis*/libogg not installed")
needs_opus = pytest.mark.skipif(not tcodecs.have_opus(),
                                reason="libopus/libogg not installed")
needs_libav = pytest.mark.skipif(not tlibav.have_libav(),
                                 reason="libav (ffmpeg libraries) not installed")


def tone(n=2000, nch=2, amp=12000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = np.sin(2 * np.pi * 220.0 * t / SR) * amp + rng.normal(0, 200, n)
    return np.ascontiguousarray(
        np.rint(np.stack([base, -0.7 * base][:nch], axis=1))).astype(np.int16)


def _ext80(rate):
    m, e = int(rate), 0
    while m < (1 << 63):
        m <<= 1
        e += 1
    return struct.pack(">HII", 16383 + 63 - e, m >> 32, m & 0xFFFFFFFF)


def _aiff(x, kind=b"AIFF", comp=b""):
    data = x.astype("<i2" if comp == b"sowt" else ">i2").tobytes()
    comm = struct.pack(">HIH", x.shape[1], len(x), 16) + _ext80(SR)
    if kind == b"AIFC":
        comm += comp + b"\x00"
        comm += b"\x00" * (len(comm) % 2)
    ssnd = struct.pack(">II", 0, 0) + data
    body = (kind + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    return b"FORM" + struct.pack(">I", len(body)) + body


def _au(payload, encoding, nch):
    return (struct.pack(">4sIIIII", b".snd", 24, len(payload), encoding,
                        SR, nch) + payload)


def _wav(tag, nch, bits, block_align, data, nframes=None):
    fmt = struct.pack("<HHIIHH", tag, nch, SR, SR * block_align,
                      block_align, bits)
    if tag == 0x11:
        fmt += struct.pack("<HH", 2, (block_align - 4 * nch) * 2 // nch + 1)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if nframes is not None:
        chunks += b"fact" + struct.pack("<II", 4, nframes)
    chunks += b"data" + struct.pack("<I", len(data)) + data
    chunks += b"\x00" * (len(data) % 2)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _ima(rng, nblocks=5, block_align=256):
    """Random IMA-ADPCM blocks (mono): any nibble stream is valid input."""
    out = b""
    for _ in range(nblocks):
        out += struct.pack("<hBB", int(rng.integers(-20000, 20000)),
                           int(rng.integers(0, 89)), 0)
        out += rng.integers(0, 256, block_align - 4, dtype=np.uint8).tobytes()
    return out


def _flac(x):
    bio = io.BytesIO()
    tflac.write_flac(bio, x, SR, 2, x.shape[1])
    return bio.getvalue()


def _pcm24(x):
    v = (x.astype(np.int32) * 256 + 17).reshape(-1)
    b = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], 1).astype(np.uint8)
    return _wav(1, x.shape[1], 24, 3 * x.shape[1], b.tobytes())


#: name -> (extension, file bytes from a seeded generator)
FORMATS = {
    "aiff_pcm16": (".aiff", lambda r: _aiff(tone())),
    "aifc_sowt": (".aifc", lambda r: _aiff(tone(nch=1), b"AIFC", b"sowt")),
    "au_pcm16": (".au", lambda r: _au(tone().astype(">i2").tobytes(), 3, 2)),
    "au_ulaw": (".au", lambda r: _au(r.integers(0, 256, 3000, dtype=np.uint8)
                                     .tobytes(), 1, 1)),
    "wav_ulaw": (".wav", lambda r: _wav(7, 1, 8, 1, r.integers(
        0, 256, 3001, dtype=np.uint8).tobytes())),
    "wav_alaw": (".wav", lambda r: _wav(6, 2, 8, 2, r.integers(
        0, 256, 3000, dtype=np.uint8).tobytes())),
    "wav_float32": (".wav", lambda r: _wav(3, 2, 32, 8, (
        tone() / 30000.0).astype("<f4").tobytes())),
    "wav_ima_adpcm": (".wav", lambda r: _wav(0x11, 1, 4, 256, _ima(r),
                                             nframes=2400)),
    "wav_pcm24": (".wav", lambda r: _pcm24(tone())),
    "flac": (".flac", lambda r: _flac(tone(3000))),
}


def _outcome(fn, arg):
    try:
        return fn(arg)
    except Exception as e:          # the reference's failure, compared
        return e


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_decoders_match_the_reference(fmt, tmp_path):
    """decode_audio_file, the port's read_wav on a path and on a file
    object, and Sample(wave_file=) give the reference's arrays exactly."""
    ext, make = FORMATS[fmt]
    p = str(tmp_path / f"x{ext}")
    with open(p, "wb") as f:
        f.write(make(np.random.default_rng(7)))
    want = jdec.decode_audio_file(p)
    got = tdec.decode_audio_file(p)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])
    for as_file in (False, True):
        r_got, r_want = (_outcome(mod.read_wav, open(p, "rb") if as_file
                                  else p) for mod in (wavio, jwavio))
        if isinstance(r_want, tuple):
            assert r_got[1:] == r_want[1:]
            np.testing.assert_array_equal(r_got[0], r_want[0])
        else:      # a FLAC file object: neither package sniffs it there
            assert (type(r_got).__name__, str(r_got)) == \
                (type(r_want).__name__, str(r_want))
    smp = T.Sample(wave_file=p, device="cpu")
    np.testing.assert_array_equal(smp.get_frame_array(),
                                  J.Sample(wave_file=p).get_frame_array())


@pytest.mark.parametrize("ext,make", [
    (".aiff", lambda: _aiff(tone())),
    (".au", lambda: _au(tone().astype(">i2").tobytes(), 3, 2)),
    (".wav", lambda: _wav(7, 1, 8, 1, bytes(range(256)) * 4))])
def test_read_wav_reads_aiff_au_and_ulaw(ext, make, tmp_path):
    """The fault this slice closes: read_wav no longer lets wave.Error out
    for AIFF, AU and u-law WAV files."""
    p = str(tmp_path / f"x{ext}")
    with open(p, "wb") as f:
        f.write(make())
    with pytest.raises(wave.Error):
        wave.open(p, "rb")
    frames, rate, width, nch = wavio.read_wav(p)
    assert rate == SR and width == 2 and frames.shape[1] == nch > 0
    assert len(frames) > 0 and np.abs(frames.astype(np.int64)).max() > 0


def _sample(K, n=4000, nch=2, width=2, sr=44100, **kw):
    a = tone(n, nch)
    if width == 4:
        a = a.astype(np.int32) * 65536 + 123
    elif width == 1:
        a = (a // 256).astype(np.int8)
    return K.Sample.from_raw_frames(a.tobytes(), width, sr, nch, **kw)


#: format -> (writer name, marker, decoder of the port)
WRITERS = {
    "flac": ("write_flac", lambda f: f, lambda p: tflac.read_flac(p)),
    "mp3": ("write_mp3", needs_mpeg, tcodecs.read_mpeg),
    "ogg": ("write_ogg", needs_vorbis, tcodecs.read_vorbis),
    "opus": ("write_opus", needs_opus, tcodecs.read_opus),
    "m4a": ("write_m4a", needs_libav, tlibav.read_with_libav),
}


@pytest.mark.parametrize("fmt", [
    pytest.param(f, marks=() if f == "flac" else (WRITERS[f][1],))
    for f in WRITERS])
def test_writer_gives_the_reference_bytes_and_reads_back(fmt, tmp_path):
    """Each compressed writer of the port's Sample writes the bytes the
    reference's writes for the same frames (a 24-bit-wide sample at
    22050 Hz, so the width conversion and the opus resample to 48 kHz are
    on the path), leaves the sample untouched, and its file reads back:
    FLAC bit-exact, the lossy formats at the written rate and shape."""
    name, _, read = WRITERS[fmt]
    ts = _sample(T, 3000, width=4, sr=SR, device="cpu")
    js = _sample(J, 3000, width=4, sr=SR)
    before = np.array(ts.get_frame_array())
    pt, pj = str(tmp_path / f"t.{fmt}"), str(tmp_path / f"j.{fmt}")
    assert getattr(ts, name)(pt) is ts
    getattr(js, name)(pj)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(ts.get_frame_array(), before)
    frames, rate, width, nch = read(pt)
    assert nch == 2 and frames.shape[1] == 2
    if fmt == "flac":
        assert (rate, width) == (SR, 4)
        np.testing.assert_array_equal(frames, before)
    else:
        assert rate == (48000 if fmt == "opus" else SR) and len(frames) > 0


def test_write_audio_dispatches_by_extension(tmp_path):
    """write_audio picks the writer by extension (case-insensitive) and
    falls back to WAV, for a path, a PathLike and a file object."""
    ts = _sample(T, 2000, sr=44100, device="cpu")
    magic = {".flac": b"fLaC", ".FLAC": b"fLaC", ".wav": b"RIFF",
             ".mp3": (b"ID3", b"\xff\xfb"), ".ogg": b"OggS", ".oga": b"OggS",
             ".opus": b"OggS", ".m4a": b"\x00\x00\x00", ".aac": b"\xff\xf1",
             ".xyz": b"RIFF"}
    need = {".mp3": tcodecs.have_lame(), ".ogg": tcodecs.have_vorbisenc(),
            ".oga": tcodecs.have_vorbisenc(), ".opus": tcodecs.have_opus(),
            ".m4a": tlibav.have_libav(), ".aac": tlibav.have_libav()}
    for ext, want in magic.items():
        if not need.get(ext, True):
            continue
        p = tmp_path / f"x{ext}"
        assert ts.write_audio(p) is ts
        head = p.read_bytes()[:4]
        assert head.startswith(want if isinstance(want, tuple) else (want,)), ext
    bio = io.BytesIO()
    ts.write_audio(bio)
    assert bio.getvalue()[:4] == b"RIFF"
    jb = io.BytesIO()
    _sample(J, 2000, sr=44100).write_wav(jb)
    assert bio.getvalue() == jb.getvalue()


def test_native_libraries_build_into_the_build_directory(tmp_path,
                                                         monkeypatch):
    """build_shared compiles native/<name>.c into build/native/ (never
    next to the source), and the pcmops bindings equal the reference's and
    their own numpy fallbacks."""
    if not tnative.available():
        pytest.skip("no C compiler: the numpy fallbacks are tested below")
    so = tnative.build_shared("pcmops", ["-O3", "-std=c11"], ["-lm"])
    assert so == os.path.join(tnative.BUILD_DIR, "libpcmops.so")
    assert os.path.isfile(so)
    rng = np.random.default_rng(3)
    bufs = [rng.integers(-32768, 32768, (1470, 2)).astype(np.int16)
            for _ in range(4)]
    got = tnative.mix_k_i16(bufs)
    np.testing.assert_array_equal(got, jnative.mix_k_i16(bufs))
    args = [(tnative.sat_add_i16, jnative.sat_add_i16, bufs[:2]),
            (tnative.mul_floor_i16, jnative.mul_floor_i16, (bufs[0], 0.37)),
            (tnative.vu_i16, jnative.vu_i16, (bufs[1],))]
    native_out = [f(*a) for f, _, a in args]
    for (f, g, a), out in zip(args, native_out):
        assert np.array_equal(np.asarray(out), np.asarray(g(*a)))
    monkeypatch.setattr(tnative, "_load", lambda: None)
    np.testing.assert_array_equal(tnative.mix_k_i16(bufs), got)
    for (f, _, a), out in zip(args, native_out):
        np.testing.assert_allclose(np.asarray(f(*a), np.float64),
                                   np.asarray(out, np.float64), rtol=1e-12)


def test_flac_native_and_python_twins_agree():
    """The FLAC decoder's native hot loop (built into build/native/) and its
    pure-Python twin give the same samples as the reference's decoder."""
    x = tone(5000)
    blob = _flac(x)
    jb = io.BytesIO()
    jflac.write_flac(jb, x, SR, 2, 2)
    assert blob == jb.getvalue()
    frames = tflac.read_flac(io.BytesIO(blob))[0]
    np.testing.assert_array_equal(frames, x)
    lib, tried = tflac._lib, tflac._tried
    try:
        tflac._lib, tflac._tried = None, True
        np.testing.assert_array_equal(tflac.read_flac(io.BytesIO(blob))[0], x)
    finally:
        tflac._lib, tflac._tried = lib, tried


@pytest.mark.skipif(not soxr.have_soxr(), reason="libsoxr not installed")
def test_soxr_matches_the_reference():
    from synthesizer_tpu.utils import soxr as jsoxr
    x = tone(4000)
    np.testing.assert_array_equal(soxr.soxr_resample(x, SR, 44100),
                                  jsoxr.soxr_resample(x, SR, 44100))


def test_profiling_counts_kernel_launches_and_traces(tmp_path):
    """count_program_launches counts the hand-written kernels' launches
    (here a stand-in increments the counters, as the wrappers do on the
    card); RenderTimer and timed_stream keep the reference's arithmetic;
    trace writes a Chrome trace."""
    from synthesizer_tpu.utils import profiling as jprof
    from synthesizer_tpu_torch.ops import kernels as K
    saved = K.voice_setup.launches, K.render_stereo.launches
    try:
        with profiling.count_program_launches() as n:
            K.voice_setup.launches += 1
            K.render_stereo.launches += 2
    finally:
        K.voice_setup.launches, K.render_stereo.launches = saved
    assert n == [3]
    t, jt = profiling.RenderTimer(44100), jprof.RenderTimer(44100)
    for timer in (t, jt):
        with timer.chunk(1470):
            pass
    assert t.stats.chunks == jt.stats.chunks == 1
    assert t.stats.audio_seconds == jt.stats.audio_seconds
    smp = [_sample(T, 1470, device="cpu") for _ in range(3)]
    gen, timer = profiling.timed_stream(iter(smp), 44100)
    assert len(list(gen)) == 3 and timer.stats.chunks == 3
    with profiling.trace(str(tmp_path)):
        torch.ones(8) + 1
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_tracker_kit_writes_the_snare_as_aiff(tmp_path):
    """bench_song.make_tracker_kit writes snare.aiff as the reference's
    example does, its song text (verbatim) names it, and the song loads it
    through the decoders: the same frames as the reference's AIFF reader
    gives."""
    from synthesizer_tpu_torch import bench_song
    from synthesizer_tpu_torch.sequencer import Song
    ini = bench_song.make_tracker_kit(str(tmp_path), device="cpu")
    assert "snare = snare.aiff" in bench_song.TRACKER_INI
    assert not (tmp_path / "snare.wav").exists()
    p = str(tmp_path / "snare.aiff")
    assert open(p, "rb").read(4) == b"FORM"
    want, rate, width, nch = jdec.read_aiff(p)
    assert (rate, width, nch) == (44100, 2, 2) and len(want) > 0
    song = Song.from_ini(ini, device="cpu")
    got = song.instruments["snare"]
    np.testing.assert_array_equal(got.get_frame_array(), want)
