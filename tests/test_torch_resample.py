"""The port's resamplers (``synthesizer_tpu_torch.ops.resample``) against
the JAX package and the oracles, on the CPU.

* ratecv: bit-exact to ``synthesizer_tpu.ops.resample.resample`` and to
  ``goldref.pcm.ratecv`` (audioop's recurrence) at widths 1, 2 and 4 over
  rate pairs that include the ones the JAX package sends down its wide
  limb-division path, whole and with carried state;
* streaming == whole, bit for bit, for both resamplers at every chunk size;
* hq: within 1 LSB of ``goldref.effects.hq_resample`` (the f64 oracle) and
  of the JAX package's ``hq_resample``;
* ``bounded_ratio`` equal to the JAX package's.
"""

import math

import numpy as np
import pytest
import torch

import goldref.effects as gfx
import goldref.pcm as gpcm
import goldref.sample as gs
from synthesizer_tpu.ops import resample as JR
from synthesizer_tpu_torch import Sample
from synthesizer_tpu_torch.ops import resample as TR

NPDT = {1: np.int8, 2: np.int16, 4: np.int32}
TDT = {1: torch.int8, 2: torch.int16, 4: torch.int32}
#: (inrate, outrate): common pairs, a pure factor of 2 each way, a deep
#: ratio, and reduced rates past the JAX package's collapsed-division
#: bounds (44100 -> 44101 is 44101/44100 irreducible; 7 and 96000 force
#: a tiny input rate; 65537 passes 2^16 at width 2)
PAIRS = [(44100, 48000), (48000, 44100), (22050, 44100), (44100, 22050),
         (8000, 44100), (44100, 44101), (96000, 7), (44100, 65537)]


def _pcm(n, width, nch=2, seed=0):
    rng = np.random.default_rng(seed)
    hi = (1 << (8 * width - 1)) - 1
    x = rng.integers(-hi - 1, hi + 1, size=(n, nch)).astype(NPDT[width])
    ext = [[hi, hi], [-hi - 1, -hi - 1], [hi, -hi - 1], [-hi - 1, hi]]
    x[:4] = ext[:n]
    return x


@pytest.mark.parametrize("inr,outr", PAIRS)
@pytest.mark.parametrize("width", [1, 2, 4])
def test_ratecv_bit_exact(width, inr, outr):
    x = _pcm(997, width, seed=width)
    y, st = TR.resample(x, inr, outr, device="cpu")
    gy, gst = gpcm.ratecv(x.tobytes(), width, 2, inr, outr, None)
    np.testing.assert_array_equal(y, np.frombuffer(gy, NPDT[width])
                                  .reshape(-1, 2))
    assert st.to_audioop(width) == gst
    jy, jst = JR.resample(x, inr, outr)
    np.testing.assert_array_equal(y, jy)
    assert (st.d, list(st.prev), list(st.cur)) == \
           (jst.d, list(jst.prev), list(jst.cur))
    # the same signal as a tensor stays a tensor, with the same bits
    yt = TR.resample_tensor(torch.from_numpy(x), inr, outr)
    assert yt.dtype == TDT[width]
    np.testing.assert_array_equal(yt.numpy(), y)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_ratecv_carried_state(width):
    """Chunks with the carried (d, prev, cur) == the whole buffer, and a
    state handed in from audioop's domain gives audioop's continuation."""
    x = _pcm(1200, width, seed=10 + width)
    for inr, outr in ((44100, 48000), (48000, 44100), (44100, 44101)):
        whole, _ = TR.resample(x, inr, outr, device="cpu")
        out, st = [], None
        for i in range(0, len(x), 113):
            y, st = TR.resample(x[i:i + 113], inr, outr, st, device="cpu")
            out.append(y)
        np.testing.assert_array_equal(np.concatenate(out), whole)
        gst = None
        gout = []
        for i in range(0, len(x), 113):
            gy, gst = gpcm.ratecv(x[i:i + 113].tobytes(), width, 2, inr,
                                  outr, gst)
            gout.append(np.frombuffer(gy, NPDT[width]).reshape(-1, 2))
        np.testing.assert_array_equal(np.concatenate(gout), whole)
        assert st.to_audioop(width) == gst


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("chunk", [1, 7, 160, 997])
def test_streaming_ratecv_equals_whole(width, chunk):
    x = _pcm(2000, width, seed=20 + width)
    for inr, outr in ((44100, 48000), (22050, 44100), (44100, 44101)):
        whole, _ = TR.resample(x, inr, outr, device="cpu")
        rs = TR.StreamingResampler(inr, outr, 2, dtype=TDT[width],
                                   device="cpu")
        out = []
        for i in range(0, len(x), chunk):
            y, n = rs.push(torch.from_numpy(x[i:i + chunk]))
            assert n == y.shape[0] <= rs.max_out(len(x[i:i + chunk]))
            out.append(y.numpy())
        np.testing.assert_array_equal(np.concatenate(out), whole)


def test_ratecv_edges():
    x = _pcm(1, 2)
    y, st = TR.resample(x, 44100, 48000, device="cpu")
    gy, gst = gpcm.ratecv(x.tobytes(), 2, 2, 44100, 48000, None)
    assert y.tobytes() == gy and st.to_audioop(2) == gst
    y, st = TR.resample(x[:0], 44100, 48000, device="cpu")
    assert y.shape == (0, 2) and st.d == -160
    mono = _pcm(500, 2)[:, 0]
    y, _ = TR.resample(mono, 48000, 44100, device="cpu")
    gy, _ = gpcm.ratecv(mono.tobytes(), 2, 1, 48000, 44100, None)
    assert y.shape[1] == 1 and y.tobytes() == gy
    with pytest.raises(ValueError):
        TR.resample(x, 0, 44100, device="cpu")
    with pytest.raises(ValueError):
        TR.resample(x, 1 << 31, 44100, device="cpu")
    with pytest.raises(ValueError, match="width"):
        TR.resample(x, 44100, 48000, width=4, device="cpu")
    assert TR.nframes_out(1000, 44100, 48000) == \
        JR.nframes_out(1000, 44100, 48000)


HQ_PAIRS = [(44100, 48000), (48000, 44100), (22050, 44100), (44100, 22050),
            (8000, 44100)]


@pytest.mark.parametrize("inr,outr", HQ_PAIRS)
def test_hq_within_one_lsb(inr, outr):
    import jax.numpy as jnp
    x = _pcm(3000, 2, seed=inr % 97) // 2
    g = math.gcd(inr, outr)
    M, L = inr // g, outr // g
    nout = TR.nframes_out(len(x), M, L)
    y = TR.hq_resample(torch.from_numpy(x), L, M, nout).numpy()
    gold = gfx.hq_resample(x, 2, inr, outr)
    jy = np.asarray(JR.hq_resample(jnp.asarray(x), L, M, nout))
    assert y.shape == gold.shape == jy.shape
    assert np.abs(y.astype(np.int64) - gold).max() <= 1
    assert np.abs(y.astype(np.int64) - jy).max() <= 1
    # the taps per leg of the design: 32 up, 32*M/L down
    assert TR._hq_filter(L, M)[1] == 32 * max(L, M) // L + \
        (1 if 32 * max(L, M) % L else 0)


def test_hq_large_decimation_in_small_blocks(monkeypatch):
    """192000 -> 8000 (M = 24, L = 1: 768 taps a leg) within 1 LSB of the
    oracle; the block of outputs shrinks with the taps, and any block size
    gives the same bits."""
    x = _pcm(4800, 2, seed=24) // 2
    nout = TR.nframes_out(len(x), 24, 1)
    y = TR.hq_resample(torch.from_numpy(x), 1, 24, nout).numpy()
    gold = gfx.hq_resample(x, 2, 192000, 8000)
    assert y.shape == gold.shape == (nout, 2)
    assert np.abs(y.astype(np.int64) - gold).max() <= 1
    monkeypatch.setattr(TR, "HQ_BLOCK", 37)      # 37 * 32 // 768 = 1 output
    np.testing.assert_array_equal(
        TR.hq_resample(torch.from_numpy(x), 1, 24, nout).numpy(), y)


@pytest.mark.parametrize("width", [1, 4])
def test_hq_widths(width):
    x = _pcm(1500, width, seed=5)
    y = Sample.from_raw_frames(x.tobytes(), width, 44100, 2, device="cpu") \
        .resample(48000, quality="hq").get_frame_array()
    gold = gs.Sample(x.copy(), 44100, width, 2).resample(48000, "hq").frames
    tol = 1 if width <= 2 else 1 << 16          # 1 LSB at 16 bit
    assert np.abs(y.astype(np.int64) - gold.astype(np.int64)).max() <= tol


@pytest.mark.parametrize("chunk", [1, 7, 160, 997])
def test_hq_streaming_equals_offline(chunk):
    x = _pcm(2500, 2, seed=7) // 2
    for inr, outr in ((44100, 48000), (48000, 44100), (44100, 22050)):
        g = math.gcd(inr, outr)
        M, L = inr // g, outr // g
        whole = TR.hq_resample(torch.from_numpy(x), L, M,
                               TR.nframes_out(len(x), M, L)).numpy()
        rs = TR.StreamingHQResampler(inr, outr, 2, device="cpu")
        out, total = [], 0
        for i in range(0, len(x), chunk):
            y, n = rs.push(torch.from_numpy(x[i:i + chunk]))
            out.append(y.numpy())
            total += n
        y, n = rs.flush()
        out.append(y.numpy())
        assert total + n == len(whole) == rs.total_out(len(x))
        np.testing.assert_array_equal(np.concatenate(out), whole)
        assert rs.flush()[1] == 0                # idempotent once drained


def test_hq_stream_window_checks_raise():
    rs = TR.StreamingHQResampler(44100, 48000, 2, device="cpu")
    rs.push(torch.zeros((500, 2), dtype=torch.int16))
    rs.j = 0            # rewind past the history ring: must raise
    with pytest.raises(RuntimeError, match="history ring"):
        rs.push(torch.zeros((500, 2), dtype=torch.int16))
    rs = TR.StreamingHQResampler(44100, 48000, 2, device="cpu")
    rs.push(torch.zeros((500, 2), dtype=torch.int16))
    with pytest.raises(RuntimeError, match="zero-padded tail"):
        rs._block(rs.hist[:0], rs.total_out(rs.n) + 50)
    with pytest.raises(ValueError, match="2048"):
        TR.StreamingHQResampler(44100, 44101, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        TR.StreamingHQResampler(44100, 48000, dtype=torch.float32,
                                device="cpu")


@pytest.mark.parametrize("outrate,inrate", [
    (48000, 44100), (44100, 48000), (int(44100 * 1.0594630943592953), 44100),
    (int(44100 * 0.7), 44100), (96000, 44100), (44101, 44100),
    (int(44100 * 2.5), 44100), (1, 4000)])
def test_bounded_ratio_matches_reference(outrate, inrate):
    try:
        want = JR.bounded_ratio(outrate, inrate)
    except ValueError:
        with pytest.raises(ValueError):
            TR.bounded_ratio(outrate, inrate)
        return
    assert TR.bounded_ratio(outrate, inrate) == want
    assert TR.HQ_MAX_FACTOR == JR.HQ_MAX_FACTOR


def test_sample_resample_and_speed():
    x = _pcm(3000, 2, seed=3) // 2
    for op in (lambda s: s.resample(48000), lambda s: s.resample(22050),
               lambda s: s.speed(1.25), lambda s: s.speed(0.8, "hq"),
               lambda s: s.resample(32000, "hq")):
        t = op(Sample.from_raw_frames(x.tobytes(), 2, 44100, 2,
                                      device="cpu"))
        g = op(gs.Sample(x.copy(), 44100, 2, 2))
        assert (t.samplerate, t.nframes) == (g.samplerate, g.nframes)
        assert np.abs(t.get_frame_array().astype(np.int64)
                      - g.frames.astype(np.int64)).max() <= 1
    s = Sample.from_raw_frames(x.tobytes(), 2, 44100, 2, device="cpu")
    assert s.resample(44100) is s and s.speed(1.0) is s
    with pytest.raises(ValueError, match="quality"):
        s.resample(48000, quality="sinc")
    with pytest.raises(ValueError, match="2048"):
        s.resample(44101, quality="hq")


def test_resample_defaults_to_the_card():
    """A numpy array goes to the card unless the caller asks for the CPU,
    as the streaming resamplers' tensors do."""
    import inspect
    for fn in (TR.resample, TR.StreamingResampler,
               TR.StreamingHQResampler):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("the raising half is for a machine without a CUDA device")
    x = _pcm(100, 2)
    for call in (lambda: TR.resample(x, 44100, 48000),
                 lambda: TR.StreamingResampler(44100, 48000),
                 lambda: TR.StreamingHQResampler(44100, 48000)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    y, st = TR.resample(x, 44100, 48000, device="cpu")
    assert isinstance(y, np.ndarray) and isinstance(st.prev, np.ndarray)
