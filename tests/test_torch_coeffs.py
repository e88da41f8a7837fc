"""Conformance: every public function and constant of the port's
``ops/coeffs.py`` equals the JAX package's, bit for bit, on a grid of
arguments.

The effects ops of this slice carry no weights: the knob -> coefficient
tables are their parameters, and the port keeps its own copy of them
(it imports nothing of the JAX package).  This test is what carries them
across.  A public function of the port's copy without a case here fails
``test_every_public_function_has_a_case``.
"""

import itertools
import math

import numpy as np
import pytest

from synthesizer_tpu.ops import coeffs as J
from synthesizer_tpu_torch.ops import coeffs as T

SRS = (8000, 22050, 44100, 48000, 96000)
_P = (np.arange(3000, dtype=np.uint64) * np.uint64(1 << 22)
      + np.uint64(123456789)) & np.uint64(0xFFFFFFFF)


def _grid(*axes):
    return list(itertools.product(*axes))


#: function name -> argument tuples (positional) or (args, kwargs) pairs
CASES = {
    "curve_grid": [([(0.0, 1.0), (2.5, -3.0), (7.0, 0.5)], n0, 400, tf)
                   for n0 in (0, 1000, 40000) for tf in (441.0, 1000.0)],
    "compressor_coeff_grids": [
        (np.array([0.0, -1.0, 0.0005, 0.005, 0.1, 2.0]),
         np.array([0.0, 0.01, -1.0, 0.1, 1.5, 0.3]), sr) for sr in SRS],
    "reverb_feedback_grid": [(np.linspace(-0.5, 1.5, 101),)],
    "chorus_inc_grid": [(np.array([0.01, 0.5, 3.0, 20.0]), sr)
                        for sr in SRS],
    "chorus_phase_grid": [(np.array([1, 1 << 30, 0xFFFFFFFF, 12345] * 50,
                                    np.uint64), c)
                          for c in (0, 1 << 31, 0xFFFFFFFF)],
    "chorus_block_plan": [(n, 44100, rate, depth, delay, voices, nch)
                          for n, rate, depth, delay, voices, nch in (
                              (20000, 0.5, 0.002, 0.02, 3, 2),
                              (50000, 3.0, 0.01, 0.05, 2, 1),
                              (16384, 0.1, 0.0005, 0.005, 4, 2))],
    "compressor_coeffs": _grid(SRS, (0.0, -1.0, 0.0005, 0.005, 0.1, 2.0),
                               (0.0, -1.0, 0.01, 0.1, 1.5)),
    "gate_coeffs": _grid((8000, 44100), (0.0, 0.001, 0.05), (0.0, 0.05, 0.5),
                         (20.0, 80.0, -60.0)),
    "biquad_coeffs": _grid(("lowpass", "highpass", "bandpass"),
                           (10.0, 30.0, 200.0, 1000.0, 8000.0, 30000.0),
                           (0.5, 0.7071, 4.0, 18.0), (8000, 44100, 48000)),
    "eq_band_coeffs": _grid(("lowshelf", "highshelf", "peaking"),
                            (60.0, 120.0, 1000.0, 8000.0),
                            (-12.0, -3.0, 0.0, 6.0, 12.0), (0.7071, 1.0, 8.0),
                            (44100, 48000)),
    "eq_coeff_grids": [((kind, f, np.linspace(-12.0, 12.0, 50), 1.0, sr),
                        {"dtype": dt})
                       for kind in ("lowshelf", "highshelf", "peaking")
                       for f in (120.0, 3000.0) for sr in (44100, 48000)
                       for dt in (np.float32, np.float64)],
    "eq_freqs_coeff_grids": [((kind, np.geomspace(40.0, 12000.0, 60), g,
                               0.7071, 44100), {"dtype": dt})
                             for kind in ("lowshelf", "highshelf", "peaking")
                             for g in (-6.0, 9.0)
                             for dt in (np.float32, np.float64)],
    "ff_split": [(v,) for v in (0.1, -1.9999999, 1e-30, math.pi,
                                np.linspace(-2.0, 2.0, 77))],
    "pole_gain": [(a1, a2) for a1, a2 in ((-1.9, 0.91), (-1.99, 0.9901),
                                          (0.3, 0.1), (-1.0, 0.25))],
    "predicted_scan_error_lsb": [
        (J.biquad_coeffs(k, f, q, 44100),)
        for k, f, q in (("lowpass", 1000.0, 0.7071), ("highpass", 30.0,
                                                      0.7071),
                        ("lowpass", 500.0, 8.0))],
    "wants_ff_scan": [(J.eq_band_coeffs(k, f, g, q, 44100),)
                      for k, f, g, q in (("lowshelf", 120.0, -12.0, 0.7071),
                                         ("peaking", 1000.0, 6.0, 1.0),
                                         ("peaking", 250.0, 12.0, 8.0),
                                         ("highshelf", 8000.0, 9.0, 0.7071))],
    "biquad_peak_gain": [(J.eq_band_coeffs(k, f, g, 1.0, 44100),)
                         for k, f, g in (("peaking", 1000.0, 6.0),
                                         ("lowshelf", 120.0, -9.0))],
    "master_chain_error_bound": [
        ([("eq_band", {"kind": "peaking", "freq": 1000.0, "q": 1.0,
                       "gains_db": [-6.0, 6.0]}),
          ("echo", {"feedback": 0.4, "wet": 0.5, "dry": 1.0}),
          ("phaser", {"stages": 4, "q": 0.7, "min_freq": 300.0,
                      "max_freq": 3000.0, "wet": 0.5, "dry": 1.0}),
          ("width", {"amount": 1.5}), ("limiter", {})], 44100, 1.0)],
    "kweight_coeffs": [(sr,) for sr in SRS],
    "true_peak_filter": [()],
    "hq_resample_filter": [(L, M) for L, M in ((160, 147), (147, 160),
                                               (2, 1), (1, 2), (441, 80),
                                               (640, 147))]
    + [((2, 1), {"taps_per_phase": 16, "beta": 6.0})],
    "reverb_delays": _grid(SRS, (0, 1)),
    "reverb_params": _grid((0.0, 0.3, 0.7, 1.0), (0.0, 0.5, 1.0),
                           (0.0, 0.33, 1.0), (0.0, 0.5, 1.0)),
    "stretch_grid": _grid((100, 2048, 50000), (0.5, 0.9, 1.0, 1.31, 2.0),
                          (2048,), (512, 300)),
    "noise_u32": [(np.arange(4096, dtype=np.uint64), s)
                  for s in (0, 1, 0xDEADBEEF, 1 << 40)],
    "grain_grid": [(n, sr, dur, 0.05, dens, jit, seed)
                   for n, sr, dur, dens, jit, seed in (
                       (44100, 44100, 2.0, 25.0, 0.02, 0),
                       (500, 22050, 0.5, 80.0, 0.0, 7),
                       (100000, 48000, 1.0, 10.0, 0.1, 3))],
    "phaser_coeff_grids": [((n0, 2000, sr, 0.5, depth, lo, 3000.0, q),
                            {"dtype": dt})
                           for n0 in (0, 123456) for sr in (44100, 48000)
                           for depth, lo, q in ((1.0, 300.0, 0.7071),
                                                (0.5, 60.0, 1.0))
                           for dt in (np.float32, np.float64)],
    "tremolo_gain_grid": [(_P, d) for d in (0.0, 0.5, 1.0,
                                            np.linspace(0, 1, 3000))],
    "autopan_pan_grid": [(_P, d) for d in (0.0, 0.7, 1.0)],
    "static_phase": _grid((0, 1000, 1 << 30), (2000,), (44100, 48000),
                          (0.5, 5.0, 19.9)),
    "phaser_coeff_grids_swept": [((_P, d, lo, 3000.0, 0.7071, 44100),
                                  {"dtype": dt})
                                 for d in (1.0, np.linspace(0, 1, 3000))
                                 for lo in (60.0, 300.0)
                                 for dt in (np.float32, np.float64)],
    "echo_tail_frames": _grid((22050, 44100), (0.001, 0.25, 1.0),
                              (0.0, 0.4, 0.95), (0.1, 0.5, 1.0),
                              (None, 0.0, 2.5)),
    "allpass_coeffs": _grid((40.0, 300.0, 3000.0, 15000.0), (0.5, 0.7071, 4.0),
                            (44100, 48000)),
    "limiter_ceiling": _grid((-60.0, -12.0, -1.0, -0.1, 0.0), (1, 2, 4)),
    "phaser_wants_ff": [(f,) for f in (30.0, 60.0, 119.9, 120.0, 300.0)],
}

CONSTANTS = ("FF_SCAN_THRESHOLD_LSB", "COMB_TUNING", "ALLPASS_TUNING",
             "STEREO_SPREAD", "FIXED_GAIN", "ALLPASS_FEEDBACK",
             "PHASER_FF_MIN_FREQ", "__all__")


def _public_functions(mod):
    return sorted(n for n, v in vars(mod).items()
                  if callable(v) and not n.startswith("_")
                  and getattr(v, "__module__", None) == mod.__name__)


def _same(a, b):
    """Equal bit for bit: same types, dtypes, shapes and values."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "f":
            assert a.tobytes() == b.tobytes()
        else:
            np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_every_public_function_has_a_case():
    assert _public_functions(T) == sorted(CASES)
    assert _public_functions(J) == _public_functions(T)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_reference(name):
    for case in CASES[name]:
        args, kwargs = (case if len(case) == 2 and isinstance(case[1], dict)
                        else (case, {}))
        try:
            want = getattr(J, name)(*args, **kwargs)
        except (ValueError, ZeroDivisionError) as e:
            with pytest.raises(type(e)):
                getattr(T, name)(*args, **kwargs)
            continue
        _same(getattr(T, name)(*args, **kwargs), want)


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_matches_reference(name):
    _same(getattr(T, name), getattr(J, name))
