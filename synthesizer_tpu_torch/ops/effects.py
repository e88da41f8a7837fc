"""Device effects rack (port of ``synthesizer_tpu.ops.effects``):
dynamics, filters, reverb, chorus, convolution, time stretch, granular
synthesis, LFO gains, feedback echo, stereo width, limiter and phaser.

The behavioural contract and each effect's tolerance live in
:mod:`goldref.effects`.  What the port keeps from the reference, and where it
differs:

* **Scans.**  Every recurrence that the reference runs as
  ``jax.lax.associative_scan`` goes through :func:`associative_scan`, the
  same odd/even recursion written out in PyTorch, so the f32 roundings take
  the same tree: the decaying-max peak detector, the affine one-pole
  smoothers, the Biquad's 2x2 companion matrices (as elementwise products:
  no matmul, so TF32 never touches them) and their float-float twin.
* **Float-float arithmetic** (``ff_add``, ``ff_mul``) relies on exact
  two-sum and two-product; each step here is its own eager op, which no
  compiler contracts or reassociates.
* **Sequential scans** (the reverb's comb stage, the feedback echo) are
  Python loops over the same blocks as the reference's ``lax.scan``: one
  set of launches a block.
* **Order.**  Nothing adds floats with atomics: the granulator and the
  stretch's overlap-add add non-overlapping groups in a fixed order, so a
  result on the card is the same from run to run.
* **Constant divisors** are 0-dim device tensors (``ops.wave.div``).
* The chorus is the reference's pair-gather form; its banded form is a
  TPU layout of the same arithmetic (bit-compatible by the reference's own
  tests) that a GPU gather does not need.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import pcm as dpcm
from .trig import sin_turns
from .wave import div, scalar

MAXVAL = dpcm.MAXVAL
MINVAL = dpcm.MINVAL

#: Each ``Sample`` op's budget against its oracle, as ``goldref.effects``
#: states it for the device twin: frames in LSB at 16 bit, loudness in LU,
#: true peak in dB.
BUDGETS = {
    "compress": 2,          # compressor_gains: 2e-6 on gains, 2 LSB applied
    "gate": 2,
    "limit": 2,
    "reverb": 4,
    "chorus": 2,
    "filter": 4,            # the Biquad's companion scan: a few LSB
    "eq": 4,
    "feedback_echo": 1,
    "tremolo": 1,
    "autopan": 1,
    "stereo_width": 1,
    "phaser": 2 + 2 * 4,    # 2 + 2*stages, at the default 4 stages
    "convolve": 8,          # max(8, 1e-4 * peak)
    "granulate": 2,
    "stretch": 64,
    "pitch_shift": 64,      # stretch, then the hq resampler (1 LSB)
    "hq_resample": 1,
    "normalize_lufs": 1,    # one gain, applied by the house rule
    "loudness": 0.01,       # loudness_lufs and each of loudness_stats
    "true_peak": 0.01,
}


def _norm(frames: torch.Tensor) -> torch.Tensor:
    return div(frames.to(torch.float32), MAXVAL[dpcm.width_of(frames)])


def _f32(v, device) -> torch.Tensor:
    """A knob (number, array or tensor) as f32 on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if np.ndim(v) == 0:
        return scalar(v, device)
    return torch.from_numpy(np.asarray(v, np.float32)).to(device)


def to_int_samples(values: torch.Tensor, width: int) -> torch.Tensor:
    """House synthesis quantization clip(rint(f32(v*maxval))), rounding
    half to even — the same formula as ``models.graph.to_int_device``."""
    v = torch.round(values * float(MAXVAL[width]))
    if width == 4:
        # clip before the cast: see ops.pcm.floor_clamp
        hi = 2147483648.0
        inner = torch.clamp(v, -hi, hi - 128).to(torch.int32)
        return torch.where(v >= hi, MAXVAL[4],
                           torch.where(v < -hi, MINVAL[4], inner))
    return torch.clamp(v, float(MINVAL[width]),
                       float(MAXVAL[width])).to(torch.int32).to(
                           dpcm.DTYPES[width])


# ---------------------------------------------------------------------------
# Parallel-scan primitives
# ---------------------------------------------------------------------------

def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 0 (even is as long as
    odd or one longer): one stacking copy."""
    m = odd.shape[0]
    pairs = torch.stack((even[:m], odd), dim=1).reshape(
        (2 * m,) + odd.shape[1:])
    return pairs if even.shape[0] == m else torch.cat([pairs, even[m:]])


def _scan0(combine, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine(tuple(e[0:-1:2] for e in elems),
                      tuple(e[1::2] for e in elems))
    odd = _scan0(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(e[:-1] for e in odd),
                       tuple(e[2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[2::2] for e in elems))
    return tuple(_interleave(torch.cat([e[0:1], r]), o)
                 for e, r, o in zip(elems, even, odd))


def associative_scan(combine, elems, dim: int = 0):
    """Inclusive scan of the tuple ``elems`` under ``combine(left, right)``
    along ``dim``: combine adjacent pairs, scan the half-length sequence
    recursively, fill in the elements between.  The recursion of
    ``jax.lax.associative_scan``, so the f32 roundings group as the
    reference's do; log2(n) levels of a few elementwise launches each."""
    elems = tuple(e.movedim(dim, 0) for e in elems)
    return tuple(e.movedim(0, dim) for e in _scan0(combine, elems))


def decaying_max_scan(a: torch.Tensor, decay, init=0.0) -> torch.Tensor:
    """e_n = max(a_n, e_{n-1} * decay) with e_{-1} = init; element (x, d)
    is the map e -> max(x, e*d)."""
    d = _f32(decay, a.device).expand(a.shape)

    def combine(l, r):
        (xl, dl), (xr, dr) = l, r
        return torch.maximum(xr, xl * dr), dl * dr

    xs, ds = associative_scan(combine, (a, d))
    return torch.maximum(xs, ds * _f32(init, a.device))


def affine_scan_fixed(coeff: torch.Tensor, axis: int = 0):
    """The affine scan y_n = coeff_n * y_{n-1} + add_n with y_{-1} = init,
    along ``axis``, with the coefficients fixed: returns ``scan(add,
    init)``.  Other axes are independent lanes; ``add`` has ``coeff``'s
    shape and ``init`` broadcasts against the result.

    The recursion is :func:`associative_scan`'s under the composition
    l-then-r, (Al*Ar, Bl*Ar + Br), split in its two halves: the coefficient
    half (each level's pair products and the cumulative product) is
    computed here, once, and each ``scan`` runs the add half on the same
    operands in the same tree.  A loop that scans many ``add`` rows against
    one ``coeff`` pays for the coefficients once; a single scan launches
    as many operations as the generic recursion."""
    levels, a = [], coeff.movedim(axis, 0)
    while a.shape[0] >= 2:
        levels.append((a, a[1::2], a[2::2]))
        a = a[0:-1:2] * a[1::2]
    levels.append((a, None, None))

    def cumprod(k):
        a_k, _, a_even = levels[k]
        n = a_k.shape[0]
        if n < 2:
            return a_k
        odd = cumprod(k + 1)
        even = (odd[:-1] if n % 2 == 0 else odd) * a_even
        return _interleave(torch.cat([a_k[0:1], even]), odd)

    def rec(b, k):
        n = b.shape[0]
        if n < 2:
            return b
        _, a_odd, a_even = levels[k]
        odd = rec(b[0:-1:2] * a_odd + b[1::2], k + 1)
        even = (odd[:-1] if n % 2 == 0 else odd) * a_even + b[2::2]
        return _interleave(torch.cat([b[0:1], even]), odd)

    acum = cumprod(0).movedim(0, axis)

    def scan(add: torch.Tensor, init) -> torch.Tensor:
        bcum = rec(add.movedim(axis, 0), 0).movedim(0, axis)
        return acum * _f32(init, add.device) + bcum
    return scan


def affine_scan(coeff: torch.Tensor, add: torch.Tensor, init,
                axis: int = 0) -> torch.Tensor:
    """y_n = coeff_n * y_{n-1} + add_n with y_{-1} = init, along ``axis``:
    one scan of :func:`affine_scan_fixed`."""
    return affine_scan_fixed(coeff, axis)(add, init)


def one_pole_scan(target: torch.Tensor, alpha, init) -> torch.Tensor:
    """y_n = y_{n-1} + alpha*(t_n - y_{n-1})."""
    al = _f32(alpha, target.device)
    return affine_scan((1.0 - al).expand(target.shape), al * target, init)


def _compose(l, r):
    """The affine map l followed by r: (Mr Ml, Mr cl + cr).  2x2 products
    as elementwise f32 multiplies and adds — no matmul.  M [n, 2, 2],
    c [n, 2]."""
    (Ml, cl), (Mr, cr) = l, r
    M = Mr[:, :, 0:1] * Ml[:, 0:1, :] + Mr[:, :, 1:2] * Ml[:, 1:2, :]
    c = Mr[:, :, 0] * cl[:, 0:1] + Mr[:, :, 1] * cl[:, 1:2] + cr
    return M, c


def companion_scan(u: torch.Tensor, a1, a2, y1, y2,
                   dtype=torch.float32) -> torch.Tensor:
    """y_n = u_n - a1_n y_{n-1} - a2_n y_{n-2} as a PARALLEL affine scan
    over 2x2 companion matrices.  ``a1``/``a2`` may be scalars
    (constant-coefficient biquads) or [B] tensors (swept filters);
    ``y1``/``y2`` carry state across blocks (numbers or 0-dim tensors).

    The f32 rounding depends on how the scan groups its products, so the
    result agrees with the sequential f64 recurrence within the budgets of
    the reference's filter tests (a few LSB at 16 bit, more as the poles
    approach the unit circle), not bit for bit.  ``dtype=torch.float64``
    runs the scan on the f32 inputs in f64 and rounds the result to f32
    (see ``effects.swept_biquad_chunk``)."""
    dev = u.device
    u = u.to(dtype)
    ones = torch.ones_like(u)
    zeros = torch.zeros_like(u)
    a1 = _f32(a1, dev).to(dtype)
    a2 = _f32(a2, dev).to(dtype)
    row0 = torch.stack([-a1 * ones, -a2 * ones], dim=-1)      # [B, 2]
    row1 = torch.stack([ones, zeros], dim=-1)
    M = torch.stack([row0, row1], dim=-2)                     # [B, 2, 2]
    c = torch.stack([u, zeros], dim=-1)                       # [B, 2]
    M, c = associative_scan(_compose, (M, c))
    y = (M[:, 0, 0] * _f32(y1, dev).to(dtype)
         + M[:, 0, 1] * _f32(y2, dev).to(dtype) + c[:, 0])
    return y.to(torch.float32)


# ---------------------------------------------------------------------------
# Compensated (float-float) companion scan: coefficients as (hi, lo) f32
# pairs split from f64 on the host (ops.coeffs.ff_split), every product and
# sum an error-free transformation — for near-unit poles, where the plain
# f32 scan drifts (ops.coeffs.wants_ff_scan decides).
# ---------------------------------------------------------------------------

def _ff_norm(hi, lo):
    """Renormalize a (hi, lo) pair (Knuth fast-two-sum, |lo| <= |hi|)."""
    s = hi + lo
    return s, lo - (s - hi)


def _prod_err(a, b, p):
    """Dekker: the exact f32 rounding error of p = fl(a * b)."""
    t = a * 4097.0                      # 2^12 + 1 splits f32's 24 bits
    ah = t - (t - a)
    al = a - ah
    t = b * 4097.0
    bh = t - (t - b)
    bl = b - bh
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl


def ff_add(ah, al, bh, bl):
    """(ah, al) + (bh, bl) in float-float (Knuth TwoSum + tail fold)."""
    s = ah + bh
    bb = s - ah
    err = (ah - (s - bb)) + (bh - bb)
    return _ff_norm(s, err + (al + bl))


def ff_mul(ah, al, bh, bl):
    """(ah, al) * (bh, bl) in float-float (Dekker TwoProd + cross terms)."""
    p = ah * bh
    e = _prod_err(ah, bh, p) + (ah * bl + al * bh)
    return _ff_norm(p, e)


def _ff_mat2mul(Ah, Al, Bh, Bl):
    """2x2 float-float matrix product A @ B over leading dims ([..., 2, 2]
    hi/lo tensors)."""
    ch = [[None, None], [None, None]]
    cl = [[None, None], [None, None]]
    for i in range(2):
        for j in range(2):
            t0 = ff_mul(Ah[..., i, 0], Al[..., i, 0],
                        Bh[..., 0, j], Bl[..., 0, j])
            t1 = ff_mul(Ah[..., i, 1], Al[..., i, 1],
                        Bh[..., 1, j], Bl[..., 1, j])
            ch[i][j], cl[i][j] = ff_add(*t0, *t1)
    Ch = torch.stack([torch.stack(ch[0], dim=-1),
                      torch.stack(ch[1], dim=-1)], dim=-2)
    Cl = torch.stack([torch.stack(cl[0], dim=-1),
                      torch.stack(cl[1], dim=-1)], dim=-2)
    return Ch, Cl


def _ff_mat2vec(Ah, Al, vh, vl):
    """2x2 float-float matrix times float-float 2-vector ([..., 2])."""
    out_h, out_l = [], []
    for i in range(2):
        t0 = ff_mul(Ah[..., i, 0], Al[..., i, 0], vh[..., 0], vl[..., 0])
        t1 = ff_mul(Ah[..., i, 1], Al[..., i, 1], vh[..., 1], vl[..., 1])
        h, l = ff_add(*t0, *t1)
        out_h.append(h)
        out_l.append(l)
    return torch.stack(out_h, dim=-1), torch.stack(out_l, dim=-1)


def companion_scan_ff(uh, ul, a1h, a1l, a2h, a2l, y1h, y1l, y2h, y2l):
    """Float-float twin of :func:`companion_scan`: y_n = u_n - a1 y_{n-1} -
    a2 y_{n-2} with every quantity a (hi, lo) pair.  The a1/a2 pairs may be
    scalars or [B] grids; y1/y2 pairs carry state across chunks.  Returns
    (y_hi, y_lo); y_hi is the correctly rounded f32 output."""
    dev = uh.device
    zeros = torch.zeros_like(uh)
    ones = torch.ones_like(uh)

    def bc(c):
        return _f32(c, dev) * ones

    row0h = torch.stack([-bc(a1h), -bc(a2h)], dim=-1)
    row0l = torch.stack([-bc(a1l), -bc(a2l)], dim=-1)
    row1h = torch.stack([ones, zeros], dim=-1)
    row1l = torch.stack([zeros, zeros], dim=-1)
    Msh = torch.stack([row0h, row1h], dim=-2)               # [B, 2, 2]
    Msl = torch.stack([row0l, row1l], dim=-2)
    csh = torch.stack([uh, zeros], dim=-1)                  # [B, 2]
    csl = torch.stack([ul, zeros], dim=-1)

    def combine(l, r):
        Mlh, Mll, clh, cll = l
        Mrh, Mrl, crh, crl = r
        Ch, Cl = _ff_mat2mul(Mrh, Mrl, Mlh, Mll)
        dh, dl = _ff_mat2vec(Mrh, Mrl, clh, cll)
        eh, el = ff_add(dh, dl, crh, crl)
        return Ch, Cl, eh, el

    Mh, Ml, ch, cl = associative_scan(combine, (Msh, Msl, csh, csl))
    s0h = torch.stack([_f32(y1h, dev), _f32(y2h, dev)])
    s0l = torch.stack([_f32(y1l, dev), _f32(y2l, dev)])
    vh, vl = _ff_mat2vec(Mh, Ml, s0h[None, :], s0l[None, :])
    yh, yl = ff_add(vh, vl, ch, cl)
    return yh[:, 0], yl[:, 0]


def _delayed(x: torch.Tensor, x1, x2):
    """(x_{n-1}, x_{n-2}) of one channel with the carried history."""
    xp1 = torch.cat([x1.reshape(1), x[:-1]])
    xp2 = torch.cat([x2.reshape(1), x1.reshape(1), x[:-2]])[:x.shape[0]]
    return xp1, xp2


def biquad_apply_ff(s: torch.Tensor, coeff_pairs, state=None):
    """Compensated twin of :func:`biquad_apply`.  ``coeff_pairs`` is
    ((b0h, b0l), ..., (a2h, a2l)), scalars or [n] grids.  ``state`` is
    (x1, x2, y1h, y1l, y2h, y2l), each [ch].  Returns (y, state) with y the
    correctly rounded f32 signal."""
    n, nch = s.shape
    dev = s.device
    (b0h, b0l), (b1h, b1l), (b2h, b2l), (a1h, a1l), (a2h, a2l) = \
        tuple((_f32(h, dev), _f32(l, dev)) for h, l in coeff_pairs)
    if state is None:
        z = torch.zeros(nch, dtype=torch.float32, device=dev)
        state = (z, z, z, z, z, z)
    x1, x2, y1h, y1l, y2h, y2l = state

    def tap(bh, bl, x):
        # ff coefficient times EXACT f32 signal value
        p = bh * x
        e = _prod_err(bh, x, p) + bl * x
        return _ff_norm(p, e)

    cols_h, ny1h, ny1l, ny2h, ny2l = [], [], [], [], []
    for c in range(nch):
        x = s[:, c]
        xp1, xp2 = _delayed(x, x1[c], x2[c])
        uh, ul = ff_add(*ff_add(*tap(b0h, b0l, x), *tap(b1h, b1l, xp1)),
                        *tap(b2h, b2l, xp2))
        yh, yl = companion_scan_ff(uh, ul, a1h, a1l, a2h, a2l,
                                   y1h[c], y1l[c], y2h[c], y2l[c])
        cols_h.append(yh)
        ny1h.append(yh[-1])
        ny1l.append(yl[-1])
        ny2h.append(yh[-2] if n >= 2 else y1h[c])
        ny2l.append(yl[-2] if n >= 2 else y1l[c])
    out = torch.stack(cols_h, dim=1)
    new_state = (s[-1], s[-2] if n >= 2 else x1,
                 torch.stack(ny1h), torch.stack(ny1l),
                 torch.stack(ny2h), torch.stack(ny2l))
    return out, new_state


def biquad_apply(s: torch.Tensor, coeffs, state=None,
                 scan_dtype=torch.float32):
    """Biquad on a normalized f32 signal [n, ch]:
    y_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2} - a1 y_{n-1} - a2 y_{n-2},
    channels independent; coefficients are scalars or [n] grids.  ``state``
    carries (x1, x2, y1, y2) each [ch] across chunks (zeros at start).
    ``scan_dtype`` is the companion scan's (f32, or f64 rounded to f32).
    Returns (y, new_state).  Spec: goldref.effects.biquad_filter."""
    n, nch = s.shape
    dev = s.device
    b0, b1, b2, a1, a2 = (_f32(c, dev) for c in coeffs)
    if state is None:
        z = torch.zeros(nch, dtype=torch.float32, device=dev)
        state = (z, z, z, z)
    x1, x2, y1, y2 = state
    cols, ny1, ny2 = [], [], []
    for c in range(nch):
        x = s[:, c]
        xp1, xp2 = _delayed(x, x1[c], x2[c])
        u = b0 * x + b1 * xp1 + b2 * xp2
        y = companion_scan(u, a1, a2, y1[c], y2[c], scan_dtype)
        cols.append(y)
        ny1.append(y[-1])
        ny2.append(y[-2] if n >= 2 else y1[c])
    out = torch.stack(cols, dim=1)
    new_state = (s[-1], s[-2] if n >= 2 else x1,
                 torch.stack(ny1), torch.stack(ny2))
    return out, new_state


# ---------------------------------------------------------------------------
# Dynamics: gate, compressor
# ---------------------------------------------------------------------------

def _level_db(e: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp_min(e, float(np.float32(1e-10))))


def gate_gains_from_coeffs(frames: torch.Tensor, threshold_db, floor_gain,
                           alpha, decay, e0, z0, with_state: bool = False):
    """Noise-gate gain curve; spec: goldref.effects.gate_gains.  A
    decaying-max peak detector, a hard open (1) / closed (floor_gain)
    target and a one-pole smoother; ``e0``/``z0`` carry the detector and
    smoother across chunks (a stream starts CLOSED: z_{-1} = floor_gain)."""
    dev = frames.device
    a = torch.amax(torch.abs(_norm(frames)), dim=1)
    e = decaying_max_scan(a, decay, init=e0)
    g = torch.where(_level_db(e) >= _f32(threshold_db, dev),
                    scalar(1.0, dev), _f32(floor_gain, dev))
    al = _f32(alpha, dev)
    z = affine_scan((1.0 - al).expand(g.shape), al * g, init=z0)
    if with_state:
        return z, e[-1], z[-1]
    return z


def compressor_gains(frames: torch.Tensor, samplerate: int,
                     threshold_db: float, ratio: float, attack: float,
                     release: float) -> torch.Tensor:
    """Per-sample linear gain curve of the peak compressor; formulas and
    budget: goldref.effects.compressor_gains."""
    from .coeffs import compressor_coeffs
    alpha, decay = compressor_coeffs(samplerate, attack, release)
    slope = 1.0 if math.isinf(ratio) else 1.0 - 1.0 / ratio
    return compressor_gains_from_coeffs(frames, threshold_db, slope, alpha,
                                        decay)


def _static_curve_db(level_db: torch.Tensor, threshold_db, slope, knee):
    """The compressor's static curve in dB: hard knee (knee=None)
    min(0, (thr - level)*slope); soft knee of width W dB: the quadratic
    -slope*(level - thr + W/2)^2 / (2W) inside the knee."""
    dev = level_db.device
    thr = _f32(threshold_db, dev)
    sl = _f32(slope, dev)
    hard = torch.clamp_max((thr - level_db) * sl, 0.0)
    if knee is None:
        return hard
    kn = _f32(knee, dev)
    half = kn * 0.5
    t = level_db - thr + half
    soft = -(sl * (t * t)) / (kn * 2.0)
    zero = scalar(0.0, dev)
    return torch.where(t <= 0.0, zero,
                       torch.where(level_db > thr + half, hard, soft))


def compressor_gains_from_level(a: torch.Tensor, threshold_db, slope, alpha,
                                decay, e0=0.0, z0=0.0,
                                with_state: bool = False, knee=None):
    """Gain curve from a detector level ``a`` [n] (normalized |signal|) —
    the sidechain entry point.  The attack smoother runs in
    deviation-from-1 form, z = 1 - y, so that the g == 1 fixpoint is exact
    (audio under the threshold passes bit-transparently)."""
    dev = a.device
    e = decaying_max_scan(a, decay, init=e0)
    g_db = _static_curve_db(_level_db(e), threshold_db, slope, knee)
    g = torch.exp2(g_db * (1.0 / 6.0206))
    al = _f32(alpha, dev)
    z = affine_scan((1.0 - al).expand(g.shape), al * (1.0 - g), init=z0)
    gains = 1.0 - z
    if with_state:
        return gains, e[-1], z[-1]
    return gains


def compressor_gains_from_coeffs(frames: torch.Tensor, threshold_db, slope,
                                 alpha, decay, e0=0.0, z0=0.0,
                                 with_state: bool = False, knee=None):
    """:func:`compressor_gains` with the host-derived coefficients passed
    explicitly; ``e0``/``z0`` carry the detector and smoother across
    chunks."""
    a = torch.amax(torch.abs(_norm(frames)), dim=1)
    return compressor_gains_from_level(a, threshold_db, slope, alpha, decay,
                                       e0, z0, with_state, knee)


# ---------------------------------------------------------------------------
# Freeverb-style reverb
# ---------------------------------------------------------------------------

#: Whole-signal lag-aligned comb packing cap: beyond this many bytes of
#: packed [M, L, Dmax] input+output the offline path runs the blocked
#: network (``reverb_network_apply``) instead.
COMB_PACK_BYTES_CAP = 1_500_000_000


def reverb_zero_state(combs: Tuple[int, ...], aps: Tuple[int, ...],
                      device):
    """Fresh (comb ring buffers, damping states, allpass ring buffers,
    write position) carry for one channel's network, on ``device`` (no
    default: a carry never lands on the CPU unasked)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=device)
    return (z(len(combs), max(combs)), z(len(combs)), z(len(aps), max(aps)),
            0)


def _comb_step(comb_buf, fstores, offs, xblk, fbv, ds, d2, scan, nets: int):
    """One blocked step of the comb stage of ``nets`` networks over
    ``block`` frames (block <= the shortest comb delay, so every delayed
    read lands at least a block behind the write head).  The combs of all
    networks run as the lanes of one [lanes, block] gather, affine scan
    (the damping filter; ``scan`` is ``affine_scan_fixed`` of its
    coefficients) and scatter; the ring writes go to distinct positions,
    so they are order-free.  ``offs`` holds the block's absolute frames.
    Returns (comb_buf, fstores, [nets, block] comb outputs, each network's
    combs summed in comb order)."""
    idx = offs[None, :] % ds[:, None]                         # [lanes, block]
    y = comb_buf.gather(1, idx)
    fs = scan(d2 * y, fstores[:, None])
    comb_buf = comb_buf.scatter(1, idx, xblk[None, :] + fs * fbv)
    y = y.view(nets, -1, y.shape[1])
    out = y[:, 0]
    for k in range(1, y.shape[1]):
        out = out + y[:, k]
    return comb_buf, fs[:, -1], out


def _allpass_chunk(buf: torch.Tensor, x: torch.Tensor, D: int, n0: int):
    """A Freeverb allpass over a chunk starting at absolute frame ``n0``:
    w_n = x_n + 0.5 * w_{n-D}, y_n = w_{n-D} - x_n, with ``buf`` [D] the
    ring of w at frames n0-D .. n0-1 (frame f at f % D).  Frames D apart
    form a lane, so the chunk is D lanes of one affine scan along the
    block axis.  Returns (new ring, y)."""
    dev = x.device
    n = x.shape[0]
    M = -(-n // D)
    j = torch.arange(D, dtype=torch.int64, device=dev)
    init = buf[(n0 + j) % D]                            # w_{n0 + j - D}
    xp = torch.cat([x, torch.zeros(M * D - n, dtype=torch.float32,
                                   device=dev)]).reshape(M, D)
    w = affine_scan(torch.full((M, D), 0.5, dtype=torch.float32, device=dev),
                    xp, init[None, :], axis=0)
    y = (torch.cat([init[None, :], w[:-1]]) - xp).reshape(-1)[:n]
    last = torch.cat([init, w.reshape(-1)[:n]])[-D:]    # frames n0+n-D ..
    new = torch.empty_like(buf)
    new[(n0 + n - D + j) % D] = last
    return new, y


def reverb_networks_apply(states, mono_in: torch.Tensor, nets, feedback,
                          damp):
    """Run ``mono_in`` (any length) through the networks ``nets`` (one per
    output channel, each (combs, allpasses)) from ``states``; returns
    (new_states, [output of each network]).  The comb stage of all
    networks runs as one set of lanes in blocks of the shortest comb delay
    (``_comb_step``), then each network's allpasses over the whole chunk as
    lanes of their delays (``_allpass_chunk``): the allpasses take the
    combs' output and feed nothing back.  ``feedback`` may be a per-frame
    [n] grid.  The f32 roundings depend on the chunking (the scans group
    by block), within the reverb's budget."""
    dev = mono_in.device
    n = int(mono_in.shape[0])
    if n == 0:
        return states, [torch.zeros(0, dtype=torch.float32, device=dev)
                        for _ in nets]
    n0 = states[0][3]
    combs = [D for cs, _ in nets for D in cs]
    per = len(nets[0][0])
    if any(len(cs) != per for cs, _ in nets):
        raise ValueError("the networks need the same number of combs")
    width = max(st[0].shape[1] for st in states)
    comb_buf = torch.cat([torch.nn.functional.pad(st[0], (0, width - st[0]
                                                          .shape[1]))
                          for st in states])
    fstores = torch.cat([st[1] for st in states])
    block = min(combs)
    fb = _f32(feedback, dev)
    d1 = _f32(damp, dev)
    d2 = 1.0 - d1
    ds = torch.tensor(combs, dtype=torch.int64, device=dev)
    frames = torch.arange(block, dtype=torch.int64, device=dev)
    scans = {}                  # the damping scan's coefficients, per length
    outs = []
    for b0 in range(0, n, block):
        m = min(block, n - b0)
        if m not in scans:
            scans[m] = affine_scan_fixed(d1.expand(len(combs), m), axis=1)
        fbv = fb[b0:b0 + block] if fb.ndim == 1 else fb
        comb_buf, fstores, y = _comb_step(
            comb_buf, fstores, frames[:m] + (n0 + b0),
            mono_in[b0:b0 + block], fbv, ds, d2, scans[m], len(nets))
        outs.append(y)
    out = torch.cat(outs, dim=1)
    new_states, results = [], []
    for i, ((cs, aps), st) in enumerate(zip(nets, states)):
        r = out[i]
        ap_new = st[2].clone()
        for k, D in enumerate(aps):
            ring, r = _allpass_chunk(st[2][k, :D], r, D, n0)
            ap_new[k, :D] = ring
        new_states.append((comb_buf[i * per:(i + 1) * per,
                                    :st[0].shape[1]].contiguous(),
                           fstores[i * per:(i + 1) * per], ap_new, n0 + n))
        results.append(r)
    return new_states, results


def reverb_network_apply(state, mono_in: torch.Tensor, combs, aps, feedback,
                         damp):
    """One network of :func:`reverb_networks_apply` -> (new_state,
    output)."""
    states, outs = reverb_networks_apply([state], mono_in, [(combs, aps)],
                                         feedback, damp)
    return states[0], outs[0]


def _comb_stage_whole(mono_in: torch.Tensor, comb_sets, fb, d1, d2):
    """Whole-signal parallel comb banks with no gather and no scatter: each
    comb's row is its OWN delay D, so the lag-D ring read is the previous
    row of that lane.  Every lane (the 8 combs of every channel network)
    pads its [ceil(n/D), D] view of the input to [M, Dmax] with
    identity-affine columns, and one loop of M = ceil(n/Dmin) steps serves
    all lanes with one in-row affine scan a step (``affine_scan_fixed``:
    the damping coefficients are the same in every step).  Returns
    [n, networks]."""
    dev = mono_in.device
    total = int(mono_in.shape[0])
    all_ds = tuple(D for cs in comb_sets for D in cs)
    dmax = max(all_ds)
    M = -(-total // min(all_ds))
    xl = torch.zeros((M, len(all_ds), dmax), dtype=torch.float32, device=dev)
    for lane, D in enumerate(all_ds):
        mk = -(-total // D)
        rows = torch.cat([mono_in, torch.zeros(mk * D - total,
                                               dtype=torch.float32,
                                               device=dev)]).reshape(mk, D)
        xl[:mk, lane, :D] = rows
    mask = (torch.arange(dmax, device=dev)[None, :]
            < torch.tensor(all_ds, device=dev)[:, None])       # [L, Dmax]
    scan = affine_scan_fixed(torch.where(mask, d1, scalar(1.0, dev)), axis=1)
    zero = scalar(0.0, dev)
    brow = torch.zeros((len(all_ds), dmax), dtype=torch.float32, device=dev)
    fstores = torch.zeros(len(all_ds), dtype=torch.float32, device=dev)
    ys = []
    for m in range(M):
        ys.append(brow)
        fs = scan(torch.where(mask, d2 * brow, zero), fstores[:, None])
        brow = xl[m] + fs * fb
        fstores = fs[:, -1]
    ys = torch.stack(ys)                                      # [M, L, Dmax]
    outs, lane = [], 0
    for cs in comb_sets:
        acc = torch.zeros(total, dtype=torch.float32, device=dev)
        for D in cs:
            mk = -(-total // D)
            acc = acc + ys[:mk, lane, :D].reshape(-1)[:total]
            lane += 1
        outs.append(acc)
    return torch.stack(outs, dim=1)


def _allpass_whole(x: torch.Tensor, D: int) -> torch.Tensor:
    """Whole-signal Freeverb allpass: b_n = x_{n-D} + g*b_{n-D} couples
    only indices D apart, so it is D independent lanes — reshape to [M, D]
    and scan along the block axis.  y_n = b_n - x_n."""
    dev = x.device
    n = x.shape[0]
    M = -(-n // D) + 1
    z = lambda k: torch.zeros(k, dtype=torch.float32, device=dev)
    xd = torch.cat([z(D), x, z(M * D - n - D)]).reshape(M, D)
    b = affine_scan(torch.full((M, D), 0.5, dtype=torch.float32, device=dev),
                    xd, 0.0, axis=0)
    return b.reshape(-1)[:n] - x


def _reverb_networks_whole(mono_in: torch.Tensor, nets, feedback,
                           damp) -> list:
    """Whole-signal networks from zero state (the offline Sample op): the
    comb stage batched over every channel's lanes, then the allpasses."""
    dev = mono_in.device
    fb = _f32(feedback, dev)
    d1 = _f32(damp, dev)
    d2 = 1.0 - d1
    total = int(mono_in.shape[0])
    all_ds = tuple(D for combs, _ in nets for D in combs)
    packed = 2 * (-(-total // min(all_ds))) * len(all_ds) * max(all_ds) * 4
    if packed > COMB_PACK_BYTES_CAP:
        return reverb_networks_apply(
            [reverb_zero_state(combs, aps, dev) for combs, aps in nets],
            mono_in, nets, fb, d1)[1]
    comb_sums = _comb_stage_whole(mono_in, [c for c, _ in nets], fb, d1, d2)
    outs = []
    for i, (_, aps) in enumerate(nets):
        out = comb_sums[:, i]
        for D in aps:
            out = _allpass_whole(out, D)
        outs.append(out)
    return outs


def reverb(frames: torch.Tensor, samplerate: int, roomsize: float,
           damping: float, wet: float, dry: float, stereo_width: float,
           tail_frames: int) -> torch.Tensor:
    """Freeverb-style reverb on an int [n, ch] tensor; spec and tolerance:
    goldref.effects.reverb."""
    from . import coeffs as gfx
    feedback, damp, wet1, wet2 = gfx.reverb_params(roomsize, damping, wet,
                                                   stereo_width)
    return reverb_from_params(frames, samplerate, feedback, damp, wet1, wet2,
                              dry, tail_frames)


def reverb_from_params(frames: torch.Tensor, samplerate: int, feedback, damp,
                       wet1, wet2, dry, tail_frames: int) -> torch.Tensor:
    """Reverb with the derived (feedback, damp, wet1, wet2, dry)
    parameters."""
    from . import coeffs as gfx
    dev = frames.device
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    total = n + int(tail_frames)
    s = torch.cat([_norm(frames),
                   torch.zeros((total - n, nch), dtype=torch.float32,
                               device=dev)])
    mono_in = torch.sum(s, dim=1) * float(np.float32(gfx.FIXED_GAIN))
    dry, wet1, wet2 = (_f32(v, dev) for v in (dry, wet1, wet2))
    if nch == 1:
        combs, aps = gfx.reverb_delays(samplerate, 0)
        rev = _reverb_networks_whole(mono_in, [(combs, aps)], feedback,
                                     damp)[0]
        out = dry * s[:, 0] + (wet1 + wet2) * rev
        return to_int_samples(out[:, None], width)
    revs = _reverb_networks_whole(
        mono_in, [gfx.reverb_delays(samplerate, ch) for ch in range(2)],
        feedback, damp)
    out = torch.stack([
        dry * s[:, 0] + wet1 * revs[0] + wet2 * revs[1],
        dry * s[:, 1] + wet1 * revs[1] + wet2 * revs[0],
    ], dim=1)
    return to_int_samples(out, width)


# ---------------------------------------------------------------------------
# Chorus
# ---------------------------------------------------------------------------

def _chorus_lfo_delay(n0: int, n: int, samplerate: int, rate: float, depth,
                      delay, voice: int, voices: int, channel: int,
                      device, P=None) -> torch.Tensor:
    """The spec's integer-DDS delay curve (goldref.effects.chorus_delay_f32):
    the phase wraps as an i32 (held as int64 masked to 32 bits, then read
    signed), x = p * 2^-32 in [-0.5, 0.5), which the turn-unit sine folds
    like [0, 1).  With ``P`` (an int64 [n] tensor of u32 cumulative phases,
    the rate automation's host grid, ``ops.coeffs.chorus_phase_grid``) the
    phase is the voice's start phase plus P_n, and ``rate``/``n0`` are
    unused; ``depth`` may be a per-frame [n] grid."""
    phi = (voice / voices + 0.25 * channel) % 1.0
    p0 = int(round(phi * 4294967296.0)) & 0xFFFFFFFF
    if P is not None:
        p = (p0 + P) & 0xFFFFFFFF
    else:
        inc = int(round(float(rate) / samplerate * 4294967296.0)) & 0xFFFFFFFF
        idx = int(n0) + torch.arange(n, dtype=torch.int64, device=device)
        p = (p0 + idx * inc) & 0xFFFFFFFF
    p = torch.where(p >= (1 << 31), p - (1 << 32), p)
    x = p.to(torch.float32) * float(2.0 ** -32)
    lfo = 0.5 + 0.5 * sin_turns(x)
    return (_f32(delay, device) + _f32(depth, device) * lfo) \
        * float(np.float32(samplerate))


def chorus_core(s: torch.Tensor, n0: int, hist: torch.Tensor,
                samplerate: int, rate, depth, delay, voices: int, wet,
                dry, P=None) -> torch.Tensor:
    """Chorus on a normalized f32 chunk [n, ch] starting at absolute frame
    ``n0``, reading past input from ``hist`` [H, ch] (the H frames before
    n0; zeros at stream start).  Gathers and a lerp, no recurrence;
    ``wet``/``dry`` and ``depth`` may be per-frame [n] arrays, and ``P``
    replaces the static-rate LFO phase (rate automation, see
    ``_chorus_lfo_delay``)."""
    dev = s.device
    n, nch = s.shape
    H = hist.shape[0]
    ext = torch.cat([hist.to(torch.float32), s])   # position j: ext[H + j]
    prev = torch.cat([torch.zeros((1, nch), dtype=torch.float32, device=dev),
                      ext[:-1]])
    dryv = _f32(dry, dev)
    if dryv.ndim == 1:
        dryv = dryv[:, None]
    out = dryv * s
    wv = div(_f32(wet, dev), voices)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    zero = scalar(0.0, dev)
    lim = H + n - 1
    cols = []
    for c in range(nch):
        acc = out[:, c]
        for v in range(voices):
            d = _chorus_lfo_delay(n0, n, samplerate, rate, depth, delay,
                                  v, voices, c, dev, P)
            df = torch.floor(d)
            fr = d - df
            i0 = H + idx - df.to(torch.int64)       # ext row of s[n - df]
            gi = i0.clamp(0, lim)
            x0 = torch.where(i0 - 1 >= 0, prev[gi, c], zero)
            x1 = torch.where(i0 >= 0, ext[gi, c], zero)
            acc = acc + wv * (x0 * fr + x1 * (1.0 - fr))
        cols.append(acc)
    return torch.stack(cols, dim=1)


def chorus(frames: torch.Tensor, samplerate: int, rate: float, depth: float,
           delay: float, voices: int, wet: float, dry: float) -> torch.Tensor:
    """Multi-voice modulated fractional delay; spec and tolerance:
    goldref.effects.chorus."""
    width = dpcm.width_of(frames)
    nch = frames.shape[1]
    out = chorus_core(_norm(frames), 0,
                      torch.zeros((0, nch), dtype=torch.float32,
                                  device=frames.device),
                      samplerate, rate, depth, delay, voices, wet, dry)
    return to_int_samples(out, width)


# ---------------------------------------------------------------------------
# FFT convolution
# ---------------------------------------------------------------------------

def _fft_conv_full(s: torch.Tensor, ir_norm: torch.Tensor, wet,
                   dry) -> torch.Tensor:
    """y = dry*pad(s) + wet*(s * ir), full length n+m-1, f32 FFTs (spec:
    goldref.effects.convolve)."""
    dev = s.device
    n, nch = s.shape
    if ir_norm.ndim == 1:
        ir_norm = ir_norm[:, None]
    m = ir_norm.shape[0]
    out_len = n + m - 1
    fft_len = 1 << (out_len - 1).bit_length()
    X = torch.fft.rfft(s, n=fft_len, dim=0)
    if ir_norm.shape[1] != nch:
        ir_norm = ir_norm[:, :1].expand(m, nch)
    Hf = torch.fft.rfft(ir_norm, n=fft_len, dim=0)
    y = torch.fft.irfft(X * Hf, n=fft_len, dim=0)[:out_len]
    y = _f32(wet, dev) * y
    return torch.cat([y[:n] + _f32(dry, dev) * s, y[n:]])


def convolve(frames: torch.Tensor, ir_norm: torch.Tensor, wet: float,
             dry: float) -> torch.Tensor:
    """Whole-signal convolution op (length n+m-1); spec and tolerance:
    goldref.effects.convolve."""
    width = dpcm.width_of(frames)
    return to_int_samples(_fft_conv_full(_norm(frames), ir_norm, wet, dry),
                          width)


def convolve_chunk(frames: torch.Tensor, ir_norm: torch.Tensor, wet, dry,
                   tail: torch.Tensor):
    """Streaming overlap-add twin: convolve one chunk, emit the first n
    frames (plus the carried tail) and return the new (m-1)-frame tail."""
    width = dpcm.width_of(frames)
    n = frames.shape[0]
    m = ir_norm.shape[0]
    y = _fft_conv_full(_norm(frames), ir_norm, wet, dry)
    if m > 1:
        y = torch.cat([y[:m - 1] + tail, y[m - 1:]])
        new_tail = y[n:]
    else:
        new_tail = tail
    return to_int_samples(y[:n], width), new_tail


# ---------------------------------------------------------------------------
# Overlap-add in a fixed order
# ---------------------------------------------------------------------------

def _groups(starts: np.ndarray, length: int):
    """Split segments [start, start + length) into groups whose members do
    not overlap: greedy in index order, each segment into the first group
    whose last segment ends at or before its start.  Host integers."""
    ends, groups = [], []
    for i, st in enumerate(starts.tolist()):
        for g, end in enumerate(ends):
            if end <= st:
                groups[g].append(i)
                ends[g] = st + length
                break
        else:
            groups.append([i])
            ends.append(st + length)
    return [np.asarray(g, np.int64) for g in groups]


def overlap_add(segs: torch.Tensor, starts: np.ndarray,
                out_len: int) -> torch.Tensor:
    """Sum segments ``segs`` [S, length, ...] placed at host-known
    ``starts`` onto a zero canvas of ``out_len`` rows; parts past the end
    are dropped.  Segments are added group by group (``_groups``), groups in
    index order, with plain indexed writes to distinct rows: no atomics, so
    the result is the same on every run."""
    dev = segs.device
    length = segs.shape[1]
    out = torch.zeros((out_len,) + tuple(segs.shape[2:]), dtype=segs.dtype,
                      device=dev)
    for g in _groups(np.asarray(starts, np.int64), length):
        rows = (starts[g][:, None] + np.arange(length)[None, :]).reshape(-1)
        keep = rows < out_len
        sel = torch.from_numpy(np.nonzero(keep)[0]).to(dev)
        idx = torch.from_numpy(rows[keep]).to(dev)
        vals = segs[torch.from_numpy(g).to(dev)].reshape(
            (-1,) + tuple(segs.shape[2:]))
        out[idx] = out[idx] + vals[sel]
    return out


# ---------------------------------------------------------------------------
# Phase-vocoder time stretch
# ---------------------------------------------------------------------------

def stretch(frames: torch.Tensor, factor: float, frame: int = 2048,
            hop: int = 512) -> torch.Tensor:
    """Phase-vocoder time stretch; spec, grid and tolerance:
    goldref.effects.stretch.  One gather builds all [T, frame] windows,
    batched rfft/irfft over the frame axis (the analysis in f64, so that
    magnitudes and phases round to the same f32 on every device), the
    per-bin phase accumulation is a parallel prefix sum
    (``associative_scan``), and the overlap-add runs in a fixed order
    (``overlap_add``)."""
    from .coeffs import stretch_grid
    dev = frames.device
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    starts_np, target = stretch_grid(n, factor, frame, hop)
    T = len(starts_np)
    n_pad = max(n, int(starts_np[-1]) + frame)
    s = torch.cat([_norm(frames),
                   torch.zeros((n_pad - n, nch), dtype=torch.float32,
                               device=dev)])
    win_np = np.hanning(frame + 1)[:frame]
    win = torch.from_numpy(win_np.astype(np.float32)).to(dev)
    K = frame // 2 + 1
    omega = (2.0 * np.pi / frame) * np.arange(K)
    hops = np.diff(starts_np).astype(np.float64)
    om_hops = torch.from_numpy(
        (omega[None, :] * hops[:, None]).astype(np.float32)).to(dev)
    hop_scale = torch.from_numpy((hop / hops).astype(np.float32)).to(dev)
    two_pi = scalar(2.0 * np.pi, dev)
    out_len = (T - 1) * hop + frame
    wsum = np.zeros(out_len, np.float64)
    for j in range(T):
        wsum[j * hop:j * hop + frame] += win_np ** 2
    inv_wsum = torch.from_numpy(
        (1.0 / np.maximum(wsum, 1e-8)).astype(np.float32)).to(dev)
    gidx = torch.from_numpy(starts_np[:, None]
                            + np.arange(frame)[None, :]).to(dev)
    syn_starts = np.arange(T, dtype=np.int64) * hop
    cols = []
    for c in range(nch):
        seg = s[:, c][gidx] * win[None, :]                    # [T, frame]
        # the analysis in f64, rounded once to f32: the wrap below is a
        # discontinuous function of the phase, and an f32 FFT and atan2
        # differ by an ulp between cuFFT/CUDA and the CPU's, enough to flip
        # a bin's 2*pi wrap and shift its phase for the rest of the signal
        spec = torch.fft.rfft(seg.to(torch.float64), dim=1)   # [T, K] c128
        mag = torch.abs(spec).to(torch.float32)
        phi = torch.atan2(spec.imag, spec.real).to(torch.float32)
        dphi = phi[1:] - phi[:-1] - om_hops
        wrapped = dphi - two_pi * torch.round(dphi / two_pi)
        adv_syn = (om_hops + wrapped) * hop_scale[:, None]
        (csum,) = associative_scan(lambda l, r: (l[0] + r[0],), (adv_syn,))
        psi = torch.cat([phi[:1], phi[:1] + csum])
        spec_s = torch.complex(mag * torch.cos(psi), mag * torch.sin(psi))
        seg_s = torch.fft.irfft(spec_s, n=frame, dim=1) * win[None, :]
        cols.append(overlap_add(seg_s, syn_starts, out_len) * inv_wsum)
    out = torch.stack(cols, dim=1)
    if target > out_len:
        out = torch.cat([out, torch.zeros((target - out_len, nch),
                                          dtype=torch.float32, device=dev)])
    return to_int_samples(out[:target], width)


# ---------------------------------------------------------------------------
# Granular synthesis
# ---------------------------------------------------------------------------

def granulate(frames: torch.Tensor, samplerate: int, duration: float,
              grain: float, density: float, jitter: float, amplitude,
              seed: int) -> torch.Tensor:
    """Granular resynthesis; spec, grid and tolerance:
    goldref.effects.granulate.  One [G, L] gather builds every grain, one
    window multiply, then the grains are added onto the canvas in a fixed
    order (``overlap_add``) — not with an atomic scatter-add."""
    from .coeffs import grain_grid
    dev = frames.device
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    in_pos, out_pos, L, out_len = grain_grid(n, samplerate, duration, grain,
                                             density, jitter, seed)
    s = torch.cat([_norm(frames),
                   torch.zeros((max(n, L) - n, nch), dtype=torch.float32,
                               device=dev)])
    win = torch.from_numpy(np.hanning(L + 1)[:L].astype(np.float32)).to(dev) \
        * _f32(amplitude, dev)
    gi = torch.from_numpy(in_pos[:, None] + np.arange(L)[None, :]).to(dev)
    grains = s[gi] * win[None, :, None]                       # [G, L, ch]
    return to_int_samples(overlap_add(grains, out_pos, out_len), width)


# ---------------------------------------------------------------------------
# LFO gains, feedback echo, stereo width
# ---------------------------------------------------------------------------

def tremolo(frames: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-frame tremolo gain grid (host-derived,
    ops.coeffs.tremolo_gain_grid) through the house gain rule.  Spec:
    goldref.effects.tremolo."""
    return dpcm.gain_apply(frames, g[:, None])


def autopan(frames: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
    """Per-frame pan grid (host-derived, ops.coeffs.autopan_pan_grid)
    through the equal-gain pan law.  Spec: goldref.effects.autopan."""
    lg = torch.clamp_max(1.0 - pan, 1.0)
    rg = torch.clamp_max(1.0 + pan, 1.0)
    return dpcm.gain_apply(frames, torch.stack([lg, rg], dim=1))


def feedback_echo_core(s: torch.Tensor, D: int, fb, hist: torch.Tensor):
    """The feedback-delay recurrence d_n = s_n + fb_n * d_{n-D}, block by
    block of D frames (each element's arithmetic is the per-sample
    oracle's; spec: goldref.effects.feedback_echo): a loop of ceil(n/D)
    steps of two launches.  ``s`` [n, ch] normalized f32; ``fb`` scalar or
    [n] grid; ``hist`` [D, ch] = the d values of the D frames before s.
    Returns (e, new_hist) with e_n = d_{n-D} (the wet tap)."""
    dev = s.device
    n, nch = s.shape
    nb = -(-n // D)
    pad = nb * D - n
    sp = torch.cat([s, torch.zeros((pad, nch), dtype=torch.float32,
                                   device=dev)]).reshape(nb, D, nch)
    fbv = _f32(fb, dev).expand(n)
    fbp = torch.cat([fbv, torch.zeros(pad, dtype=torch.float32,
                                      device=dev)]).reshape(nb, D, 1)
    prev = hist
    blocks = []
    for b in range(nb):
        prev = sp[b] + fbp[b] * prev
        blocks.append(prev)
    d = torch.cat(blocks)[:n] if blocks else s[:0]
    e = torch.cat([hist, d])[:n]
    new_hist = torch.cat([hist, d])[n:n + D] if n < D else d[n - D:n]
    return e, new_hist


def feedback_echo(frames: torch.Tensor, D: int, fb, wet, dry,
                  tail_frames: int) -> torch.Tensor:
    """Whole-signal feedback echo: zero-pads by ``tail_frames``, runs the
    blocked recurrence cold, mixes dry*s + wet*e.  Spec/budget:
    goldref.effects.feedback_echo."""
    dev = frames.device
    width = dpcm.width_of(frames)
    n, nch = frames.shape
    total = n + int(tail_frames)
    s = torch.cat([_norm(frames),
                   torch.zeros((total - n, nch), dtype=torch.float32,
                               device=dev)])
    e, _ = feedback_echo_core(s, D, fb, torch.zeros(
        (D, nch), dtype=torch.float32, device=dev))
    out = _f32(dry, dev) * s + _f32(wet, dev) * e
    return to_int_samples(out, width)


def stereo_width(frames: torch.Tensor, amount) -> torch.Tensor:
    """Mid/side width control; spec: goldref.effects.stereo_width.
    ``amount`` scalar or [n] grid."""
    width = dpcm.width_of(frames)
    s = _norm(frames)
    a = _f32(amount, frames.device).expand(frames.shape[0])
    m = 0.5 * (s[:, 0] + s[:, 1])
    sd = 0.5 * (s[:, 0] - s[:, 1])
    return to_int_samples(torch.stack([m + a * sd, m - a * sd], dim=1), width)


# ---------------------------------------------------------------------------
# Lookahead brickwall limiter
# ---------------------------------------------------------------------------

def limiter_gains_core(a: torch.Tensor, ceil_db, decay, L: int, r0=0.0,
                       gpad0=None):
    """Per-sample limiter gains from the linked detector level ``a`` (spec:
    goldref.effects.limiter_gains).  ``a`` includes the L frames of
    lookahead past the emission range; gains come back for the first
    len(a) - L positions.  The window max is an unfolded max (exact in any
    order), the release the decaying-max scan, and the box attack ramp adds
    its L+1 terms one after the other, in the window's order (the
    reference's ``reduce_window`` sum).  ``r0`` carries the release state,
    ``gpad0`` [L] the previous chunk's trailing gains (ones at a cold
    start).  Returns (gs, new_r, new_gpad)."""
    dev = a.device
    n_em = a.shape[0] - L
    need = torch.clamp_min(_level_db(a) - _f32(ceil_db, dev), 0.0)
    w = need.unfold(0, L + 1, 1).amax(dim=1)                 # [n_em]
    R = decaying_max_scan(w, decay, init=r0)
    g = torch.exp2(-R * (1.0 / 6.0206))
    if gpad0 is None:
        gpad0 = torch.ones(L, dtype=torch.float32, device=dev)
    gp = torch.cat([gpad0, g])
    acc = gp[0:n_em]
    for k in range(1, L + 1):
        acc = acc + gp[k:k + n_em]
    gs = acc * float(np.float32(1.0 / (L + 1)))
    new_r = R[-1] if n_em > 0 else _f32(r0, dev)
    return gs, new_r, gp[n_em:n_em + L]


def limiter(frames: torch.Tensor, ceil_db, decay, L: int,
            ceil_int: int) -> torch.Tensor:
    """Whole-signal lookahead limiter: gains over the zero-padded window,
    the house gain rule, then the hard integer clamp at ``ceil_int``.
    Length preserved.  Spec: goldref.effects.limiter."""
    a = torch.amax(torch.abs(_norm(frames)), dim=1)
    ap = torch.cat([a, torch.zeros(L, dtype=torch.float32,
                                   device=frames.device)])
    gs, _, _ = limiter_gains_core(ap, ceil_db, decay, L)
    y = dpcm.gain_apply(frames, gs[:, None])
    return torch.clamp(y, -int(ceil_int), int(ceil_int))


# ---------------------------------------------------------------------------
# Phaser (LFO-swept allpass cascade)
# ---------------------------------------------------------------------------

def phaser_apply(s: torch.Tensor, grids, states, ff: bool):
    """The phaser's allpass cascade on a normalized f32 signal: every stage
    shares the SAME per-frame coefficient grids (ops.coeffs.
    phaser_coeff_grids) and keeps its own biquad state; ``ff`` routes
    badly-conditioned sweeps through the float-float scan.  Returns (y,
    new_states).  Spec/budget: goldref.effects.phaser."""
    new_states = []
    y = s
    for st in states:
        if ff:
            y, ns = biquad_apply_ff(y, grids, st)
        else:
            y, ns = biquad_apply(y, grids, st)
        new_states.append(ns)
    return y, tuple(new_states)
