"""Exact ratecv and the windowed-sinc resampler (port of
``synthesizer_tpu.ops.resample``).

**ratecv.**  The reference resamples through C ``audioop.ratecv``, a
stateful DDA linear interpolator whose exact recurrence is written down in
``goldref.pcm.ratecv``.  Here the same recurrence is a closed-form gather:
output ``k`` reads input frames ``i_k - 1`` / ``i_k - 2`` where
``i_k = ceil((k*inrate - d0) / outrate)`` and blends them at weight
``d_k = d0 + i_k*outrate - k*inrate``, in audioop's 32-bit domain::

    q = trunc(((prev << sh) * d + (cur << sh) * (outr - d)) / outr) >> sh

with ``sh = 32 - 8*width``.  ``|S| < 2^31 * outr < 2^62``, so one int64
division is exact for every width and every rate pair: PyTorch has int64 on
the CPU and on the card.  (The JAX package has no int64 on its device and
routes through three limb-division formulas and input segments instead.)
Chunked use carries ``(d, prev, cur)`` exactly like audioop, so output over
chunks is bit-identical to output over the whole buffer.

**hq.**  The windowed-sinc polyphase resampler (spec and output-length rule:
``goldref.effects.hq_resample``) computes each output as a tap sum in a
fixed order::

    y[j] = sum_{t = 0 .. T-1} h[phi_j + t*L] * x[k0_j - t]      (t ascending)

with ``phi_j = (j*M + C) % L`` and ``k0_j = (j*M + C) // L``.  Each step is
a gather, a multiply and an add as separate eager ops, so nothing is
contracted or regrouped: the streaming twin, which computes the same sum for
the same ``j`` from a history ring, is bit-identical to the offline op at
every chunk size, and the card is bit-identical to the CPU.  It is not a
``conv1d``: cuDNN picks its algorithm (and its summation order) per shape
and runs TF32 by default.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import pcm as dpcm
from .effects import to_int_samples
from .wave import div


class RatecvState(NamedTuple):
    """Resampler carry in the *sample* domain (not audioop's 32-bit
    domain).  ``prev``/``cur`` are [nchannels] arrays or tensors."""
    d: int
    prev: object
    cur: object

    def to_audioop(self, width: int) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
        sh = 32 - 8 * width
        return (int(self.d), tuple(
            (int(p) << sh, int(c) << sh) for p, c in zip(self.prev, self.cur)))

    @classmethod
    def initial(cls, nchannels: int, outrate_reduced: int) -> "RatecvState":
        return cls(-outrate_reduced,
                   np.zeros(nchannels, np.int32), np.zeros(nchannels, np.int32))


def _reduce(inrate: int, outrate: int) -> Tuple[int, int]:
    if inrate <= 0 or outrate <= 0:
        raise ValueError("sampling rates must be > 0")
    if inrate >= (1 << 31) or outrate >= (1 << 31):
        # audioop's own domain (C int rates); the int64 interpolation needs
        # |S| < 2^31 * outr < 2^62
        raise ValueError("sampling rates must be < 2**31")
    g = math.gcd(inrate, outrate)
    return inrate // g, outrate // g


def nframes_out(nframes_in: int, inrate: int, outrate: int,
                d0: Optional[int] = None) -> int:
    inr, outr = _reduce(inrate, outrate)
    if d0 is None:
        d0 = -outr
    kmax = nframes_in * outr + d0
    return 0 if kmax < 0 else kmax // inr + 1


def _ratecv(x: torch.Tensor, prev0: torch.Tensor, cur0: torch.Tensor,
            inr: int, outr: int, d0: int, nout: int):
    """x: [L, ch] int8/int16/int32 -> (y [nout, ch], prev_end, cur_end), all
    on x's device.  ``prev0``/``cur0`` are [ch] tensors of x's dtype."""
    L = x.shape[0]
    width = dpcm.width_of(x)
    dev = x.device
    xi = x.to(torch.int64)
    p0 = prev0.to(device=dev, dtype=torch.int64)
    c0 = cur0.to(device=dev, dtype=torch.int64)
    k = torch.arange(nout, dtype=torch.int64, device=dev)
    # ceil((k*inr - d0)/outr) through the floor-division identity
    ik = -torch.div(d0 - k * inr, outr, rounding_mode="floor")
    dk = (d0 + ik * outr - k * inr)[:, None]
    cur_idx = (ik - 1)[:, None]
    prev_idx = (ik - 2)[:, None]
    last = max(L - 1, 0)
    if L:
        cur_x = xi[(ik - 1).clamp(0, last)]
        prev_x = xi[(ik - 2).clamp(0, last)]
    else:
        cur_x = prev_x = torch.zeros((nout, x.shape[1]), dtype=torch.int64,
                                     device=dev)
    cur = torch.where(cur_idx >= 0, cur_x, c0[None, :])
    prev = torch.where(prev_idx >= 0, prev_x,
                       torch.where(prev_idx == -1, c0[None, :], p0[None, :]))
    scale = 1 << (32 - 8 * width)       # a product: no negative is shifted
    s = (prev * scale) * dk + (cur * scale) * (outr - dk)
    q = torch.div(s, outr, rounding_mode="trunc")
    y = (q >> (32 - 8 * width)).to(x.dtype)
    if L >= 2:
        prev_end, cur_end = x[L - 2], x[L - 1]
    elif L == 1:
        prev_end, cur_end = cur0.to(device=dev, dtype=x.dtype), x[0]
    else:
        prev_end = prev0.to(device=dev, dtype=x.dtype)
        cur_end = cur0.to(device=dev, dtype=x.dtype)
    return y, prev_end.clone(), cur_end.clone()


def _as_state_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """A carried prev/cur (array or tensor) on ``like``'s device and dtype."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.int64))
    return v.to(device=like.device, dtype=like.dtype)


def resample(x, inrate: int, outrate: int,
             state: Optional[RatecvState] = None,
             width: Optional[int] = None, device="cuda"):
    """Resample [n, ch] int samples from inrate to outrate, audioop-exact.
    Returns the output and the carry state for chunked streaming.  A tensor
    is resampled on its own device and its output stays there.  A numpy
    array is copied to ``device`` (the card, unless the caller asks for the
    CPU), resampled there, and its output and state come back as numpy."""
    from ..utils.device import resolve, to_host
    host = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(x)).to(resolve(device)) \
        if host else x
    if t.ndim == 1:
        t = t[:, None]
    nch = t.shape[1]
    if width is not None and width != dpcm.width_of(t):
        raise ValueError(f"width {width} does not match dtype {t.dtype} "
                         "(the sample domain is the dtype)")
    inr, outr = _reduce(inrate, outrate)
    if state is None:
        state = RatecvState.initial(nch, outr)
    d = int(state.d)
    kmax = t.shape[0] * outr + d
    nout = 0 if kmax < 0 else kmax // inr + 1
    y, prev, cur = _ratecv(t, _as_state_tensor(state.prev, t),
                           _as_state_tensor(state.cur, t), inr, outr, d, nout)
    d = d + t.shape[0] * outr - nout * inr
    if host:
        return to_host(y), RatecvState(d, to_host(prev), to_host(cur))
    return y, RatecvState(d, prev, cur)


def resample_tensor(x: torch.Tensor, inrate: int, outrate: int) -> torch.Tensor:
    """Whole-buffer resample of an [n, ch] int tensor from a fresh stream,
    on its device (the reference's ``resample_jax``)."""
    inr, outr = _reduce(inrate, outrate)
    zeros = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    y, _, _ = _ratecv(x, zeros, zeros, inr, outr, -outr,
                      nframes_out(x.shape[0], inr, outr))
    return y


class StreamingResampler:
    """Chunked ratecv on the device: push chunks of any size, get exact
    audioop-compatible output without the signal leaving the device.

    The ``d`` phase of the DDA evolves deterministically
    (d' = d + L*outr - nout*inr), so the host mirrors it with integer
    arithmetic and knows each chunk's output count without a device ->
    host copy; ``prev``/``cur`` stay on the device.

    >>> rs = StreamingResampler(44100, 48000, nchannels=2, device="cuda")
    >>> y, n = rs.push(chunk)          # y: [n, ch] on the chunk's device
    """

    def __init__(self, inrate: int, outrate: int, nchannels: int = 2,
                 dtype=torch.int16, device="cuda"):
        from ..utils.device import resolve
        dev = resolve(device)
        self.inr, self.outr = _reduce(inrate, outrate)
        self.d = -self.outr
        self.prev = torch.zeros(nchannels, dtype=dtype, device=dev)
        self.cur = torch.zeros(nchannels, dtype=dtype, device=dev)

    def out_count(self, nframes_in: int) -> int:
        kmax = nframes_in * self.outr + self.d
        return 0 if kmax < 0 else kmax // self.inr + 1

    def max_out(self, nframes_in: int) -> int:
        """The largest output count a chunk of this size can give."""
        return nframes_in * self.outr // self.inr + 1

    def push(self, x: torch.Tensor):
        """x: [L, ch] int tensor -> (output [n, ch], n)."""
        L = int(x.shape[0])
        nout = self.out_count(L)
        y, self.prev, self.cur = _ratecv(x, self.prev, self.cur, self.inr,
                                         self.outr, self.d, nout)
        self.d = self.d + L * self.outr - nout * self.inr
        return y, nout


# ---------------------------------------------------------------------------
# High-quality polyphase resampler (windowed sinc, fixed-order tap sum)
# ---------------------------------------------------------------------------

#: Largest reduced up- or down-factor the hq path accepts (the prototype
#: filter has 32 * max(L, M) taps).  Every standard audio-rate pair reduces
#: to L, M <= 640; a coprime pair such as 44100 -> 44101 is refused.
HQ_MAX_FACTOR = 2048


def bounded_ratio(outrate: int, inrate: int,
                  maxterm: int = HQ_MAX_FACTOR) -> Tuple[int, int]:
    """Best rational approximation (L, M) of outrate/inrate with BOTH
    terms <= ``maxterm`` (continued-fraction convergent via
    Fraction.limit_denominator).  Used by Sample.speed(quality='hq') for
    arbitrary-real speed ratios.  Spec twin: goldref.sample._bounded_ratio.
    Raises for ratios that cannot fit (|log2 ratio| > log2 maxterm)."""
    from fractions import Fraction
    if outrate < 1 or inrate < 1:
        raise ValueError("rates must be positive")
    # bound the denominator so the numerator lands under maxterm too
    # (numerator ~= ratio*denominator); back off if the convergent's
    # rounding still overshoots by one
    limit = min(maxterm, maxterm * inrate // outrate)
    while limit >= 1:
        f = Fraction(outrate, inrate).limit_denominator(limit)
        if f.numerator < 1:
            break
        if max(f.numerator, f.denominator) <= maxterm:
            return f.numerator, f.denominator
        limit -= 1
    raise ValueError(
        f"speed ratio {inrate}/{outrate} is beyond the {maxterm}x range "
        f"of the quality='hq' polyphase bank")


def _check_factor(L: int, M: int) -> None:
    if max(L, M) > HQ_MAX_FACTOR:
        raise ValueError(
            f"quality='hq' supports rational rate ratios up to "
            f"{HQ_MAX_FACTOR} after gcd reduction; got {L}/{M}")


@functools.lru_cache(maxsize=32)
def _hq_filter(L: int, M: int) -> Tuple[np.ndarray, int, int]:
    """(h as f32, T taps per leg, C the filter's centre) for the reduced
    ratio L/M; h is the f64 prototype rounded once to f32."""
    from .coeffs import hq_resample_filter
    h = hq_resample_filter(L, M)
    return h.astype(np.float32), len(h) // L, (len(h) - 1) // 2


@functools.lru_cache(maxsize=32)
def _hq_taps_on(L: int, M: int, device: torch.device) -> torch.Tensor:
    """The f32 prototype filter on ``device``, copied there once (a stream
    pushes many small blocks)."""
    return torch.from_numpy(_hq_filter(L, M)[0]).to(device)


#: outputs per block of the tap sum at 32 taps per leg; a block of T taps
#: a leg holds HQ_BLOCK * 32 // T outputs, so that its [block, T, ch]
#: windows and products take the same memory at every rate ratio
HQ_BLOCK = 1 << 19


def _hq_taps(s: torch.Tensor, first: int, j0: int, j1: int, L: int, M: int,
             limit: int) -> torch.Tensor:
    """Outputs j0 .. j1-1 of the tap sum over ``s`` [rows, ch] f32, whose
    row r holds global input frame ``first + r``; frames outside
    ``[max(first, 0), limit)`` read as zero.  -> [j1 - j0, ch] f32.

    Per block of outputs: one gather of the [block, T] input window and of
    the taps, one multiply, then the T products added one after the other
    (t ascending) — about T + 10 launches a block, the same roundings for
    every block size.  Outputs are independent, so the block size is free:
    it shrinks as T grows (``HQ_BLOCK``)."""
    _, T, C = _hq_filter(L, M)
    dev = s.device
    h = _hq_taps_on(L, M, dev)
    rows = s.shape[0]
    lo = max(first, 0) - first
    hi = min(limit - first, rows)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    taps = torch.arange(T, dtype=torch.int64, device=dev)
    block = max(1, HQ_BLOCK * 32 // T)
    out = []
    for b0 in range(j0, j1, block):
        j = torch.arange(b0, min(b0 + block, j1), dtype=torch.int64,
                         device=dev)
        phi = (j * M + C) % L
        k0 = torch.div(j * M + C, L, rounding_mode="floor")
        r = k0[:, None] - first - taps[None, :]                   # [B, T]
        valid = ((r >= lo) & (r < hi))[:, :, None]
        xv = torch.where(valid, s[r.clamp(0, max(rows - 1, 0))], zero)
        prod = h[phi[:, None] + L * taps[None, :]][:, :, None] * xv
        acc = prod[:, 0]
        for t in range(1, T):
            acc = acc + prod[:, t]
        out.append(acc)
    return torch.cat(out) if len(out) != 1 else out[0]


def hq_resample(x: torch.Tensor, L: int, M: int, nout: int) -> torch.Tensor:
    """Windowed-sinc polyphase resample of an [n, ch] int tensor by the
    reduced ratio L/M to ``nout`` frames, on its device.  Spec,
    output-length rule and the <= 1 LSB (width 2) budget:
    goldref.effects.hq_resample."""
    _check_factor(L, M)
    width = dpcm.width_of(x)
    n = x.shape[0]
    if n == 0 or nout == 0:
        return x[:0]
    s = div(x.to(torch.float32), dpcm.MAXVAL[width])
    return to_int_samples(_hq_taps(s, 0, 0, nout, L, M, n), width)


class StreamingHQResampler:
    """Chunked twin of ``hq_resample``: push chunks of any size, get the
    windowed-sinc output BIT-IDENTICAL to the offline op at every chunk
    size, with the signal on the device.

    Output ``j`` is a pure function of the global output index (``y[j]``
    reads input anchor ``k0_j = (j*M + C) // L`` back through ``T`` taps,
    in the same order as the offline op), so the host mirrors ``j`` (next
    output) and ``n`` (inputs fed) in exact integers and the device keeps a
    history ring of the last ``hmax`` input frames.  The first output not
    yet emitted has ``k0 >= n``, so the next block reads no frame before
    ``n - (T - 1)``; the ring is longer than that.

    Offline emits ``nframes_out`` rows, the last few of which read
    zero-padded future input: call :meth:`flush` at the end of the stream
    to get that tail.

    >>> rs = StreamingHQResampler(44100, 48000, nchannels=2, device="cuda")
    >>> y, n = rs.push(chunk)     # y: [n, ch] rows, globally contiguous
    >>> y, n = rs.flush()         # the zero-padded tail
    """

    def __init__(self, inrate: int, outrate: int, nchannels: int = 2,
                 dtype=torch.int16, device="cuda"):
        from ..utils.device import resolve
        g = math.gcd(int(inrate), int(outrate))
        self.M, self.L = int(inrate) // g, int(outrate) // g
        _check_factor(self.L, self.M)
        if dtype not in (torch.int8, torch.int16, torch.int32):
            raise ValueError(
                f"unsupported dtype {dtype}: the hq resampler operates on "
                "integer PCM samples (int8/int16/int32)")
        _, self._t, self._c = _hq_filter(self.L, self.M)
        self.hmax = (self._t - 1) + self.M + self._c // self.L + 2
        self.width = dpcm.width_of(torch.empty(0, dtype=dtype))
        self.hist = torch.zeros((self.hmax, nchannels), dtype=dtype,
                                device=resolve(device))
        self.j = 0      # next global output index to emit
        self.n = 0      # global input frames consumed

    def _emittable(self, n_in: int) -> int:
        """Outputs [0, j_end) whose full window is inside the first
        ``n_in`` input frames: k0_j <= n_in - 1."""
        num = n_in * self.L - 1 - self._c
        return 0 if num < 0 else num // self.M + 1

    def total_out(self, n_in: int) -> int:
        """The offline output-length rule (nframes_out: (n-1)*L//M + 1)."""
        return nframes_out(n_in, self.M, self.L)

    def _block(self, chunk: torch.Tensor, j_end: int):
        n0 = self.n - int(chunk.shape[0])
        first = n0 - self.hmax              # global frame of buf's row 0
        buf = torch.cat([self.hist, chunk.to(self.hist.device)], dim=0)
        self.hist = buf[buf.shape[0] - self.hmax:].clone()
        cnt = j_end - self.j
        if cnt <= 0:
            return buf[:0], 0
        k_lo = (self.j * self.M + self._c) // self.L - (self._t - 1)
        k_hi = ((j_end - 1) * self.M + self._c) // self.L
        if k_lo < first:
            raise RuntimeError(
                f"hq stream: output {self.j} reads input frame {k_lo}, "
                f"before the history ring's first frame {first}")
        if k_hi > self.n - 1 + self._c // self.L:
            raise RuntimeError(
                f"hq stream: output {j_end - 1} reads input frame {k_hi}, "
                f"past the stream's zero-padded tail")
        s = div(buf.to(torch.float32), dpcm.MAXVAL[self.width])
        y = _hq_taps(s, first, self.j, j_end, self.L, self.M, self.n)
        self.j = j_end
        return to_int_samples(y, self.width), cnt

    def push(self, x: torch.Tensor):
        """x: [Lc, ch] int tensor -> ([n, ch] rows, n).  Rows continue
        exactly where the previous push/flush ended."""
        self.n += int(x.shape[0])
        return self._block(x, max(self.j, self._emittable(self.n)))

    def flush(self):
        """Emit the zero-padded tail so that the total row count equals the
        offline ``nframes_out`` rule.  Idempotent once drained."""
        return self._block(self.hist[:0], max(self.j, self.total_out(self.n)))
