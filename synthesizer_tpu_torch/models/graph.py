"""Device lowering of oscillator patch specs (port of
``synthesizer_tpu.models.graph``).

Turns a ``models.spec`` patch tree into a step function

    step(state, n0) -> (f32 values[blocksize], new_state)

which renders one fixed-size block of samples at absolute offset ``n0`` (a
Python int) as eager PyTorch on the patch's device.  Whole renders call the
step block after block in a Python loop (the JAX package scans over the
blocks inside one compiled program); streams call it as blocks are pulled.
Results are block-size invariant by construction: phase accumulators and
FM integrals are integer (wrapping u32, held as masked int64: see
``ops.wave``), delay/echo tails are carried exactly, envelopes/LFOs are
closed-form in the absolute sample index.  The ONE approximate node is
``Biquad`` (IIR): its parallel affine scan's f32 rounding depends on the
grouping, so block-size invariance and oracle agreement hold to a few LSB,
not bit-exactly (documented in the spec node).

No step writes into a tensor it was given or has handed out: states are
replaced, never updated in place, so a block a caller holds stays valid.

Numeric contract: ``goldref.osc``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from . import spec as S
from ..ops import wave as W
from ..ops.effects import companion_scan, to_int_samples
from ..ops.trig import sin_turns
from ..utils.device import resolve as _device
from ..utils.device import to_host

_TWO_PI = float(np.float32(2.0 * math.pi))
_U32 = W.U32

State = Any
StepFn = Callable[[State, int], Tuple[torch.Tensor, State]]


def poly_blep(t: torch.Tensor, dt: float) -> torch.Tensor:
    """Quadratic polyBLEP residual (spec: goldref.osc.poly_blep)."""
    return W.blep(t, W.scalar(max(dt, 1e-9), t.device))


def _noise_u32_host(idx: int, seed: int) -> int:
    """Host twin of the counter hash (pluck's static per-harmonic
    excitation constants; spec: goldref/spec.py docstring)."""
    M = 0xFFFFFFFF
    x = (idx * 0x9E3779B9 + (seed & M)) & M
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M
    x ^= x >> 15
    x = (x * 0x846CA68B) & M
    x ^= x >> 16
    return x


def _square(p: torch.Tensor, threshold) -> torch.Tensor:
    one = torch.ones((), dtype=torch.float32, device=p.device)
    return torch.where(p < threshold, one, -one)


def _wave_values(node: S.Osc, p: torch.Tensor, sr: int, n_abs: torch.Tensor,
                 pwm_vals, table: Optional[torch.Tensor]) -> torch.Tensor:
    """The waveform at u32 phases ``p`` (int64 [B]) and absolute frames
    ``n_abs`` (int64 [B]).  ``table`` is a wavetable node's table on the
    device (built once per lowering)."""
    k = node.kind
    dev = p.device
    if k == "sine":
        return sin_turns(W.phase_x(p))
    if k == "triangle":
        return W.triangle(W.phase_x(p))
    if k == "square":
        return _square(p, 1 << 31)
    if k == "sawtooth":
        return 2.0 * W.phase_x(p) - 1.0
    if k == "pulse":
        if pwm_vals is not None:
            w = torch.clamp(pwm_vals, float(np.float32(1.0 / 65536.0)),
                            float(np.float32(1.0 - 1.0 / 65536.0)))
            wu = (w * 4294967296.0).to(torch.int64)
        else:
            w = min(max(node.pulse_width, 1.0 / 65536.0), 1.0 - 1.0 / 65536.0)
            wu = int(np.float32(w) * 4294967296.0) & _U32
        return _square(p, wu)
    if k == "square_h":
        acc = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        for i in range(node.num_harmonics):
            kk = 2 * i + 1
            pk = (p * kk) & _U32
            acc = acc + W.div(sin_turns(W.phase_x(pk)), kk)
        return acc
    if k == "sawtooth_h":
        acc = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        for kk in range(1, node.num_harmonics + 1):
            pk = (p * kk) & _U32
            term = W.div(sin_turns(W.phase_x(pk)), kk)
            acc = acc + (term if kk % 2 == 1 else -term)
        return acc
    if k == "harmonics":
        acc = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        for ratio, amp in node.harmonics:
            amp = float(np.float32(amp))
            if float(ratio).is_integer():
                pk = (p * int(ratio)) & _U32
                acc = acc + amp * sin_turns(W.phase_x(pk))
            else:
                acc = acc + amp * torch.sin(
                    _TWO_PI * (float(np.float32(ratio)) * W.phase_x(p)))
        return acc
    if k == "white_noise":
        hold = max(1, int(round(sr / node.frequency))) if node.frequency > 0 else 1
        idx = (n_abs // hold) & _U32
        return W.noise_values(idx, node.seed & _U32)
    if k == "semicircle":
        return W.semicircle(W.phase_x(p))
    if k == "pointy":
        t = W.triangle(W.phase_x(p))
        return t * t * t
    if k == "wavetable":
        # single-cycle table, linear interp with wraparound (spec:
        # goldref.osc; a gather — beyond-reference waveform)
        T = len(node.table)
        x = W.phase_x(p)
        pos = x * float(T)
        i = torch.clamp_max(pos.to(torch.int64), T - 1)
        frac = pos - i.to(torch.float32)
        lo = table[i]
        hi = table[(i + 1) % T]
        return lo + (hi - lo) * frac
    if k == "pluck":
        # Karplus-Strong, spectral form (spec: goldref/spec.py docstring).
        # The node is static, so the per-harmonic excitation amps, phase
        # offsets, and decay exponents are host-computed f32 numpy (same
        # steps as the spec); only exp(n*alpha)*sin(phase) runs per frame.
        K = max(1, int(node.num_harmonics))
        inc = S.phase_increment(node.frequency, sr)
        ratio = np.float32(np.float32(inc) * np.float32(2.0 ** -32))
        active = [kk for kk in range(1, K + 1)
                  if inc != 0 and kk * inc < (1 << 31)]
        u = np.asarray([np.float32(
            (_noise_u32_host(kk, node.seed) >> 8)
            * np.float32(2.0 ** -23) - np.float32(1.0))
            for kk in (active or [1])], np.float32)
        denom = np.float32(max(np.abs(u.astype(np.float64)).sum(), 1e-30))
        nrel = torch.clamp_min(n_abs, 0).to(torch.float32)
        acc = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        for j, kk in enumerate(active):
            a_k = np.float32(u[j] / denom)
            phi = _noise_u32_host(K + kk, node.seed)
            g = np.float32(np.cos(np.float32(np.pi) * np.float32(kk) * ratio))
            alpha = np.float32(np.float32(node.damping) * ratio
                               * np.log(max(g, np.float32(1e-30))))
            pk = (p * kk + phi) & _U32
            acc = acc + (float(a_k) * torch.exp(nrel * float(alpha))
                         * sin_turns(W.phase_x(pk)))
        return acc
    if k == "sawtooth_bl":
        x = W.phase_x(p)
        dt = node.frequency / sr
        return (2.0 * x - 1.0) - poly_blep(x, dt)
    if k == "square_bl":
        x = W.phase_x(p)
        dt = node.frequency / sr
        naive = _square(p, 1 << 31)
        x2 = torch.where(x < 0.5, x + 0.5, x - 0.5)
        return naive + poly_blep(x, dt) - poly_blep(x2, dt)
    raise ValueError(f"unknown waveform {k}")


class HostBuf:
    """State of a HostSource node: the per-block staging buffer that the
    stream loop refills from the host pull before every step (one host
    -> device copy per block).  Plain Python state: the stream loop reaches
    every buffer of a patch through the list ``lower`` fills."""

    def __init__(self, slot: int, data: torch.Tensor):
        self.slot = slot
        self.data = data


#: HostSource key -> pull FACTORY (zero-arg callable returning a fresh
#: ``pull(n0, nframes) -> np.float32[<=nframes] | None`` for one stream).
#: Registered by oscillators.UserOscillator; entries are removed by its
#: weakref finalizer when the node is garbage-collected.
_HOST_PULLS: dict = {}
_host_key_counter = [0]


def new_host_key() -> int:
    _host_key_counter[0] += 1
    return _host_key_counter[0]


def register_host_source(key: int, pull_factory) -> None:
    _HOST_PULLS[key] = pull_factory


def unregister_host_source(key: int) -> None:
    _HOST_PULLS.pop(key, None)


def lower(node: S.Node, samplerate: int, blocksize: int, device="cuda",
          host_bufs: Optional[list] = None) -> Tuple[State, StepFn]:
    """Recursively lower a spec tree to (init_state, step) on ``device``.
    ``host_bufs`` collects the ``HostBuf`` of every HostSource node."""
    dev = _device(device)
    B = blocksize
    ar = torch.arange(B, dtype=torch.int64, device=dev)

    def sub(child):
        return lower(child, samplerate, blocksize, dev, host_bufs)

    if isinstance(node, S.HostSource):
        buf = HostBuf(node.key, torch.zeros((B,), dtype=torch.float32,
                                            device=dev))
        if host_bufs is not None:
            host_bufs.append(buf)

        def step(state, n0):
            return state.data, state
        return buf, step

    if isinstance(node, S.Const):
        value = float(np.float32(node.value))

        def step(state, n0):
            return torch.full((B,), value, dtype=torch.float32,
                              device=dev), state
        return (), step

    if isinstance(node, S.Linear):
        start = float(np.float32(node.start))
        increase = float(np.float32(node.increase))
        lo = float(np.float32(node.min_value))
        hi = float(np.float32(node.max_value))

        def step(state, n0):
            n = (n0 + ar).to(torch.float32)
            v = start + n * increase
            return torch.clamp(v, lo, hi), state
        return (), step

    if isinstance(node, S.Osc):
        inc0 = S.phase_increment(node.frequency, samplerate)
        p0 = S.phase_offset(node.phase)
        bias = float(np.float32(node.bias))
        amplitude = float(np.float32(node.amplitude))
        table = None
        if node.kind == "wavetable":
            table = torch.from_numpy(
                np.asarray(node.table, np.float32)).to(dev)
        pwm_init, pwm_step = (None, None)
        if node.kind == "pulse" and node.pwm_lfo is not None:
            pwm_init, pwm_step = sub(node.pwm_lfo)

        if node.fm_lfo is None:
            def step(state, n0):
                pwm_state = state
                n = n0 + ar
                p = (p0 + (n & _U32) * inc0) & _U32
                pwm_vals = None
                if pwm_step is not None:
                    pwm_vals, pwm_state = pwm_step(pwm_state, n0)
                w = _wave_values(node, p, samplerate, n, pwm_vals, table)
                return bias + amplitude * w, pwm_state
            return (pwm_init if pwm_step is not None else ()), step

        fm_init, fm_step = sub(node.fm_lfo)
        base = float(np.float32(np.uint32(inc0)))
        lim = float(2 ** 31 - 256)

        def step(state, n0):
            phase, fm_state, pwm_state = state
            fm, fm_state = fm_step(fm_state, n0)
            inc_f = torch.clamp(base * (1.0 + fm), -lim, lim)
            # truncation toward zero, then the wrap to u32
            inc = W.f32_to_i32(inc_f) & _U32
            # at most blocksize * 2^32: no int64 overflow, mask after
            csum = torch.cumsum(inc, 0)
            p = (phase + csum - inc) & _U32           # exclusive cumsum
            new_phase = (phase + csum[-1]) & _U32
            n = n0 + ar
            pwm_vals = None
            if pwm_step is not None:
                pwm_vals, pwm_state = pwm_step(pwm_state, n0)
            w = _wave_values(node, p, samplerate, n, pwm_vals, table)
            return bias + amplitude * w, (new_phase, fm_state, pwm_state)

        init = (torch.full((), p0, dtype=torch.int64, device=dev), fm_init,
                pwm_init if pwm_step is not None else ())
        return init, step

    if isinstance(node, S.Envelope):
        src_init, src_step = sub(node.source)

        def step(state, n0):
            v, state = src_step(state, n0)
            g = envelope_gains_device(n0 + ar, samplerate, node)
            return v * g, state
        return src_init, step

    if isinstance(node, S.Mix):
        lowered = [sub(s) for s in node.sources]

        def step(state, n0):
            acc = torch.zeros((B,), dtype=torch.float32, device=dev)
            new_states = []
            for (_, st_fn), st in zip(lowered, state):
                v, st2 = st_fn(st, n0)
                acc = acc + v
                new_states.append(st2)
            return acc, tuple(new_states)
        return tuple(init for init, _ in lowered), step

    if isinstance(node, S.AmpMod):
        a_init, a_step = sub(node.source)
        m_init, m_step = sub(node.modulator)

        def step(state, n0):
            sa, sm = state
            va, sa = a_step(sa, n0)
            vm, sm = m_step(sm, n0)
            return va * vm, (sa, sm)
        return (a_init, m_init), step

    if isinstance(node, S.Delay):
        d = int(round(node.seconds * samplerate))
        src_init, src_step = sub(node.source)
        if d <= 0:
            return src_init, src_step

        def step(state, n0):
            tail, sstate = state
            v, sstate = src_step(sstate, n0)
            buf = torch.cat([tail, v])
            return buf[:B], (buf[-d:], sstate)
        return (torch.zeros((d,), dtype=torch.float32, device=dev),
                src_init), step

    if isinstance(node, S.Echo):
        d_after = int(round(node.after * samplerate))
        d_delay = int(round(node.delay * samplerate))
        dmax = d_after + node.amount * d_delay
        gains = []
        g = 1.0
        for _ in range(node.amount):
            g *= node.decay
            gains.append(float(np.float32(g)))
        src_init, src_step = sub(node.source)
        if dmax <= 0:
            return src_init, src_step

        def step(state, n0):
            tail, sstate = state
            v, sstate = src_step(sstate, n0)
            buf = torch.cat([tail, v])             # [dmax + B]
            out = v
            for k, gk in enumerate(gains, start=1):
                dk = d_after + k * d_delay
                out = out + gk * buf[dmax - dk:dmax - dk + B]
            return out, (buf[-dmax:], sstate)
        return (torch.zeros((dmax,), dtype=torch.float32, device=dev),
                src_init), step

    if isinstance(node, S.Biquad):
        src_init, src_step = sub(node.source)
        swept = node.cutoff_lfo is not None
        if swept:
            lfo_init, lfo_step = sub(node.cutoff_lfo)
            cutoff = float(np.float32(node.cutoff))
            fc_hi = float(np.float32(0.49 * samplerate))
            w_scale = float(np.float32(2.0 * math.pi / samplerate))
            two_q = W.scalar(2.0 * node.q, dev)
        else:
            sb0, sb1, sb2, sa1, sa2 = (
                W.scalar(c, dev) for c in S.biquad_coeffs(
                    node.kind, node.cutoff, node.q, samplerate))

        def step(state, n0):
            if swept:
                x1, x2, y1, y2, lstate, sstate = state
                lv, lstate = lfo_step(lstate, n0)
                fc = torch.clamp(cutoff * torch.exp2(lv), 10.0, fc_hi)
                w0 = w_scale * fc
                alpha = torch.sin(w0) / two_q
                cw = torch.cos(w0)
                if node.kind == "lowpass":
                    b0 = (1.0 - cw) * 0.5
                    b1 = 1.0 - cw
                    b2 = b0
                elif node.kind == "highpass":
                    b0 = (1.0 + cw) * 0.5
                    b1 = -(1.0 + cw)
                    b2 = b0
                else:
                    b0 = alpha
                    b1 = torch.zeros_like(alpha)
                    b2 = -alpha
                a0r = torch.ones_like(alpha) / (1.0 + alpha)
                b0, b1, b2 = b0 * a0r, b1 * a0r, b2 * a0r
                a1 = (-2.0 * cw) * a0r
                a2 = (1.0 - alpha) * a0r
            else:
                x1, x2, y1, y2, sstate = state
                b0, b1, b2, a1, a2 = sb0, sb1, sb2, sa1, sa2
            x, sstate = src_step(sstate, n0)
            xp1 = torch.cat([x1[None], x[:-1]])
            xp2 = torch.cat([x2[None], x1[None], x[:-2]])
            u = b0 * x + b1 * xp1 + b2 * xp2
            y = companion_scan(u, a1, a2, y1, y2)
            if swept:
                return y, (x[-1], x[-2], y[-1], y[-2], lstate, sstate)
            return y, (x[-1], x[-2], y[-1], y[-2], sstate)

        z = torch.zeros((), dtype=torch.float32, device=dev)
        if swept:
            init = (z, z, z, z, lfo_init, src_init)
        else:
            init = (z, z, z, z, src_init)
        return init, step

    if isinstance(node, S.Clip):
        src_init, src_step = sub(node.source)
        lo = float(np.float32(node.minimum))
        hi = float(np.float32(node.maximum))

        def step(state, n0):
            v, state = src_step(state, n0)
            return torch.clamp(v, lo, hi), state
        return src_init, step

    if isinstance(node, S.Abs):
        src_init, src_step = sub(node.source)

        def step(state, n0):
            v, state = src_step(state, n0)
            return torch.abs(v), state
        return src_init, step

    if isinstance(node, S.Null):
        return sub(node.source)

    raise TypeError(f"unknown spec node {type(node)}")


def envelope_gains_device(n: torch.Tensor, samplerate: int,
                          e: S.Envelope) -> torch.Tensor:
    t = W.div(n.to(torch.float32), samplerate)
    a = np.float32(max(e.attack, 0.0))
    d = np.float32(max(e.decay, 0.0))
    s = np.float32(max(e.sustain, 0.0))
    r = np.float32(max(e.release, 0.0))
    sl = np.float32(e.sustain_level)
    t2, t3, t4 = a + d, a + d + s, a + d + s + r
    tiny = np.float32(1e-30)
    a_, t2_, t3_, t4_ = float(a), float(t2), float(t3), float(t4)
    sl_ = float(sl)
    zero = torch.zeros((), dtype=torch.float32, device=n.device)
    g = torch.where(
        t < a_, W.div(t, max(a, tiny)),
        torch.where(
            t < t2_,
            1.0 + W.div(float(sl - np.float32(1.0)) * (t - a_), max(d, tiny)),
            torch.where(
                t < t3_, W.scalar(sl, n.device),
                torch.where(t < t4_,
                            W.div(sl_ * (t4_ - t), max(r, tiny)),
                            zero))))
    return torch.clamp_min(g, 0.0)


# ---------------------------------------------------------------------------
# Whole-patch rendering
# ---------------------------------------------------------------------------

def patch_values(node: S.Node, nsamples: int, samplerate: int,
                 blocksize: int = 8192, device="cuda") -> torch.Tensor:
    """Patch render: samples [0, nsamples) -> f32[nsamples] on ``device``,
    block after block (one set of launches per block)."""
    if S.has_host_source(node):
        raise ValueError(
            "host-source patches cannot render in one pass (the host "
            "feeds them block by block) — render via render_patch / "
            "block_stream, which run the per-block hybrid loop")
    dev = _device(device)
    nblocks = -(-nsamples // blocksize)
    if nblocks <= 0:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    state, step = lower(node, samplerate, blocksize, dev)
    out = []
    for i in range(nblocks):
        v, state = step(state, i * blocksize)
        out.append(v)
    return torch.cat(out)[:nsamples]


def render_patch(node: S.Node, nsamples: int, samplerate: int,
                 blocksize: int = 8192, device="cuda") -> torch.Tensor:
    """Render samples [0, nsamples) of a patch on ``device`` ->
    f32[nsamples].  Host-source patches (user oscillators) run the
    per-block hybrid loop — one staged copy per block (S.HostSource
    docstring); when the source ends early the rest is zeros."""
    dev = _device(device)
    if not S.has_host_source(node):
        return patch_values(node, nsamples, samplerate, blocksize, dev)
    out = []
    got = 0
    for blk in _host_blocks(node, samplerate, blocksize, None, dev):
        out.append(blk)
        got += len(blk)
        if got >= nsamples:
            break
    if not out:
        return torch.zeros((nsamples,), dtype=torch.float32, device=dev)
    vals = torch.cat(out)[:nsamples]
    if len(vals) < nsamples:            # source exhausted early: pad
        vals = torch.cat([vals, torch.zeros((nsamples - len(vals),),
                                            dtype=torch.float32,
                                            device=dev)])
    return vals


def _device_blocks(node: S.Node, samplerate: int, blocksize: int,
                   samplewidth: Optional[int], dev) -> Iterator[torch.Tensor]:
    """Endless blocks of a patch without host sources, as tensors on the
    device (quantized when ``samplewidth`` is given)."""
    state, step = lower(node, samplerate, blocksize, dev)
    n0 = 0
    while True:
        vals, state = step(state, n0)
        n0 += blocksize
        yield vals if samplewidth is None else to_int_device(vals,
                                                             samplewidth)


def _host_blocks(node: S.Node, samplerate: int, blocksize: int,
                 samplewidth: Optional[int], dev) -> Iterator[torch.Tensor]:
    """Blocks of a host-source patch as tensors on the device.  Before
    every step each HostBuf is refilled from its pull.  The stream ends
    with its source: a ``None`` (or empty) pull stops before the block, a
    short pull emits one zero-padded block and stops."""
    canon, keys = S.canonical_host_patch(node)
    pulls = {}
    for slot, key in enumerate(keys):
        factory = _HOST_PULLS.get(key)
        if factory is None:
            raise ValueError(
                "host source not registered (was the UserOscillator "
                "garbage-collected while its patch was still in use?)")
        pulls[slot] = factory()
    bufs: list = []
    state, step = lower(canon, samplerate, blocksize, dev, bufs)
    n0 = 0
    while True:
        stop_after = False           # a source returned a short final block
        for buf in bufs:
            blk = pulls[buf.slot](n0, blocksize)
            if blk is None:
                return
            blk = np.asarray(blk, np.float32).reshape(-1)
            if blk.size == 0:
                return
            if len(blk) < blocksize:
                stop_after = True
                blk = np.pad(blk, (0, blocksize - len(blk)))
            buf.data = torch.from_numpy(
                np.ascontiguousarray(blk[:blocksize])).to(dev)
        vals, state = step(state, n0)
        yield vals if samplewidth is None else to_int_device(vals,
                                                             samplewidth)
        n0 += blocksize
        if stop_after:
            return


def device_block_stream(node: S.Node, samplerate: int, blocksize: int = 512,
                        samplewidth: Optional[int] = None,
                        device="cuda") -> Iterator[torch.Tensor]:
    """The blocks of :func:`block_stream` as tensors that stay on the
    device (for consumers that go on computing there, as the ``*_gen``
    renders do)."""
    dev = _device(device)
    blocks = _host_blocks if S.has_host_source(node) else _device_blocks
    return blocks(node, samplerate, blocksize, samplewidth, dev)


def _read_only(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


def block_stream(node: S.Node, samplerate: int, blocksize: int = 512,
                 samplewidth: Optional[int] = None,
                 device="cuda") -> Iterator[np.ndarray]:
    """Host generator of blocks (the original's ``Oscillator.blocks()``
    pull model) as read-only numpy arrays.  On the card block k+1 is
    enqueued before block k is copied out (through pinned memory), so the
    device renders while the host consumes.

    With ``samplewidth`` the blocks are quantized to ints on the device.

    Host-source patches (user oscillators) run the hybrid loop: each
    HostBuf is refilled from its registered pull before the step — one
    host->device copy per block.  The stream ends when a host source is
    exhausted (a finite custom generator ends the sound); its final short
    block is zero-padded and emitted."""
    dev = _device(device)
    if S.has_host_source(node):
        yield from _host_block_stream(node, samplerate, blocksize,
                                      samplewidth, dev)
        return
    pending = None
    for vals in _device_blocks(node, samplerate, blocksize, samplewidth, dev):
        if pending is not None:
            yield _read_only(to_host(pending))
        pending = vals


def _host_block_stream(node: S.Node, samplerate: int, blocksize: int,
                       samplewidth: Optional[int],
                       device="cuda") -> Iterator[np.ndarray]:
    for vals in _host_blocks(node, samplerate, blocksize, samplewidth,
                             _device(device)):
        yield _read_only(to_host(vals))


def int_block_stream(node: S.Node, samplerate: int, blocksize: int,
                     samplewidth: int, device="cuda") -> Iterator[np.ndarray]:
    """:func:`block_stream` quantized to int samples on the device, for
    the realtime ``*_gen`` paths."""
    return block_stream(node, samplerate, blocksize, samplewidth=samplewidth,
                        device=device)


def to_int_device(values: torch.Tensor, samplewidth: int) -> torch.Tensor:
    """f32 [-1,1] -> int samples: clip(rint(v * maxval)) (nearest-even)."""
    return to_int_samples(values, samplewidth)
