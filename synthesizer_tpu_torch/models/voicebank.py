"""Batched voice-bank render engine (port of ``synthesizer_tpu.models.voicebank``).

A bank holds V uniform voices described by parameter *tensors*
(structure-of-arrays).  Each output frame is a pure function of its
absolute sample index: DDS phase accumulation (u32), closed-form sine-LFO
FM, waveform evaluation, per-voice ADSR from note start/duration,
equal-gain pan and the stereo mixdown.  Chunk size never affects output and
streaming equals offline by construction.  FM uses the exact discrete
geometric-sum phase of the reference (see its module docstring):

    p_n = p0 + inc*n + inc*d*S_n,
    S_n = (cos(2*pi*phi - pi*b) - cos(2*pi*(b n + phi) - pi*b)) / (2 sin(pi*b))

Two halves:

* the host half (``pack_voices``, ``Voice``, ``BankLayout``, the curve
  compilers) computes in numpy with the reference's f64 host arithmetic,
  so every packed field is bit-identical to the JAX package's, and builds
  tensors at the end (``voice_params_from_numpy``);
* the plain render (``render_block``) is the PyTorch twin of the
  reference's ``render_block`` with the same formulas.  It is the
  kernels' plain version: ``VoiceBank`` runs it for CPU tensors and runs
  the Hopper kernels (``ops.kernels.render_stereo``) for CUDA tensors.

u32 on the CPU: PyTorch has no ``+``, ``>>``, ``<`` or ``//`` for
``uint32`` there, so u32 quantities are held as int64 in [0, 2^32) and
masked with ``& 0xFFFFFFFF`` after every add and multiply.  A product of
two such values can overflow int64; only its low 32 bits are kept, and
those survive the two's-complement wrap.  int64 -> f32 rounds like the
reference's u32 -> f32.

Pitch, amplitude and FM-depth curves (``use_bend``/``use_amp``/
``use_dmod``), the sparse bucketed render (``VoiceBank.sparse_plan``,
``render_song_sparse``) and the segment buses (``seg``/``nseg``:
``render_song_grouped``, ``render_chunk_grouped``, which give each voice's
stereo signal to its own bus) are ported.

Voice waveforms: 0=sine 1=triangle 2=square 3=sawtooth 4=pulse 5=semicircle
6=pointy 7=white_noise (sample-and-hold via ``frequency``) 8=harmonics
(integer partials 1..H with per-voice amplitudes) 9=sawtooth_bl
10=square_bl (polyBLEP bandlimited) 11=wavetable (canonical 256-sample
single-cycle table, linear interp) 12=pluck (Karplus-Strong in spectral
form, per-harmonic exponential decay).
"""

from __future__ import annotations

import dataclasses
from itertools import chain
from operator import attrgetter
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import spec as S
from ..ops.trig import cos_turns, exp_f32, log_f32, sin_turns
from ..ops.wave import TWO_NEG32 as _TWO_NEG32
from ..ops.wave import U32 as _U32
from ..ops.wave import blep as _blep
from ..ops.wave import f32_to_i32 as _f32_to_i32
from ..ops.wave import noise_u32, noise_values
from ..ops.wave import phase_x as _phase_x
from ..ops.wave import semicircle as _semicircle
from ..ops.wave import triangle as _triangle
from ..utils import profiling
from ..utils.device import resolve as _device

WAVE_IDS = {
    "sine": 0, "triangle": 1, "square": 2, "sawtooth": 3, "pulse": 4,
    "semicircle": 5, "pointy": 6, "white_noise": 7, "harmonics": 8,
    "sawtooth_bl": 9, "square_bl": 10, "wavetable": 11, "pluck": 12,
}
ALL_WAVES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)

#: canonical single-cycle table length for banked wavetable voices: user
#: tables of any length are resampled to this at pack time (linear interp
#: with wraparound, f32 — bank_table() is the documented canonicalization)
BANK_TABLE_LEN = 256

def bank_table(table) -> np.ndarray:
    """Resample a single-cycle table to BANK_TABLE_LEN (f32 linear interp
    with wraparound).  A table already of length BANK_TABLE_LEN passes
    through bit-identically."""
    t = np.asarray(table, np.float32)
    T = len(t)
    if T == 0:
        return np.zeros(BANK_TABLE_LEN, np.float32)
    if T == BANK_TABLE_LEN:
        return t
    pos = (np.arange(BANK_TABLE_LEN, dtype=np.float32)
           * np.float32(T) / np.float32(BANK_TABLE_LEN)).astype(np.float32)
    i = np.minimum(pos.astype(np.int64), T - 1)
    frac = (pos - i.astype(np.float32)).astype(np.float32)
    lo = t[i]
    hi = t[(i + 1) % T]
    return (lo + (hi - lo) * frac).astype(np.float32)


class VoiceParams(NamedTuple):
    """Structure-of-arrays voice parameters as tensors; every field has
    shape [V] unless noted.  "u32" fields are int64 tensors holding the
    u32 value (see the module docstring); "i32" fields are int32 and "f32"
    fields float32."""
    wave: torch.Tensor        # i32 waveform id
    base_inc: torch.Tensor    # u32 DDS increment
    phase0: torch.Tensor      # u32 initial phase
    amp: torch.Tensor         # f32
    bias: torch.Tensor        # f32
    pan: torch.Tensor         # f32 in [-1, 1]
    start: torch.Tensor       # i32 note start frame
    gate: torch.Tensor        # i32 gate duration in frames (before release)
    attack: torch.Tensor      # f32 seconds
    decay: torch.Tensor       # f32 seconds
    sustain_level: torch.Tensor  # f32
    release: torch.Tensor     # f32 seconds
    fm_inc: torch.Tensor      # u32 FM LFO increment
    fm_phase0: torch.Tensor   # u32
    fm_depth: torch.Tensor    # f32 (0 = no FM)
    fm_r: torch.Tensor        # f32 R = 1/(2 sin(pi b)), 0 when no FM
    fm_c0: torch.Tensor       # f32 C0 = cos(2 pi phi - pi b)
    pulse_width: torch.Tensor  # f32
    seed: torch.Tensor        # u32 noise seed
    noise_hold: torch.Tensor  # i32 sample-and-hold period (frames, >=1)
    harm_amps: torch.Tensor   # f32 [V, H] partial amplitudes (wave id 8)
    table: torch.Tensor       # f32 [V, BANK_TABLE_LEN] wavetable (wave id 11)
    damping: torch.Tensor     # f32 pluck loop-loss exponent scale (wave 12)
    glide_inc0: torch.Tensor  # u32 glide start increment (== base_inc: none)
    glide_d: torch.Tensor     # u32 per-frame increment step (two's complement)
    glide_frames: torch.Tensor  # i32 glide length in frames (0 = no glide)
    # pitch-curve (MIDI bend) chirp segments, [V, S] each; slot 0 starts at
    # note-relative frame 0 for curve voices, INT32_MAX rows = no curve
    bend_start: torch.Tensor  # i32 [V, S] segment start (note-relative frames)
    bend_phase: torch.Tensor  # u32 [V, S] exact phase accumulated at start
    bend_inc: torch.Tensor    # u32 [V, S] DDS increment at segment start
    bend_d: torch.Tensor      # u32 [V, S] per-frame increment step (2's compl)
    # amplitude-curve (MIDI CC7/CC11) gain segments, [V, K] each
    acurve_start: torch.Tensor  # i32 [V, K] segment start (note-rel frames)
    acurve_g0: torch.Tensor     # f32 [V, K] gain at segment start
    acurve_dg: torch.Tensor     # f32 [V, K] per-frame gain slope
    # FM-depth-curve (MIDI CC1 mod-wheel vibrato) segments, [V, D] each
    dcurve_start: torch.Tensor  # i32 [V, D] segment start (note-rel frames)
    dcurve_c: torch.Tensor      # f32 [V, D] depth-weighted LFO sum at start
    dcurve_a: torch.Tensor      # f32 [V, D] depth at segment start
    dcurve_b: torch.Tensor      # f32 [V, D] per-frame depth slope

    @property
    def device(self) -> torch.device:
        return self.wave.device

    def to(self, device) -> "VoiceParams":
        return VoiceParams(*(f.to(device) for f in self))


#: fields that hold u32 values (int64 tensors here, uint32 in the reference)
U32_FIELDS = frozenset({"base_inc", "phase0", "fm_inc", "fm_phase0", "seed",
                        "glide_inc0", "glide_d", "bend_phase", "bend_inc",
                        "bend_d"})
I32_FIELDS = frozenset({"wave", "start", "gate", "noise_hold",
                         "glide_frames", "bend_start", "acurve_start",
                         "dcurve_start"})


def voice_params_from_numpy(fields: Mapping[str, np.ndarray],
                            device="cuda") -> VoiceParams:
    """Build ``VoiceParams`` on ``device`` from host arrays keyed by field
    name — the reference's packed parameters (``vp._asdict()`` as numpy)
    or this module's own packing.  u32 fields become int64 tensors holding
    the u32 value; i32 fields int32; the rest float32."""
    device = _device(device)
    out = []
    for name in VoiceParams._fields:
        a = np.asarray(fields[name])
        if name in U32_FIELDS:
            if a.dtype.kind not in "iu":
                raise TypeError(f"{name}: integer array expected, got {a.dtype}")
            a = a.astype(np.int64)
            if a.size and (a.min() < 0 or a.max() > _U32):
                raise ValueError(f"{name}: values outside the u32 range")
        elif name in I32_FIELDS:
            if a.dtype != np.int32:
                raise TypeError(f"{name}: int32 array expected, got {a.dtype}")
        elif a.dtype != np.float32:
            raise TypeError(f"{name}: float32 array expected, got {a.dtype}")
        out.append(torch.from_numpy(np.array(a, order="C")).to(device))
    return VoiceParams(*out)


@dataclasses.dataclass(frozen=True)
class Voice:
    """Host-side description of one voice (converted into VoiceParams).
    Field meanings are the reference's (``synthesizer_tpu.models.
    voicebank.Voice``)."""
    wave: str = "sine"
    frequency: float = 440.0
    amplitude: float = 1.0
    phase: float = 0.0
    bias: float = 0.0
    pan: float = 0.0
    start: float = 0.0          # seconds
    duration: float = 1.0       # gate seconds (release follows)
    attack: float = 0.01
    decay: float = 0.05
    sustain_level: float = 0.8
    release: float = 0.05
    fm_frequency: float = 0.0
    fm_depth: float = 0.0
    fm_phase: float = 0.0
    pulse_width: float = 0.5
    seed: int = 0
    table: Sequence[float] = ()       # wave="wavetable": one cycle
    harmonics: Sequence[float] = ()   # partial amps for wave="harmonics"
    damping: float = 1.0              # wave="pluck": loop-loss scale
    # Portamento: slide from ``glide_from`` Hz to ``frequency`` over
    # ``glide_time`` seconds from note start (0 on either = no glide).
    # Pluck and noise are excluded (see _phases).
    glide_from: float = 0.0
    glide_time: float = 0.0
    # Pitch, amplitude and FM-depth curves: ((t_rel_seconds, value), ...)
    # control points (MIDI bend, CC7/CC11, CC1 and pressure).
    pitch_curve: Sequence[Tuple[float, float]] = ()
    amp_curve: Sequence[Tuple[float, float]] = ()
    fm_depth_curve: Sequence[Tuple[float, float]] = ()


@dataclasses.dataclass(frozen=True)
class BankLayout:
    """Static voice grouping: tuple of (wave_id, has_fm, start, count)."""
    groups: Tuple[Tuple[int, bool, int, int], ...]
    nvoices: int
    num_harmonics: int

    @classmethod
    def ungrouped(cls, nvoices: int, num_harmonics: int,
                  use_fm: bool = True) -> "BankLayout":
        # a single mixed group: per-voice waveform select, FM optional
        return cls(((-1, use_fm, 0, nvoices),), nvoices, num_harmonics)


_I32_MAX = 2 ** 31 - 1
_TWO32 = 4294967296.0
#: pitch/amp curves denser than this are decimated (evenly, keeping the
#: first and last points) at pack time — bounds the static segment dim
MAX_CURVE_SEGS = 128

# The host packing works in NumPy columns over all voices at once, with the
# reference's f64 operations in the reference's order, so that every field
# is the one its per-voice Python loops give, bit for bit: ``np.rint`` is
# ``round`` (half to even), ``np.trunc`` is ``int()``, ``//`` on int64
# floors like Python's, and u32 phase sums wrap in uint64, which is exact
# mod 2**32.


def _finite(x: np.ndarray) -> None:
    """Raise where Python's ``int`` would on a non-finite f64."""
    if not np.isfinite(x).all():
        if np.isnan(x).any():
            raise ValueError("cannot convert float NaN to integer")
        raise OverflowError("cannot convert float infinity to integer")


def _u32_round(x: np.ndarray) -> np.ndarray:
    """``int(round(x)) & 0xFFFFFFFF`` over an f64 array, as int64 (exact
    for every finite x: ``fmod`` of an integral f64 by 2**32 is exact)."""
    _finite(x)
    r = np.fmod(np.rint(x), _TWO32)
    r[r < 0] += _TWO32
    return r.astype(np.int64)


def _phase_increments(frequency: np.ndarray, samplerate: int) -> np.ndarray:
    """``S.phase_increment`` over an array."""
    return _u32_round(frequency / samplerate * _TWO32)


def _phase_offsets(turns: np.ndarray) -> np.ndarray:
    """``S.phase_offset`` over an array (``np.mod`` is Python's ``%``)."""
    with np.errstate(invalid="ignore"):       # inf % 1.0: NaN, raised next
        x = np.mod(turns, 1.0) * _TWO32
    return _u32_round(x)


def _int32s(x: np.ndarray) -> np.ndarray:
    """Integral f64 values -> int64, raising where Python's ``int`` would,
    or where the value would not fit the int32 field it is bound for."""
    if not ((x >= -2.0 ** 31) & (x <= _I32_MAX)).all():
        _finite(x)
        raise OverflowError("a value out of bounds for int32")
    return x.astype(np.int64)


def _frames(seconds: np.ndarray, samplerate: int) -> np.ndarray:
    """``int(seconds * samplerate)`` over an array, as int64."""
    return _int32s(np.trunc(seconds * samplerate))


class _Points(NamedTuple):
    """Curve control points of many voices, as the per-voice compile keeps
    them (sorted, held from 0, decimated, framed, one a frame), flat and
    ordered by voice, then frame."""
    row: np.ndarray    # int64 voice row of each point
    group: np.ndarray  # int64 index of its curve in the caller's list
    pos: np.ndarray    # int64 segment index within its voice
    frame: np.ndarray  # int64 note-relative start frame of its segment
    value: np.ndarray  # f64 control value
    nxt: np.ndarray    # int64 indices of the points followed in their voice
    width: int         # most segments of one voice (0: no point)


_NO_POINTS = _Points(*(np.zeros(0, np.int64),) * 4, np.zeros(0),
                     np.zeros(0, np.int64), 0)


def _curve_points(rows: Sequence[int], curves: Sequence, samplerate: int
                  ) -> _Points:
    """(t_seconds, value) control points of ``curves[k]`` (one per voice
    row ``rows[k]``, none empty) -> ``_Points``.  Per voice, as the
    reference: the points sorted as (t, value) tuples; a (0, first value)
    hold before a first point after 0; more than ``MAX_CURVE_SEGS`` points
    decimated evenly; ``int(t * samplerate)`` frames, of which a run of
    equal frames keeps its last point."""
    if not curves:
        return _NO_POINTS
    counts = np.fromiter(map(len, curves), np.int64, len(curves))
    group = np.repeat(np.arange(len(curves)), counts)
    pts = np.fromiter(chain.from_iterable(chain.from_iterable(curves)),
                      np.float64)
    if pts.size != 2 * counts.sum():
        raise ValueError("curve points must be (t, value) pairs")
    pts = pts.reshape(-1, 2)
    order = np.lexsort((pts[:, 1], pts[:, 0], group))
    t, val = pts[order, 0], pts[order, 1]
    first = np.cumsum(counts) - counts
    late = t[first] > 0.0
    if late.any():
        at = first[late]
        t = np.insert(t, at, 0.0)
        val = np.insert(val, at, val[at])
        group = np.insert(group, at, group[at])
        counts = counts + late
        first = np.cumsum(counts) - counts
    dense = np.flatnonzero(counts > MAX_CURVE_SEGS)
    if dense.size:
        keep = np.ones(t.size, bool)
        for k in dense:
            n = int(counts[k])
            idx = np.unique(np.round(np.linspace(0, n - 1, MAX_CURVE_SEGS))
                            .astype(int))
            keep[first[k]:first[k] + n] = False
            keep[first[k] + idx] = True
        t, val, group = t[keep], val[keep], group[keep]
    frame = _frames(t, samplerate)
    # a run of equal frames (frames rise with t) keeps its last point
    kept = np.ones(frame.size, bool)
    kept[:-1] = (group[1:] != group[:-1]) | (frame[1:] != frame[:-1])
    group, frame, val = group[kept], frame[kept], val[kept]
    head = np.ones(group.size, bool)
    head[1:] = group[1:] != group[:-1]
    pos = np.arange(group.size) - np.flatnonzero(head)[np.cumsum(head) - 1]
    nxt = np.flatnonzero(~np.append(head[1:], True))
    width = int(pos.max()) + 1 if pos.size else 0
    return _Points(np.asarray(rows, np.int64)[group], group, pos, frame, val,
                   nxt, width)


def _pitch_columns(p: _Points, frequency: np.ndarray, samplerate: int):
    """Chirp segments of ``compile_pitch_segments`` for every point, with
    ``frequency`` per point: (phases, incs, ds), int64 u32 values.  The
    phase at a segment start sums ``L*inc + d*(L*(L-1)//2)`` over the
    voice's earlier segments, in uint64 (exact mod 2**32)."""
    incs = _phase_increments(frequency * p.value, samplerate)
    j = p.nxt
    L = p.frame[j + 1] - p.frame[j]
    ds = np.zeros(incs.size, np.int64)
    ds[j] = ((incs[j + 1] - incs[j]) // L) & 0xFFFFFFFF
    step = np.zeros(incs.size, np.uint64)
    Lu = L.astype(np.uint64)
    step[j] = (Lu * incs[j].astype(np.uint64)
               + ds[j].astype(np.uint64) * (L * (L - 1) // 2).astype(np.uint64))
    run = np.cumsum(step) - step            # exclusive, wrapping in uint64
    phases = run - run[p.pos == 0][p.group]
    return (phases & np.uint64(0xFFFFFFFF)).astype(np.int64), incs, ds


def _amp_columns(p: _Points) -> np.ndarray:
    """Per-frame gain slopes of ``compile_amp_segments`` (0 on a voice's
    last, held segment), f64."""
    j = p.nxt
    dgs = np.zeros(p.value.size)
    dgs[j] = (p.value[j + 1] - p.value[j]) / (p.frame[j + 1] - p.frame[j])
    return dgs


def _depth_columns(p: _Points, inc: np.ndarray, ph0: np.ndarray,
                   start_frame: np.ndarray):
    """FM-depth-curve segments of ``compile_depth_segments`` for every
    point, with the LFO's u32 ``inc`` and ``ph0`` (int64, ``inc`` > 0) and
    the note's start frame per point: (cs, slopes), f64.  Each segment's
    closed forms in the reference's operand order; ``C`` sums them along
    each voice's row of a padded array, sequentially like the loop."""
    b = inc / _TWO32
    alpha = 2.0 * np.pi * b
    r1 = 1.0 / (2.0 * np.sin(np.pi * b))
    r2 = r1 * r1
    m = (start_frame + p.frame).astype(np.uint64)
    u = (ph0.astype(np.uint64) + m * inc.astype(np.uint64)) \
        & np.uint64(0xFFFFFFFF)
    theta = u / _TWO32 * 2.0 * np.pi
    j = p.nxt
    L = p.frame[j + 1] - p.frame[j]
    d = p.value[j]
    slope = (p.value[j + 1] - d) / L
    th, th2, al, q1, q2 = theta[j], theta[j + 1], alpha[j], r1[j], r2[j]
    s1 = (np.cos(th - al / 2.0) - np.cos(th2 - al / 2.0)) * q1
    K = L - 1
    A = np.sin(al * K) * q2 - K * np.cos(al * (K + 0.5)) * q1
    B = K * np.sin(al * (K + 0.5)) * q1 - (1.0 - np.cos(al * K)) * q2
    s2 = np.sin(th) * B + np.cos(th) * A
    # exclusive running sum per voice: C_0 = 0, C_{k+1} = C_k + term_k
    grid = np.zeros((int(p.group[-1]) + 1 if p.group.size else 0,
                     max(p.width, 1)))
    grid[p.group[j], p.pos[j] + 1] = d * s1 + slope * s2
    cs = np.cumsum(grid, axis=1)[p.group, p.pos]
    slopes = np.zeros(p.value.size)
    slopes[j] = slope
    return cs, slopes


def compile_pitch_segments(curve, frequency: float, samplerate: int):
    """(t_rel, freq_ratio) control points -> exact integer chirp segments
    (starts, phases, incs, ds): per-segment note-relative start frame,
    phase accumulated at that frame (mod 2^32, exact), DDS increment at the
    start, and per-frame increment step (u32 two's complement).  The last
    segment has d=0 and holds forever.  One voice of ``_pitch_columns``."""
    curve = tuple(curve)
    if not curve:
        return [0], [0], [int(S.phase_increment(frequency, samplerate))], [0]
    p = _curve_points([0], [curve], samplerate)
    phases, incs, ds = _pitch_columns(
        p, np.full(p.row.size, frequency, np.float64), samplerate)
    return p.frame.tolist(), phases.tolist(), incs.tolist(), ds.tolist()


def compile_amp_segments(curve, samplerate: int):
    """(t_rel, gain) control points -> (starts, g0s, dgs) linear-ramp
    segments (per-frame slope; last segment holds, dg=0).  One voice of
    ``_amp_columns``."""
    curve = tuple(curve)
    if not curve:
        raise ValueError("an amplitude curve needs a point")
    p = _curve_points([0], [curve], samplerate)
    return p.frame.tolist(), p.value.tolist(), _amp_columns(p).tolist()


def compile_depth_segments(curve, fm_frequency: float, fm_phase: float,
                           start_frame: int, samplerate: int):
    """(t_rel, depth) control points -> FM-depth-curve segments
    (starts, cs, a0s, bs): per-segment note-relative start frame, the
    depth-weighted LFO sum accumulated at that frame (f64 closed form),
    depth at the segment start, and per-frame depth slope (0 on the final
    hold segment).  Closed forms: the reference's docstring.  One voice of
    ``_depth_columns``."""
    inc = int(S.phase_increment(fm_frequency, samplerate))
    if inc == 0:
        raise ValueError("fm_depth_curve requires fm_frequency > 0")
    curve = tuple(curve)
    if not curve:
        raise ValueError("an FM-depth curve needs a point")
    p = _curve_points([0], [curve], samplerate)
    n = p.row.size
    cs, bs = _depth_columns(
        p, np.full(n, inc, np.int64),
        np.full(n, S.phase_offset(fm_phase), np.int64),
        np.full(n, start_frame, np.int64))
    return p.frame.tolist(), cs.tolist(), p.value.tolist(), bs.tolist()


@profiling.spanned("voicebank.pack_voices")
def pack_voices(voices: Sequence[Voice], samplerate: int,
                num_harmonics: int = 8, pad_to: int = 8,
                sort_by_wave: bool = False,
                tags: Optional[Sequence[int]] = None, device="cuda"):
    """Pack host voice descriptions into parameter tensors on ``device``
    (the card unless the caller passes ``device="cpu"``).

    Pads the voice count up to a multiple of ``pad_to`` with silent voices.
    With ``sort_by_wave`` the voices are ordered into per-waveform groups,
    each padded to ``pad_to``, and a (VoiceParams, BankLayout) pair is
    returned (the grouped fast path); otherwise just VoiceParams.

    ``tags`` (sort_by_wave only): per-voice integer labels carried through
    the sort — returns (vp, layout, packed_tags) where pad voices get tag 0.
    """
    silent = Voice(amplitude=0.0, frequency=0.0, duration=0.0)

    if sort_by_wave:
        # group by waveform only: FM (if any voice in the group uses it) is
        # cheap closed-form per group, while a finer (wave, fm) split would
        # double the padding for mixed banks
        keyed = sorted(range(len(voices)), key=lambda i: WAVE_IDS[voices[i].wave])
        ordered: list = []
        otags: list = []
        groups: list = []
        i = 0
        while i < len(keyed):
            v0 = voices[keyed[i]]
            wid = WAVE_IDS[v0.wave]
            members = []
            mtags = []
            while i < len(keyed) and WAVE_IDS[voices[keyed[i]].wave] == wid:
                members.append(voices[keyed[i]])
                mtags.append(tags[keyed[i]] if tags is not None else 0)
                i += 1
            has_fm = any(v.fm_depth != 0.0 for v in members)
            start = len(ordered)
            npad = -len(members) % pad_to
            members = members + [dataclasses.replace(silent, wave=v0.wave)] * npad
            mtags = mtags + [0] * npad
            ordered.extend(members)
            otags.extend(mtags)
            groups.append((wid, has_fm, start, len(members)))
        vp = _pack_upload(ordered, samplerate, num_harmonics, device)
        layout = BankLayout(tuple(groups), len(ordered), num_harmonics)
        if tags is not None:
            return vp, layout, np.asarray(otags, np.int32)
        return vp, layout

    npad = -len(voices) % pad_to
    ordered = list(voices) + [silent] * max(npad, pad_to - len(voices)
                                            if len(voices) < pad_to else npad)
    return _pack_upload(ordered, samplerate, num_harmonics, device)


def _pack_upload(voices: Sequence[Voice], samplerate: int,
                 num_harmonics: int, device) -> VoiceParams:
    with profiling.span("voicebank.pack_columns"):
        fields = _pack_flat(voices, samplerate, num_harmonics)
    with profiling.span("voicebank.pack_upload"):
        return voice_params_from_numpy(fields, device)


#: the Voice fields that the packing reads, in one ``attrgetter`` pass;
#: the first ``_NUMERIC`` are numbers, read as f64 columns
_FIELDS = ("frequency", "amplitude", "phase", "bias", "pan", "start",
           "duration", "attack", "decay", "sustain_level", "release",
           "fm_frequency", "fm_depth", "fm_phase", "pulse_width", "damping",
           "glide_from", "glide_time",
           "wave", "seed", "harmonics", "pitch_curve", "amp_curve",
           "fm_depth_curve")
_NUMERIC = 18
_voice_fields = attrgetter(*_FIELDS)


def _pack_flat(voices: Sequence[Voice], samplerate: int,
               num_harmonics: int) -> dict:
    """Host packing -> {field: numpy array} with the reference's dtypes
    (u32 fields as np.uint32) and f64 host arithmetic, in columns over all
    voices (see the note above ``_u32_round``)."""
    V = len(voices)
    H = num_harmonics
    sr = samplerate
    cols = list(zip(*map(_voice_fields, voices))) or [()] * len(_FIELDS)
    (freq, amp, phase, bias, pan, start, duration, attack, decay, sustain,
     release, fm_freq, fm_depth, fm_phase, pulse_width, damping, glide_from,
     glide_time) = np.array(cols[:_NUMERIC], np.float64).reshape(_NUMERIC, V)
    waves, seeds, harmonics, pcurves, acurves, dcurves = cols[_NUMERIC:]

    wave = np.array([WAVE_IDS[w] for w in waves], np.int32)
    fm_inc = _phase_increments(fm_freq, sr)
    fm_phase0 = _phase_offsets(fm_phase)
    fm_r = np.zeros(V, np.float32)
    fm_c0 = np.zeros(V, np.float32)
    on = fm_inc != 0
    b = fm_inc[on] / _TWO32
    phi = fm_phase0[on] / _TWO32
    fm_r[on] = 1.0 / (2.0 * np.sin(np.pi * b))
    fm_c0[on] = np.cos(2.0 * np.pi * phi - np.pi * b)

    harm = np.zeros((V, max(H, 1)), np.float32)
    rows = [i for i, h in enumerate(harmonics) if len(h)]
    if rows and H:
        parts = [harmonics[i][:H] for i in rows]
        lens = np.fromiter(map(len, parts), np.int64, len(parts))
        heads = np.cumsum(lens) - lens
        harm[np.repeat(rows, lens),
             np.arange(lens.sum()) - np.repeat(heads, lens)] = \
            np.array(list(chain.from_iterable(parts)), np.float64)

    tables = np.zeros((V, BANK_TABLE_LEN), np.float32)
    for i in np.flatnonzero(wave == WAVE_IDS["wavetable"]):
        tables[i] = bank_table(voices[i].table)

    # portamento constants: per-frame increment step d = floor((inc1 -
    # inc0) / G), u32 two's complement
    g_inc0 = np.zeros(V, np.uint32)
    g_d = np.zeros(V, np.uint32)
    g_frames = np.zeros(V, np.int32)
    glide = np.flatnonzero((glide_from > 0.0) & (glide_time > 0.0)
                           & (freq > 0.0))
    if glide.size:
        if any(pcurves[i] for i in glide):
            raise ValueError(
                "glide_from/glide_time and pitch_curve are mutually "
                "exclusive on one voice (both sweep the DDS increment)")
        inc0 = _phase_increments(glide_from[glide], sr)
        inc1 = _phase_increments(freq[glide], sr)
        G = np.maximum(1, _frames(glide_time[glide], sr))
        g_inc0[glide] = inc0
        g_d[glide] = ((inc1 - inc0) // G) & 0xFFFFFFFF
        g_frames[glide] = G

    # pitch/amp/depth curve segments (static [V, S] dims sized to the
    # densest curve in the bank; no-curve rows are INT32_MAX-start sentinels)
    rows = [i for i, c in enumerate(pcurves) if c]
    p = _curve_points(rows, [pcurves[i] for i in rows], sr)
    S = p.width or 1
    b_start = np.full((V, S), _I32_MAX, np.int32)
    b_phase = np.zeros((V, S), np.uint32)
    b_inc = np.zeros((V, S), np.uint32)
    b_d = np.zeros((V, S), np.uint32)
    at = p.row, p.pos
    b_start[at] = p.frame
    b_phase[at], b_inc[at], b_d[at] = _pitch_columns(p, freq[p.row], sr)

    rows = [i for i, c in enumerate(acurves) if c]
    p = _curve_points(rows, [acurves[i] for i in rows], sr)
    S = p.width or 1
    a_start = np.full((V, S), _I32_MAX, np.int32)
    a_g0 = np.ones((V, S), np.float32)
    a_dg = np.zeros((V, S), np.float32)
    held = np.ones(p.pos.size, bool)
    held[p.nxt] = False
    # pad by replicating the hold segment (never selected: I32_MAX start)
    a_g0[p.row[held]] = p.value[held, None]
    at = p.row, p.pos
    a_start[at] = p.frame
    a_g0[at] = p.value
    a_dg[at] = _amp_columns(p)

    rows = [i for i, c in enumerate(dcurves) if c]
    if (fm_depth[rows] != 0.0).any():
        raise ValueError(
            "fm_depth_curve and a non-zero constant fm_depth are "
            "mutually exclusive on one voice (the curve IS the depth)")
    if (fm_inc[rows] == 0).any():
        raise ValueError("fm_depth_curve requires fm_frequency > 0")
    p = _curve_points(rows, [dcurves[i] for i in rows], sr)
    S = p.width or 1
    d_start = np.full((V, S), _I32_MAX, np.int32)
    d_c = np.zeros((V, S), np.float32)
    d_a = np.zeros((V, S), np.float32)
    d_b = np.zeros((V, S), np.float32)
    at = p.row, p.pos
    d_start[at] = p.frame
    d_a[at] = p.value
    d_c[at], d_b[at] = _depth_columns(p, fm_inc[p.row], fm_phase0[p.row],
                                      _frames(start[p.row], sr))

    base_inc = _phase_increments(freq, sr)
    noise_hold = np.ones(V, np.int32)
    noisy = np.flatnonzero((wave == WAVE_IDS["white_noise"]) & (freq > 0))
    noise_hold[noisy] = np.maximum(1, _int32s(np.rint(sr / freq[noisy])))

    f32 = np.float32
    return dict(
        wave=wave,
        base_inc=base_inc.astype(np.uint32),
        phase0=_phase_offsets(phase).astype(np.uint32),
        amp=amp.astype(f32),
        bias=bias.astype(f32),
        pan=pan.astype(f32),
        start=_frames(start, sr).astype(np.int32),
        gate=_frames(duration, sr).astype(np.int32),
        attack=attack.astype(f32),
        decay=decay.astype(f32),
        sustain_level=sustain.astype(f32),
        release=release.astype(f32),
        fm_inc=fm_inc.astype(np.uint32),
        fm_phase0=fm_phase0.astype(np.uint32),
        fm_depth=fm_depth.astype(f32),
        fm_r=fm_r,
        fm_c0=fm_c0,
        pulse_width=np.minimum(np.maximum(pulse_width, 1.0 / 65536.0),
                               1.0 - 1.0 / 65536.0).astype(f32),
        seed=np.array([s & 0xFFFFFFFF for s in seeds], np.uint32),
        noise_hold=noise_hold,
        harm_amps=harm,
        table=tables,
        damping=damping.astype(f32),
        glide_inc0=g_inc0,
        glide_d=g_d,
        glide_frames=g_frames,
        bend_start=b_start,
        bend_phase=b_phase,
        bend_inc=b_inc,
        bend_d=b_d,
        acurve_start=a_start,
        acurve_g0=a_g0,
        acurve_dg=a_dg,
        dcurve_start=d_start,
        dcurve_c=d_c,
        dcurve_a=d_a,
        dcurve_b=d_b,
    )


# ---------------------------------------------------------------------------
# Waveform evaluation (plain PyTorch twin of the reference's render_block).
# Phases are int64 tensors in [0, 2^32) ("u32"); every add and multiply of
# u32 values is followed by ``& _U32``.  The per-phase primitives are
# ``ops.wave``'s, shared with the patch graph.
# ---------------------------------------------------------------------------

def _noise_u32(idx, seed):
    """Counter hash (u32).  idx [v, N] or [1, N], seed [v]."""
    return noise_u32(idx, seed[:, None])


def _noise(idx, seed):
    return noise_values(idx, seed[:, None])


def _one_wave(wid: int, p, vp: VoiceParams, n, num_harmonics: int,
              inst_inc=None):
    """Evaluate a single statically-known waveform at phases p [v, N].

    ``inst_inc`` (u32 [v, N], optional): the instantaneous DDS increment
    under glide — the polyBLEP waveforms place their residual at the
    current chirp pitch from it instead of the landing ``base_inc``."""
    x = _phase_x(p)
    one = torch.ones((), dtype=torch.float32, device=p.device)
    if wid == 0:
        return sin_turns(x)
    if wid == 1:
        return _triangle(x)
    if wid == 2:
        return torch.where(p < 2 ** 31, one, -one)
    if wid == 3:
        return 2.0 * x - 1.0
    if wid == 4:
        wu = (vp.pulse_width[:, None] * 4294967296.0).to(torch.int64)
        return torch.where(p < wu, one, -one)
    if wid == 5:
        return _semicircle(x)
    if wid == 6:
        t = _triangle(x)
        return t * t * t
    if wid == 7:
        idx = (n[None, :] // vp.noise_hold[:, None]) & _U32
        return _noise(idx, vp.seed)
    if wid == 8:
        acc = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k in range(1, num_harmonics + 1):
            pk = (p * k) & _U32
            acc = acc + vp.harm_amps[:, k - 1][:, None] * sin_turns(_phase_x(pk))
        return acc
    if wid in (9, 10):
        # polyBLEP bandlimited saw/square: per-voice dt = f/sr = inc * 2^-32
        inc = vp.base_inc[:, None] if inst_inc is None else inst_inc
        dt = torch.clamp_min(inc.to(torch.float32) * _TWO_NEG32,
                             float(np.float32(1e-9)))
        blep = _blep(x, dt)
        if wid == 9:
            return (2.0 * x - 1.0) - blep
        naive = torch.where(p < 2 ** 31, one, -one)
        x2 = torch.where(x < 0.5, x + 0.5, x - 0.5)
        return naive + blep - _blep(x2, dt)
    if wid == 12:
        return _pluck(p, vp, n, num_harmonics)
    if wid == 11:
        # banked wavetable: canonical [v, BANK_TABLE_LEN] table, linear
        # interp with wraparound
        T = vp.table.shape[1]
        pos = x * float(T)
        i = torch.clamp_max(pos.to(torch.int64), T - 1)
        frac = pos - i.to(torch.float32)
        lo = torch.gather(vp.table, 1, i)
        hi = torch.gather(vp.table, 1, (i + 1) % T)
        return lo + (hi - lo) * frac
    raise ValueError(f"bad wave id {wid}")


def _pluck(p, vp: VoiceParams, n, num_harmonics: int):
    """Karplus-Strong in spectral form (spec: goldref/spec.py): K partials
    with hashed amplitudes and phases, each decaying at its loop-loss rate
    from the note start.  Sums over k run serially in k order, as the
    kernel does."""
    K = max(1, num_harmonics)
    dev = p.device
    inc = vp.base_inc                                     # u32 [v]
    ratio = inc.to(torch.float32) * _TWO_NEG32            # f32 [v]
    nrel = torch.clamp_min(n[None, :] - vp.start[:, None], 0).to(torch.float32)
    V = inc.shape[0]
    ks = torch.arange(1, K + 1, dtype=torch.int64, device=dev)[None, :]
    u = _noise(ks.expand(V, K), vp.seed)                  # [v, K]
    # active iff k*inc < 2^31 (exact integer Nyquist mask)
    lim = torch.tensor([(2 ** 31 - 1) // k for k in range(1, K + 1)],
                       dtype=torch.int64, device=dev)[None, :]
    active = (inc[:, None] <= lim) & (inc[:, None] > 0)   # [v, K]
    absu = torch.where(active, u.abs(), torch.zeros_like(u))
    denom = torch.zeros_like(ratio)
    for j in range(K):
        denom = denom + absu[:, j]
    denom = torch.clamp_min(denom, float(np.float32(1e-30)))
    phi = _noise_u32((ks + K).expand(V, K), vp.seed)      # [v, K]
    # cos(pi*k*ratio) in turns, and the exp/log polynomials of ops.trig
    # (the same bits on the card and on the CPU)
    g = cos_turns(ks.to(torch.float32) * ratio[:, None] * 0.5)
    alpha = (vp.damping[:, None] * ratio[:, None]
             * log_f32(torch.clamp_min(g, float(np.float32(1e-30)))))
    acc = torch.zeros(p.shape, dtype=torch.float32, device=dev)
    for j in range(K):
        pk = (p * (j + 1) + phi[:, j][:, None]) & _U32
        term = ((u[:, j] / denom)[:, None]
                * exp_f32(nrel * alpha[:, j][:, None])
                * sin_turns(_phase_x(pk)))
        acc = acc + torch.where(active[:, j][:, None], term,
                                torch.zeros_like(term))
    return acc


def _wave_select(p, vp: VoiceParams, n, num_harmonics: int,
                 used_waves: tuple = ALL_WAVES, inst_inc=None):
    """Per-voice waveform select (mixed group): computes every used family."""
    used = tuple(w for w in used_waves
                 if w not in (8, 12) or num_harmonics > 0)
    wid = vp.wave[:, None]
    out = None
    for w in used:
        vals = _one_wave(w, p, vp, n, num_harmonics, inst_inc)
        out = vals if out is None else torch.where(wid == w, vals, out)
    return out if out is not None else torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device)


def _tri_u32(m):
    """Triangular number m*(m-1)/2 mod 2^32 (u32 in, u32 out).

    Halve the EVEN factor before the wrapped multiply — dividing a
    wrapped product by 2 would need mod 2^33."""
    even = (m & 1) == 0
    m1 = (m - 1) & _U32
    a = torch.where(even, m >> 1, m)
    b = torch.where(even, m1, m1 >> 1)
    return (a * b) & _U32


def _wrap_i32(x):
    """int64 values -> what int32 arithmetic wraps them to."""
    return ((x + 2 ** 31) & _U32) - 2 ** 31


def _seg_idx(starts, m):
    """Active curve segment per (voice, frame): the count of segment starts
    <= m, minus one, clamped to [0, S-1] (pre-note frames take segment 0,
    whose values are envelope-masked there).  starts [v, S], m [v, N] ->
    int64 [v, N].  Counted one segment at a time to bound memory."""
    cnt = torch.zeros(m.shape, dtype=torch.int64, device=m.device)
    for s in range(starts.shape[1]):
        cnt += m >= starts[:, s:s + 1]
    return torch.clamp(cnt - 1, 0, starts.shape[1] - 1)


def _seg(starts, m, *fields):
    """(segment start as int64, then each field's value) at the active
    segment of every (voice, frame)."""
    idx = _seg_idx(starts, m)
    return (torch.gather(starts, 1, idx).to(torch.int64),
            *(torch.gather(f, 1, idx) for f in fields))


def _dmod_delta(vp: VoiceParams, n):
    """FM phase contribution for depth-curve voices, f32 [v, N]:
    inc * sum_{u<m} D(u) sin(2*pi*(phi_s + u*b)) with D the piecewise-
    linear depth: the host's per-segment sum C_j plus the within-segment
    weighted trig sums of ``compile_depth_segments``, elementwise.  Eight
    turn-unit trig evaluations per voice-frame, in the reference's order."""
    m = n[None, :] - vp.start[:, None]                 # note-relative
    st, c, a, b = _seg(vp.dcurve_start, m, vp.dcurve_c, vp.dcurve_a,
                       vp.dcurve_b)
    inc = vp.fm_inc[:, None]
    half = inc >> 1
    # exact u32 LFO phases at the current frame and the segment start
    ph_n = (vp.fm_phase0[:, None] + (n[None, :] & _U32) * inc) & _U32
    ph_j = (vp.fm_phase0[:, None]
            + ((vp.start[:, None] + st) & _U32) * inc) & _U32
    r1 = vp.fm_r[:, None]
    r2 = r1 * r1
    s1 = (cos_turns(_phase_x((ph_j - half) & _U32))
          - cos_turns(_phase_x((ph_n - half) & _U32))) * r1
    K = torch.clamp_min(_wrap_i32(m - st - 1), 0)      # L-1, clamped
    xK = _phase_x((K * inc) & _U32)                    # K*b mod 1 (exact)
    xKh = _phase_x((K * inc + half) & _U32)            # (K+1/2)*b mod 1
    Kf = K.to(torch.float32)
    A = sin_turns(xK) * r2 - Kf * cos_turns(xKh) * r1
    B = Kf * sin_turns(xKh) * r1 - (1.0 - cos_turns(xK)) * r2
    xj = _phase_x(ph_j)
    s2 = sin_turns(xj) * B + cos_turns(xj) * A
    return vp.base_inc.to(torch.float32)[:, None] * (c + a * s1 + b * s2)


def _phases(vp: VoiceParams, n, use_fm: bool, use_glide: bool = False,
            use_bend: bool = False, use_dmod: bool = False):
    """Closed-form DDS phases (u32 [v, N]) for absolute frames n [N].

    Portamento (use_glide): for note-relative frame m, inc_m = inc0 + m*d,
    so phase_m = phase0 + m*inc0 + d*m(m-1)/2 (mod 2^32) during the glide
    and phase_G + (m-G)*incG after it.  Pitch curves (use_bend): the same
    chirp per segment, anchored at the segment's host-computed phase.
    Pluck (wave 12) is excluded from both: its spectral decay rates are
    tied to ONE pitch.  FM-depth curves (use_dmod) replace the constant FM
    integral of their voices."""
    nu = n[None, :] & _U32
    p = (vp.phase0[:, None] + nu * vp.base_inc[:, None]) & _U32
    if use_bend:
        m = n[None, :] - vp.start[:, None]
        st, ph, bi, bd = _seg(vp.bend_start, m, vp.bend_phase, vp.bend_inc,
                              vp.bend_d)
        mrel = (m - st) & _U32
        pb = (vp.phase0[:, None] + ph + mrel * bi + bd * _tri_u32(mrel)) & _U32
        has_bend = ((vp.bend_start[:, 0] == 0) & (vp.wave != 12))[:, None]
        p = torch.where(has_bend, pb, p)
    if use_glide:
        m = n[None, :] - vp.start[:, None]               # note-relative
        mu = m & _U32
        inc0 = vp.glide_inc0[:, None]
        d = vp.glide_d[:, None]
        G = vp.glide_frames[:, None]
        Gu = G.to(torch.int64) & _U32
        during = (inc0 * mu + d * _tri_u32(mu)) & _U32
        phase_g = (inc0 * Gu + d * _tri_u32(Gu)) & _U32   # phase at m == G
        inc_g = (inc0 + d * Gu) & _U32
        after = (phase_g + ((mu - Gu) & _U32) * inc_g) & _U32
        pg = (vp.phase0[:, None] + torch.where(m < G, during, after)) & _U32
        p = torch.where((G > 0) & (vp.wave[:, None] != 12), pg, p)
    if not (use_fm or use_dmod):
        return p
    # exact discrete FM integral (module docstring): delta = inc*d*S_n
    fm_inc = vp.fm_inc[:, None]
    fm_phase = (vp.fm_phase0[:, None] + nu * fm_inc) & _U32
    x_half = _phase_x((fm_phase - (fm_inc >> 1)) & _U32)
    s_n = (vp.fm_c0[:, None] - cos_turns(x_half)) * vp.fm_r[:, None]
    delta = (vp.base_inc.to(torch.float32) * vp.fm_depth)[:, None] * s_n
    has_fm = ((vp.fm_depth != 0.0) & (vp.fm_inc != 0))[:, None]
    if use_dmod:
        has_dc = ((vp.dcurve_start[:, 0] == 0) & (vp.fm_inc != 0))[:, None]
        delta = torch.where(has_dc, _dmod_delta(vp, n), delta)
        has_fm = has_fm | has_dc
    # wrap to [-2^31, 2^31) before the integer cast (phase is modular)
    q = delta * _TWO_NEG32
    frac = q - torch.round(q)
    dunits = _f32_to_i32(frac * 4294967296.0) & _U32
    return torch.where(has_fm, (p + dunits) & _U32, p)


def _inst_inc(vp: VoiceParams, n, use_glide: bool, use_bend: bool = False):
    """Instantaneous DDS increment (u32 [v, N]) under glide or bend --
    feeds the polyBLEP dt.  None when the bank has no pitch sweeps."""
    if not (use_glide or use_bend):
        return None
    m = n[None, :] - vp.start[:, None]
    inc = vp.base_inc[:, None].expand(m.shape)
    if use_bend:
        st, bi, bd = _seg(vp.bend_start, m, vp.bend_inc, vp.bend_d)
        mrel = torch.clamp_min(_wrap_i32(m - st), 0)
        has_bend = (vp.bend_start[:, 0] == 0)[:, None]
        inc = torch.where(has_bend, (bi + mrel * bd) & _U32, inc)
    if use_glide:
        G = vp.glide_frames[:, None].to(torch.int64)
        mcl = torch.minimum(torch.clamp_min(m, 0), G)
        gi = (vp.glide_inc0[:, None] + mcl * vp.glide_d[:, None]) & _U32
        inc = torch.where(G > 0, gi, inc)
    return inc


def _amp_curve_gain(vp: VoiceParams, n):
    """Per-voice amplitude-curve gain [v, N] (f32): linear ramps between
    control points, held after the last; 1.0 for rows without a curve."""
    m = n[None, :] - vp.start[:, None]
    st, g0, dg = _seg(vp.acurve_start, m, vp.acurve_g0, vp.acurve_dg)
    g = g0 + torch.clamp_min(_wrap_i32(m - st), 0).to(torch.float32) * dg
    has = (vp.acurve_start[:, 0] == 0)[:, None]
    return torch.where(has, g, torch.ones((), dtype=torch.float32,
                                          device=g.device))


def _adsr(n, vp: VoiceParams, samplerate: int):
    """Per-voice ADSR gain at absolute frames n [N] -> [v, N] (f32).

    Sustain duration = max(0, gate/sr - attack - decay); release follows the
    gate; outside [start, start+total) the gain is 0.  Time is the i32
    note-relative frame converted to f32 (exact past 2^24 absolute frames),
    the slopes are per-voice reciprocals, and the result is clipped to
    [0, 1]."""
    sr_r = float(np.float32(1.0 / samplerate))
    t = (n[None, :] - vp.start[:, None]).to(torch.float32) * sr_r
    a = torch.clamp_min(vp.attack, 0.0)[:, None]
    d = torch.clamp_min(vp.decay, 0.0)[:, None]
    r = torch.clamp_min(vp.release, 0.0)[:, None]
    sl = vp.sustain_level[:, None]
    gate = vp.gate.to(torch.float32)[:, None] * sr_r
    s = torch.clamp_min(gate - a - d, 0.0)
    t2 = a + d
    t4 = t2 + s + r
    t3 = t2 + s
    eps = float(np.float32(1e-30))
    # region select, not a min-of-lines form (see the reference's _adsr)
    a_r = torch.reciprocal(torch.clamp_min(a, eps))
    d_r = torch.reciprocal(torch.clamp_min(d, eps))
    r_r = torch.reciprocal(torch.clamp_min(r, eps))
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    g = torch.where(t < a, t * a_r,
        torch.where(t < t2, 1.0 + (sl - 1.0) * (t - a) * d_r,
        torch.where(t < t3, sl.expand_as(t),
        torch.where(t < t4, sl * (t4 - t) * r_r, zero))))
    g = torch.where(t < 0, zero, g)
    return torch.clamp(g, 0.0, 1.0)


def _slice_params(vp: VoiceParams, start: int, count: int) -> VoiceParams:
    return VoiceParams(*(f[start:start + count] for f in vp))


def render_block(vp: VoiceParams, n0: int, blocksize: int,
                 samplerate: int, num_harmonics: int,
                 layout: Optional[BankLayout] = None,
                 used_waves: tuple = ALL_WAVES, use_fm: bool = True,
                 seg=None, nseg: int = 0,
                 use_glide: bool = False, use_bend: bool = False,
                 use_amp: bool = False, use_dmod: bool = False):
    """Render one block -> stereo f32 [blocksize, 2] on vp's device
    (stateless, pure in n0).

    With a grouped ``layout`` each group evaluates only its own waveform;
    otherwise the mixed-group select path is used.  The voices are summed
    serially in packed order (the order the kernel sums in), so the result
    does not depend on the block size.  ``use_bend``/``use_amp``/
    ``use_dmod`` enable the pitch, amplitude and FM-depth curve segments.

    With ``seg`` (per-voice bus ids [V], any int sequence or tensor) the
    mixdown is grouped into ``nseg`` stereo buses -> [blocksize, nseg, 2]:
    each voice adds to its own bus, serially in packed order, so bus b is
    the render of bus b's voices alone.  (The reference scatters the pan
    gains into a [V, 2*nseg] matrix for one matmul, where the other buses'
    voices add exact zeros: the same sum up to the matmul's order.)"""
    dev = vp.device
    buses = None
    if seg is not None:
        buses = [int(b) for b in (seg.tolist() if isinstance(seg, torch.Tensor)
                                  else seg)]
        if len(buses) != vp.wave.shape[0] or not all(
                0 <= b < nseg for b in buses):
            raise ValueError(f"seg needs one bus in [0, {nseg}) per voice "
                             f"({vp.wave.shape[0]})")
    elif nseg:
        raise ValueError("nseg without seg")
    n = n0 + torch.arange(blocksize, dtype=torch.int64, device=dev)
    if layout is None:
        layout = BankLayout.ungrouped(vp.wave.shape[0], num_harmonics, use_fm)
    mix = torch.zeros((blocksize, 2) if buses is None else (blocksize, nseg, 2),
                      dtype=torch.float32, device=dev)
    for (wid, has_fm, start, count) in layout.groups:
        if count == 0:
            continue
        sub = _slice_params(vp, start, count)
        p = _phases(sub, n, has_fm, use_glide, use_bend, use_dmod)
        blep_here = wid in (9, 10) or (
            wid < 0 and any(w in (9, 10) for w in used_waves))
        inst = _inst_inc(sub, n, use_glide, use_bend) if blep_here else None
        if wid < 0:
            w = _wave_select(p, sub, n, num_harmonics, used_waves, inst)
        else:
            w = _one_wave(wid, p, sub, n, num_harmonics, inst)
        env = _adsr(n, sub, samplerate)
        if use_amp:
            env = env * _amp_curve_gain(sub, n)
        sig = (sub.bias[:, None] + sub.amp[:, None] * w) * env
        lg = torch.clamp_max(1.0 - sub.pan, 1.0)
        rg = torch.clamp_max(1.0 + sub.pan, 1.0)
        prod = sig[:, :, None] * torch.stack([lg, rg], dim=1)[:, None, :]
        for i in range(count):
            if buses is None:
                mix += prod[i]
            else:
                mix[:, buses[start + i]] += prod[i]
    return mix


#: pad-slot fills for the sparse render's sentinel row (every other field
#: is 0 of its dtype): amp 0 and gate 0 make every sample an exact 0, and
#: start lies past the song
_SPARSE_PAD_FILLS = {"pulse_width": 0.5, "noise_hold": 1, "damping": 1.0,
                     "bend_start": _I32_MAX, "acurve_start": _I32_MAX,
                     "acurve_g0": 1.0, "dcurve_start": _I32_MAX}


def _append_pad_voice(vp: VoiceParams, start_frame: int) -> VoiceParams:
    """Append ONE silent sentinel row (index V) for the sparse render's pad
    slots, keeping every field's dtype and trailing segment dims."""
    rows = []
    for name, a in zip(VoiceParams._fields, vp):
        fill = start_frame if name == "start" else _SPARSE_PAD_FILLS.get(name, 0)
        pad = torch.full((1,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                         device=a.device)
        rows.append(torch.cat([a, pad]))
    return VoiceParams(*rows)


def audible_ranges(start, gate, attack, decay, release, samplerate: int,
                   margin: int = 0):
    """Conservative frame range [start, end) of each voice's non-zero
    envelope, from host arrays (start and gate in frames, the ADSR times in
    seconds): ``_adsr`` runs to max(gate, attack + decay) + release, so a
    short-gate voice still completes its attack and decay.  ``margin``
    frames are added to the attack+decay and to the release; the end gets
    2 frames for the f32 boundary compare plus dur >> 20 for the f32
    rounding of the envelope's time scale (2^-24 relative).  Shared by
    ``VoiceBank.sparse_plan`` (margin 0, from the packed fields) and
    ``midi.render_notes`` (margin 1, from the note list)."""
    start = np.asarray(start, np.int64)
    ad = np.ceil((np.asarray(attack, np.float64)
                  + np.asarray(decay, np.float64)) * samplerate
                 ).astype(np.int64) + margin
    rel = np.ceil(np.asarray(release, np.float64) * samplerate
                  ).astype(np.int64) + margin
    dur = np.maximum(np.asarray(gate, np.int64), ad) + rel
    return start, start + dur + 2 + (dur >> 20)


class VoiceBank:
    """Batched renderer for a fixed (V, chunk, samplerate) shape on one
    device, the card unless the caller passes ``device="cpu"``.  On a CUDA
    device ``render_song``/``render_chunk``/``render_song_sparse`` launch
    the Hopper kernels (``ops.kernels.render_stereo``); on the CPU they run
    the plain ``render_block``."""

    def __init__(self, nvoices: int, samplerate: int = 44100,
                 chunk_frames: int = 8192, num_harmonics: int = 8,
                 used_waves: tuple = ALL_WAVES, use_fm: bool = True,
                 layout: Optional[BankLayout] = None,
                 use_glide: bool = False, use_bend: bool = False,
                 use_amp: bool = False, use_dmod: bool = False,
                 device="cuda"):
        self.nvoices = nvoices
        self.samplerate = samplerate
        self.chunk_frames = chunk_frames
        self.num_harmonics = num_harmonics
        self.used_waves = tuple(sorted(used_waves))
        self.use_fm = use_fm
        self.use_glide = use_glide
        self.use_bend = use_bend
        self.use_amp = use_amp
        self.use_dmod = use_dmod
        self.layout = layout
        self.device = _device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    @classmethod
    @profiling.spanned("voicebank.for_voices")
    def for_voices(cls, voices: Sequence[Voice], samplerate: int = 44100,
                   chunk_frames: int = 8192, num_harmonics: int = 8,
                   layout: Optional[BankLayout] = None,
                   nvoices: Optional[int] = None,
                   device="cuda") -> "VoiceBank":
        """Bank statically specialized to the waveforms/FM these voices use."""
        used = tuple(sorted({WAVE_IDS[v.wave] for v in voices})) or (0,)
        use_fm = any(v.fm_depth != 0.0 for v in voices)
        use_glide = any(v.glide_from > 0.0 and v.glide_time > 0.0
                        and v.frequency > 0.0 for v in voices)
        use_bend = any(v.pitch_curve for v in voices)
        use_amp = any(v.amp_curve for v in voices)
        use_dmod = any(v.fm_depth_curve for v in voices)
        if 8 not in used and 12 not in used:
            num_harmonics = 0
        return cls(nvoices or len(voices), samplerate, chunk_frames,
                   num_harmonics, used_waves=used, use_fm=use_fm,
                   layout=layout, use_glide=use_glide, use_bend=use_bend,
                   use_amp=use_amp, use_dmod=use_dmod, device=device)

    def _check(self, vp: VoiceParams):
        if vp.device != self.device:
            raise ValueError(f"voice params on {vp.device}, bank on "
                             f"{self.device}")

    def _flags(self) -> dict:
        return dict(use_glide=self.use_glide, use_bend=self.use_bend,
                    use_amp=self.use_amp, use_dmod=self.use_dmod)

    def _kernel_layout(self, vp: VoiceParams) -> BankLayout:
        """The layout the kernel walks: the bank's grouped layout, or one
        mixed group (per-voice waveform switch) for an ungrouped bank."""
        if self.layout is not None:
            return self.layout
        return BankLayout.ungrouped(vp.wave.shape[0], self.num_harmonics,
                                    self.use_fm)

    def _render(self, vp: VoiceParams, n0: int, nframes: int, seg=None,
                nseg: int = 0):
        if self.device.type == "cuda":
            from ..ops.kernels import render_stereo
            return render_stereo(vp, n0, nframes=nframes,
                                 samplerate=self.samplerate,
                                 layout=self._kernel_layout(vp), seg=seg,
                                 nseg=nseg, **self._flags())
        return render_block(vp, n0, nframes, self.samplerate,
                            self.num_harmonics, self.layout, self.used_waves,
                            self.use_fm, seg=seg, nseg=nseg, **self._flags())

    def _seg(self, seg, nseg: int):
        """Per-voice bus ids as a contiguous int32 tensor on the bank's
        device, checked against ``nseg``."""
        t = torch.as_tensor(np.asarray(seg, np.int32) if not isinstance(
            seg, torch.Tensor) else seg).to(device=self.device,
                                            dtype=torch.int32).contiguous()
        if t.ndim != 1 or (t.numel() and (int(t.min()) < 0
                                          or int(t.max()) >= nseg)):
            raise ValueError(f"seg needs one bus in [0, {nseg}) per voice")
        return t

    @profiling.spanned("voicebank.render")
    def render_chunk(self, vp: VoiceParams, n0: int) -> torch.Tensor:
        """One streaming chunk: stereo f32 [chunk, 2] (stateless)."""
        self._check(vp)
        return self._render(vp, n0, self.chunk_frames)

    @profiling.spanned("voicebank.render")
    def render_song(self, vp: VoiceParams, total_frames: int) -> torch.Tensor:
        """Offline mixdown: stereo f32 [total_frames, 2].  On a CUDA device
        the whole song is one kernel launch; on the CPU it renders chunk by
        chunk (bit-identical, every frame depends only on its index)."""
        self._check(vp)
        if self.device.type == "cuda":
            return self._render(vp, 0, total_frames)
        cf = self.chunk_frames
        nchunks = -(-total_frames // cf)
        out = torch.cat([self._render(vp, i * cf, cf) for i in range(nchunks)])
        return out[:total_frames]

    @profiling.spanned("voicebank.render")
    def render_song_grouped(self, vp: VoiceParams, seg, nseg: int,
                            total_frames: int) -> torch.Tensor:
        """Grouped offline mixdown: every voice renders in one pass and
        adds to its own stereo bus (``seg``, per-voice bus ids) -> f32
        [total_frames, nseg, 2].  Each bus sums its own voices in packed
        order, so bus b equals the render of bus b's voices alone, bit for
        bit.  On a CUDA device one kernel launch (a block row per bus); on
        the CPU chunk by chunk."""
        self._check(vp)
        seg = self._seg(seg, int(nseg))
        if self.device.type == "cuda":
            return self._render(vp, 0, total_frames, seg, int(nseg))
        cf = self.chunk_frames
        nchunks = -(-total_frames // cf)
        out = torch.cat([self._render(vp, i * cf, cf, seg, int(nseg))
                         for i in range(nchunks)])
        return out[:total_frames]

    @profiling.spanned("voicebank.render")
    def render_chunk_grouped(self, vp: VoiceParams, seg, nseg: int,
                             n0: int) -> torch.Tensor:
        """One streaming chunk of the grouped render: f32 [chunk, nseg, 2]
        (stateless in the absolute frame index, like ``render_chunk``)."""
        self._check(vp)
        return self._render(vp, n0, self.chunk_frames,
                            self._seg(seg, int(nseg)), int(nseg))

    def render_song_sparse(self, vp: VoiceParams,
                           total_frames: int) -> torch.Tensor:
        """Sparse offline mixdown: stereo f32 [total_frames, 2].

        Buckets the voices by their audible frame range per chunk on the
        host and renders each chunk over only its K active rows, in packed
        order, instead of all V.  A dropped row adds an exact zero to the
        flat render's serial sum, so for finite parameters the output is
        bit-identical to :meth:`render_song`.  Falls back to render_song
        when the bucketed shape would not be smaller."""
        plan = self.sparse_plan(vp, total_frames)
        if plan is None:
            return self.render_song(vp, total_frames)
        fn, idx, pad_start, nchunks = plan
        return fn(vp, idx, pad_start, nchunks)[:total_frames]

    @profiling.spanned("voicebank.sparse_plan")
    def sparse_plan(self, vp: VoiceParams, total_frames: int,
                    ranges=None):
        """Host side of :meth:`render_song_sparse`: bucket the voices'
        audible frame ranges per chunk -> (fn, idx [nchunks, K] int32 on
        the bank's device, pad_start, nchunks), or None when the bucketed
        shape would not beat the flat render (the cost model below).  Call
        ``fn(vp, idx, pad_start, nchunks)`` -> f32 [nchunks * chunk, 2].
        Pad slots hold V, the index of a silent sentinel row.

        ``ranges``: optional (starts, ends, live) host arrays (a
        conservative cover of each voice's audible frames; live False =
        never audible).  Callers that still hold the host note list pass
        them, which saves the copies of vp's fields to the host."""
        self._check(vp)
        cf = self.chunk_frames
        nchunks = -(-total_frames // cf)
        sr = self.samplerate
        if ranges is not None:
            starts, ends, live = ranges
        else:
            host = {f: getattr(vp, f).cpu().numpy() for f in
                    ("start", "gate", "attack", "decay", "release", "amp",
                     "bias")}
            starts, ends = audible_ranges(
                host["start"], host["gate"], host["attack"], host["decay"],
                host["release"], sr)
            # sig = (bias + amp*w) * env: a row needs amp or bias to sound
            live = (host["amp"] != 0.0) | (host["bias"] != 0.0)
        V = int(starts.shape[0])
        first_c = np.maximum(0, starts // cf)
        last_c = np.minimum(nchunks - 1, (ends - 1) // cf)
        span_ok = live & (last_c >= first_c)
        # K first, vectorized, so dense songs bail out before the fill
        delta = np.zeros(nchunks + 1, np.int64)
        np.add.at(delta, first_c[span_ok], 1)
        np.add.at(delta, last_c[span_ok] + 1, -1)
        K = int(np.cumsum(delta)[:nchunks].max(initial=0)) or 1
        K += -K % 8
        # cost model (the reference's): bucketed rows pay every used
        # waveform, grouped flat rows one
        if K * (1 + len(self.used_waves)) >= 2 * V:
            return None
        idx = np.full((nchunks, K), V, np.int32)       # V = sentinel row
        fill = np.zeros(nchunks, np.int32)
        for v in np.flatnonzero(span_ok):
            for c in range(int(first_c[v]), int(last_c[v]) + 1):
                idx[c, fill[c]] = v
                fill[c] += 1
        return (self._render_rows, torch.from_numpy(idx).to(self.device),
                total_frames + cf + 8, nchunks)

    @profiling.spanned("voicebank.render")
    def _render_rows(self, vp: VoiceParams, idx: torch.Tensor,
                     pad_start: int, nchunks: int) -> torch.Tensor:
        """The sparse plan's fn: chunk c renders over the rows idx[c].  On
        CUDA one launch of the render kernel, which takes its candidate
        voices from the rows; on the CPU each chunk gathers its rows (pad
        slots read the appended sentinel row) and renders them ungrouped,
        as the reference's bucketed program does."""
        self._check(vp)
        cf = self.chunk_frames
        if self.device.type == "cuda":
            from ..ops.kernels import render_stereo
            return render_stereo(
                vp, 0, nframes=nchunks * cf, samplerate=self.samplerate,
                layout=BankLayout.ungrouped(vp.wave.shape[0],
                                            self.num_harmonics, self.use_fm),
                idx=idx, chunk_frames=cf, **self._flags())
        vp_pad = _append_pad_voice(vp, pad_start)
        out = []
        for c in range(nchunks):
            rows = idx[c].to(torch.int64)
            vpk = VoiceParams(*(f.index_select(0, rows) for f in vp_pad))
            out.append(render_block(vpk, c * cf, cf, self.samplerate,
                                    self.num_harmonics, None,
                                    self.used_waves, self.use_fm,
                                    **self._flags()))
        return torch.cat(out)

    @staticmethod
    def to_int16(stereo_f32: torch.Tensor,
                 master_gain: float = 1.0) -> torch.Tensor:
        """f32 mix -> saturating int16 (rint half-even, then clip)."""
        v = torch.round(stereo_f32 * float(np.float32(32767.0 * master_gain)))
        return torch.clamp(v, -32768, 32767).to(torch.int16)
