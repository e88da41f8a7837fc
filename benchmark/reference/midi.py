"""The plain reference of a General MIDI file's render, in NumPy.

From the file's bytes alone:

- the Standard MIDI File: chunks, running status, meta and sysex events,
  the tempo map (120 bpm until a tempo event);
- the channel state a note starts in and the curves of its controllers
  while it sounds or rings: CC7 x CC11 gain, CC10 pan, pitch bend in the
  range set through RPN 0,0 (CC101/100, CC6/38), the strongest of CC1,
  channel pressure and the note's own poly pressure as vibrato depth, the
  sustain pedal (CC64), all notes off (CC120/123); after its note-off a
  note keeps taking controller events for ``RELEASE_GRACE`` seconds, its
  curve anchored at the off;
- the General MIDI mapping: program families onto waveforms and
  envelopes, channel 10 as percussion (noise, a sine kick);
- each note as a voice: an integer phase accumulator from frame 0 (with
  pitch bend, a chirp of linearly moving increments between the curve's
  frames), vibrato as the discrete FM integral ``inc * sum D(u)
  sin(lfo_u)``, the waveform (sine, polyBLEP saw and square, harmonic
  stacks, held noise), the ADSR envelope, the gain curve as linear ramps,
  the equal-gain pan law; summed, then ``rint(x * 32767)`` to int16.

``control=True`` rounds each voice's signal and the mix to bfloat16: the
same render one precision below the float32 the file's render states.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .song import (F32, MASK, SR, TWO_NEG32, bf16, noise_values,
                   phase_increment)

RELEASE_GRACE = 2.0
VIBRATO_RATE_HZ = 5.5
VIBRATO_SEMITONES = 0.5
MAX_CURVE_POINTS = 128
TAIL_SECONDS = 0.3
#: phase units (of 2**32 a cycle) by which a voice's phase under FM may
#: lie off the reference's: the program sums the FM integral in float32.
#: The square's value jumps by two at the 64 phases below the half cycle
#: (its float32 position rounds to 0.5), so within this slack of it the
#: reference gives the range of values either phase may take
PHASE_SLACK = 1 << 16

_DEFAULT = dict(wave="sawtooth_bl", amplitude=0.3, attack=0.005, decay=0.05,
                sustain_level=0.7, release=0.15)
#: (lowest program, instrument) of the GM families
GM_FAMILIES = (
    (0, dict(wave="harmonics", amplitude=0.35, attack=0.003, decay=0.4,
             sustain_level=0.25, release=0.25,
             harmonics=(1.0, 0.45, 0.22, 0.1, 0.05))),
    (16, dict(wave="harmonics", amplitude=0.3, attack=0.01, decay=0.1,
              sustain_level=0.8, release=0.1,
              harmonics=(1.0, 0.6, 0.0, 0.4, 0.0, 0.25))),
    (24, dict(wave="harmonics", amplitude=0.32, attack=0.003, decay=0.5,
              sustain_level=0.15, release=0.2,
              harmonics=(1.0, 0.5, 0.25, 0.12))),
    (32, dict(wave="sine", amplitude=0.4, attack=0.004, decay=0.15,
              sustain_level=0.6, release=0.1)),
    (40, dict(wave="sawtooth_bl", amplitude=0.28, attack=0.05, decay=0.1,
              sustain_level=0.8, release=0.2)),
    (56, dict(wave="square_bl", amplitude=0.28, attack=0.02, decay=0.05,
              sustain_level=0.8, release=0.1)),
    (80, dict(wave="square_bl", amplitude=0.3, attack=0.01, decay=0.05,
              sustain_level=0.75, release=0.12)),
    (88, dict(wave="sawtooth_bl", amplitude=0.25, attack=0.1, decay=0.2,
              sustain_level=0.8, release=0.4)),
)
PERC = dict(wave="white_noise", amplitude=0.3, attack=0.001, decay=0.05,
            sustain_level=0.0, release=0.05)
KICK = dict(wave="sine", amplitude=0.5, attack=0.001, decay=0.12,
            sustain_level=0.0, release=0.05)


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

def _vlq(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _events(track: bytes) -> list:
    """(tick, kind, channel, a, b) of one track."""
    out, pos, tick, status = [], 0, 0, 0
    while pos < len(track):
        delta, pos = _vlq(track, pos)
        tick += delta
        b0 = track[pos]
        if b0 == 0xFF:
            status = 0
            meta = track[pos + 1]
            n, p2 = _vlq(track, pos + 2)
            body = track[p2:p2 + n]
            pos = p2 + n
            if meta == 0x51 and n == 3:
                out.append((tick, "tempo", 0, int.from_bytes(body, "big"), 0))
            elif meta == 0x2F:
                break
            continue
        if b0 in (0xF0, 0xF7):
            status = 0
            n, p2 = _vlq(track, pos + 1)
            pos = p2 + n
            continue
        if b0 & 0x80:
            status = b0
            pos += 1
        kind, ch = status & 0xF0, status & 0x0F
        if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
            a, b = track[pos], track[pos + 1]
            pos += 2
            if kind == 0x90:
                out.append((tick, "on" if b else "off", ch, a, b))
            elif kind == 0x80:
                out.append((tick, "off", ch, a, b))
            elif kind == 0xA0:
                out.append((tick, "ppress", ch, a, b))
            elif kind == 0xB0:
                out.append((tick, "cc", ch, a, b))
            else:
                out.append((tick, "bend", ch, 0, (a | (b << 7)) - 8192))
        elif kind in (0xC0, 0xD0):
            out.append((tick, "program" if kind == 0xC0 else "press", ch,
                        track[pos], 0))
            pos += 1
        else:
            raise ValueError(f"MIDI status 0x{status:02x}")
    return out


class _Note:
    """A sounding note: its state at the note-on and its curves."""

    def __init__(self, t0, vel, prog, vol, pan, bend, mod):
        self.t0, self.vel, self.prog = t0, vel, prog
        self.vol, self.pan, self.bend, self.mod = vol, pan, bend, mod
        self.curves = {"bend": [], "gain": [], "mod": []}
        self.base = {"bend": bend, "gain": vol, "mod": mod}

    def record(self, curve: str, now: float, t_off, value: float) -> None:
        pts = self.curves[curve]
        trel = now - self.t0
        if t_off is not None:
            anchor = t_off - self.t0
            if not pts or pts[-1][0] < anchor:
                pts.append((anchor, pts[-1][1] if pts else self.base[curve]))
            if trel <= anchor:
                trel = anchor + 1e-3
        pts.append((trel, value))


def parse(data: bytes) -> list:
    """SMF bytes -> notes: dicts of start, duration, note, velocity,
    channel, program, volume, pan, bend and the curves (None without
    events while the note sounded)."""
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    hlen, _, ntrks, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time is not in the reference")
    pos, events = 8 + hlen, []
    for _ in range(ntrks):
        n = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        events += _events(data[pos + 8:pos + 8 + n])
        pos += 8 + n
    events.sort(key=lambda e: (e[0], e[1] != "tempo"))

    out = []
    open_, held, ringing = {}, {}, []
    programs, cc7, cc11 = [0] * 16, [127] * 16, [127] * 16
    cc10, cc1, press = [None] * 16, [0] * 16, [0] * 16
    ppress, pedal, bend14 = {}, [False] * 16, [0] * 16
    rpn = [(127, 127)] * 16
    rmsb, rlsb = [2] * 16, [0] * 16
    sec, last, tempo = 0.0, 0, 500_000

    def finish(key, nt, t1):
        def curve(name, base):
            pts = nt.curves[name]
            return tuple([(0.0, base)] + pts) if pts else None
        out.append(dict(start=nt.t0, duration=max(t1 - nt.t0, 1e-3),
                        note=key[1], velocity=nt.vel, channel=key[0],
                        program=nt.prog, volume=nt.vol, pan=nt.pan,
                        bend=nt.bend, mod=nt.mod,
                        bend_curve=curve("bend", nt.bend),
                        gain_curve=curve("gain", nt.vol),
                        mod_curve=curve("mod", nt.mod)))

    def sounding(ch):
        keep = []
        for key, nt, t1 in ringing:
            if sec < t1 + RELEASE_GRACE:
                keep.append((key, nt, t1))
            else:
                finish(key, nt, t1)
        ringing[:] = keep
        return ([(k, nt, None) for k, nt in list(open_.items())
                 + list(held.items()) if k[0] == ch]
                + [(k, nt, t1) for k, nt, t1 in ringing if k[0] == ch])

    def depth(ch, key):
        return max(cc1[ch], press[ch], ppress.get(key, (0, 0.0))[0]) / 127.0

    for tick, kind, ch, a, b in events:
        sec += (tick - last) * tempo / 1e6 / division
        last = tick
        if kind == "tempo":
            tempo = a
        elif kind == "program":
            programs[ch] = a
        elif kind == "cc":
            if a == 64:
                down = b >= 64
                if pedal[ch] and not down:
                    for key in [k for k in held if k[0] == ch]:
                        ringing.append((key, held.pop(key), sec))
                pedal[ch] = down
            elif a in (7, 11):
                (cc7 if a == 7 else cc11)[ch] = b
                g = cc7[ch] / 127.0 * (cc11[ch] / 127.0)
                for _, nt, t1 in sounding(ch):
                    nt.record("gain", sec, t1, g)
            elif a == 1:
                cc1[ch] = b
                for k, nt, t1 in sounding(ch):
                    nt.record("mod", sec, t1, depth(ch, k))
            elif a == 10:
                cc10[ch] = b
            elif a == 101:
                rpn[ch] = (b, rpn[ch][1])
            elif a == 100:
                rpn[ch] = (rpn[ch][0], b)
            elif a in (98, 99):
                rpn[ch] = (127, 127)
            elif a == 6 and rpn[ch] == (0, 0):
                rmsb[ch] = b
            elif a == 38 and rpn[ch] == (0, 0):
                rlsb[ch] = b
            elif a in (120, 123):
                for src in (open_, held):
                    for key in [k for k in src if k[0] == ch]:
                        ringing.append((key, src.pop(key), sec))
                pedal[ch] = False
        elif kind == "press":
            press[ch] = a
            for k, nt, t1 in sounding(ch):
                nt.record("mod", sec, t1, depth(ch, k))
        elif kind == "ppress":
            ppress[(ch, a)] = (b, sec)
            for k, nt, t1 in sounding(ch):
                if k == (ch, a):
                    nt.record("mod", sec, t1, depth(ch, k))
        elif kind == "bend":
            bend14[ch] = b
            val = b / 8192.0 * (rmsb[ch] + rlsb[ch] / 100.0)
            for _, nt, t1 in sounding(ch):
                nt.record("bend", sec, t1, val)
        elif kind == "on":
            key = (ch, a)
            if key in held:
                ringing.append((key, held.pop(key), sec))
            pp = ppress.get(key)
            if pp is not None and pp[1] < sec:
                del ppress[key]
            pan = None if cc10[ch] is None else \
                max(-1.0, min(1.0, (cc10[ch] - 64) / 63.0))
            open_[key] = _Note(sec, b, programs[ch],
                               cc7[ch] / 127.0 * (cc11[ch] / 127.0), pan,
                               bend14[ch] / 8192.0
                               * (rmsb[ch] + rlsb[ch] / 100.0),
                               depth(ch, key))
        elif kind == "off":
            key = (ch, a)
            nt = open_.pop(key, None)
            if nt is not None:
                if pedal[ch]:
                    held[key] = nt
                else:
                    ringing.append((key, nt, sec))
    for key in list(held):
        ringing.append((key, held.pop(key), sec))
    for key, nt, t1 in ringing:
        finish(key, nt, t1)
    out.sort(key=lambda n: n["start"])
    return out


# ---------------------------------------------------------------------------
# the General MIDI mapping
# ---------------------------------------------------------------------------

def voices(notes: list) -> list:
    """Notes -> voices (dicts): waveform, envelope, pitch, gain and pan,
    and the curves in the frames of the note."""
    out = []
    unit = 2.0 ** (VIBRATO_SEMITONES / 12.0) - 1.0
    for n in notes:
        perc = n["channel"] == 9
        if perc:
            sd = KICK if n["note"] in (35, 36) else PERC
        else:
            sd = _DEFAULT
            for lo, fam in GM_FAMILIES:
                if n["program"] >= lo:
                    sd = fam
        f_note = 440.0 * 2.0 ** ((n["note"] - 69) / 12.0)
        v = dict(sd, harmonics=sd.get("harmonics", ()), seed=n["note"],
                 start=n["start"], duration=n["duration"],
                 pan=0.0 if n["pan"] is None else n["pan"],
                 pitch_curve=(), amp_curve=(), depth_curve=(),
                 fm_frequency=0.0, fm_depth=0.0)
        if perc:
            v["frequency"] = 60.0 if n["note"] in (35, 36) else \
                180.0 + 40.0 * (n["note"] % 12)
        elif n["bend_curve"] is not None:
            v["frequency"] = f_note
            v["pitch_curve"] = tuple((t, 2.0 ** (s / 12.0))
                                     for t, s in n["bend_curve"])
        else:
            v["frequency"] = f_note * 2.0 ** (n["bend"] / 12.0)
        vol = n["volume"]
        if n["gain_curve"] is not None and not perc:
            v["amp_curve"] = n["gain_curve"]
            vol = 1.0
        v["amplitude"] = sd["amplitude"] * (n["velocity"] / 127.0) * vol
        if not perc:
            mc = n["mod_curve"]
            if mc is not None and len({d for _, d in mc}) > 1:
                v["fm_frequency"] = VIBRATO_RATE_HZ
                v["depth_curve"] = tuple((t, d * unit) for t, d in mc)
            else:
                static = mc[0][1] if mc is not None else n["mod"]
                if static > 0.0:
                    v["fm_frequency"] = VIBRATO_RATE_HZ
                    v["fm_depth"] = static * unit
        out.append(v)
    return out


def frames(voices_: list) -> int:
    """The render's length: to the last envelope's end, and the tail."""
    return max(int((v["start"] + v["attack"] + v["decay"]
                    + max(v["duration"] - v["attack"] - v["decay"], 0.0)
                    + v["release"]) * SR) + 1 for v in voices_) \
        + int(TAIL_SECONDS * SR)


def _framed(curve) -> list:
    """A curve's points at note frames: a hold from frame 0, evenly
    thinned to ``MAX_CURVE_POINTS``, one point a frame (the later)."""
    pts = sorted((float(t), float(x)) for t, x in curve)
    if pts[0][0] > 0.0:
        pts.insert(0, (0.0, pts[0][1]))
    if len(pts) > MAX_CURVE_POINTS:
        idx = np.unique(np.round(np.linspace(0, len(pts) - 1,
                                             MAX_CURVE_POINTS)).astype(int))
        pts = [pts[i] for i in idx]
    out = []
    for t, x in pts:
        f = int(t * SR)
        if out and out[-1][0] == f:
            out[-1] = (f, x)
        else:
            out.append((f, x))
    return out


def _ramp(framed, m: np.ndarray) -> np.ndarray:
    """Linear between the framed points, the last value held after
    them."""
    f = np.asarray([p[0] for p in framed], np.float64)
    x = np.asarray([p[1] for p in framed], np.float64)
    return np.interp(m, f, x)


def _bend_phase(v, m: np.ndarray):
    """(u32 phase, increment) of a pitch-curve voice at note frames ``m``:
    the increment moves by a whole step a frame from one curve frame's
    increment to the next's; the phase is its exact integer sum."""
    fr = _framed(v["pitch_curve"])
    incs = [phase_increment(v["frequency"] * r) for _, r in fr]
    starts = np.asarray([f for f, _ in fr], np.int64)
    phases, ds, phase = [], [], 0
    for j, (f, _) in enumerate(fr):
        phases.append(phase)
        if j + 1 < len(fr):
            L = fr[j + 1][0] - f
            d = (incs[j + 1] - incs[j]) // L
            phase = (phase + L * incs[j] + d * (L * (L - 1) // 2)) % 2 ** 32
        else:
            d = 0
        ds.append(d & 0xFFFFFFFF)
    j = np.clip(np.searchsorted(starts, m, side="right") - 1, 0,
                len(starts) - 1)
    mr = (m - starts[j]).astype(np.uint64)
    tri = (m - starts[j]) * (m - starts[j] - 1) // 2
    p = (np.asarray(phases, np.uint64)[j] + mr * np.asarray(incs, np.uint64)[j]
         + np.asarray(ds, np.uint64)[j] * tri.astype(np.uint64)) & MASK
    inc = (np.asarray(incs, np.uint64)[j] + mr * np.asarray(ds, np.uint64)[j]
           ) & MASK
    return p, inc


def _square(p32: np.ndarray, dt: np.ndarray) -> np.ndarray:
    """The polyBLEP square at u32 phases ``p32``: the naive sign from the
    integer phase, the residuals from its float32 position."""
    x32 = p32.astype(np.float32) * TWO_NEG32
    naive = np.where(p32 < np.uint32(1 << 31), 1.0, -1.0)
    x2 = np.where(x32 < F32(0.5), x32 + F32(0.5), x32 - F32(0.5))
    return naive + _blep(x32, dt) - _blep(x2, dt)


def render_voice(v, n: np.ndarray, spread: bool = False):
    """One voice's mono signal (float64) at absolute frames ``n``; with
    ``spread``, also the lowest and highest signal the voice may take
    there, as offsets from it (see ``PHASE_SLACK``)."""
    s0 = int(v["start"] * SR)
    m = n - s0
    inc0 = phase_increment(v["frequency"])
    inc = np.full(n.shape, inc0, np.uint64)
    if v["pitch_curve"]:
        p, inc = _bend_phase(v, m)
    else:
        p = (n.astype(np.uint64) * np.uint64(inc0)) & MASK
    finc = phase_increment(v["fm_frequency"])
    fm = bool(finc and (v["fm_depth"] or v["depth_curve"]))
    if fm:
        b = finc / 2 ** 32
        if v["depth_curve"]:
            lfo = ((n.astype(np.uint64) * np.uint64(finc)) & MASK) / 2 ** 32
            d = _ramp(_framed(v["depth_curve"]), m.astype(np.float64)) * \
                np.sin(2 * np.pi * lfo)
            # the sum runs from the note's start
            delta = inc0 * np.concatenate([[0.0], np.cumsum(d)[:-1]])
        else:
            s = (math.cos(math.pi * b) - np.cos(2 * np.pi * b * n
                                                  - math.pi * b)) \
                / (2 * math.sin(math.pi * b))
            delta = inc0 * v["fm_depth"] * s
        p = (p.astype(np.int64) + np.rint(delta).astype(np.int64)) \
            .astype(np.uint64) & MASK
    p32 = p.astype(np.uint32)
    x = p32.astype(np.float64) * 2.0 ** -32
    w = v["wave"]
    lo = hi = None
    if w == "sine":
        val = np.sin(2 * np.pi * x)
    elif w == "harmonics":
        val = np.zeros(n.shape)
        for k, a in enumerate(v["harmonics"][:8], start=1):
            if a:
                pk = ((p.astype(np.uint64) * np.uint64(k)) & MASK)
                val += a * np.sin(2 * np.pi * pk / 2 ** 32)
    elif w in ("sawtooth_bl", "square_bl"):
        dt = np.maximum(inc.astype(np.float64) * 2.0 ** -32, 1e-9)
        x32 = p32.astype(np.float32) * TWO_NEG32
        if w == "sawtooth_bl":
            val = (2.0 * x32 - 1.0) - _blep(x32, dt)
        else:
            val = _square(p32, dt)
            if spread and fm:
                lo, hi = _square_spread(p32, dt, val)
    elif w == "white_noise":
        hold = max(1, int(round(SR / v["frequency"])))
        val = noise_values((n // hold).astype(np.uint32),
                           v["seed"]).astype(np.float64)
    else:
        raise ValueError(f"waveform {w!r} is not in the reference")
    gate = int(v["duration"] * SR) / SR
    a, dcy, r = v["attack"], v["decay"], v["release"]
    sus = max(gate - a - dcy, 0.0)
    t = m / SR
    t2, t3, t4 = a + dcy, a + dcy + sus, a + dcy + sus + r
    sl = v["sustain_level"]
    env = np.where(t < a, t / max(a, 1e-30),
          np.where(t < t2, 1.0 + (sl - 1.0) * (t - a) / max(dcy, 1e-30),
          np.where(t < t3, sl,
          np.where(t < t4, sl * (t4 - t) / max(r, 1e-30), 0.0))))
    env = np.clip(np.where(t < 0, 0.0, env), 0.0, 1.0)
    if v["amp_curve"]:
        env = env * _ramp(_framed(v["amp_curve"]), m.astype(np.float64))
    mono = v["amplitude"] * val * env
    if not spread:
        return mono
    if lo is None:
        lo = hi = np.zeros(n.shape)
    g = v["amplitude"] * env
    return mono, g * lo, g * hi


def _square_spread(p32: np.ndarray, dt: np.ndarray, val: np.ndarray):
    """(lowest, highest) offsets from ``val`` of the square's value where
    the phase lies within ``PHASE_SLACK`` of the half cycle: there the
    float32 position rounds to 0.5 for the 64 phases below 2**31, where
    the residuals read 2 instead of about 0, so a phase a few units off
    lands on the other value."""
    lo = np.zeros(p32.shape)
    hi = np.zeros(p32.shape)
    near = np.abs(p32.astype(np.int64) - (1 << 31)) <= PHASE_SLACK
    if near.any():
        pn, dn = p32[near], dt[near]
        cands = [_square(q, dn) - val[near] for q in (
            pn, np.full_like(pn, (1 << 31) - 1),
            pn - np.uint32(128), pn + np.uint32(128))]
        lo[near] = np.minimum.reduce(cands)
        hi[near] = np.maximum.reduce(cands)
    return lo, hi


def _blep(t, dt):
    """The polyBLEP residual (float64 of the float32 phase)."""
    t = t.astype(np.float64)
    lo = 2 * t / dt - (t / dt) ** 2 - 1.0
    u1 = (t - 1.0) / dt
    hi = u1 * u1 + 2 * u1 + 1.0
    return np.where(t < dt, lo, np.where(t > 1.0 - dt, hi, 0.0))


def render(data: bytes, control: bool = False, spread: bool = False):
    """The file -> int16 [n, 2]; with ``spread``, the (lowest, highest)
    int16 [n, 2] renders the file may give (``PHASE_SLACK``)."""
    vs = voices(parse(data))
    total = frames(vs)
    out = np.zeros((total, 2))
    lo = np.zeros((total, 2))
    hi = np.zeros((total, 2))
    for v in vs:
        s0 = int(v["start"] * SR)
        gate = int(v["duration"] * SR) / SR
        end = v["attack"] + v["decay"] + max(
            gate - v["attack"] - v["decay"], 0.0) + v["release"]
        n = np.arange(max(s0, 0), min(total, s0 + math.ceil(end * SR) + 1),
                      dtype=np.int64)
        gains = (min(1.0, 1.0 - v["pan"]), min(1.0, 1.0 + v["pan"]))
        if spread:
            mono, dlo, dhi = render_voice(v, n, spread=True)
            for c, g in enumerate(gains):
                lo[n, c] += dlo * g
                hi[n, c] += dhi * g
        else:
            mono = render_voice(v, n)
        if control:
            mono = bf16(mono).astype(np.float64)
        for c, g in enumerate(gains):
            out[n, c] += mono * g
    if control:
        out = bf16(out).astype(np.float64)
    if spread:
        return _int16(out + lo), _int16(out + hi)
    return _int16(out)


def _int16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)
