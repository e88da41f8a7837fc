"""The plain reference of the tracker song's stream, in PyTorch (float64 on
the CPU) beside the NumPy stages of ``reference/song.py``.

It implements the semantics of the trackmixer ``.ini`` song (the schema of
``docs/SONGS.md``) for what the tracker song uses beyond ``song.py``, from
the text and the instrument files alone (WAV and AIFF, read here):

- ``[sampler.NAME]`` with ``loop_start``/``loop_end``: a note reads the
  source at ``(n - start) * rate`` until it passes the loop's end, then at
  ``loop_start + x * loop_len`` where ``x`` is the 32-bit DDS phase of the
  loop (increment ``rate / loop_len`` and initial phase ``-loop_start /
  loop_len`` in units of 2**-32), for the note's tie length; then a linear
  fade over ``release`` ends it;
- the RBJ biquad (``filter``): a highpass with fixed coefficients, and a
  lowpass whose cutoff follows ``fx.filter.cutoff`` frame by frame,
  clipped to [10 Hz, 0.49 * rate];
- the peak compressor keyed by another track's hits bus
  (``sidechain=NAME``: the detector hears the int16 bus of that
  instrument's own hits, the gain applies to the track);
- ``fx.compress.release`` and ``fx.reverb.roomsize`` inside their
  recurrences: per-frame decay and comb-feedback grids;
- chains on a drum track's bus and on a sampler track's bus.

Each recurrence runs in float64: the biquad and the compressor's smoother
block by block (:func:`recur2`), the compressor's decaying-max envelope in
closed form over the logarithm of its decay, the Freeverb combs by blocks
of their shortest delay with the damping one-pole as its impulse response.
The formulas are those of ``goldref.effects``' sequential oracles
(``biquad_filter``, ``compressor_gains_swept``, ``sidechain_level``,
``reverb``), with their float32 knobs and grids (compressor alpha and
decay, comb feedback and damping) and the one-frame house rules (``rint``,
``floor``, and the float32 products and read positions before them).
``control=True`` rounds every float signal between stages to bfloat16.

Departures from the published description, each too small to show in an
int16 frame except where a rounding flips: the swept lowpass's
coefficients come from the float64 curve (the program derives them in
float32 frame by frame); the static biquad's are float64, as in
``goldref.effects.biquad_filter``; the damping one-pole (pole at most 0.4)
is cut after 64 taps, where it has fallen below 2**-84 of its first.  A
drum track's chain without automation or sidechain is applied to the
instrument's samples once, as the song layer bakes it into the WAV.  The
stream's length follows the program's accounting of the song's end: the
last hit or note (a looped note at its gate plus release, two frames of
slack as for one-shot notes), plus the longest track chain's tail, plus
the master chain's tail.
"""

from __future__ import annotations

import configparser
import math
import os
import struct
import wave

import numpy as np
import torch
import torch.nn.functional as F

from . import song as ref

SR = ref.SR
F32 = np.float32
F64 = torch.float64
MASK = 0xFFFFFFFF
#: taps kept of the combs' damping one-pole
DAMP_TAPS = 64


# ---------------------------------------------------------------------------
# the instrument files
# ---------------------------------------------------------------------------

def _aiff_rate(b: bytes) -> float:
    exp, hi, lo = struct.unpack(">HII", b)
    return ((hi << 32) | lo) * 2.0 ** ((exp & 0x7FFF) - 16383 - 63)


def read_sample(path: str) -> np.ndarray:
    """A 16-bit WAV or AIFF file at 44.1 kHz -> int16 [n, channels]."""
    if path.lower().endswith((".aif", ".aiff")):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"FORM" or data[8:12] != b"AIFF":
            raise ValueError(f"{path}: not an AIFF file")
        pos, comm, ssnd = 12, None, None
        while pos + 8 <= len(data):
            cid, size = data[pos:pos + 4], struct.unpack(
                ">I", data[pos + 4:pos + 8])[0]
            body = data[pos + 8:pos + 8 + size]
            if cid == b"COMM":
                comm = body
            elif cid == b"SSND":
                ssnd = body
            pos += 8 + size + (size & 1)
        ch, nframes, bits = struct.unpack(">HIH", comm[:8])
        if bits != 16 or _aiff_rate(comm[8:18]) != SR:
            raise ValueError(f"{path}: not 16-bit at {SR} Hz")
        off = struct.unpack(">I", ssnd[:4])[0]
        pcm = np.frombuffer(ssnd[8 + off:8 + off + 2 * ch * nframes], ">i2")
        return pcm.reshape(-1, ch).astype(np.int16)
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getframerate() != SR:
            raise ValueError(f"{path}: not 16-bit at {SR} Hz")
        ch = w.getnchannels()
        data = w.readframes(w.getnframes())
    return np.frombuffer(data, "<i2").reshape(-1, ch).astype(np.int16)


# ---------------------------------------------------------------------------
# the song text
# ---------------------------------------------------------------------------

class TrackerText(ref.SongText):
    """``song.SongText`` with the sampler loops and the text-valued effect
    knobs (``kind``, ``sidechain``) the tracker song has."""

    TEXT_KNOBS = ("kind", "sidechain")

    def __init__(self, text: str, sample_dir: str):
        super().__init__(text, sample_dir, read_sample)
        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        cp.read_string(text)
        #: sampler -> (loop start, loop end, release) seconds, when looped
        self.loops = {}
        for name in self.samplers:
            g = cp[f"sampler.{name}"]
            ls = g.getfloat("loop_start", -1.0)
            le = g.getfloat("loop_end", -1.0)
            if 0.0 <= ls < le:
                self.loops[name] = (ls, le, g.getfloat("release", 0.01))

    def _chain(self, items):
        out = []
        for name, val in items:
            p = {}
            for tok in val.split():
                k, v = tok.split("=", 1)
                p[k] = v if k in self.TEXT_KNOBS else float(v)
            out.append((name, p))
        return out

    def curve(self, key: str, n0: int, n: int):
        """An automation curve at frames [n0, n0 + n) (float64 linear
        interpolation over ticks, ends held), or None."""
        pts = self.automation.get(key)
        if pts is None:
            return None
        t = (n0 + np.arange(n)) / (self.tick_seconds * SR)
        return np.interp(t, [a for a, _ in pts], [b for _, b in pts])


def sampler_notes(song: TrackerText):
    """[(sampler, start frame, rate f64, gains [2] f32, held ticks)]."""
    tickf = song.tick_seconds * SR
    out = []
    for bar, pat in song.events():
        for inst, p in pat.items():
            if inst not in song.samplers:
                continue
            for t, tok, held in ref.notes(p):
                note, vel = ref.split_token(tok)
                out.append((inst, int(song.tick_pos(bar + t) * tickf),
                            ref.note_freq(note) / song.samplers[inst]["base"],
                            np.float32(vel) * song.hit_gain(inst, bar + t),
                            held))
    return out


# ---------------------------------------------------------------------------
# recurrences
# ---------------------------------------------------------------------------

def _frames(v, n: int) -> torch.Tensor:
    """A scalar or per-frame value as float64 [n, 1]."""
    t = torch.as_tensor(v, dtype=F64)
    return t.expand(n, 1) if t.numel() == 1 else t.reshape(n, 1)


def recur2(u: torch.Tensor, a1, a2, y1=0.0, y2=0.0) -> torch.Tensor:
    """y_n = u_n - a1_n y_{n-1} - a2_n y_{n-2} along the frames of ``u``
    [n, c], with y_{-1} = y1 and y_{-2} = y2, in float64: blocks of about
    sqrt(n) frames step side by side from rest (with the responses to
    each of the two entering states beside them), then the states carry
    from block to block."""
    n, c = u.shape
    B = max(2, math.isqrt(n))
    m = -(-n // B)
    pad = m * B - n

    def blocks(v):
        return F.pad(v, (0, 0, 0, pad)).reshape(m, B, v.shape[1])
    U, A1, A2 = blocks(u), blocks(_frames(a1, n)), blocks(_frames(a2, n))
    Yp = torch.empty_like(U)
    Ha = torch.empty_like(A1)
    Hb = torch.empty_like(A1)
    p1 = p2 = torch.zeros(m, c, dtype=F64)
    a_1, a_2 = torch.ones(m, 1, dtype=F64), torch.zeros(m, 1, dtype=F64)
    b_1, b_2 = a_2, a_1
    for k in range(B):
        c1, c2 = A1[:, k], A2[:, k]
        p1, p2 = U[:, k] - c1 * p1 - c2 * p2, p1
        a_1, a_2 = -c1 * a_1 - c2 * a_2, a_1
        b_1, b_2 = -c1 * b_1 - c2 * b_2, b_1
        Yp[:, k], Ha[:, k], Hb[:, k] = p1, a_1, b_1
    s1 = torch.as_tensor(y1, dtype=F64).expand(c).clone()
    s2 = torch.as_tensor(y2, dtype=F64).expand(c).clone()
    S1, S2 = torch.empty(m, c, dtype=F64), torch.empty(m, c, dtype=F64)
    for j in range(m):
        S1[j], S2[j] = s1, s2
        s1, s2 = (Yp[j, -1] + s1 * Ha[j, -1] + s2 * Hb[j, -1],
                  Yp[j, -2] + s1 * Ha[j, -2] + s2 * Hb[j, -2])
    Y = Yp + S1[:, None] * Ha + S2[:, None] * Hb
    return Y.reshape(m * B, c)[:n]


def decaying_max(a: torch.Tensor, decay) -> torch.Tensor:
    """e_n = max(a_n, e_{n-1} decay_n), e_{-1} = 0, for a >= 0 and
    0 < decay < 1 (scalar or per frame): with L the running sum of
    log decay, log e_n = L_n + max over j <= n of (log a_j - L_j)."""
    L = torch.cumsum(torch.log(_frames(decay, a.shape[0])[:, 0]), 0)
    m = torch.cummax(torch.log(a) - L, 0).values
    return torch.exp(m + L)


# ---------------------------------------------------------------------------
# effects
# ---------------------------------------------------------------------------

def _norm(x16: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x16, np.float64)) / 32767.0


def _out16(y: torch.Tensor, prec) -> np.ndarray:
    """The house synthesis rule rint(y * 32767), saturated."""
    return ref.to16(ref.quantize(prec(y.numpy())))


def rbj(kind: str, fc, q: float):
    """RBJ cookbook (b0, b1, b2, a1, a2) over a0, float64, per frame of
    the cutoff ``fc`` (Hz, clipped to [10, 0.49 * rate])."""
    fc = torch.clamp(torch.as_tensor(fc, dtype=F64), 10.0, 0.49 * SR)
    w0 = 2.0 * math.pi * fc / SR
    alpha = torch.sin(w0) / (2.0 * q)
    cw = torch.cos(w0)
    if kind == "lowpass":
        b = ((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
    elif kind == "highpass":
        b = ((1 + cw) / 2, -(1 + cw), (1 + cw) / 2)
    else:
        raise ValueError(f"filter kind {kind!r} is not in the reference")
    a0 = 1 + alpha
    return tuple(v / a0 for v in b + (-2 * cw, 1 - alpha))


def biquad(x16: np.ndarray, coeffs, prec) -> np.ndarray:
    """y_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2} - a1 y_{n-1} - a2 y_{n-2} on
    the normalised signal, channels apart, from rest."""
    b0, b1, b2, a1, a2 = (_frames(c, x16.shape[0]) for c in coeffs)
    s = _norm(x16)
    x1 = F.pad(s, (0, 0, 1, 0))[:-1]
    x2 = F.pad(s, (0, 0, 2, 0))[:-2]
    return _out16(recur2(b0 * s + b1 * x1 + b2 * x2, a1, a2), prec)


def compressor_coeffs(attack, release):
    """(alpha, decay) as the float32 knobs or grids of the program:
    alpha = 1 - exp(-1 / (attack * rate)), decay = exp(-1 / (release *
    rate)), from float64."""
    a = np.asarray(attack, np.float64)
    r = np.asarray(release, np.float64)
    return (np.float32(1.0 - np.exp(-1.0 / (a * SR))).astype(np.float64),
            np.float32(np.exp(-1.0 / (r * SR))).astype(np.float64))


def compress(x16: np.ndarray, level: torch.Tensor, alpha, decay, prec,
             threshold_db=-20.0, ratio=4.0, makeup_db=0.0) -> np.ndarray:
    """The peak compressor on ``x16`` with detector level ``level`` [n]
    (the signal's own, or a sidechain key's): e_n = max(a_n, e_{n-1}
    decay_n); g_n = 2**(min(0, (threshold - 20 log10 max(e_n, 1e-10)) (1
    - 1/ratio)) / 6.0206); y_n = y_{n-1} + alpha_n (g_n - y_{n-1}), y_{-1}
    = 1, run as z = 1 - y; gain floor(f32(x) * f32(y makeup))."""
    e = decaying_max(level, decay)
    slope = 1.0 - 1.0 / ratio
    level_db = 20.0 * torch.log10(torch.clamp_min(e, 1e-10))
    g = torch.exp2(torch.clamp_max((threshold_db - level_db) * slope, 0.0)
                   / 6.0206)
    al = _frames(alpha, len(g))
    z = recur2(al * (1.0 - g[:, None]), -(1.0 - al), 0.0)
    makeup = float(np.exp2(np.float32(makeup_db) / np.float32(6.0206)))
    gain = (prec((1.0 - z[:, 0]).numpy()) * makeup).astype(np.float32)
    return ref.to16(np.floor(x16.astype(np.float32) * gain[:, None]))


def detector(x16: np.ndarray) -> torch.Tensor:
    """a_n = max over channels of |x_n| / 32767."""
    return torch.amax(torch.abs(_norm(x16)), 1)


def _combs(mono: torch.Tensor, delays, fb: torch.Tensor, damp: float):
    """The sum of Freeverb's damped combs over ``mono`` [n]: y_n =
    w_{n-D}; fs_n = y_n (1 - damp) + fs_{n-1} damp; w_n = x_n + fs_n fb_n;
    all combs side by side, by blocks of the shortest delay (a block's y
    reads only earlier blocks)."""
    n = mono.shape[0]
    T = DAMP_TAPS
    d1, d2 = float(np.float32(damp)), float(np.float32(1.0 - damp))
    if d1 > 0.5:
        raise ValueError("the reference's combs take damping up to 1.25")
    kern = (d2 * d1 ** torch.arange(T, dtype=F64)).flip(0)[None, None]
    D = torch.tensor(delays)[:, None]
    K = len(delays)
    W = torch.zeros(K, n, dtype=F64)
    Y = torch.zeros(K, n + T - 1, dtype=F64)      # T - 1 frames of rest
    rows = torch.arange(K)[:, None]
    B = min(delays)
    for b0 in range(0, n, B):
        b1 = min(n, b0 + B)
        src = torch.arange(b0, b1)[None] - D
        Y[:, T - 1 + b0:T - 1 + b1] = torch.where(
            src >= 0, W[rows, src.clamp(min=0)], 0.0)
        fs = F.conv1d(Y[:, None, b0:T - 1 + b1], kern)[:, 0]
        W[:, b0:b1] = mono[b0:b1] + fs * fb[b0:b1]
    return Y[:, T - 1:].sum(0)


def reverb(x16: np.ndarray, prec, wet, dry, fb, damping: float,
           width: float = 1.0) -> np.ndarray:
    """Freeverb with per-frame ``wet``, ``dry`` and comb feedback ``fb``
    (float32 grids, as ``goldref.effects.reverb``'s): the channels'
    sum times 0.015 feeds each channel's eight combs and four
    allpasses (the right channel's delays 23 frames longer); out = dry s
    + wet1 rev_own + wet2 rev_other."""
    n = x16.shape[0]
    s = _norm(x16)
    mono = torch.from_numpy(prec((torch.sum(s, 1) * ref.FIXED_GAIN).numpy()))
    fbt = _frames(fb, n)[:, 0]
    revs = []
    for ch in range(2):
        combs = [d + ref.STEREO_SPREAD * ch for d in ref.COMB_TUNING]
        out = prec(_combs(mono, combs, fbt, 0.4 * damping).numpy())
        for d in ref.ALLPASS_TUNING:
            out = prec(ref._allpass(out, d + ref.STEREO_SPREAD * ch,
                                    ref.ALLPASS_FEEDBACK))
        revs.append(out)
    w1 = np.asarray(wet) * (width / 2.0 + 0.5)
    w2 = np.asarray(wet) * (1.0 - width) / 2.0
    dry = np.asarray(dry)
    sn = s.numpy()
    out = np.stack([dry * sn[:, 0] + w1 * revs[0] + w2 * revs[1],
                    dry * sn[:, 1] + w1 * revs[1] + w2 * revs[0]], 1)
    return ref.to16(ref.quantize(prec(out)))


def run_chain(x16: np.ndarray, chain, song: TrackerText, prec,
              prefix: str = "fx.", keys=None) -> np.ndarray:
    """A chain over a whole int16 signal, entry by entry (curves from
    ``prefix``: ``fx.`` for the master chain, ``fx.TRACK.`` for a
    track's), each entry's result rounded to int16."""
    n = x16.shape[0]

    def knob(key, static):
        c = song.curve(prefix + key, 0, n)
        return np.full(n, static) if c is None else c

    for name, p in chain:
        if name == "compress":
            sc = p.get("sidechain")
            alpha, decay = compressor_coeffs(
                knob("compress.attack", p.get("attack", 0.005)),
                knob("compress.release", p.get("release", 0.1)))
            x16 = compress(x16, detector(keys[sc] if sc else x16), alpha,
                           decay, prec, p.get("threshold_db", -20.0),
                           p.get("ratio", 4.0), p.get("makeup_db", 0.0))
        elif name == "filter":
            coeffs = rbj(p["kind"], knob("filter.cutoff", p["cutoff"]),
                         p.get("q", 0.7071))
            x16 = biquad(x16, coeffs, prec)
        elif name == "reverb":
            room = knob("reverb.roomsize", p.get("roomsize", 0.7))
            x16 = reverb(x16, prec, knob("reverb.wet", p.get("wet", 0.33)),
                         knob("reverb.dry", p.get("dry", 0.7)),
                         (0.7 + 0.28 * room).astype(np.float32),
                         p.get("damping", 0.5), p.get("width", 1.0))
        else:
            raise ValueError(f"effect {name!r} is not in the reference")
    return x16


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _read(w: np.ndarray, pos: np.ndarray, gains: np.ndarray) -> np.ndarray:
    """rint of the linear interpolation of ``w`` at float32 positions,
    times float32 per-frame gains [k, 2]."""
    last = len(w) - 1
    i = np.minimum(np.maximum(pos.astype(np.int64), 0), max(last - 1, 0))
    frac = (pos - i.astype(np.float32))[:, None]
    v0 = w[i].astype(np.float32)
    v1 = w[np.minimum(i + 1, last)].astype(np.float32)
    return np.rint((v0 + (v1 - v0) * frac) * gains).astype(np.int64)


def _looped(w, loop, start, rate, g, held, tickf, total):
    """A looped note -> (frames relative to the song, int64 [k, 2])."""
    ls_s, le_s, release = loop
    ls = float(int(ls_s * SR))
    lp = float(int(le_s * SR)) - ls
    fade = max(1, int(release * SR))
    gate = np.float32(held * tickf + fade)
    inc = int(round(rate / lp * 4294967296.0)) & MASK
    p0 = int(round(((-ls / lp) % 1.0) * 4294967296.0)) & MASK
    nr = np.arange(0, min(total - start, int(gate) + 1), dtype=np.int64)
    nr = nr[nr.astype(np.float32) < gate]
    pos = nr.astype(np.float32) * np.float32(rate)
    phase = (p0 + nr.astype(np.uint64) * np.uint64(inc)) & np.uint64(MASK)
    x = phase.astype(np.float32) * np.float32(2.0 ** -32)
    pos_loop = F32(ls) + x * F32(lp)
    pos = np.where(pos > F32(ls + lp), pos_loop, pos)
    pos = np.minimum(pos, F32(len(w) - 1))
    env = np.clip((gate - nr.astype(np.float32)) * np.float32(1.0 / fade),
                  0.0, 1.0).astype(np.float32)
    return start + nr, _read(w, pos, (g[None, :] * env[:, None]))


def _oneshot(w, start, rate, g, total):
    nr = np.arange(0, max(0, total - start), dtype=np.int64)
    pos = nr.astype(np.float32) * np.float32(rate)
    keep = pos <= F32(len(w) - 1)
    return start + nr[keep], _read(w, pos[keep], g[None, :])


def _note_end(song, inst, start, rate, held, tickf) -> int:
    """Where the program's mix stops counting a note (exclusive)."""
    w = song.samplers[inst]["frames"]
    if inst in song.loops:
        fade = max(1, int(song.loops[inst][2] * SR))
        return start + int(np.float32(held * tickf + fade)) + 2
    return start + int(np.floor((len(w) - 1)
                                / max(float(np.float32(rate)), 1e-9))) + 2


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

def stream(song: TrackerText, control: bool = False) -> np.ndarray:
    """The song -> int16 [n, 2]: what ``Song.mix_generator`` streams,
    ``mix(normalize=False, tail_seconds=0)``."""
    if song.synths:
        raise ValueError("synth tracks are in reference/song.py")
    prec = ref._Prec(control)
    tickf = song.tick_seconds * SR
    drums = dict(song.instruments)
    for inst, chain in song.track_fx.items():
        if inst in drums:
            if any(p.get("sidechain") for _, p in chain) or any(
                    k.startswith(f"fx.{inst}.") for k in song.automation):
                raise ValueError(f"the drum bus of {inst!r} is not in the "
                                 f"reference")
            drums[inst] = run_chain(drums[inst], chain, song, prec,
                                    f"fx.{inst}.")
    hits = ref.drum_hits(song)
    notes = sampler_notes(song)
    content = max([s + len(drums[i]) for i, s, _ in hits]
                  + [_note_end(song, i, s, r, h, tickf)
                     for i, s, r, _, h in notes] + [0])
    tail = max([ref.chain_tail(song.track_fx[i])
                for i in {n[0] for n in notes} if i in song.track_fx] + [0])
    total = content + tail

    def scatter(selected) -> np.ndarray:
        out = np.zeros((total, 2), np.int64)
        for inst, s, g in selected:
            w = drums[inst][:max(0, total - s)]
            out[s:s + len(w)] += np.rint(w.astype(np.float32) * g).astype(
                np.int64)
        return out

    out = scatter(hits)
    keys = {p["sidechain"]: ref.to16(scatter(
        [h for h in hits if h[0] == p["sidechain"]]))
        for chain in song.track_fx.values() for _, p in chain
        if p.get("sidechain")}
    for inst in sorted({n[0] for n in notes}):
        bus = np.zeros((total, 2), np.int64)
        w = song.samplers[inst]["frames"]
        for _, s, rate, g, held in (n for n in notes if n[0] == inst):
            if inst in song.loops:
                idx, v = _looped(w, song.loops[inst], s, rate, g, held,
                                 tickf, total)
            else:
                idx, v = _oneshot(w, s, rate, g, total)
            bus[idx] += v
        if inst in song.track_fx:
            bus = run_chain(ref.to16(bus), song.track_fx[inst], song, prec,
                            f"fx.{inst}.", keys)
        out += bus
    out16 = ref.to16(out)
    mv = song.automation.get("master.volume")
    if mv:
        g = prec(song.curve("master.volume", 0, total))
        out16 = ref.to16(np.rint(out16 * g.astype(np.float32)[:, None]))
    if song.fx:
        pad = ref.chain_tail(song.fx) + ref.chain_flush(song.fx)
        out16 = np.concatenate([out16, np.zeros((pad, 2), np.int64)])
        out16 = run_chain(out16, song.fx, song, prec, "fx.", keys)
    return out16.astype(np.int16)


def render(text: str, sample_dir: str, control: bool = False) -> np.ndarray:
    """The stream of the song ``text`` over the kit in ``sample_dir``,
    with TF32 off while it runs."""
    b = torch.backends
    flags = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        return stream(TrackerText(text, os.fspath(sample_dir)), control)
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = flags
