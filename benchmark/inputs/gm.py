"""The General MIDI file of the ``gm_midi`` configuration, from the seed:
a frozen copy of the repository's seeded GM song generator
(``gm_events``) and of its format-0 Standard MIDI File writer
(``write_midi``), so that later changes to the program cannot move the
benchmark's input.

The song: ``nnotes`` notes over ``duration`` seconds on 16 channels
(channel 10, index 9, percussion), programs from eight GM families, pan
on most channels, pitch-bend sweeps (channel 1 with a +-12 semitone range
through RPN 0,0), CC7/CC11 fades, CC1 vibrato swells, channel and poly
pressure and the sustain pedal.
"""

from __future__ import annotations

import io
import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class MidiNote(NamedTuple):
    start: float        # seconds
    duration: float     # seconds
    note: int           # MIDI note number
    velocity: int       # 1..127
    channel: int        # 0..15
    program: int = 0
    volume: float = 1.0
    pan: Optional[float] = None


def gm_events(nnotes: int, duration: float, seed: int = 0):
    """A seeded General-MIDI song for ``write_midi``: ``nnotes`` notes on 16
    channels (channel 10, index 9, is percussion) over ``duration``
    seconds, with the controllers the MIDI path turns into curves.
    Returns (notes, bends, controls, pressures, poly_pressures).

    - programs from every GM family the mapping knows, pan on most
      channels;
    - pitch-bend sweeps on channels 0-3, channel 1 with a +-12 semitone
      range set through RPN 0,0;
    - CC7/CC11 fades on channels 4 and 5, CC1 vibrato swells on 6 and 7,
      channel pressure on 8, poly pressure on 10;
    - the sustain pedal (CC64) going down and up on channel 0."""
    rng = np.random.default_rng(seed)
    families = (0, 16, 24, 32, 40, 56, 80, 88)
    programs = [families[c % 8] + int(rng.integers(0, 8)) for c in range(16)]
    pans = [None if c % 5 == 4 else float(rng.uniform(-1, 1))
            for c in range(16)]
    notes = []
    for _ in range(nnotes):
        ch = int(rng.integers(0, 16))
        start = round(float(rng.uniform(0.0, duration - 2.0)), 4)
        if ch == 9:
            key, dur = int(rng.integers(35, 52)), float(rng.uniform(0.05, 0.2))
        else:
            key = int(rng.integers(36, 90))
            dur = float(rng.uniform(0.08, 1.2))
        notes.append(MidiNote(start, round(dur, 4), key,
                              int(rng.integers(20, 90)), ch, programs[ch],
                              pan=pans[ch]))
    notes.sort(key=lambda n: n.start)
    step = 0.02

    def ramp(t0, length):
        return [round(t0 + k * step, 4) for k in range(int(length / step))]

    def spots(count, length):
        return sorted(float(t) for t in rng.uniform(0.0, duration - length - 1,
                                                    count))

    nsweeps = max(2, int(duration / 6))
    bends, controls, pressures, poly = [], [], [], []
    controls += [(0.0, 1, 101, 0), (0.0, 1, 100, 0), (0.0, 1, 6, 12),
                 (0.0, 1, 38, 0)]
    for ch in range(4):
        for t0 in spots(nsweeps, 0.6):
            ts = ramp(t0, 0.6)
            bends += [(t, ch, int(8191 * np.sin(np.pi * k / len(ts))
                                  * (1 if ch % 2 else -1)))
                      for k, t in enumerate(ts)]
            bends.append((round(ts[-1] + step, 4), ch, 0))
    for ch, cc in ((4, 7), (5, 11)):
        for t0 in spots(nsweeps, 1.0):
            ts = ramp(t0, 1.0)
            controls += [(t, ch, cc, int(127 - 100 * k / len(ts)))
                         for k, t in enumerate(ts)]
            controls.append((round(ts[-1] + step, 4), ch, cc, 127))
    for ch in (6, 7):
        for t0 in spots(nsweeps, 1.0):
            ts = ramp(t0, 1.0)
            controls += [(t, ch, 1, int(127 * k / len(ts)))
                         for k, t in enumerate(ts)]
            controls.append((round(ts[-1] + step, 4), ch, 1, 0))
    for t0 in spots(nsweeps, 0.8):
        ts = ramp(t0, 0.8)
        pressures += [(t, 8, int(120 * k / len(ts))) for k, t in enumerate(ts)]
        pressures.append((round(ts[-1] + step, 4), 8, 0))
    for n in [n for n in notes if n.channel == 10][:nsweeps]:
        poly += [(round(n.start + 0.05 * k, 4), 10, n.note, 30 * k)
                 for k in range(1, 4)]
    for t0 in spots(nsweeps, 2.0):
        controls += [(round(t0, 4), 0, 64, 127), (round(t0 + 2.0, 4), 0, 64, 0)]
    return notes, bends, controls, pressures, poly


def _vlq(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def write_midi(notes: Sequence[MidiNote], division: int = 480,
               bpm: float = 120.0,
               bends: Sequence[Tuple[float, int, int]] = (),
               controls: Sequence[Tuple[float, int, int, int]] = (),
               pressures: Sequence[Tuple[float, int, int]] = (),
               poly_pressures: Sequence[Tuple[float, int, int, int]] = ()
               ) -> bytes:
    """Serialize note events to a format-0 SMF byte string.

    ``bends``: (seconds, channel, signed 14-bit value -8192..8191) wheel
    events; ``controls``: (seconds, channel, controller, value) CC events;
    ``pressures``: (seconds, channel, value 0..127) channel-pressure
    (0xD0 aftertouch) events; ``poly_pressures``: (seconds, channel,
    note, value 0..127) per-note key-pressure (0xA0) events.
    Controller/bend/pressure events at the same tick as a note-on are
    written BEFORE it (they describe the state the note starts in).

    Note ``program`` and ``pan`` fields round-trip: a program change
    (0xC0) / CC10 pan event is emitted before any note-on whose field
    differs from the channel's tracked state (initial state: program 0,
    pan never-sent — files using only those defaults serialize without
    any derived events).  Pan quantizes to the nearest 7-bit CC10 step
    (the 64 + pan*63 inverse of the parser's mapping); because pan/
    program are CHANNEL state, a later pan=None note on a channel that
    already set a pan parses back with that channel pan, exactly like
    any real SMF.  An explicit CC10 entry in ``controls`` disables pan
    derivation on its channel (the caller owns that lane)."""
    us_per_quarter = int(round(60e6 / bpm))
    sec_per_tick = us_per_quarter / 1e6 / division

    notes = list(notes)              # single materialization: the loop
    #                                  below is the only pass, so a
    #                                  one-shot iterator input still
    #                                  serializes every note
    # moments: (tick, order, sub, kind, payload) — offs first (order 0),
    # then explicit controller events (1), then note-ons (2).  A derived
    # program/pan event shares its note-on's order-2 slot with a sub key
    # just below it, so it lands IMMEDIATELY before that on: two
    # same-tick notes with different programs on one channel interleave
    # as prog-a, on-a, prog-b, on-b and both parse back correctly.
    moments: List[tuple] = []
    manual_pan = {c for _, c, cc, _ in controls if cc == 10}
    prog_state = [0] * 16
    pan_state: List[Optional[int]] = [None] * 16
    for i, n in enumerate(sorted(notes, key=lambda m: m.start)):
        t0 = int(round(n.start / sec_per_tick))
        t1 = int(round((n.start + n.duration) / sec_per_tick))
        ch = n.channel & 0x0F
        prog = n.program & 0x7F
        if prog != prog_state[ch]:
            prog_state[ch] = prog
            moments.append((t0, 2, 2 * i, "prog", (ch, prog)))
        if n.pan is not None and ch not in manual_pan:
            cc = max(0, min(127, int(round(64 + n.pan * 63))))
            if cc != pan_state[ch]:
                pan_state[ch] = cc
                moments.append((t0, 2, 2 * i, "cc", (ch, 10, cc)))
        moments.append((t0, 2, 2 * i + 1, "on", n))
        moments.append((max(t1, t0 + 1), 0, 0, "off", n))
    for sec, ch, value in bends:
        moments.append((int(round(sec / sec_per_tick)), 1, 0, "bend",
                        (ch, value)))
    for sec, ch, cc, value in controls:
        moments.append((int(round(sec / sec_per_tick)), 1, 0, "cc",
                        (ch, cc, value)))
    for sec, ch, value in pressures:
        moments.append((int(round(sec / sec_per_tick)), 1, 0, "press",
                        (ch, value)))
    for sec, ch, note, value in poly_pressures:
        moments.append((int(round(sec / sec_per_tick)), 1, 0, "ppress",
                        (ch, note, value)))
    moments.sort(key=lambda m: (m[0], m[1], m[2]))

    track = io.BytesIO()
    track.write(_vlq(0) + bytes([0xFF, 0x51, 0x03]) +
                us_per_quarter.to_bytes(3, "big"))
    last = 0
    for tick, _, _, kind, payload in moments:
        track.write(_vlq(tick - last))
        last = tick
        if kind in ("on", "off"):
            n = payload
            status = (0x90 if kind == "on" else 0x80) | (n.channel & 0x0F)
            vel = n.velocity if kind == "on" else 0
            track.write(bytes([status, n.note & 0x7F, vel & 0x7F]))
        elif kind == "bend":
            ch, value = payload
            u = (int(value) + 8192) & 0x3FFF
            track.write(bytes([0xE0 | (ch & 0x0F), u & 0x7F, (u >> 7) & 0x7F]))
        elif kind == "press":
            ch, value = payload
            track.write(bytes([0xD0 | (ch & 0x0F), value & 0x7F]))
        elif kind == "ppress":
            ch, note, value = payload
            track.write(bytes([0xA0 | (ch & 0x0F), note & 0x7F,
                               value & 0x7F]))
        elif kind == "prog":
            ch, prog = payload
            track.write(bytes([0xC0 | (ch & 0x0F), prog & 0x7F]))
        else:
            ch, cc, value = payload
            track.write(bytes([0xB0 | (ch & 0x0F), cc & 0x7F, value & 0x7F]))
    track.write(_vlq(0) + bytes([0xFF, 0x2F, 0x00]))
    tdata = track.getvalue()
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, division)
            + b"MTrk" + struct.pack(">I", len(tdata)) + tdata)


def gm_file(nnotes: int, duration: float, seed) -> bytes:
    """``gm_events`` as SMF bytes."""
    notes, bends, controls, pressures, poly = gm_events(nnotes, duration,
                                                        seed)
    return write_midi(notes, bends=bends, controls=controls,
                      pressures=pressures, poly_pressures=poly)
