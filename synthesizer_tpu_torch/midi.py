"""Standard MIDI File import: .mid -> voice events -> batched bank render
(port of ``synthesizer_tpu.midi``).

Parse SMF format 0/1 files (tempo map, note on/off, running status),
convert notes to :class:`~synthesizer_tpu_torch.models.voicebank.Voice`
events, and render the whole file in one batched bank render on the card:
by default the sparse render (``VoiceBank.sparse_plan``), which launches
the Hopper render kernel once with per-chunk rows of the voices that may
sound.  A minimal writer is included for tests and for exporting songs.
The GM tables, ``midi_to_voices`` and the writer are the reference's pure
Python, copied so the same bytes give equal results; the parser keeps the
sounding notes per channel and gives the reference's notes, field for
field, in the same order.

    smp = render_midi("song.mid")                 # int16 Sample on the card
    smp = render_midi("song.mid", instruments={0: SynthDef(wave="sine")})

``render_midi`` and ``render_notes`` return a 16-bit stereo ``Sample`` on
``device``; a file with no notes gives an empty one.  With ``mesh=`` (a
``parallel.mesh.VoiceMesh``) the voices shard over the mesh's devices.

Controllers honored: CC64 sustain pedal (note-offs while the pedal is
down are deferred to the pedal release — the gap that audibly truncates
piano files), CC7 channel volume / CC11 expression (continuous: mid-note
changes become per-voice amplitude-curve segments scaling
(vol/127)*(expr/127); a channel with no mid-note changes keeps the
note-on-sampled factor, bit-identical to the curve-free renderer), CC10
pan (sampled at note-on, mapped to the voice's constant-power pan), and
pitch bend (0xE0, CONTINUOUS: mid-note wheel events become piecewise
exact integer-DDS chirp segments — the portamento closed form per
segment, linearly ramping the frequency between events and holding after
the last, so a bend sweep renders as a sweep, not stairs; the bend RANGE
honors RPN 0,0 — CC101/100 select, CC6/CC38 set semitones+cents, a
CC98/99 NRPN select nulls the RPN — with the GM default of ±2
semitones, evaluated at each event's time), CC1 mod-wheel vibrato
(CONTINUOUS: the wheel curve becomes a TIME-VARYING FM depth on the
voice — a sinusoidal LFO at ``VIBRATO_RATE_HZ`` whose depth ramps
linearly between wheel events, rendered by the bank's per-segment
weighted-trig-sum closed form (``fm_depth_curve``); full wheel =
``VIBRATO_SEMITONES`` of peak deviation; a wheel that never moves
mid-note maps to the constant ``fm_depth`` path, and instruments that
define their own FM (``fm_depth`` != 0) keep it — their CC1 is ignored
rather than silently replacing the patch's modulator), channel
pressure / aftertouch (0xD0, GM-style: pressure deepens the vibrato
through the SAME CC1 depth-curve machinery; when both the wheel and
pressure move, the stronger one wins — a max merge — and a
pressure-free file records nothing, staying bit-identical), and POLY
aftertouch (0xA0, per-NOTE pressure: only the keyed note's vibrato-depth
curve moves — other notes on the channel are untouched — merged with the
channel-wide CC1/0xD0 by the same max rule, reset at each note-on).

Bend/CC events keep reaching a note through its whole release tail: the
grace window after note-off is DERIVED from the instruments' actual ADSR
releases (``release_grace_for`` — the ``_RELEASE_GRACE`` floor extended
past the longest release in play), so a wheel sweep through a
long-release pad's tail renders to its end.

Limitations (deliberate, documented): notes map to the bank's gate-ADSR
voices (no per-note velocity curves beyond linear amplitude), callers
that run ``parse_midi`` themselves get the ``_RELEASE_GRACE`` default
unless they pass the derived grace, a percussion-channel (10) bend
keeps note-on sampling (its drum pitches are synthetic, not
note-derived), CC1/pressure/poly-aftertouch vibrato is ignored on
percussion and on instruments with their own FM, and a retriggered note
(note-on while the same note is already sounding on the channel)
replaces the open note rather than layering.
"""

from __future__ import annotations

import io
import struct
from collections import deque
from operator import itemgetter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from .models.voicebank import (Voice, VoiceBank, _device, audible_ranges,
                               pack_voices)
from .sample import Sample
from .sequencer import SynthDef
from .utils import profiling
from . import params

__all__ = ["MidiNote", "parse_midi", "midi_to_voices", "render_midi",
           "render_notes", "release_grace_for", "write_midi"]

_A4_KEY = 69  # MIDI note number of A4

#: how long after its note-off a note still receives bend/controller
#: events (the release tail keeps sounding; see parse_midi._record).
#: This is the FLOOR: :func:`release_grace_for` extends it past any
#: instrument whose ADSR release outlasts it, so long-release pads keep
#: receiving bend/wheel through their whole tail (render_midi threads
#: the derived value into parse_midi automatically).
_RELEASE_GRACE = 2.0

#: margin added past the longest instrument release when deriving the
#: grace (events an epsilon after envelope-zero still belong to the tail)
_RELEASE_GRACE_MARGIN = 0.25


class MidiNote(NamedTuple):
    start: float        # seconds
    duration: float     # seconds
    note: int           # MIDI note number
    velocity: int       # 1..127
    channel: int        # 0..15
    program: int = 0    # GM program active at note-on
    volume: float = 1.0         # (CC7/127)*(CC11/127) at note-on
    pan: Optional[float] = None  # CC10 at note-on mapped to [-1, 1];
    #                              None = channel never sent CC10
    bend: float = 0.0           # pitch bend at note-on, in semitones
    # mid-note wheel/controller curves: ((t_rel_seconds, value), ...)
    # starting with the note-on value at t=0; None = no mid-note events
    # (the scalar fields above fully describe the note — bit-identical
    # to the pre-curve renderer)
    bend_curve: Optional[Tuple[Tuple[float, float], ...]] = None  # semitones
    gain_curve: Optional[Tuple[Tuple[float, float], ...]] = None  # abs gain
    mod: float = 0.0            # CC1/127 mod wheel at note-on
    mod_curve: Optional[Tuple[Tuple[float, float], ...]] = None  # CC1/127


def note_to_freq(note: int, a4: float = 440.0) -> float:
    return a4 * 2.0 ** ((note - _A4_KEY) / 12.0)


def _read_vlq(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


#: event kinds of a decoded track, dispatched on in ``parse_midi``
_TEMPO, _PROGRAM, _CC, _BEND, _PRESS, _PPRESS, _ON, _OFF = range(8)

#: channel-message status nibble -> kind (note on with velocity 0 is an off)
_KINDS = {0x80: _OFF, 0x90: _ON, 0xA0: _PPRESS, 0xB0: _CC, 0xC0: _PROGRAM,
          0xD0: _PRESS, 0xE0: _BEND}


def _parse_track(data: bytes) -> List[tuple]:
    """One track's events as ``(order, kind, channel, a, b)`` tuples.

    ``order`` is twice the tick, plus one for every kind but a tempo
    change, so a stable sort on it puts each tick's tempo changes first
    and keeps file and track order otherwise.  ``a``: note, tempo (µs
    per quarter), program, controller or pressure; ``b``: velocity,
    controller or poly-pressure value, or the signed 14-bit bend.
    """
    events: List[tuple] = []
    append = events.append
    end = len(data)
    pos = 0
    tick = 0
    status = 0
    while pos < end:
        b = data[pos]                              # delta time (VLQ)
        pos += 1
        delta = b & 0x7F
        while b & 0x80:
            b = data[pos]
            pos += 1
            delta = (delta << 7) | (b & 0x7F)
        tick += delta
        b0 = data[pos]
        if b0 == 0xFF:                             # meta (cancels running status)
            status = 0
            meta = data[pos + 1]
            length, p2 = _read_vlq(data, pos + 2)
            body = data[p2:p2 + length]
            pos = p2 + length
            if meta == 0x51 and length == 3:
                tempo = (body[0] << 16) | (body[1] << 8) | body[2]
                append((tick << 1, _TEMPO, 0, tempo, 0))
            elif meta == 0x2F:                     # end of track
                break
            continue
        if b0 == 0xF0 or b0 == 0xF7:               # sysex (cancels running status)
            status = 0
            length, p2 = _read_vlq(data, pos + 1)
            pos = p2 + length
            continue
        if b0 & 0x80:
            status = b0
            pos += 1
        elif not status & 0x80:                    # SMF spec: meta/sysex end
            raise ValueError(                      # any running-status run
                f"data byte 0x{b0:02x} at offset {pos} with no running status")
        kind = _KINDS.get(status & 0xF0)
        if kind is None:
            raise ValueError(f"unexpected MIDI byte 0x{status:02x}")
        a = data[pos]
        if kind == _PROGRAM or kind == _PRESS:     # one data byte
            pos += 1
            append((tick << 1 | 1, kind, status & 0x0F, a, 0))
            continue
        b = data[pos + 1]
        pos += 2
        if kind == _BEND:                          # pitch bend (14-bit)
            append((tick << 1 | 1, kind, status & 0x0F, 0,
                    (a | (b << 7)) - 8192))
        else:
            if kind == _ON and not b:
                kind = _OFF
            append((tick << 1 | 1, kind, status & 0x0F, a, b))
    return events


def release_grace_for(
        instruments: Optional[Dict[int, "SynthDef"]] = None) -> float:
    """The bend/controller grace window for a render with these
    instruments: the ``_RELEASE_GRACE`` floor, extended past the longest
    ADSR release any note could get (user instruments, every GM family
    mapping, the default, and the percussion defs) plus a small margin —
    so a 4 s-release pad's tail follows a post-off wheel sweep to its
    end, while default-GM files (all releases <= 0.4 s) keep the exact
    pre-derivation grace (bit-identical curves)."""
    releases = [sd.release for sd in (instruments or {}).values()]
    releases += [sd.release for _, sd in _GM_FAMILIES]
    releases += [_DEFAULT_DEF.release, _PERC_DEF.release, _KICK_DEF.release]
    return max(_RELEASE_GRACE, max(releases) + _RELEASE_GRACE_MARGIN)


@profiling.spanned("midi.parse_midi")
def parse_midi(source: Union[str, bytes],
               release_grace: float = _RELEASE_GRACE) -> List[MidiNote]:
    """Parse an SMF file (path or bytes) into note events in seconds.

    ``release_grace``: how long after its note-off a note keeps
    receiving bend/controller events (its release tail keeps sounding).
    :func:`render_midi` derives this from the instruments' actual ADSR
    releases via :func:`release_grace_for`; callers that parse
    separately and render long-release instruments should do the same.
    """
    data = open(source, "rb").read() if isinstance(source, str) else source
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    hlen, fmt, ntrks, division = struct.unpack(">IHHH", data[4:14])
    smpte_sec_per_tick = 0.0
    if division & 0x8000:
        # SMPTE division (SMF spec): high byte = negative two's-complement
        # frames/second (-24, -25, -29 meaning 29.97 drop-frame, -30),
        # low byte = ticks/frame.  Timing is absolute — tempo meta events
        # do NOT rescale it.
        fps = 256 - (division >> 8)
        tpf = division & 0xFF
        if fps not in (24, 25, 29, 30) or tpf == 0:
            raise ValueError(f"bad SMPTE division 0x{division:04x}")
        # -29 is 29.97 drop-frame; use the exact NTSC rate 30000/1001
        # (= 29.97002997...) rather than the spec's "(29.97)" literal —
        # the literal drifts ~1 ppm (~1 ms per 1000 s of file)
        rate = 30000.0 / 1001.0 if fps == 29 else float(fps)
        smpte_sec_per_tick = 1.0 / (rate * tpf)
    pos = 8 + hlen
    events: List[tuple] = []
    for _ in range(ntrks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError("bad track header")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        events += _parse_track(data[pos + 8:pos + 8 + tlen])
        pos += 8 + tlen
    events.sort(key=itemgetter(0))

    # tick -> seconds with the tempo map (default 120 bpm).  The notes
    # are kept per channel, so an event costs time in proportion to the
    # notes sounding on its own channel.  A note is one list, [t0, vel,
    # prog, volume, pan, bend, mod, bend curve, gain curve, mod curve,
    # channel, key, t_off]: a curve is None until its first point, t_off
    # None until the note closes
    #: per channel: key -> the open note
    open_notes: List[Dict[int, list]] = [{} for _ in range(16)]
    #: notes whose note-off arrived while CC64 was down: they keep
    #: sounding until the pedal releases (the GM sustain rule).  Per
    #: channel, and in ``sustained`` over all channels in the order the
    #: end of the file closes them
    held: List[Dict[int, list]] = [{} for _ in range(16)]
    sustained: Dict[Tuple[int, int], list] = {}
    programs = [0] * 16
    # neutral defaults (a file that never sends CC7/CC11 renders exactly
    # as before CC support); files that DO send them get the relative
    # channel balance they encode
    cc7 = [127] * 16            # channel volume
    cc11 = [127] * 16           # expression
    cc10: List[Optional[int]] = [None] * 16   # pan (None = never sent)
    cc1 = [0] * 16              # mod wheel (vibrato)
    press = [0] * 16            # channel pressure (GM: vibrato, like CC1)
    #: per channel: note -> (poly aftertouch (0xA0) value, event seconds):
    #: per-NOTE pressure, merged into that note's vibrato depth alongside
    #: the channel-wide CC1/pressure.  Reset at note-on — a new note
    #: instance starts pressure-free — EXCEPT a pressure event at the
    #: note-on's own moment: write_midi orders same-tick controllers
    #: before the on ("the state the note starts in"), so only STRICTLY
    #: OLDER stored values are stale (the event time disambiguates)
    ppress: List[Dict[int, Tuple[int, float]]] = [{} for _ in range(16)]
    pedal = [False] * 16
    bend14 = [0] * 16           # signed 14-bit wheel position (-8192..8191)
    # RPN 0,0 (pitch-bend sensitivity): GM default ±2 semitones; CC6/CC38
    # are semitones/cents, honored only while RPN 0,0 is selected
    rpn = [(0x7F, 0x7F)] * 16   # selected RPN (127,127 = null)
    range_msb = [2] * 16
    range_lsb = [0] * 16
    sec = 0.0
    last_tick = 0
    us_per_quarter = 500_000

    # notes whose note-off has passed but whose release tail may still be
    # sounding: controller/bend events within ``release_grace`` seconds
    # of the off keep appending to their curves (the wheel bends whatever
    # rings — a GM synth bends release tails too); render_midi derives
    # the grace from the instruments' actual ADSR releases
    # (release_grace_for), and points past envelope-zero are
    # acoustically inert.  Notes close at the current time, which only
    # grows, so each channel's queue is in order of expiry
    ringing = [deque() for _ in range(16)]
    #: every closed note, in the order it closed: the notes' order before
    #: their stable sort by start
    closed: List[list] = []

    def _close(nt):
        nt[12] = sec
        ringing[nt[10]].append(nt)
        closed.append(nt)

    def _close_all(found):
        # close every note of ``found`` now, in the order it holds them
        for nt in found.values():
            _close(nt)
        found.clear()

    def _close_held(ch):
        # close every note the channel's pedal holds
        for key in held[ch]:
            del sustained[ch, key]
        _close_all(held[ch])

    def _depth(ch, key):
        # a note's vibrato depth merges the channel-wide wheel (CC1) and
        # pressure (0xD0) with its OWN poly aftertouch (0xA0): all three
        # are depth controllers, the strongest one wins (max preserves
        # whichever is driving)
        return max(cc1[ch], press[ch],
                   ppress[ch].get(key, (0, 0.0))[0]) / 127.0

    def _record(ch, idx, base_idx, val, only=None):
        # append (now, val) to curve ``idx`` of every note the channel's
        # wheel/controllers reach RIGHT NOW (of note ``only`` alone where
        # given; ``val`` None: each note's vibrato depth): open,
        # pedal-held, and recently-released (ringing) ones
        if val is None and not ppress[ch]:     # one depth for every note
            val = max(cc1[ch], press[ch]) / 127.0
        for nt in (*open_notes[ch].values(), *held[ch].values()):
            if only is None or nt[11] == only:
                point = (sec - nt[0],
                         _depth(ch, nt[11]) if val is None else val)
                if nt[idx] is None:
                    nt[idx] = [point]
                else:
                    nt[idx].append(point)
        # expired ringing notes leave the head of the channel's queue
        # (they wait in ``closed``)
        ring = ringing[ch]
        while ring and not sec < ring[0][12] + release_grace:
            ring.popleft()
        for nt in ring:
            if only is not None and nt[11] != only:
                continue
            lst = nt[idx]
            if lst is None:
                lst = nt[idx] = []
            trel = sec - nt[0]
            # a RINGING note's first post-off event first anchors the
            # curve at the off time with the last in-note value:
            # curve points are samples of continuous wheel motion and
            # ramp linearly between, so without the anchor a
            # recenter-at-note-off (ubiquitous in real files) would
            # retro-sweep the WHOLE note instead of just the release
            # tail
            anchor = nt[12] - nt[0]
            if not lst or lst[-1][0] < anchor:
                lst.append((anchor, lst[-1][1] if lst else nt[base_idx]))
            if trel <= anchor:
                trel = anchor + 1e-3   # off-tick event: 1 ms into the tail
            lst.append((trel, _depth(ch, nt[11]) if val is None else val))

    for order, kind, ch, a, b in events:
        tick = order >> 1
        if smpte_sec_per_tick:
            sec += (tick - last_tick) * smpte_sec_per_tick
        else:
            sec += (tick - last_tick) * us_per_quarter / 1e6 / division
        last_tick = tick
        if kind == _CC:
            if a == 64:                            # sustain pedal
                down = b >= 64
                if pedal[ch] and not down:
                    # release: close every note held only by the pedal
                    _close_held(ch)
                pedal[ch] = down
            elif a in (7, 11):
                (cc7 if a == 7 else cc11)[ch] = b
                _record(ch, 8, 3, (cc7[ch] / 127.0) * (cc11[ch] / 127.0))
            elif a == 1:                           # mod wheel (vibrato)
                cc1[ch] = b
                _record(ch, 9, 6, None)
            elif a == 10:
                cc10[ch] = b
            elif a == 101:                         # RPN select MSB
                rpn[ch] = (b, rpn[ch][1])
            elif a == 100:                         # RPN select LSB
                rpn[ch] = (rpn[ch][0], b)
            elif a in (98, 99):                    # NRPN select: null the RPN
                # so a later CC6/CC38 data entry addressed at the NRPN is
                # not misread as a bend-range change (GS/XG files select
                # RPN 0,0, then edit drum NRPNs with the same data CCs)
                rpn[ch] = (0x7F, 0x7F)
            elif a == 6 and rpn[ch] == (0, 0):     # bend range semitones
                range_msb[ch] = b
            elif a == 38 and rpn[ch] == (0, 0):    # bend range cents
                range_lsb[ch] = b
            elif a in (120, 123):                  # all sound/notes off
                _close_all(open_notes[ch])
                _close_held(ch)
                pedal[ch] = False
        elif kind == _BEND:
            bend14[ch] = b
            # mid-note wheel movement: record on every sounding note of
            # the channel (pedal-sustained ones too — the wheel bends
            # whatever rings), with the RPN bend range in effect NOW
            semis_now = (range_msb[ch] + range_lsb[ch] / 100.0)
            _record(ch, 7, 5, b / 8192.0 * semis_now)
        elif kind == _ON:
            nt = held[ch].pop(a, None)
            if nt is not None:                     # pedal retrigger
                del sustained[ch, a]
                _close(nt)
            # a new note instance starts poly-pressure-free (0xA0 events
            # describe THIS key press, not the next one) — but keep a
            # pressure event from this very moment: same-tick controllers
            # precede the on and describe the state the note starts in
            pp = ppress[ch].get(a)
            if pp is not None and pp[1] < sec:
                del ppress[ch][a]
            pan = cc10[ch]
            notes_pan = None if pan is None \
                else max(-1.0, min(1.0, (pan - 64) / 63.0))
            vol = (cc7[ch] / 127.0) * (cc11[ch] / 127.0)
            semis = range_msb[ch] + range_lsb[ch] / 100.0
            bend = bend14[ch] / 8192.0 * semis
            open_notes[ch][a] = [sec, b, programs[ch], vol, notes_pan, bend,
                                 _depth(ch, a), None, None, None, ch, a, None]
        elif kind == _OFF:
            nt = open_notes[ch].pop(a, None)
            if nt is not None:
                if pedal[ch]:                      # ring until pedal up
                    held[ch][a] = sustained[ch, a] = nt
                else:
                    _close(nt)
        elif kind == _PRESS:                       # channel pressure (0xD0)
            press[ch] = a
            # GM-style: pressure deepens the vibrato exactly like CC1
            # (same curve machinery, same depth mapping), merged with the
            # wheel and poly pressure by max — a pressure-free file
            # records nothing here and stays bit-identical
            _record(ch, 9, 6, None)
        elif kind == _PPRESS:                      # poly aftertouch (0xA0)
            ppress[ch][a] = (b, sec)
            # per-NOTE pressure: only the keyed note's depth curve moves
            # (open, pedal-held, or still ringing); other notes on the
            # channel are untouched
            _record(ch, 9, 6, None, only=a)
        elif kind == _PROGRAM:
            programs[ch] = a
        else:                                      # tempo
            us_per_quarter = a
    # a pedal still down at end of file: close what it was holding
    for nt in sustained.values():
        _close(nt)
    notes = [MidiNote(
        t0, max(t1 - t0, 1e-3), note, vel, ch, prog, vol, pan, bend,
        tuple([(0.0, bend)] + bcurve) if bcurve else None,
        tuple([(0.0, vol)] + gcurve) if gcurve else None,
        mod,
        tuple([(0.0, mod)] + mcurve) if mcurve else None)
        for (t0, vel, prog, vol, pan, bend, mod, bcurve, gcurve, mcurve, ch,
             note, t1) in closed]
    notes.sort(key=lambda n: n.start)
    return notes


_DEFAULT_DEF = SynthDef(wave="sawtooth_bl", amplitude=0.3, attack=0.005,
                        decay=0.05, sustain_level=0.7, release=0.15)

#: CC1 mod-wheel vibrato: LFO rate and the peak pitch deviation at a
#: fully-raised wheel (CC1 = 127).  The deviation maps to the bank's FM
#: depth as the frequency RATIO excursion 2^(semis/12) - 1, so the
#: rendered vibrato peaks exactly VIBRATO_SEMITONES sharp.
VIBRATO_RATE_HZ = 5.5
VIBRATO_SEMITONES = 0.5

#: coarse General-MIDI program-family mapping onto bank waveforms
_GM_FAMILIES = (
    (0, SynthDef(wave="harmonics", amplitude=0.35, attack=0.003, decay=0.4,
                 sustain_level=0.25, release=0.25,
                 harmonics=(1.0, 0.45, 0.22, 0.1, 0.05))),   # pianos
    (16, SynthDef(wave="harmonics", amplitude=0.3, attack=0.01, decay=0.1,
                  sustain_level=0.8, release=0.1,
                  harmonics=(1.0, 0.6, 0.0, 0.4, 0.0, 0.25))),  # organs
    (24, SynthDef(wave="harmonics", amplitude=0.32, attack=0.003, decay=0.5,
                  sustain_level=0.15, release=0.2,
                  harmonics=(1.0, 0.5, 0.25, 0.12))),        # guitars
    (32, SynthDef(wave="sine", amplitude=0.4, attack=0.004, decay=0.15,
                  sustain_level=0.6, release=0.1)),          # basses
    (40, SynthDef(wave="sawtooth_bl", amplitude=0.28, attack=0.05, decay=0.1,
                  sustain_level=0.8, release=0.2)),          # strings
    (56, SynthDef(wave="square_bl", amplitude=0.28, attack=0.02, decay=0.05,
                  sustain_level=0.8, release=0.1)),          # brass
    (80, SynthDef(wave="square_bl", amplitude=0.3, attack=0.01, decay=0.05,
                  sustain_level=0.75, release=0.12)),        # synth leads
    (88, SynthDef(wave="sawtooth_bl", amplitude=0.25, attack=0.1, decay=0.2,
                  sustain_level=0.8, release=0.4)),          # pads
)

#: channel 10 (index 9) percussion: key -> short noise/sine hits
_PERC_DEF = SynthDef(wave="white_noise", amplitude=0.3, attack=0.001,
                     decay=0.05, sustain_level=0.0, release=0.05)
_KICK_DEF = SynthDef(wave="sine", amplitude=0.5, attack=0.001, decay=0.12,
                     sustain_level=0.0, release=0.05)


def _gm_instrument(program: int) -> SynthDef:
    best = _DEFAULT_DEF
    for lo, sd in _GM_FAMILIES:
        if program >= lo:
            best = sd
    return best


@profiling.spanned("midi.to_voices")
def midi_to_voices(notes: Sequence[MidiNote],
                   instruments: Optional[Dict[int, SynthDef]] = None,
                   a4: float = 440.0,
                   vibrato_rate: float = VIBRATO_RATE_HZ,
                   vibrato_semitones: float = VIBRATO_SEMITONES) -> List[Voice]:
    """Note events -> bank voices; velocity scales amplitude linearly.

    ``vibrato_rate``/``vibrato_semitones`` set the CC1 mod-wheel vibrato
    LFO (rate in Hz, peak deviation at a full wheel); an instrument's own
    ``fm_frequency`` (with ``fm_depth`` 0) overrides the rate.
    """
    instruments = instruments or {}
    voices = []
    for n in notes:
        if n.channel in instruments:
            sd = instruments[n.channel]
        elif n.channel == 9:                       # GM percussion channel
            sd = _KICK_DEF if n.note in (35, 36) else _PERC_DEF
        else:
            sd = _gm_instrument(n.program)
        percussion = n.channel == 9 and n.channel not in instruments
        pitch_curve: tuple = ()
        amp_curve: tuple = ()
        if percussion:
            freq = 60.0 if n.note in (35, 36) else 180.0 + 40.0 * (n.note % 12)
        elif n.bend_curve is not None:
            # continuous bend: the curve carries the absolute wheel value
            # (semitones, note-on value at t=0) — the voice's base
            # frequency stays the unbent note and each point becomes a
            # frequency ratio (exact chirp segments in the bank)
            freq = note_to_freq(n.note, a4)
            pitch_curve = tuple((t, 2.0 ** (s / 12.0)) for t, s in n.bend_curve)
        else:
            freq = note_to_freq(n.note, a4) * 2.0 ** (n.bend / 12.0)
        if n.gain_curve is not None and not percussion:
            # continuous CC7/CC11: absolute gains in the curve, so the
            # note-on factor moves OUT of the scalar amplitude
            amp_curve = tuple(n.gain_curve)
            vol_factor = 1.0
        else:
            vol_factor = n.volume
        # CC1 mod-wheel vibrato -> FM depth (never on percussion; never on
        # instruments that define their own FM — CC1 would silently
        # replace the patch's modulator)
        fm_frequency, fm_depth = sd.fm_frequency, sd.fm_depth
        depth_curve: tuple = ()
        if not percussion and sd.fm_depth == 0.0:
            unit = 2.0 ** (vibrato_semitones / 12.0) - 1.0
            rate = sd.fm_frequency if sd.fm_frequency > 0.0 else vibrato_rate
            if n.mod_curve is not None and \
                    len({v for _, v in n.mod_curve}) > 1:
                fm_frequency = rate
                depth_curve = tuple((t, v * unit) for t, v in n.mod_curve)
            else:
                static = (n.mod_curve[0][1] if n.mod_curve is not None
                          else n.mod)
                if static > 0.0:
                    fm_frequency = rate
                    fm_depth = static * unit
        voices.append(Voice(
            wave=sd.wave,
            frequency=freq,
            seed=n.note,
            amplitude=sd.amplitude * (n.velocity / 127.0) * vol_factor,
            pan=sd.pan if n.pan is None else n.pan,
            start=n.start,
            duration=n.duration,
            attack=sd.attack, decay=sd.decay,
            sustain_level=sd.sustain_level, release=sd.release,
            fm_frequency=fm_frequency, fm_depth=fm_depth,
            pulse_width=sd.pulse_width,
            harmonics=sd.harmonics,
            table=sd.table,
            pitch_curve=pitch_curve,
            amp_curve=amp_curve,
            fm_depth_curve=depth_curve,
        ))
    return voices


@profiling.spanned("midi.render_midi")
def render_midi(source: Union[str, bytes],
                instruments: Optional[Dict[int, SynthDef]] = None,
                samplerate: int = 0, tail_seconds: float = 0.3,
                mesh=None, sparse: bool = True,
                device="cuda") -> Sample:
    """Render a MIDI file (path or bytes) in one batched bank render -> a
    16-bit stereo ``Sample`` on ``device`` (the card unless the caller
    passes ``device="cpu"``).  The bend/controller grace follows the
    instruments' releases (:func:`release_grace_for`)."""
    return render_notes(
        parse_midi(source, release_grace=release_grace_for(instruments)),
        instruments, samplerate, tail_seconds, mesh=mesh, sparse=sparse,
        device=device)


def song_frames(voices: Sequence[Voice], samplerate: int,
                tail_seconds: float = 0.3) -> int:
    """Frames ``render_notes`` renders: to the end of the last envelope,
    plus the tail."""
    return max(int((v.start + v.attack + v.decay
                    + max(v.duration - v.attack - v.decay, 0.0)
                    + v.release) * samplerate) + 1
               for v in voices) + int(tail_seconds * samplerate)


def note_ranges(voices: Sequence[Voice], nrows: int, samplerate: int):
    """The sparse plan's (starts, ends, live) host arrays for these voices,
    packed unsorted into ``nrows`` rows (pad rows never live), from the
    note list instead of device copies: one frame of margin on the attack
    and decay and on the release, as the reference takes."""
    starts = np.zeros(nrows, np.int64)
    ends = np.zeros(nrows, np.int64)
    live = np.zeros(nrows, bool)
    n = len(voices)
    starts[:n], ends[:n] = audible_ranges(
        [int(v.start * samplerate) for v in voices],
        [int(v.duration * samplerate) for v in voices],
        [v.attack for v in voices], [v.decay for v in voices],
        [v.release for v in voices], samplerate, margin=1)
    live[:n] = [v.amplitude != 0.0 or v.bias != 0.0 for v in voices]
    return starts, ends, live


@profiling.spanned("midi.render_notes")
def render_notes(notes: Sequence[MidiNote],
                 instruments: Optional[Dict[int, SynthDef]] = None,
                 samplerate: int = 0, tail_seconds: float = 0.3,
                 mesh=None, sparse: bool = True,
                 device="cuda") -> Sample:
    """Render pre-parsed note events -> a 16-bit stereo ``Sample`` on
    ``device``.

    ``sparse`` (default True): long sparse files render over per-chunk
    active-voice rows (``VoiceBank.sparse_plan``, bit-identical to the
    flat render); the plan's ranges come from the note list.  Dense or
    short files keep the flat grouped render through the plan's cost
    model; ``sparse=False`` forces it.

    With ``mesh`` (a ``parallel.mesh.VoiceMesh``) the voice axis shards
    over the mesh's devices like ``Song.mix(mesh=)``: each shard renders
    its voices (curves included) in the flat render, never the sparse
    plan, and the f32 partials add in shard order (within 1 LSB of the
    single-device render); the result is moved to ``device``."""
    dev = _device(device)
    sr = samplerate or params.norm_samplerate
    if not notes:
        return Sample.from_torch(
            torch.zeros((0, 2), dtype=torch.int16, device=dev), sr, 2)
    voices = midi_to_voices(notes, instruments)
    total = song_frames(voices, sr, tail_seconds)
    if mesh is not None:
        from .parallel.mesh import render_song_sharded, song_synth_shards
        vp, uw, ufm, ugl, ub, ua, ud = song_synth_shards(
            voices, sr, mesh, num_harmonics=8)
        stereo = render_song_sharded(
            vp, total, sr, chunk_frames=8192, num_harmonics=8, mesh=mesh,
            used_waves=uw, use_fm=ufm, use_glide=ugl, use_bend=ub,
            use_amp=ua, use_dmod=ud)
        return Sample.from_torch(VoiceBank.to_int16(stereo).to(dev), sr, 2,
                                 name="midi")
    if sparse:
        # UNSORTED pack: the rows render ungrouped anyway, and keeping the
        # note order aligned with the vp rows lets the plan's ranges come
        # from the host note list
        vp_flat = pack_voices(voices, sr, num_harmonics=8, device=dev)
        V = int(vp_flat.start.shape[0])           # incl. pad rows
        bank_flat = VoiceBank.for_voices(voices, sr, num_harmonics=8,
                                         nvoices=V, device=dev)
        plan = bank_flat.sparse_plan(vp_flat, total,
                                     ranges=note_ranges(voices, V, sr))
        if plan is not None:
            fn, idx, pad_start, nchunks = plan
            stereo = fn(vp_flat, idx, pad_start, nchunks)[:total]
            return Sample.from_torch(VoiceBank.to_int16(stereo), sr, 2,
                                     name="midi")
    vp, layout = pack_voices(voices, sr, num_harmonics=8, sort_by_wave=True,
                             device=dev)
    bank = VoiceBank.for_voices(voices, sr, num_harmonics=8, layout=layout,
                                nvoices=layout.nvoices, device=dev)
    return Sample.from_torch(bank.to_int16(bank.render_song(vp, total)), sr,
                             2, name="midi")


# ---------------------------------------------------------------------------
# Minimal SMF writer (format 0) — for tests and song export
# ---------------------------------------------------------------------------

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
