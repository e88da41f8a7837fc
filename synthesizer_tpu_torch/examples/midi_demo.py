"""MIDI round trip: compose -> write SMF -> parse -> batched render.

The whole MIDI surface in one script:
1. compose note events (three channels: lead, pad, bass),
2. add continuous controllers: a pitch-bend slide, a mod-wheel (CC1)
   vibrato swell, an expression (CC11) fade, a channel-pressure swell and
   one poly-aftertouch push on a single chord note,
3. write a format-0 SMF with ``write_midi`` (same-tick controllers go
   before their note-on: the state the note starts in),
4. parse it back and render every voice in one batched VoiceBank render
   (``render_notes``; pass ``mesh=`` to shard the voices over devices).

    python -m synthesizer_tpu_torch.examples.midi_demo [outdir] [--device cpu]
"""

import os

from synthesizer_tpu_torch.examples._cli import parse
from synthesizer_tpu_torch.midi import (MidiNote, SynthDef, parse_midi,
                                        render_notes, write_midi)

SR = 44100


def compose():
    """An 8-second three-channel phrase.  Times in seconds, 120 bpm."""
    notes = []
    # channel 0, lead: an arpeggio, the last note held and bent up a tone
    lead = [(0.0, 69), (0.5, 72), (1.0, 76), (1.5, 81)]
    for t, n in lead[:-1]:
        notes.append(MidiNote(t, 0.45, n, 100, channel=0))
    notes.append(MidiNote(1.5, 3.0, 81, 110, channel=0))
    # channel 1, pad: a soft chord under the whole phrase
    for n in (57, 60, 64):
        notes.append(MidiNote(0.0, 6.0, n, 70, channel=1, pan=-0.3))
    # channel 2, bass: root notes on the half notes
    for i, n in enumerate((45, 45, 40, 45)):
        notes.append(MidiNote(i * 1.0, 0.9, n, 90, channel=2))

    bends = [(2.0 + 0.05 * i, 0, int(8191 * i / 20)) for i in range(21)]
    controls = (
        # CC1 mod wheel: vibrato swells in over the held lead note
        [(2.5 + 0.1 * i, 0, 1, int(127 * i / 15)) for i in range(16)]
        # CC11 expression: the pad fades out over its last two seconds
        + [(4.0 + 0.1 * i, 1, 11, 127 - int(110 * i / 20))
           for i in range(21)])
    # channel pressure: leaning into the bass on beat 3
    pressures = [(2.0 + 0.05 * i, 2, int(100 * i / 10)) for i in range(11)] \
        + [(2.55 + 0.05 * i, 2, 100 - int(100 * i / 10)) for i in range(11)]
    # poly aftertouch: push only the chord's middle note, on its note-on
    # tick (the state the note starts in)
    poly = [(0.0, 1, 60, 90), (3.0, 1, 60, 0)]
    return notes, bends, controls, pressures, poly


def main(argv=None) -> None:
    args = parse(__doc__, argv, ".", "directory for demo.mid and the WAV")
    outdir = args.out
    os.makedirs(outdir, exist_ok=True)

    notes, bends, controls, pressures, poly = compose()
    smf = write_midi(notes, bpm=120.0, bends=bends, controls=controls,
                     pressures=pressures, poly_pressures=poly)
    midpath = os.path.join(outdir, "demo.mid")
    with open(midpath, "wb") as f:
        f.write(smf)
    print(f"wrote {midpath} ({len(smf)} bytes, {len(notes)} notes, "
          f"{len(bends)} bends, {len(controls)} CCs, "
          f"{len(pressures)} pressures, {len(poly)} poly-aftertouch)")

    instruments = {          # keyed by channel (overrides the GM table)
        0: SynthDef(wave="sawtooth_bl", amplitude=0.30, attack=0.01,
                    decay=0.15, sustain_level=0.7, release=0.4),
        1: SynthDef(wave="harmonics", amplitude=0.22, attack=0.4,
                    decay=0.3, sustain_level=0.8, release=1.2,
                    harmonics=(1.0, 0.35, 0.15)),
        2: SynthDef(wave="triangle", amplitude=0.35, attack=0.005,
                    decay=0.1, sustain_level=0.8, release=0.25),
    }
    parsed = parse_midi(smf)
    curved = sum(1 for n in parsed
                 if n.bend_curve or n.mod_curve or n.gain_curve)
    print(f"parsed back {len(parsed)} notes, {curved} carry controller "
          f"curves")

    sample = render_notes(parsed, instruments, samplerate=SR,
                          device=args.device)
    wavpath = os.path.join(outdir, "midi_demo.wav")
    sample.write_wav(wavpath)
    print(f"rendered {sample.duration:.2f}s -> {wavpath}")


if __name__ == "__main__":
    main()
