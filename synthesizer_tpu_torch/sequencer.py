"""Song sequencer (port of ``synthesizer_tpu.sequencer``), so far only the
synth instrument definition that ``midi`` maps General-MIDI programs onto.
``Song``, the schedule compile and the mixdowns come with the sequencer
slice of the port (ROADMAP queue 1 item 9)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SynthDef:
    """A synth instrument definition (the [synth.NAME] ini section)."""
    wave: str = "sawtooth_bl"
    amplitude: float = 0.4
    attack: float = 0.01
    decay: float = 0.05
    sustain_level: float = 0.7
    release: float = 0.1
    pan: float = 0.0
    fm_frequency: float = 0.0
    fm_depth: float = 0.0
    pulse_width: float = 0.5
    harmonics: tuple = ()
    table: tuple = ()            # wave="wavetable": one cycle of samples
    damping: float = 1.0         # wave="pluck": loop-loss exponent scale
    seed: int = 0                # wave="pluck"/"white_noise" excitation
    glide: float = 0.0           # portamento seconds: each note slides
    #                              from the track's PREVIOUS note's pitch
