"""The demo song of the repository, as text: a frozen copy of
``examples/make_demo_song.py``'s song (trackmixer ``.ini`` pattern format),
and the seeded variants the cells render.

A variant keeps every section and value of the song.  Only two things
change with the seed and the repeat count ``k``:

- the order of the six patterns before the outro (the outro stays last, so
  every order of one ``k`` has the same length and the same content end);
- the pattern list is that order ``k`` times over, and every automation
  breakpoint's tick is multiplied by ``k``, so the arc of the song (the hat
  ride, the reverb and echo swells, the master fade) spans the long form
  instead of ending after the first pass.
"""

from __future__ import annotations

import numpy as np

#: the song text, verbatim
TEXT = """\
; demo song for synthesizer_tpu trackmixer
[song]
bpm = 128
ticks = 4
patterns = intro main main fill main main outro

[paths]
samples = .

[instruments]
kick = kick.wav
snare = snare.wav
hat = hat.wav
openhat = openhat.wav
bass = bass.wav
stab = stab.wav

[synth.lead]
wave = square_bl
amplitude = 0.22
attack = 0.008
decay = 0.04
sustain_level = 0.6
release = 0.09
pan = 0.25

[sampler.pluckgtr]
; tracker-style pitched sample playback (beyond-reference)
file = pluckgtr.wav
base_note = C4

[synth.gtr]
; Karplus-Strong plucked string (beyond-reference physical modeling)
wave = pluck
amplitude = 0.3
damping = 1.4
seed = 4
attack = 0.0
decay = 0.0
sustain_level = 1.0
release = 0.12
pan = -0.35

[synth.sub]
wave = sine
amplitude = 0.35
attack = 0.004
decay = 0.03
sustain_level = 0.8
release = 0.06
pan = -0.1

[fx]
; master bus: gentle glue compression + a small room, a tempo-synced
; slapback, and a safety brickwall (all beyond-reference)
compress = threshold_db=-10 ratio=3 attack=0.004 release=0.12 makeup_db=1.5
reverb = roomsize=0.45 damping=0.6 wet=0.14 dry=0.95 tail=0.6
echo = beats=0.75 feedback=0.25 wet=0.12
limiter = ceiling_db=-0.5 lookahead=0.004

[fx.lead]
; per-synth-track chain: the lead gets its own chorus bus
chorus = rate=1.2 depth=0.002 delay=0.014 wet=0.35

[automation]
; hats ride up across the song; the whole mix fades over the outro
track.hat.volume = 0:0.6 48:1.0
fx.reverb.wet = 0:0.10 64:0.22
fx.echo.wet = 0:0.06 64:0.16
master.volume = 0:1 96:1 112:0

[pattern.intro]
hat   = x.x. x.x. x.x. x.x.
kick  = x... .... x... ....

[pattern.main]
kick  = x... x... x... x...
snare = .... x... .... x...
hat   = x.x. x.x. x.x. x.xx
bass  = x... ..x. x... ..x.
stab  = .... .... x... ....
lead  = E4 .. G4 A4 -  .. E5 D5 -  .. A4 -  G4 .. E4 -
gtr   = E3 .. .. B3 .. .. G3 .. E3 .. .. B2 .. .. A2 ..
pluckgtr = .. E4 .. .. G4 .. .. B4 .. E5 .. .. B4 .. G4 ..
sub   = E2 -  -  -  A1 -  -  -  C2 -  -  -  B1 -  -  -

[pattern.fill]
kick  = x... x... x... xxxx
snare = .... x... .x.x xxxx
hat   = x.x. x.x. x.x. ....
openhat = .... .... .... x...

[pattern.outro]
kick  = x... .... x... ....
openhat = x... .... .... ....
bass  = x... .... ..x. ....
sub   = E1 -  -  -  -  -  -  -  -  -  -  -  -  -  -  -
"""

#: the patterns of the song as written
PATTERNS = ("intro", "main", "main", "fill", "main", "main", "outro")


def pattern_order(rng: np.random.Generator) -> list:
    """The six patterns before the outro in an order drawn from ``rng``,
    then the outro."""
    head = list(PATTERNS[:-1])
    return [head[i] for i in rng.permutation(len(head))] + [PATTERNS[-1]]


def variant(order, k: int, text: str = TEXT) -> str:
    """The song text with ``patterns =`` set to ``order`` repeated ``k``
    times and the automation ticks scaled by ``k``."""
    out, in_auto = [], False
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("["):
            in_auto = s == "[automation]"
        if line.startswith("patterns ="):
            line = "patterns = " + " ".join(list(order) * k)
        elif in_auto and "=" in line and not s.startswith(";"):
            key, pts = line.split("=", 1)
            scaled = []
            for tok in pts.split():
                t, v = tok.split(":", 1)
                scaled.append(f"{float(t) * k:g}:{v}")
            line = f"{key.rstrip()} = " + " ".join(scaled)
        out.append(line)
    return "\n".join(out) + "\n"
