"""FM bell: a classic two-operator FM patch rendered three ways.

The three synthesis surfaces make the same sound:
1. the declarative oscillator graph,
2. the eager WaveSynth renderer,
3. the batched voice bank (a chord of bells in one kernel launch).

    python -m synthesizer_tpu_torch.examples.fm_bell [outdir] [--device cpu]
"""

import os

from synthesizer_tpu_torch import (Sample, Voice, VoiceBank, WaveSynth,
                                   key_freq, oscillators as osc, pack_voices)
from synthesizer_tpu_torch.examples._cli import parse

SR = 44100


def main(argv=None) -> None:
    args = parse(__doc__, argv, ".", "directory for the three WAV files")
    outdir = args.out
    os.makedirs(outdir, exist_ok=True)
    synth = WaveSynth(samplerate=SR, samplewidth=2, device=args.device)

    # 1) graph API: carrier FM'd at a 3.5x ratio (inharmonic -> bell)
    modulator = osc.Sine(440.0 * 3.5, amplitude=0.08, samplerate=SR)
    bell = osc.EnvelopeFilter(
        osc.Sine(440.0, amplitude=0.9, fm_lfo=modulator, samplerate=SR),
        attack=0.002, decay=1.6, sustain=0.0, sustain_level=0.0, release=0.2)
    synth.render_oscillator(bell, 2.0, "bell").stereo().write_wav(
        os.path.join(outdir, "bell_graph.wav"))

    # 2) eager: the same patch through the WaveSynth front end
    s = synth.sine(440.0, 2.0, amplitude=0.9, fm_lfo=modulator)
    s.envelope(0.002, 1.6, 0.0, 0.2).stereo().write_wav(
        os.path.join(outdir, "bell_eager.wav"))

    # 3) voice bank: a whole bell chord in one render
    chord = [Voice("sine", key_freq(k), amplitude=0.25,
                   fm_frequency=key_freq(k) * 3.5, fm_depth=0.08,
                   attack=0.002, decay=0.0, sustain_level=1.0,
                   duration=0.002, release=1.8, pan=p)
             for k, p in [(40, -0.6), (47, -0.2), (52, 0.2), (59, 0.6)]]
    vp, layout = pack_voices(chord, SR, sort_by_wave=True, device=args.device)
    bank = VoiceBank.for_voices(chord, SR, layout=layout,
                                nvoices=layout.nvoices, device=args.device)
    stereo = bank.render_song(vp, 2 * SR)
    Sample.from_torch(bank.to_int16(stereo), SR, 2, "chord").write_wav(
        os.path.join(outdir, "bell_chord.wav"))

    print(f"wrote bell_graph.wav, bell_eager.wav, bell_chord.wav to "
          f"{outdir}/")


if __name__ == "__main__":
    main()
