"""Sharded song mixdown: one song's voices over a mesh of devices.

The song path scales by data parallelism over a 1-D ``VoiceMesh``: sample
hits shard across the devices and their int32 partials add exactly; synth
voices shard over the same axis and their f32 partials add on the first
device in shard order.  A device may repeat: on a machine with one card
the mesh is four shards of ``cuda:0`` (every card, one shard each, where
there are several), and on the CPU eight shards of ``cpu``.

    python -m synthesizer_tpu_torch.examples.sharded_mixdown [out.wav]
        [--device cpu]
"""

import numpy as np
import torch

from synthesizer_tpu_torch import WaveSynth
from synthesizer_tpu_torch.examples._cli import parse
from synthesizer_tpu_torch.parallel.mesh import voice_mesh
from synthesizer_tpu_torch.sequencer import Song, SynthDef


def shard_devices(device) -> list:
    """The mesh's devices: every card where there are several, else four
    shards of the one card, or eight of the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * (4 if dev.type == "cuda" else 8)


def main(argv=None) -> None:
    args = parse(__doc__, argv, "sharded_mix.wav", "the WAV file to write")
    ws = WaveSynth(device=args.device)
    song = Song(device=args.device)
    song.bpm = 120
    song.ticks = 4
    song.add_instrument("kick", ws.sine(55, 0.12, amplitude=0.9)
                        .fadeout(0.1).stereo())
    song.add_instrument("hat", ws.white_noise(duration=0.04, amplitude=0.35,
                                              seed=11).fadeout(0.03).stereo())
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.22,
                                    attack=0.01, release=0.12, pan=0.3))
    song.add_synth("bass", SynthDef(wave="sine", amplitude=0.3, release=0.1,
                                    fm_frequency=3.0, fm_depth=0.008,
                                    pan=-0.2))
    song.add_pattern("a", {
        "kick": "x... x... x... x...",
        "hat": "x.x. x.x. x.x. xxx.",
        "lead": "C4 - E4 - G4 - E4 - C4 - E4 - A4 - G4 -",
        "bass": "C2 - - - - - - - G1 - - - - - - -",
    })
    song.pattern_sequence = ["a", "a"]

    mesh = voice_mesh(devices=shard_devices(args.device))
    print(f"mesh: {mesh.shape} over {mesh}")
    sharded = song.mix(normalize=False, mesh=mesh)
    single = song.mix(normalize=False)
    d = np.abs(sharded.get_frame_array().astype(np.int64)
               - single.get_frame_array().astype(np.int64))
    print(f"sharded vs single-device mixdown: max {d.max()} LSB (drums "
          f"exact through int32 adds; synths differ only by the f32 "
          f"summation order)")
    sharded.write_wav(args.out)
    print(f"{sharded.duration:.2f}s -> {args.out}")


if __name__ == "__main__":
    main()
