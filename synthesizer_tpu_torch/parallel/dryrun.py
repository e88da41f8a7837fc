"""Compile check and multi-device dry run of the port (counterpart of the
repo's ``__graft_entry__.py``).

``entry()``            -> (fn, example_args): one render step of the 64-voice
                          demo bank (a 2048-frame chunk through
                          ``ops.kernels.render_stereo``: the Hopper kernels
                          on the card, the plain version on the CPU).
``dryrun_multichip(n)`` -> the sharded render over an n-device
                          ``VoiceMesh``, checked against the single-device
                          render with every bound of the reference's dry run:
                          a tiny sharded bank, an ``.ini`` song with drum
                          hits, a synth track, a pitched sampler, track fx
                          buses, a sidechain and automation (<= 2 LSB),
                          streaming chunk 0 == the offline slice, a swept
                          master chain (within ``ops.coeffs.
                          master_chain_error_bound``), and a MIDI file with
                          bend, CC1, CC11 and pressure curves (<= 1 LSB).

    python -c "from synthesizer_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4)"        # every CUDA device

Without enough cards pass the devices: ``dryrun_multichip(8,
devices=[torch.device("cpu")] * 8)`` shards over eight CPU shards, and
``devices=[torch.device("cuda", 0)] * 4`` puts four shards on one card.
"""

from __future__ import annotations

import os
import tempfile
import wave as wavemod

import numpy as np
import torch

SR = 44100


def _demo_voices(n: int = 64):
    from ..models.voicebank import Voice
    waves = ["sine", "triangle", "square", "sawtooth", "pulse",
             "semicircle", "pointy", "harmonics"]
    voices = []
    for i in range(n):
        w = waves[i % len(waves)]
        voices.append(Voice(
            wave=w,
            frequency=110.0 * (1 + (i % 12)),
            amplitude=0.6 / n * 8,
            pan=((i % 9) - 4) / 4.0,
            start=0.001 * i,
            duration=0.5,
            fm_frequency=5.0 if i % 3 == 0 else 0.0,
            fm_depth=0.01 if i % 3 == 0 else 0.0,
            harmonics=[1.0, 0.5, 0.25, 0.125] if w == "harmonics" else (),
            seed=i,
        ))
    return voices


def entry(device="cuda"):
    """(fn, example_args): fn(vp, n0) renders one 2048-frame chunk of the
    64-voice demo bank at frame n0 -> f32 [2048, 2] on vp's device."""
    from ..models.voicebank import BankLayout, pack_voices
    from ..ops.kernels import render_stereo

    samplerate = SR
    chunk = 2048
    num_harmonics = 8
    vp = pack_voices(_demo_voices(64), samplerate,
                     num_harmonics=num_harmonics, device=device)
    layout = BankLayout.ungrouped(int(vp.wave.shape[0]), num_harmonics)

    def fn(vp, n0):
        return render_stereo(vp, n0, nframes=chunk, samplerate=samplerate,
                             layout=layout)

    return fn, (vp, 0)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _lsb(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _write_kick(path: str) -> None:
    t = np.arange(int(0.05 * SR)) / float(SR)
    kick = (np.sin(2 * np.pi * 60.0 * t) * 20000
            * np.exp(-t * 40)).astype(np.int16)
    with wavemod.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.stack([kick, kick], axis=1).tobytes())


SONG_INI = (
    "[song]\nbpm = 480\nticks = 2\npatterns = a\n"
    "[instruments]\nkick = kick.wav\n"
    "[sampler.smp]\nfile = kick.wav\nbase_note = C4\n"
    "[synth.lead]\nwave = sine\namplitude = 0.2\n"
    "release = 0.02\nglide = 0.02\n"
    "[pattern.a]\nkick = x.X.\nlead = C4 . E4 .\n"
    "smp = . E4 . G3\n"
    # the synth track's bus shards through the grouped render, the sampler
    # track's through an exact int32 merge
    "[fx.lead]\nfilter = kind=lowpass cutoff=6000\n"
    # sidechain ducking: the key bus (kick's own hits) renders unsharded
    "[fx.smp]\ncompress = threshold_db=-18 ratio=4 sidechain=kick\n"
    "[automation]\ntrack.kick.volume = 0:1 2:0.5\n"
    "track.smp.pan = 0:-0.5 3:0.5\n")

MASTER_FX = ("[fx]\neq = mid_db=3 mid_freq=1200 high_db=2\n"
             "echo = beats=0.5 feedback=0.4 wet=0.3\n"
             "phaser = rate=0.8 depth=1.0 stages=2\n"
             "width = amount=1.3\n"
             "limiter = ceiling_db=-2 lookahead=0.003\n")

#: the master chain's stages at their knob and automation extremes, for
#: ``ops.coeffs.master_chain_error_bound``
MASTER_STAGES = [
    ("eq_band", {"kind": "peaking", "freq": 1200.0, "q": 1.0,
                 "gains_db": [-9.0, 3.0, 6.0]}),
    ("eq_band", {"kind": "highshelf", "freq": 8000.0, "q": 0.7071,
                 "gains_db": [2.0]}),
    ("echo", {"feedback": 0.4, "wet": 0.3, "dry": 1.0}),
    ("phaser", {"stages": 2, "q": 0.7071, "min_freq": 300.0,
                "max_freq": 3000.0, "wet": 0.7, "dry": 1.0}),
    ("width", {"amount": 1.3}),
    ("limiter", {}),
]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded paths over an ``n_devices`` mesh (every CUDA device
    unless ``devices`` names them) and check each against the
    single-device render on ``mesh.devices[0]``.  Raises AssertionError on
    a failed check; returns the measured differences in LSB."""
    from ..midi import MidiNote, render_midi, write_midi
    from ..models.voicebank import pack_voices
    from ..ops.coeffs import master_chain_error_bound
    from ..sequencer import Song, SynthDef
    from .mesh import render_song_sharded, voice_mesh

    mesh = voice_mesh(n_devices, devices)
    dev = mesh.devices[0]
    out = {}

    samplerate = 8000           # tiny shapes
    chunk = 256
    nvoices = max(n_devices * 8, 16)
    vp = pack_voices(_demo_voices(nvoices), samplerate, num_harmonics=4,
                     pad_to=n_devices * 8, device="cpu")
    tiny = render_song_sharded(vp, total_frames=2 * chunk,
                               samplerate=samplerate, chunk_frames=chunk,
                               num_harmonics=4, mesh=mesh).cpu().numpy()
    _require(tiny.shape == (2 * chunk, 2) and np.isfinite(tiny).all(),
             f"tiny sharded render: shape {tiny.shape}, finite "
             f"{np.isfinite(tiny).all()}")
    print(f"dryrun_multichip({n_devices}): OK, rendered {tiny.shape} on "
          f"mesh {mesh.shape}")

    # the .ini song: hits and voices sharded, then one sharded streaming
    # chunk of the realtime path
    with tempfile.TemporaryDirectory() as td:
        _write_kick(os.path.join(td, "kick.wav"))
        ini = os.path.join(td, "song.ini")
        with open(ini, "w") as f:
            f.write(SONG_INI)
        song = Song.from_ini(ini, device=dev)
        arr = song.mix(normalize=False, tail_seconds=0.05,
                       mesh=mesh).get_frame_array()
        _require(arr.ndim == 2 and arr.shape[1] == 2 and len(arr) > 0
                 and np.abs(arr.astype(np.int64)).max() > 1000,
                 f"sharded song mix: shape {arr.shape}")
        # the integer parts are exact; the synth bus differs by the f32
        # summation order (1 LSB) and its track chain re-rounds it once
        single = song.mix(normalize=False,
                          tail_seconds=0.05).get_frame_array()
        out["song_lsb"] = d = _lsb(arr, single)
        _require(d <= 2, f"sharded mix off by {d} LSB vs single-device")
        first = next(song.mix_generator(chunk_frames=1470, mesh=mesh))
        chunk0 = first.get_frame_array()
        _require(np.array_equal(chunk0, arr[:len(chunk0)]),
                 "sharded streaming chunk != sharded offline slice")
        print(f"dryrun_multichip({n_devices}): Song.mix OK, {arr.shape} "
              f"frames (drums+synth+sampler+track-fx-buses+automation) "
              f"sharded over {mesh.shape}, {d} LSB vs single-device")

        # the swept master chain on the merged bus: only the synth bus's
        # f32 summation order differs (<= 2 LSB pre-master), composed
        # through each stage's gain bound
        ini2 = os.path.join(td, "song2.ini")
        with open(ini2, "w") as f:
            f.write(SONG_INI + MASTER_FX)
        song2 = Song.from_ini(ini2, device=dev)
        song2.add_automation("fx.eq.mid_db", "0:-9 3:6")
        song2.add_automation("fx.limiter.ceiling_db", "0:-1 3:-6")
        song2.add_automation("fx.phaser.wet", "0:0.2 3:0.7")
        song2.add_automation("fx.lead.filter.cutoff", "0:800 3:6000")
        m2 = song2.mix(normalize=False, tail_seconds=0.05,
                       mesh=mesh).get_frame_array()
        s2 = song2.mix(normalize=False, tail_seconds=0.05).get_frame_array()
        out["master_chain_lsb"] = d2 = _lsb(m2, s2)
        out["master_chain_bound"] = bound = master_chain_error_bound(
            MASTER_STAGES, SR, e_in_lsb=2.0)
        _require(d2 <= bound, f"sharded swept-fx mix off by {d2} LSB > "
                 f"derived bound {bound:.1f}")
        print(f"dryrun_multichip({n_devices}): swept master chain "
              f"(eq+echo+phaser+width+limiter, automation) OK ({d2} LSB vs "
              f"single-device, derived bound {bound:.1f})")

    # a MIDI file with bend, CC1, CC11 and pressure curves: one f32 merge,
    # quantized once.  sparse=False pins the single-device side to the flat
    # render the mesh shards
    sd = SynthDef(wave="sine", amplitude=0.4, attack=0.005, decay=0.02,
                  sustain_level=0.8, release=0.05)
    mnotes = [MidiNote(0.02 * i, 0.2, 52 + 3 * i, 90 + i, 0)
              for i in range(10)]
    mdata = write_midi(
        mnotes, bends=[(0.05, 0, 0), (0.15, 0, 4096), (0.22, 0, 8191)],
        controls=[(0.08, 0, 1, 30), (0.18, 0, 1, 100),
                  (0.1, 0, 11, 90), (0.2, 0, 11, 40)],
        pressures=[(0.16, 0, 80)])
    m_single = render_midi(mdata, instruments={0: sd}, samplerate=samplerate,
                           sparse=False, device=dev).get_frame_array()
    m_shard = render_midi(mdata, instruments={0: sd}, samplerate=samplerate,
                          mesh=mesh, device=dev).get_frame_array()
    out["midi_lsb"] = md = _lsb(m_single, m_shard)
    _require(md <= 1, f"sharded MIDI render off by {md} LSB vs single-device")
    _require(np.abs(m_single.astype(np.int64)).max() > 1000,
             "the MIDI render is silent")
    print(f"dryrun_multichip({n_devices}): MIDI render (bend+CC1+CC11+"
          f"aftertouch curves) OK ({md} LSB vs single-device over "
          f"{mesh.shape})")
    return out


if __name__ == "__main__":
    import sys
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    dryrun_multichip(n)
