#!/usr/bin/env python3
"""trackmixer — CLI pattern sequencer / song mixer (the port's copy of the
repo's ``trackmixer.py``).

Load an ``.ini`` song, then either mix it offline to a WAV (the whole song
compiles to one batched device render) or play it streaming, with an
interactive REPL for auditioning patterns.  Songs render on ``--device``,
the card unless ``--device cpu`` is given.  MIDI ``--stems`` pads every
channel's stem to the longest one, so all stems align sample for sample.

Usage:
    python -m synthesizer_tpu_torch.apps.trackmixer song.ini            # REPL
    python -m synthesizer_tpu_torch.apps.trackmixer song.ini -o out.wav # mixdown
    python -m synthesizer_tpu_torch.apps.trackmixer song.ini --play     # stream
    python -m synthesizer_tpu_torch.apps.trackmixer song.ini -o out.wav --device cpu
"""

from __future__ import annotations

import argparse
import cmd
import os
import sys
import time

import torch

from synthesizer_tpu_torch import LevelMeter, Output, Song
from synthesizer_tpu_torch.utils.device import resolve


def mix_to_wav(song: Song, outfile: str, normalize: bool = True,
               lufs: float = None) -> None:
    t0 = time.perf_counter()
    mixed = song.mix(normalize=normalize and lufs is None)
    if lufs is not None:
        before = mixed.loudness_lufs()
        mixed.normalize_lufs(lufs)
        print(f"loudness {before:.1f} LUFS -> target {lufs:.1f} LUFS "
              f"(true peak {mixed.true_peak_dbtp():.1f} dBTP)")
    mixed.write_audio(outfile)   # .flac -> lossless, .mp3/.ogg -> lossy
    dt = time.perf_counter() - t0
    print(f"mixed {mixed.duration:.2f}s of audio in {dt:.3f}s "
          f"({mixed.duration / dt:.0f}x realtime) -> {outfile}")


def play_streaming(song: Song, with_meter: bool = True,
                   start_seconds: float = 0.0) -> None:
    # loudness=True: the console bar carries a live momentary/short-term
    # LUFS readout next to the VU levels (EBU R128 M/S meters)
    meter = LevelMeter(loudness=True) if with_meter else None
    start_frame = int(start_seconds * song.samplerate)
    # ~0.2 s chunks: sequential playback doesn't need mixer-sized blocks
    chunk_frames = song.samplerate // 5
    with Output(samplerate=song.samplerate, nchannels=song.nchannels,
                mixing="sequential") as out:
        for chunk in song.mix_generator(chunk_frames=chunk_frames,
                                        start_frame=start_frame):
            out.play_sample(chunk)
            if meter:
                meter.update(chunk)
                meter.print(bar_width=50)
        out.wait_all_played(timeout=60.0)
    if meter:
        print()


class TrackmixerRepl(cmd.Cmd):
    intro = ("Track mixer.  Commands: load <song.ini>, patterns, "
             "play <pattern>, mix [file], record [file], stems [dir], "
             "stream, loudness, info, quit")
    prompt = "mix> "

    def __init__(self, song: Song, ini_file: str):
        super().__init__()
        self.song = song
        self.ini_file = ini_file

    def do_info(self, _):
        """Show song metadata."""
        s = self.song
        print(f"song: {self.ini_file}")
        extras = []
        if s.synths:
            extras.append(f"{len(s.synths)} synths")
        if s.samplers:
            extras.append(f"{len(s.samplers)} samplers")
        if s.fx:
            extras.append("fx: " + " ".join(n for n, _ in s.fx))
        tfx = sorted(set(s.synth_fx) | set(s.sampler_fx))
        if tfx:
            extras.append("track fx: " + " ".join(tfx))
        if s.automation:
            extras.append("automation: " + " ".join(sorted(s.automation)))
        if s.swing:
            extras.append(f"swing {s.swing:g}")
        print(f"bpm {s.bpm}, {s.ticks} ticks/beat, "
              f"{len(s.instruments)} instruments, "
              f"{len(s.patterns)} patterns, sequence: "
              f"{' '.join(s.pattern_sequence)}"
              + ("".join("\n  " + e for e in extras)))

    def do_load(self, arg):
        """load <song.ini> — load another song file."""
        path = arg.strip()
        if not path:
            print("usage: load <song.ini>")
            return
        try:
            self.song = Song.from_ini(path, device=self.song.device)
            self.ini_file = path
            self.do_info("")
        except FileNotFoundError:
            print(f"no such file: {path}")
        except (KeyError, ValueError) as e:
            print(f"error in song definition: {e}")

    def do_patterns(self, _):
        """List patterns and their tracks."""
        for name, pat in self.song.patterns.items():
            print(f"[pattern.{name}]")
            for inst, ticks in pat.items():
                print(f"  {inst:10s} {ticks}")

    def do_play(self, arg):
        """play <pattern> — render one pattern and play/write it."""
        name = arg.strip()
        if name not in self.song.patterns:
            print(f"unknown pattern {name!r}; try 'patterns'")
            return
        sub = Song(device=self.song.device)
        sub.bpm, sub.ticks = self.song.bpm, self.song.ticks
        sub.swing = self.song.swing
        sub.instruments = self.song.instruments
        sub.synths = self.song.synths
        sub.samplers = self.song.samplers
        sub.synth_fx = self.song.synth_fx
        sub.sampler_fx = self.song.sampler_fx
        sub.fx_irs = self.song.fx_irs
        sub.automation = self.song.automation
        sub.samplerate, sub.nchannels = self.song.samplerate, self.song.nchannels
        sub.patterns = {name: self.song.patterns[name]}
        sub.pattern_sequence = [name]
        try:
            sample = sub.mix(normalize=False)
        except (KeyError, ValueError) as e:
            print(f"error in pattern: {e}")
            return
        with Output(samplerate=sample.samplerate, nchannels=sample.nchannels,
                    mixing="sequential") as out:
            out.play_sample(sample)
            out.wait_all_played(timeout=30.0)
        print(f"played pattern {name} ({sample.duration:.2f}s)")

    def do_mix(self, arg):
        """mix [file.wav] — offline mixdown of the whole song."""
        outfile = arg.strip() or "mixdown.wav"
        mix_to_wav(self.song, outfile)

    def do_stems(self, arg):
        """stems [dir] — render every track to dir/NAME.wav (pre-master:
        per-track fx applied, master chain/normalization skipped)."""
        outdir = arg.strip() or "stems"
        os.makedirs(outdir, exist_ok=True)
        t0 = time.perf_counter()
        stems = self.song.mix_stems()
        for name, smp in stems.items():
            smp.write_wav(os.path.join(outdir, f"{name}.wav"))
        dur = next(iter(stems.values())).duration if stems else 0.0
        print(f"rendered {len(stems)} stems x {dur:.2f}s in "
              f"{time.perf_counter() - t0:.3f}s -> {outdir}/")

    def do_loudness(self, _):
        """Measure the mixdown's EBU R128 meter set (integrated LUFS,
        loudness range, momentary/short-term maxima, true peak)."""
        mixed = self.song.mix(normalize=False)
        s = mixed.loudness_stats()
        print(f"integrated   {s['integrated']:7.1f} LUFS")
        print(f"range (LRA)  {s['lra']:7.1f} LU")
        print(f"momentary    {s['momentary_max']:7.1f} LUFS max")
        print(f"short-term   {s['short_term_max']:7.1f} LUFS max")
        print(f"true peak    {mixed.true_peak_dbtp():7.1f} dBTP")

    def do_stream(self, _):
        """Stream the whole song through the playback engine."""
        play_streaming(self.song)

    # 'record' is the reference REPL's name for an offline mixdown
    do_record = do_mix

    def do_quit(self, _):
        """Exit."""
        return True

    do_EOF = do_quit


def pad_stems(stems):
    """Pad every stem (int16 Samples) with silence to the longest one's
    frame count, so the files align sample for sample."""
    n = max(s.nframes for s in stems)
    for s in stems:
        f = s.torch_frames
        if f.shape[0] < n:
            s._replace_frames(torch.cat([f, f.new_zeros(
                (n - f.shape[0], f.shape[1]))]))
    return stems


def midi_stems(path: str, outdir: str, device) -> int:
    """One stem per MIDI channel (the natural track axis of an SMF), named
    chNN[_drums].wav, all padded to the longest channel."""
    from synthesizer_tpu_torch.midi import (parse_midi, release_grace_for,
                                            render_notes)
    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    notes = parse_midi(path, release_grace=release_grace_for(None))
    chans = sorted({n.channel for n in notes})
    stems = pad_stems([render_notes([n for n in notes if n.channel == ch],
                                    device=device) for ch in chans])
    for ch, smp in zip(chans, stems):
        tag = f"ch{ch:02d}" + ("_drums" if ch == 9 else "")
        smp.write_wav(os.path.join(outdir, f"{tag}.wav"))
    dur = stems[0].duration if stems else 0.0
    dt = time.perf_counter() - t0
    print(f"rendered {len(chans)} MIDI channel stems x {dur:.2f}s in "
          f"{dt:.3f}s -> {outdir}/")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("song", help="song .ini file (or a .mid file to render)")
    ap.add_argument("-o", "--output", help="mix offline to this file and "
                    "exit (.wav/.flac/.mp3/.ogg by extension; .mid "
                    "exports the song's note events as an SMF instead "
                    "of rendering audio)")
    ap.add_argument("--play", action="store_true",
                    help="stream the whole song and exit")
    ap.add_argument("--start", type=float, default=0.0, metavar="SECONDS",
                    help="with --play: seek before streaming (bit-exact "
                         "mid-song resume)")
    ap.add_argument("--lufs", type=float, metavar="TARGET",
                    help="loudness-normalize the mixdown to TARGET LUFS "
                         "(BS.1770-4 integrated, true peak capped at "
                         "-1 dBTP) instead of peak normalization")
    ap.add_argument("--no-normalize", action="store_true",
                    help="skip peak normalization in offline mixdown")
    ap.add_argument("--stems", metavar="DIR",
                    help="render every track to DIR/NAME.wav (pre-master "
                         "stems: per-track fx applied, master chain and "
                         "normalization skipped) and exit; for a .mid "
                         "input, one stem per MIDI channel (chNN.wav), "
                         "all padded to the longest")
    ap.add_argument("--stem-format", choices=("wav", "flac", "mp3", "ogg"),
                    default="wav", help="stem file format (flac = "
                    "in-process lossless encoder; mp3/ogg = lossy via the "
                    "system codec libraries)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.start < 0:
        ap.error("--start must be >= 0")
    if args.start and not args.play:
        ap.error("--start only applies with --play")
    try:
        device = resolve(args.device)
    except RuntimeError as e:          # no card: say how to run without one
        ap.error(str(e).replace("device='cpu'", "--device cpu"))

    try:
        if args.song.lower().endswith((".mid", ".midi")):
            from synthesizer_tpu_torch.midi import render_midi
            if args.output and args.output.lower().endswith(
                    (".mid", ".midi")):
                # -o .mid means "export the song's notes as an SMF": for a
                # MIDI input that would be a lossy rewrite (controller
                # curves don't re-serialize), so refuse rather than write
                # audio into a .mid path
                ap.error("-o .mid exports an .ini song; the input is "
                         "already a MIDI file")
            if args.stems:
                return midi_stems(args.song, args.stems, device)
            out = args.output or (args.song.rsplit(".", 1)[0] + ".wav")
            t0 = time.perf_counter()
            sample = render_midi(args.song, device=device)
            if args.lufs is not None:
                before = sample.loudness_lufs()
                sample.normalize_lufs(args.lufs)
                print(f"loudness {before:.1f} LUFS -> target "
                      f"{args.lufs:.1f} LUFS")
            if args.play:
                if args.start:
                    sample.cut(args.start, sample.duration)
                with Output(samplerate=sample.samplerate,
                            nchannels=sample.nchannels,
                            mixing="sequential") as outdev:
                    outdev.play_sample(sample)
                    outdev.wait_all_played(timeout=max(
                        60.0, sample.duration + 10.0))
                print(f"played MIDI {sample.duration:.2f}s")
                return 0
            sample.write_wav(out)
            dt = time.perf_counter() - t0
            print(f"rendered MIDI {sample.duration:.2f}s in {dt:.3f}s "
                  f"({sample.duration / dt:.0f}x realtime) -> {out}")
            return 0
        song = Song.from_ini(args.song, device=device)
        if args.stems:
            os.makedirs(args.stems, exist_ok=True)
            t0 = time.perf_counter()
            stems = song.mix_stems()
            ext = "." + args.stem_format
            for name, smp in stems.items():
                smp.write_audio(os.path.join(args.stems, f"{name}{ext}"))
            dt = time.perf_counter() - t0
            dur = next(iter(stems.values())).duration if stems else 0.0
            print(f"rendered {len(stems)} stems x {dur:.2f}s in {dt:.3f}s "
                  f"-> {args.stems}/")
            return 0
        if args.output:
            if args.output.lower().endswith((".mid", ".midi")):
                with open(args.output, "wb") as f:
                    f.write(song.export_midi())
                print(f"exported note events -> {args.output}")
                return 0
            mix_to_wav(song, args.output, normalize=not args.no_normalize,
                       lufs=args.lufs)
            return 0
        if args.play:
            play_streaming(song, start_seconds=args.start)
            return 0
        TrackmixerRepl(song, args.song).cmdloop()
        return 0
    except FileNotFoundError as e:
        print(f"error: {e.filename or e}: no such file", file=sys.stderr)
    except (KeyError, ValueError) as e:
        print(f"error in song definition: {e}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
