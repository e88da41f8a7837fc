#!/usr/bin/env python3
"""jukebox player: playlist + two-deck crossfade engine (+ optional Tk UI)
(the port's copy of the repo's ``jukebox/box.py``).

Tracks decode through :class:`AudiofileToWavStream` on the jukebox's
``device`` (the card unless the caller asks for the CPU), two "decks"
are summed chunk by chunk, and a crossfade hands playback from one deck
to the other by ramping per-deck ``VolumeFilter`` gains while both are
live.  The engine (:class:`Jukebox`) is headless and CI-tested; the Tk
playlist window (:class:`JukeboxGUI`) is a thin view.

Run:  python -m synthesizer_tpu_torch.apps.jukebox.box DIR... [--play]
      [--device cpu]
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, List, Optional

from synthesizer_tpu_torch import (AudiofileToWavStream, Output, Sample,
                                   SampleStream, VolumeFilter, params)
from synthesizer_tpu_torch.utils.device import resolve
from .backend import MusicLibrary, Track, measure_track_loudness


class Deck:
    """One playback deck: a decoded sample stream with its own volume.

    ``trim`` is a static level-match gain (R128 loudness normalization)
    multiplied under the 0..1 crossfade ``volume`` — the fade ramps the
    FRACTION, the trim carries the track's loudness correction."""

    def __init__(self, track: Track, frames_per_chunk: int,
                 trim: float = 1.0, device="cuda"):
        self.track = track
        self.trim = float(trim)
        self._fade = 1.0
        self.wav = AudiofileToWavStream(track.path, device=device)
        self.stream = SampleStream(self.wav, frames_per_chunk, device=device)
        self.volume_filter = VolumeFilter(self.stream, self.trim)
        self.exhausted = False

    @property
    def volume(self) -> float:
        return self._fade

    @volume.setter
    def volume(self, v: float) -> None:
        self._fade = max(0.0, min(1.0, v))
        self.volume_filter.volume = self._fade * self.trim

    def close(self) -> None:
        self.stream.close()
        self.wav.close()


class Jukebox:
    """Playlist player with two-deck crossfading (headless engine).

    Pull :meth:`chunks` for the mixed output; the crossfade starts
    ``crossfade`` seconds before the active deck's track ends (when track
    duration is known) or when the deck runs dry.
    """

    #: never boost a level-matched track past +12 dB (broken/near-silent
    #: measurements would otherwise explode the gain)
    MAX_TRIM = 4.0

    def __init__(self, library: Optional[MusicLibrary] = None,
                 crossfade: float = 3.0, frames_per_chunk: int = 0,
                 level_match: bool = False, target_lufs: float = -18.0,
                 limiter_db: Optional[float] = None, device="cuda"):
        """``level_match=True`` plays every track at ``target_lufs``
        (EBU R128 loudness normalization, the streaming-player
        convention): each deck loads with a static trim gain of
        target - integrated LUFS, capped so the track's sample peak
        never exceeds full scale.  Unmeasured library tracks are
        measured (and cached in the sqlite index) on first load.
        ``limiter_db`` adds the standard companion brickwall: a
        lookahead limiter (effects.StreamingLimiter) on the mixed
        output, so crossfade overlaps of two hot tracks can never
        clip past the ceiling.  Decks decode and mix on ``device``."""
        self.device = resolve(device)
        self.library = library or MusicLibrary(device=self.device)
        self.crossfade = crossfade
        self.frames_per_chunk = frames_per_chunk or params.norm_frames_per_chunk
        self.level_match = bool(level_match)
        self.target_lufs = float(target_lufs)
        self.limiter_db = limiter_db
        self.playlist: List[Track] = []
        self.decks: List[Optional[Deck]] = [None, None]
        self.active_deck = 0
        self.position = 0.0          # seconds into the active track
        self.paused = False          # while set, chunks() yields silence
        self._fading = False
        self._fade_left = 0.0

    # -- playlist ------------------------------------------------------------

    def enqueue(self, track: Track) -> None:
        self.playlist.append(track)

    def enqueue_path(self, path: str) -> None:
        self.playlist.append(Track(-1, path,
                                   os.path.splitext(os.path.basename(path))[0],
                                   0.0, 0, 0))

    def skip(self) -> None:
        """Start crossfading into the next track now."""
        if self.playlist and not self._fading:
            self._start_fade()

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    # -- engine ----------------------------------------------------------------

    def _trim_for(self, track: Track) -> float:
        """Static level-match gain for a track (1.0 when disabled or
        unmeasurable): 10^((target - LUFS)/20), capped at the sample
        peak's headroom and MAX_TRIM."""
        if not self.level_match:
            return 1.0
        lufs, peak = track.lufs, track.peak
        if lufs is None and track.track_id >= 0:
            refreshed = self.library.measure_loudness(track.track_id)
            if refreshed is not None:
                lufs, peak = refreshed.lufs, refreshed.peak
        if lufs is None:
            # ad-hoc path (enqueue_path): measure without a library row
            try:
                lufs, peak = measure_track_loudness(track.path, self.device)
            except Exception:
                return 1.0
        if lufs is None:
            return 1.0
        trim = 10.0 ** ((self.target_lufs - lufs) / 20.0)
        if peak:
            trim = min(trim, 1.0 / peak)    # boost never clips the peak
        return min(trim, self.MAX_TRIM)

    def _load_next(self, deck_index: int) -> bool:
        if not self.playlist:
            return False
        track = self.playlist.pop(0)
        old = self.decks[deck_index]
        if old:
            old.close()
        self.decks[deck_index] = Deck(track, self.frames_per_chunk,
                                      trim=self._trim_for(track),
                                      device=self.device)
        return True

    def _start_fade(self) -> None:
        other = 1 - self.active_deck
        if self._load_next(other):
            self.decks[other].volume = 0.0
            self._fading = True
            self._fade_left = self.crossfade

    def chunks(self) -> Iterator:
        """Yield mixed Samples until the playlist and decks run dry
        (through the output limiter when ``limiter_db`` is set — a
        HOLDBACK processor: the first chunk is its lookahead shorter,
        and the held-back frames flush after the last deck ends, so
        total output length is preserved)."""
        if self.limiter_db is None:
            yield from self._chunks_raw()
            return
        import torch
        from synthesizer_tpu_torch.effects import StreamingLimiter
        sr = params.norm_samplerate
        lim = StreamingLimiter(sr, 2, ceiling_db=float(self.limiter_db),
                               device=self.device)
        for raw in self._chunks_raw():
            out = lim.process(raw.torch_frames)
            if int(out.shape[0]):
                yield Sample.from_torch(out, sr, 2, name=raw.name)
        z = torch.zeros((lim.flush_frames, 2), dtype=torch.int16,
                        device=self.device)
        out = lim.process(z)
        if int(out.shape[0]):
            yield Sample.from_torch(out, sr, 2, name="limiter-flush")

    def _chunks_raw(self) -> Iterator:
        """Yield mixed Samples until the playlist and decks run dry."""
        chunk_dur = self.frames_per_chunk / params.norm_samplerate
        if self.decks[self.active_deck] is None and not self._load_next(self.active_deck):
            return
        import numpy as _np
        while True:
            if self.paused:
                z = _np.zeros(self.frames_per_chunk * 2, _np.int16)
                yield Sample.from_raw_frames(z.tobytes(), 2,
                                             params.norm_samplerate, 2,
                                             device=self.device)
                continue
            deck = self.decks[self.active_deck]
            if deck is None:
                return
            # trigger fade near end of a known-duration track
            if (not self._fading and self.playlist
                    and deck.track.duration > 0
                    and deck.track.duration - self.position <= self.crossfade):
                self._start_fade()

            parts = []
            for i, d in enumerate(self.decks):
                if d is None or d.exhausted:
                    continue
                try:
                    parts.append(next(d.volume_filter))
                except StopIteration:
                    d.exhausted = True
                    if i == self.active_deck and not self._fading:
                        # track ended without a timed fade: hard switch
                        if self._load_next(i):
                            self.position = 0.0
                            continue
            if self._fading:
                other = 1 - self.active_deck
                self._fade_left -= chunk_dur
                frac = max(0.0, self._fade_left / self.crossfade)
                if self.decks[self.active_deck]:
                    self.decks[self.active_deck].volume = frac
                if self.decks[other]:
                    self.decks[other].volume = 1.0 - frac
                if self._fade_left <= 0:
                    old = self.decks[self.active_deck]
                    if old:
                        old.close()
                        self.decks[self.active_deck] = None
                    self.active_deck = other
                    self.position = 0.0
                    self._fading = False

            live = [p for p in parts if p is not None]
            if not live:
                if self.decks[self.active_deck] is None or \
                        self.decks[self.active_deck].exhausted:
                    if not self._load_next(self.active_deck):
                        return
                    self.decks[self.active_deck].exhausted = False
                    self.position = 0.0
                    continue
                return
            mixed = live[0]
            for p in live[1:]:
                if p.nframes < mixed.nframes:
                    p.add_silence((mixed.nframes - p.nframes) / p.samplerate)
                elif mixed.nframes < p.nframes:
                    mixed.add_silence((p.nframes - mixed.nframes) / mixed.samplerate)
                mixed.mix(p)
            self.position += chunk_dur
            yield mixed

    def play(self, output: Optional[Output] = None) -> None:
        """Blocking playback of the whole playlist."""
        own = output is None
        out = output or Output(mixing="sequential")
        try:
            for chunk in self.chunks():
                out.play_sample(chunk)
            out.wait_all_played(timeout=600.0)
        finally:
            if own:
                out.close()


class JukeboxGUI:
    """Tk playlist window over the Jukebox engine (display required)."""

    def __init__(self, library: MusicLibrary, device="cuda"):
        import tkinter as tk
        from tkinter import ttk
        self.tk = tk
        self.root = tk.Tk()
        self.root.title("synthesizer_tpu_torch jukebox")
        self.box = Jukebox(library, device=device)
        self.listbox = tk.Listbox(self.root, width=60, height=20)
        self.listbox.pack(side=tk.LEFT, fill=tk.BOTH, expand=True)
        for t in library.search(""):
            self.listbox.insert(tk.END, f"{t.title}  ({t.duration:.0f}s)")
        self._tracks = library.search("")
        btns = ttk.Frame(self.root)
        btns.pack(side=tk.RIGHT, fill=tk.Y)
        ttk.Button(btns, text="enqueue", command=self._enqueue).pack()
        ttk.Button(btns, text="play", command=self._play).pack()
        ttk.Button(btns, text="skip", command=self.box.skip).pack()
        ttk.Button(btns, text="pause", command=self.box.pause).pack()
        ttk.Button(btns, text="resume", command=self.box.resume).pack()
        self._thread: Optional[threading.Thread] = None

    def _enqueue(self):
        for i in self.listbox.curselection():
            self.box.enqueue(self._tracks[i])

    def _play(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self.box.play, daemon=True)
            self._thread.start()

    def run(self):
        self.root.mainloop()


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description="jukebox music player")
    ap.add_argument("dirs", nargs="*", default=["."],
                    help="directories to index")
    ap.add_argument("--play", action="store_true",
                    help="headless: enqueue everything and play (no GUI)")
    ap.add_argument("--level-match", action="store_true",
                    help="R128 loudness normalization across tracks")
    ap.add_argument("--target-lufs", type=float, default=-18.0,
                    help="level-match target (default -18 LUFS)")
    ap.add_argument("--limit", type=float, default=None, metavar="DB",
                    help="brickwall-limit the output at DB dBFS "
                         "(e.g. --limit -1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode and mix on (default: cuda)")
    args = ap.parse_args(argv)
    lib = MusicLibrary(device=args.device)
    for d in args.dirs:
        print(f"indexed {lib.scan(d)} tracks from {d}")
    if args.play:
        box = Jukebox(lib, crossfade=1.0, level_match=args.level_match,
                      target_lufs=args.target_lufs,
                      limiter_db=args.limit, device=args.device)
        for t in lib.search(""):
            box.enqueue(t)
            print(f"queued: {t.title} ({t.duration:.1f}s)")
        box.play()
        print("playlist finished")
        return
    JukeboxGUI(lib, device=args.device).run()


if __name__ == "__main__":
    main()
