"""Music-library backend: sqlite track index + search (the port's copy of
the repo's ``jukebox/backend.py``).

Scans directories for audio files, stores (path, title, duration, format)
rows, and serves searches for the player UI, in-process.  Measuring a
track's loudness decodes it through the port's streams on ``device``.
"""

from __future__ import annotations

import os
import sqlite3
import wave
from typing import List, NamedTuple, Optional


def _probe(path):
    """(duration_seconds, rate, nch) from the container HEADERS only —
    no PCM is decoded (indexing directories of long files stays O(1)
    per file)."""
    from synthesizer_tpu_torch.utils.decoders import probe_audio_file
    nframes, rate, nch = probe_audio_file(path)
    return (nframes / rate if rate else 0.0), rate, nch


AUDIO_EXTENSIONS = (".wav", ".wave", ".aif", ".aiff", ".aifc", ".au",
                    ".snd", ".mp3", ".mp2", ".ogg", ".oga", ".opus",
                    ".flac", ".m4a", ".aac", ".wma", ".mka", ".webm",
                    ".mod", ".xm", ".it", ".s3m", ".mptm")


class Track(NamedTuple):
    track_id: int
    path: str
    title: str
    duration: float
    samplerate: int
    nchannels: int
    #: measured EBU R128 integrated loudness (LUFS) — None until
    #: measure_loudness() runs (measuring decodes the whole file, so it
    #: is NOT part of the headers-only scan)
    lufs: Optional[float] = None
    #: measured sample peak (linear, 1.0 = full scale) — the boost cap
    peak: Optional[float] = None


class MusicLibrary:
    """sqlite-backed track index; loudness is measured on ``device``."""

    def __init__(self, db_path: str = ":memory:", device="cuda"):
        self.device = device
        self.db = sqlite3.connect(db_path)
        self.db.execute(
            """CREATE TABLE IF NOT EXISTS tracks (
                   id INTEGER PRIMARY KEY,
                   path TEXT UNIQUE NOT NULL,
                   title TEXT NOT NULL,
                   duration REAL NOT NULL DEFAULT 0,
                   samplerate INTEGER NOT NULL DEFAULT 0,
                   nchannels INTEGER NOT NULL DEFAULT 0,
                   lufs REAL,
                   peak REAL)""")
        for col in ("lufs", "peak"):
            # migrate pre-loudness databases in place
            try:
                self.db.execute(f"ALTER TABLE tracks ADD COLUMN {col} REAL")
            except sqlite3.OperationalError:
                pass
        self.db.commit()

    def scan(self, directory: str) -> int:
        """Index every audio file under a directory; returns #added."""
        added = 0
        for root, _dirs, files in os.walk(directory):
            for fn in sorted(files):
                if not fn.lower().endswith(AUDIO_EXTENSIONS):
                    continue
                path = os.path.join(root, fn)
                if self._probe_and_insert(path):
                    added += 1
        self.db.commit()
        return added

    def _probe_and_insert(self, path: str) -> bool:
        title = os.path.splitext(os.path.basename(path))[0]
        if path.lower().endswith((".mod", ".xm", ".it", ".s3m", ".mptm")):
            # tracker modules carry an embedded song title
            try:
                from synthesizer_tpu_torch.utils.modules import module_title
                title = module_title(path) or title
            except Exception:
                pass
        duration, rate, nch = 0.0, 0, 0
        if path.lower().endswith((".wav", ".wave")):
            try:
                with wave.open(path, "rb") as w:
                    rate = w.getframerate()
                    nch = w.getnchannels()
                    duration = w.getnframes() / rate
            except Exception:
                # compressed WAV: header-only in-process probe
                try:
                    duration, rate, nch = _probe(path)
                except Exception:
                    return False
        elif path.lower().endswith((".aif", ".aiff", ".aifc", ".au",
                                    ".snd", ".flac", ".mp3", ".mp2",
                                    ".ogg", ".oga", ".opus", ".mod",
                                    ".xm", ".it", ".s3m", ".mptm",
                                    ".m4a", ".aac", ".mp4", ".wma",
                                    ".mka", ".webm")):
            # in-process formats (round 3): full duration metadata with
            # no external binary — mp3/ogg via the system codec library
            # bindings, m4a/aac/wma/mka via the libav catch-all shim
            # when present, headers only.  A file the probe
            # cannot parse still gets indexed with zero duration (an
            # ffmpeg-equipped deck may play it anyway)
            try:
                duration, rate, nch = _probe(path)
            except Exception:
                pass
        try:
            self.db.execute(
                "INSERT OR IGNORE INTO tracks(path, title, duration, samplerate, nchannels) "
                "VALUES (?, ?, ?, ?, ?)", (path, title, duration, rate, nch))
            return True
        except sqlite3.Error:
            return False

    _COLS = "id, path, title, duration, samplerate, nchannels, lufs, peak"

    def search(self, query: str = "") -> List[Track]:
        cur = self.db.execute(
            f"SELECT {self._COLS} FROM tracks "
            "WHERE title LIKE ? ORDER BY title", (f"%{query}%",))
        return [Track(*row) for row in cur.fetchall()]

    def get(self, track_id: int) -> Optional[Track]:
        cur = self.db.execute(
            f"SELECT {self._COLS} FROM tracks WHERE id = ?", (track_id,))
        row = cur.fetchone()
        return Track(*row) if row else None

    def measure_loudness(self, track_id: int) -> Optional[Track]:
        """Decode the track once, measure its EBU R128 integrated
        loudness + sample peak (measure_track_loudness), store both, and
        return the refreshed row.  Decks use this lazily for
        level-matched playback — scan() stays headers-only."""
        track = self.get(track_id)
        if track is None:
            return None
        lufs, peak = measure_track_loudness(track.path, self.device)
        self.db.execute("UPDATE tracks SET lufs = ?, peak = ? WHERE id = ?",
                        (lufs, peak, track_id))
        self.db.commit()
        return self.get(track_id)

    def close(self) -> None:
        self.db.close()


def measure_track_loudness(path: str, device="cuda"):
    """(integrated LUFS, linear sample peak) of a whole audio file,
    memory-bounded: the stream decoded on ``device`` feeds the chunk-fed
    R128 meter (ops.loudness.StreamingLoudness, host-f64 path) one block at
    a time.  LUFS is None for silence/too-short programmes (gated to
    -inf)."""
    import math

    import numpy as np

    from synthesizer_tpu_torch.ops.loudness import StreamingLoudness
    from synthesizer_tpu_torch.streaming import (AudiofileToWavStream,
                                                 SampleStream)

    wav = AudiofileToWavStream(path, device=device)
    stream = SampleStream(wav, 32768, device=device)
    meter = None
    peak = 0.0
    try:
        for chunk in stream:
            a = chunk.get_frame_array()
            if a.ndim == 1:
                a = a[:, None]
            if meter is None:
                meter = StreamingLoudness(chunk.samplerate, a.shape[1])
            meter.update_host(a, maxvalue=float(chunk.maxvalue))
            peak = max(peak, float(np.abs(a.astype(np.int64)).max())
                       / float(chunk.maxvalue))
    finally:
        stream.close()
        wav.close()
    if meter is None:
        return None, None
    lufs = meter.stats()["integrated"]
    return (lufs if math.isfinite(lufs) else None), peak
