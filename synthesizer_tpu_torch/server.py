"""Render server: HTTP serving surface for the framework (port of
``synthesizer_tpu.server``).

Serves renders over HTTP (stdlib-only, threaded) so that a fleet can treat
a GPU host as a render node.  Every render runs on the server's ``device``
(the card unless the caller passes ``device="cpu"``); a result leaves the
card through the pinned host copy when its WAV is written.

Endpoints
---------
GET  /health            -> {"status": "ok", "device": "cuda:0", "name": ...}
POST /render/song       body: trackmixer .ini text          -> WAV bytes
POST /render/patch      body: JSON patch spec (see below)   -> WAV bytes
POST /render/voices     body: JSON voice list               -> WAV bytes
POST /render/midi       body: Standard MIDI File bytes      -> WAV bytes

Patch JSON mirrors ``models.spec`` (the declarative DAG), e.g.::

    {"duration": 2.0, "samplerate": 44100,
     "patch": {"node": "envelope", "attack": 0.02, "decay": 0.1,
               "sustain": 1.0, "sustain_level": 0.6, "release": 0.3,
               "source": {"node": "osc", "kind": "sine", "frequency": 440,
                          "fm_lfo": {"node": "osc", "kind": "sine",
                                     "frequency": 6, "amplitude": 0.01}}}}

Voices JSON::

    {"duration": 3.0, "voices": [{"wave": "square_bl", "frequency": 220,
                                  "start": 0.0, "duration": 1.0, ...}, ...]}

``/render/voices`` requests that arrive while the device renders are
coalesced (``RenderBatcher``): one render-kernel launch with a stereo bus
per request.

Threads and the card: the batcher renders on its own thread while the
handler threads copy results out.  They all use the default CUDA stream,
so a handler's copy (``utils.device.to_host``: a copy on the current
stream, then a synchronise of that stream) runs after the render that made
the tensor.
"""

from __future__ import annotations

import configparser
import io
import json
import os
import struct
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from . import params
from .models import graph as G
from .models import spec as S
from .models.voicebank import Voice, VoiceBank, pack_voices
from .sample import Sample
from .sequencer import Song
from .utils.device import resolve as _device

__all__ = ["RenderServer", "spec_from_json", "voices_from_json"]


def spec_from_json(obj) -> S.Node:
    """Recursively decode a JSON patch description into a spec tree."""
    if isinstance(obj, (int, float)):
        return S.Const(float(obj))
    if not isinstance(obj, dict):
        raise ValueError(f"patch node must be a JSON object or number, "
                         f"got {type(obj).__name__}")
    node = obj.get("node", "osc")
    if node == "osc":
        return S.Osc(
            obj.get("kind", "sine"),
            float(obj.get("frequency", 440.0)),
            amplitude=float(obj.get("amplitude", 1.0)),
            phase=float(obj.get("phase", 0.0)),
            bias=float(obj.get("bias", 0.0)),
            fm_lfo=spec_from_json(obj["fm_lfo"]) if obj.get("fm_lfo") else None,
            pwm_lfo=spec_from_json(obj["pwm_lfo"]) if obj.get("pwm_lfo") else None,
            pulse_width=float(obj.get("pulse_width", 0.5)),
            num_harmonics=int(obj.get("num_harmonics", 8)),
            harmonics=tuple((float(r), float(a))
                            for r, a in obj.get("harmonics", [])),
            seed=int(obj.get("seed", 0)),
            table=tuple(float(v) for v in obj.get("table", [])),
        )
    if node == "envelope":
        return S.Envelope(spec_from_json(obj["source"]),
                          float(obj.get("attack", 0.0)),
                          float(obj.get("decay", 0.0)),
                          float(obj.get("sustain", 0.0)),
                          float(obj.get("sustain_level", 1.0)),
                          float(obj.get("release", 0.0)))
    if node == "mix":
        return S.Mix(tuple(spec_from_json(s) for s in obj["sources"]))
    if node == "amp_mod":
        return S.AmpMod(spec_from_json(obj["source"]),
                        spec_from_json(obj["modulator"]))
    if node == "delay":
        return S.Delay(spec_from_json(obj["source"]), float(obj["seconds"]))
    if node == "echo":
        return S.Echo(spec_from_json(obj["source"]), float(obj.get("after", 0.0)),
                      int(obj.get("amount", 1)), float(obj.get("delay", 0.1)),
                      float(obj.get("decay", 0.5)))
    if node in ("lowpass", "highpass", "bandpass"):
        return S.Biquad(spec_from_json(obj["source"]), node,
                        float(obj["cutoff"]), float(obj.get("q", 0.7071)),
                        cutoff_lfo=spec_from_json(obj["cutoff_lfo"])
                        if obj.get("cutoff_lfo") else None)
    if node == "clip":
        return S.Clip(spec_from_json(obj["source"]),
                      float(obj.get("minimum", -1.0)), float(obj.get("maximum", 1.0)))
    if node == "abs":
        return S.Abs(spec_from_json(obj["source"]))
    if node == "linear":
        return S.Linear(float(obj.get("start", 0.0)),
                        float(obj.get("increase", 0.0)),
                        float(obj.get("min_value", -1e6)),
                        float(obj.get("max_value", 1e6)))
    raise ValueError(f"unknown patch node type {node!r}")


def voices_from_json(items) -> list:
    fields = {f.name for f in Voice.__dataclass_fields__.values()} \
        if hasattr(Voice, "__dataclass_fields__") else set()
    out = []
    for item in items:
        kw = {k: v for k, v in item.items() if k in fields}
        if "harmonics" in kw:
            kw["harmonics"] = tuple(float(x) for x in kw["harmonics"])
        if "table" in kw:
            kw["table"] = tuple(float(x) for x in kw["table"])
        out.append(Voice(**kw))
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "synthesizer-tpu-torch/0.1"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/health":
            dev = self.server.device  # type: ignore[attr-defined]
            self._send_json(200, {
                "status": "ok",
                "device": str(dev),
                "platform": dev.type,
                "name": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "samplerate": params.norm_samplerate,
            })
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._send_json(400, {"error": "malformed Content-Length"})
            return
        if length < 0:     # read(-1) would buffer until the client closes
            self._send_json(400, {"error": "malformed Content-Length"})
            return
        if length > self.server.max_body_bytes:  # type: ignore[attr-defined]
            remaining = length   # drain in bounded chunks so the client can
            while remaining > 0:  # finish sending before it sees the error
                chunk = self.rfile.read(min(65536, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
            self._send_json(413, {"error": "request body too large"})
            return
        body = self.rfile.read(length)
        try:
            if self.path == "/render/song":
                wav = self._render_song(body.decode())
            elif self.path == "/render/patch":
                wav = self._render_patch(json.loads(body))
            elif self.path == "/render/voices":
                wav = self._render_voices(json.loads(body))
            elif self.path == "/render/midi":
                from .midi import parse_midi, release_grace_for, render_notes
                # the grace follows the default instruments' releases, as
                # render_midi derives it
                notes = parse_midi(body, release_grace=release_grace_for(None))
                if notes:
                    self._check_duration(max(n.start + n.duration
                                             for n in notes))
                bio = io.BytesIO()
                # sparse=False: the flat render, as the reference serves it
                render_notes(notes, sparse=False,
                             device=self.server.device  # type: ignore[attr-defined]
                             ).write_wav(bio)
                wav = bio.getvalue()
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
        except (KeyError, IndexError, AttributeError, ValueError, TypeError,
                ZeroDivisionError, OSError, wave.Error,
                json.JSONDecodeError, configparser.Error, struct.error) as e:
            self._send_json(400, {"error": str(e)})
            return
        self._send(200, wav, "audio/wav")

    def _check_duration(self, seconds: float) -> None:
        limit = self.server.max_render_seconds  # type: ignore[attr-defined]
        if seconds > limit:
            raise ValueError(f"render of {seconds:.1f}s exceeds the server "
                             f"limit of {limit:.0f}s")

    @staticmethod
    def _check_samplerate(sr: int) -> int:
        # bounded so duration caps actually cap frames: an unbounded
        # client samplerate would turn a legal duration into a
        # terabyte-scale render (and 0 into a ZeroDivisionError)
        if not 1000 <= sr <= 384000:
            raise ValueError(f"samplerate {sr} outside the served "
                             f"range [1000, 384000]")
        return sr

    def _render_song(self, ini_text: str) -> bytes:
        """Render attacker-controllable song text.

        Untrusted ini may name instrument WAV files; those resolve ONLY
        under the server's configured ``sample_root`` ([paths] sections are
        rejected, as are absolute / parent-escaping filenames) so a request
        cannot read arbitrary host files into the rendered output."""
        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        cp.read_string(ini_text)
        root = self.server.sample_root  # type: ignore[attr-defined]
        if cp.has_section("paths"):
            raise ValueError("[paths] sections are not allowed in "
                             "server-submitted songs")
        # every file an untrusted song can name resolves ONLY under the
        # sample root: instrument WAVs, [sampler.*] files, and [fx]
        # convolve impulse responses
        files = list(cp.items("instruments")) if cp.has_section(
            "instruments") else []
        for sec in cp.sections():
            if sec.startswith("sampler.") and cp.has_option(sec, "file"):
                files.append((f"[{sec}] file", cp.get(sec, "file")))
        from .effects import DEFAULT_REVERB_TAIL, parse_fx_items
        fx_sections = [s for s in cp.sections()
                       if s == "fx" or s.startswith("fx.")]
        total_tail = 0.0
        for sec in fx_sections:
            for fxname, p in parse_fx_items(cp.items(sec)):
                if fxname == "convolve":
                    files.append((f"[{sec}] {fxname} ir", p["ir"]))
                elif fxname == "reverb":
                    total_tail += p.get("tail", DEFAULT_REVERB_TAIL)
                elif fxname == "echo":
                    # echo trains extend renders like reverb tails; beats
                    # resolve against the song's own bpm
                    from .ops.coeffs import echo_tail_frames
                    delay = p.get("delay")
                    if delay is None:
                        bpm = cp.getint("song", "bpm", fallback=128)
                        delay = float(p["beats"]) * 60.0 / max(bpm, 1)
                    total_tail += echo_tail_frames(
                        44100, delay, p.get("feedback", 0.4),
                        p.get("wet", 0.5), p.get("tail")) / 44100.0
        # reverb tails extend renders (and per-track tails pad instrument
        # banks at LOAD time, before mix()'s max_frames bound can see
        # them): cap the requested decay like any other render length
        limit = self.server.max_render_seconds  # type: ignore[attr-defined]
        if total_tail > limit:
            raise ValueError(
                f"total [fx] reverb tail of {total_tail:.0f}s exceeds this "
                f"server's render limit of {limit:.0f}s")
        if files:
            if not root:
                raise ValueError("this server has no sample_root configured; "
                                 "songs may not reference sample files")
            rootreal = os.path.realpath(root)
            for name, filename in files:
                real = os.path.realpath(os.path.join(rootreal, filename))
                # strict prefix: equality would mean an empty/"." filename
                # resolving to the root directory itself
                if os.path.isabs(filename) or not real.startswith(
                        rootreal + os.sep):
                    raise ValueError(f"{name!r} path escapes the "
                                     f"server sample root")
        song = Song.from_string(ini_text, sample_dir=root or "",
                                device=self.server.device)  # type: ignore[attr-defined]
        limit = self.server.max_render_seconds  # type: ignore[attr-defined]
        mixed = song.mix(max_frames=int(limit * song.samplerate))
        bio = io.BytesIO()
        mixed.write_wav(bio)
        return bio.getvalue()

    def _render_patch(self, obj) -> bytes:
        self._check_duration(float(obj["duration"]))
        node = spec_from_json(obj["patch"])
        sr = self._check_samplerate(
            int(obj.get("samplerate", params.norm_samplerate)))
        n = int(float(obj["duration"]) * sr)
        vals = G.render_patch(node, n, sr,
                              device=self.server.device)  # type: ignore[attr-defined]
        data = G.to_int_device(vals, 2)[:, None]
        bio = io.BytesIO()
        Sample.from_torch(data, sr, 2, "patch").write_wav(bio)
        return bio.getvalue()

    def _render_voices(self, obj) -> bytes:
        self._check_duration(float(obj["duration"]))
        voices = voices_from_json(obj["voices"])
        if not voices:
            raise ValueError("no voices given")
        sr = self._check_samplerate(
            int(obj.get("samplerate", params.norm_samplerate)))
        total = int(float(obj["duration"]) * sr)
        out16 = self.server.batcher.render(voices, total, sr)  # type: ignore[attr-defined]
        bio = io.BytesIO()
        Sample.from_torch(out16, sr, 2, "voices").write_wav(bio)
        return bio.getvalue()


class _BatchReq:
    __slots__ = ("voices", "total", "sr", "event", "result", "error")

    def __init__(self, voices, total, sr):
        self.voices = voices
        self.total = total
        self.sr = sr
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class RenderBatcher:
    """Dynamic request coalescing for ``/render/voices`` (the inference-
    server pattern, adapted to audio): while the device renders one batch,
    concurrently arriving requests queue; the worker then packs all queued
    same-samplerate requests' voices into one bank whose render adds every
    voice into its request's stereo bus (``VoiceBank.render_song_grouped``:
    one ``render_kernel<false, buses>`` launch, a row of blocks per
    request).  Under concurrent load the card runs one render per batch
    instead of one per request.  A lone request takes ``render_song``
    (``render_kernel<false>``).  Results are int16 tensors on ``device``."""

    def __init__(self, max_batch_voices: int = 1024, device="cuda"):
        self.device = _device(device)
        self._cv = threading.Condition()
        self._pending: list = []
        self._thread: Optional[threading.Thread] = None
        self.max_batch_voices = max_batch_voices
        #: observability: batches executed / requests served / coalesced
        self.batches = 0
        self.requests = 0
        self.coalesced = 0

    def render(self, voices, total: int, sr: int):
        """Render (blocking) -> int16 [total, 2] on the batcher's device."""
        req = _BatchReq(voices, total, sr)
        with self._cv:
            self._pending.append(req)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                sr = self._pending[0].sr
                batch, rest, nv = [], [], 0
                for r in self._pending:
                    if r.sr == sr and nv + len(r.voices) <= self.max_batch_voices:
                        batch.append(r)
                        nv += len(r.voices)
                    else:
                        rest.append(r)
                self._pending[:] = rest
            try:
                self._execute(batch)
            except Exception as e:            # surface to every waiter
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.event.set()

    def _execute(self, batch) -> None:
        self.batches += 1
        self.requests += len(batch)
        sr = batch[0].sr
        dev = self.device
        if len(batch) == 1:
            r = batch[0]
            vp, layout = pack_voices(r.voices, sr, num_harmonics=8,
                                     sort_by_wave=True, device=dev)
            bank = VoiceBank.for_voices(r.voices, sr, num_harmonics=8,
                                        layout=layout, nvoices=layout.nvoices,
                                        device=dev)
            r.result = bank.to_int16(bank.render_song(vp, r.total))
            return
        self.coalesced += len(batch)
        allv, tags = [], []
        for i, r in enumerate(batch):
            allv.extend(r.voices)
            tags.extend([i] * len(r.voices))
        vp, layout, seg = pack_voices(allv, sr, num_harmonics=8,
                                      sort_by_wave=True, tags=tags,
                                      device=dev)
        bank = VoiceBank.for_voices(allv, sr, num_harmonics=8,
                                    layout=layout, nvoices=layout.nvoices,
                                    device=dev)
        total = max(r.total for r in batch)
        out = bank.render_song_grouped(vp, seg, len(batch), total)
        out16 = bank.to_int16(out)                     # [total, R, 2]
        for i, r in enumerate(batch):
            r.result = out16[:r.total, i, :]


class RenderServer:
    """Threaded HTTP render server.

    >>> srv = RenderServer(port=0)      # 0 = ephemeral
    >>> srv.start()
    >>> srv.port
    >>> srv.stop()
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 verbose: bool = False, sample_root: Optional[str] = None,
                 max_body_bytes: int = 8 * 1024 * 1024,
                 max_render_seconds: float = 600.0, device="cuda"):
        """``sample_root``: the only directory server-submitted songs may
        load instrument WAVs from (None = songs with [instruments] are
        rejected).  ``max_body_bytes`` / ``max_render_seconds`` bound
        request size and output length (413 / 400 beyond them).
        ``device``: where every render runs (the card unless the caller
        passes ``device="cpu"``)."""
        dev = _device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.device = dev  # type: ignore[attr-defined]
        self._httpd.verbose = verbose  # type: ignore[attr-defined]
        self._httpd.sample_root = sample_root  # type: ignore[attr-defined]
        self._httpd.max_body_bytes = max_body_bytes  # type: ignore[attr-defined]
        self._httpd.max_render_seconds = max_render_seconds  # type: ignore[attr-defined]
        self._httpd.batcher = RenderBatcher(device=dev)  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def device(self) -> torch.device:
        return self._httpd.device  # type: ignore[attr-defined]

    @property
    def batcher(self) -> RenderBatcher:
        return self._httpd.batcher  # type: ignore[attr-defined]

    @property
    def sample_root(self) -> Optional[str]:
        return self._httpd.sample_root  # type: ignore[attr-defined]

    @sample_root.setter
    def sample_root(self, value: Optional[str]) -> None:
        self._httpd.sample_root = value  # type: ignore[attr-defined]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "RenderServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5.0)

    def serve_forever(self) -> None:
        self._httpd.serve_forever()


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="synthesizer_tpu_torch render server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--sample-root", default=None,
                    help="directory song [instruments] WAVs resolve under "
                         "(default: songs may not use instruments)")
    ap.add_argument("--max-render-seconds", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="where renders run (default: the card)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    srv = RenderServer(args.host, args.port, verbose=args.verbose,
                       sample_root=args.sample_root,
                       max_render_seconds=args.max_render_seconds,
                       device=args.device)
    print(f"render server listening on {args.host}:{srv.port} "
          f"({srv.device})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
