"""The port's render server (``synthesizer_tpu_torch.server``) against the
JAX package's on the CPU, over real sockets.

Tolerances: each endpoint's WAV within 1 LSB of the reference server's for
the same request (the bank, patch and song renders are within 1 LSB of the
JAX package); coalesced ``/render/voices`` responses equal their solo
renders bit for bit (each bus sums its own voices in packed order); error
responses carry the reference's status codes and messages.
"""

import http.client
import io
import json
import threading
import time
import wave

import numpy as np
import pytest
import torch

from synthesizer_tpu.server import RenderServer as JServer
from synthesizer_tpu_torch import server as server_mod
from synthesizer_tpu_torch.server import RenderServer, spec_from_json

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("samples")
    from synthesizer_tpu_torch import WaveSynth
    ws = WaveSynth(44100, 2, device="cpu")
    ws.sine(60, 0.1, amplitude=0.8).fadeout(0.08).write_wav(
        str(root / "kick.wav"))
    t = RenderServer(port=0, sample_root=str(root), device="cpu").start()
    j = JServer(port=0, sample_root=str(root)).start()
    yield t, j
    t.stop()
    j.stop()


def request(server, method, path, body=None, ctype="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    if isinstance(body, str):
        body = body.encode()
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if body is not None else {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def frames(data):
    with wave.open(io.BytesIO(data)) as w:
        a = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        return a.reshape(-1, w.getnchannels()), w.getframerate()


def _lsb(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
        if a.size else 0


def _midi():
    from synthesizer_tpu_torch.midi import MidiNote, write_midi
    return write_midi([MidiNote(0.0, 0.3, 60, 100, 0),
                       MidiNote(0.1, 0.25, 67, 90, 1),
                       MidiNote(0.2, 0.2, 36, 110, 9)])


SONG_INI = """
[song]
bpm = 240
ticks = 4
patterns = a

[instruments]
kick = kick.wav

[synth.lead]
wave = square_bl
amplitude = 0.3
release = 0.05

[pattern.a]
kick = x... x...
lead = C4 .. E4 ..
"""

#: endpoint -> (body, content type)
ENDPOINTS = {
    "patch": (json.dumps({
        "duration": 0.25, "samplerate": 22050,
        "patch": {"node": "envelope", "attack": 0.02, "decay": 0.05,
                  "sustain": 0.1, "sustain_level": 0.6, "release": 0.05,
                  "source": {"node": "osc", "kind": "sine", "frequency": 440,
                             "amplitude": 0.8,
                             "fm_lfo": {"node": "osc", "kind": "sine",
                                        "frequency": 6,
                                        "amplitude": 0.01}}}}),
        "application/json"),
    "voices": (json.dumps({
        "duration": 0.3,
        "voices": [{"wave": "square_bl", "frequency": 220, "amplitude": 0.3,
                    "start": 0.0, "duration": 0.2, "pan": -0.5},
                   {"wave": "harmonics", "frequency": 110, "amplitude": 0.3,
                    "duration": 0.2, "harmonics": [1.0, 0.5, 0.25],
                    "pan": 0.5, "start": 0.05}]}), "application/json"),
    "midi": (None, "audio/midi"),
    "song": (SONG_INI, "text/plain"),
}


@pytest.mark.parametrize("endpoint", sorted(ENDPOINTS))
def test_endpoint_matches_the_reference_server(servers, endpoint):
    t, j = servers
    body, ctype = ENDPOINTS[endpoint]
    body = _midi() if body is None else body
    st, ct, got = request(t, "POST", f"/render/{endpoint}", body, ctype)
    sj, cj, want = request(j, "POST", f"/render/{endpoint}", body, ctype)
    assert (st, ct) == (sj, cj) == (200, "audio/wav")
    a, ra = frames(got)
    b, rb = frames(want)
    assert ra == rb and a.shape == b.shape
    assert np.abs(a).max() > 1000
    assert _lsb(a, b) <= 1


def test_health_names_the_device(servers):
    t, _ = servers
    status, ctype, data = request(t, "GET", "/health")
    info = json.loads(data)
    assert (status, ctype) == (200, "application/json")
    assert info == {"status": "ok", "device": "cpu", "platform": "cpu",
                    "name": "cpu", "samplerate": 44100}


#: (method, path, body) of requests the servers must refuse
BAD = [
    ("POST", "/render/patch", "{not json"),
    ("POST", "/render/patch", json.dumps({"duration": 1,
                                          "patch": {"node": "nope"}})),
    ("POST", "/render/patch", json.dumps({"duration": 1e6, "patch": {
        "node": "osc", "frequency": 440}})),
    ("POST", "/render/patch", json.dumps({"duration": 1.0, "samplerate": 0,
                                          "patch": {"node": "osc"}})),
    ("POST", "/render/voices", json.dumps({"duration": 1, "voices": []})),
    ("POST", "/render/voices", json.dumps({"duration": 1.0,
                                           "samplerate": 2_000_000_000,
                                           "voices": [{"wave": "sine"}]})),
    ("POST", "/render/voices", json.dumps({"duration": 1e6,
                                           "voices": [{"wave": "sine"}]})),
    ("POST", "/render/voices", '{"voices": [{"wave": "nope"}], '
                               '"duration": 1}'),
    ("POST", "/render/midi", "nope"),
    ("POST", "/render/song", "[song]\nbpm = 120\nticks = 4\n"
                             "patterns = missing\n"),
    ("POST", "/render/song", "[paths]\nsamples = /\n"),
    ("POST", "/render/song", "[song]\npatterns = a\n[instruments]\n"
                             "k = ../../etc/passwd\n"),
    ("POST", "/render/song", "[song]\npatterns = a\n[instruments]\n"
                             "k = /etc/passwd\n"),
    ("POST", "/render/song", "[song]\npatterns = a\n[fx]\n"
                             "reverb = tail=1000\n"),
    ("POST", "/render/nope", "{}"),
    ("GET", "/nope", None),
]


@pytest.mark.parametrize("k", range(len(BAD)))
def test_refusals_match_the_reference(servers, k):
    """400 and 404 with the reference's JSON bodies."""
    method, path, body = BAD[k]
    t, j = servers
    got = request(t, method, path, body)
    want = request(j, method, path, body)
    assert got[0] in (400, 404) and got[1] == "application/json"
    assert got == want


def test_body_limit_and_sample_root(servers):
    """413 for a body over max_body_bytes (after draining it); a server
    without a sample root refuses songs that name files."""
    t, j = servers
    big = b"x" * (8 * 1024 * 1024 + 1)
    got = request(t, "POST", "/render/song", big, "text/plain")
    assert got == request(j, "POST", "/render/song", big, "text/plain")
    assert got[:2] == (413, "application/json")
    bare = RenderServer(port=0, device="cpu").start()
    try:
        status, _, data = request(bare, "POST", "/render/song", SONG_INI)
        assert status == 400 and b"no sample_root" in data
    finally:
        bare.stop()


def test_concurrent_voices_coalesce_and_match_solo(servers):
    """Requests that queue while the batcher renders are coalesced into one
    grouped render (``render_song_grouped``, a bus per request), and each
    response equals its solo render bit for bit."""
    t, _ = servers
    batcher = t.batcher
    gate = threading.Event()
    orig = batcher._execute
    batcher._execute = lambda batch: (gate.wait(10.0), orig(batch))[1]
    b0, r0, c0 = batcher.batches, batcher.requests, batcher.coalesced

    def body(i):
        return json.dumps({"duration": 0.05, "samplerate": 22050, "voices": [
            {"wave": ("sine", "square_bl", "triangle", "sawtooth")[i % 4],
             "frequency": 220.0 * (i + 1), "amplitude": 0.4,
             "pan": (i - 1.5) / 2, "duration": 0.03 + 0.005 * i}]})

    N = 4
    results = [None] * N

    def worker(i):
        results[i] = request(t, "POST", "/render/voices", body(i))
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
    for th in threads:
        th.start()
    deadline = time.time() + 10.0
    while time.time() < deadline:
        with batcher._cv:
            if len(batcher._pending) + (batcher.requests - r0) >= N - 1:
                break
        time.sleep(0.005)
    gate.set()
    for th in threads:
        th.join(timeout=60.0)
    batcher._execute = orig
    assert all(r is not None and r[0] == 200 for r in results)
    assert batcher.requests - r0 == N
    assert batcher.batches - b0 < N and batcher.coalesced - c0 >= 2
    for i, r in enumerate(results):
        solo = request(t, "POST", "/render/voices", body(i))
        a, b = frames(r[2])[0], frames(solo[2])[0]
        assert a.shape == b.shape == (int(0.05 * 22050), 2)
        np.testing.assert_array_equal(a, b)


def test_spec_from_json_and_the_default_device():
    from synthesizer_tpu_torch.models import spec as S
    node = spec_from_json({"node": "mix", "sources": [
        {"node": "osc", "kind": "triangle", "frequency": 100}, 0.25]})
    assert isinstance(node, S.Mix) and node.sources[1] == S.Const(0.25)
    vs = server_mod.voices_from_json([{"wave": "sine", "frequency": 440,
                                       "other": 1}])
    assert vs[0].frequency == 440
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RenderServer(port=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server_mod.RenderBatcher()
