"""Render-server demo: start the HTTP service, request a patch and a voice
bank render over the wire, save the WAVs.

    python -m synthesizer_tpu_torch.examples.render_server_demo [outdir]
        [--device cpu]
"""

import http.client
import json
import os

from synthesizer_tpu_torch.examples._cli import parse
from synthesizer_tpu_torch.server import RenderServer


def post(port, path, body, ctype="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"{path}: HTTP {resp.status}: {data[:200]!r}")
    return data


def main(argv=None) -> None:
    args = parse(__doc__, argv, ".", "directory for the two WAV files")
    outdir = args.out
    os.makedirs(outdir, exist_ok=True)
    srv = RenderServer(port=0, device=args.device).start()
    try:
        wav = post(srv.port, "/render/patch", json.dumps({
            "duration": 1.5,
            "patch": {"node": "echo", "after": 0.25, "amount": 3,
                      "delay": 0.18, "decay": 0.5,
                      "source": {"node": "envelope", "attack": 0.005,
                                 "decay": 0.4, "sustain": 0.0,
                                 "sustain_level": 0.0, "release": 0.1,
                                 "source": {"node": "osc",
                                            "kind": "harmonics",
                                            "frequency": 220,
                                            "harmonics": [[1, 0.6], [2, 0.3],
                                                          [3, 0.15],
                                                          [5, 0.05]]}}}}))
        with open(os.path.join(outdir, "served_patch.wav"), "wb") as f:
            f.write(wav)

        wav = post(srv.port, "/render/voices", json.dumps({
            "duration": 2.0,
            "voices": [{"wave": "sawtooth_bl", "frequency": 110 * r,
                        "amplitude": 0.12, "start": 0.15 * i,
                        "duration": 1.2, "pan": (i % 5 - 2) / 2.5}
                       for i, r in enumerate([1, 1.5, 2, 3, 4, 5, 6, 8])]}))
        with open(os.path.join(outdir, "served_voices.wav"), "wb") as f:
            f.write(wav)
        print(f"wrote served_patch.wav, served_voices.wav to {outdir}/")
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
