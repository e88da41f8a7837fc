"""Hold two trees of this repository against each other on one card.

    python3 -m synthesizer_tpu_torch.ab_smoke PARENT_DIR [CHANGE_DIR]

runs each tree's ``chip_smoke.py`` in the order parent, change, change,
parent (so that a drift of the card over the call shows as a difference
between a tree's two runs, not between the trees), each from its own root
so that each builds and loads its own kernels.  It prints, per tree and
run, the numbers of the ``{"kernels": [...]}`` line that the trees are
compared on, the sha256 of the three workloads' int16 bytes (rendered once
more by each tree's package after the timed runs, so that a parent whose
``chip_smoke.py`` prints no digest is held too), and ptxas' registers and
spill bytes and the count of SASS operations of each kernel in the tree's
built library (from ``cuobjdump -sass``).  It ends with one JSON line of
everything and a line that says whether the two trees' digests are equal.
A tree's run that fails, or digests that differ, make the exit code 1.

To make PARENT_DIR: ``mkdir -p build/parent && git archive <commit> | tar -x
-C build/parent`` (``build/`` is not committed).  CHANGE_DIR defaults to the
checkout this module lies in.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

#: the keys of a tree's kernels line that are printed side by side
KEYS = ("ms", "midi_ms", "midi_render_ms", "midi_render_flat_ms",
        "midi_setup_ms", "sparse_workload_render_ms", "midi_wall_ms",
        "midi_bound_ms", "midi_fallback_share")

#: renders config 5, the sparse workload and the MIDI file with the package
#: of the tree it is run in, and prints the sha256 of their int16 bytes
DIGESTS = """
import hashlib, json, torch
from synthesizer_tpu_torch import bench_song, midi
from synthesizer_tpu_torch.models.voicebank import VoiceBank, pack_voices
dev, SR = torch.device("cuda"), 44100
sha = lambda pcm: hashlib.sha256(pcm.cpu().numpy().tobytes()).hexdigest()
bank, vp, total = bench_song.song_bank(device=dev)
sv = bench_song.sparse_voices()
vps, lys = pack_voices(sv, SR, num_harmonics=8, sort_by_wave=True, device=dev)
bs = VoiceBank.for_voices(sv, SR, num_harmonics=8, layout=lys,
                          chunk_frames=bench_song.CHUNK_FRAMES,
                          nvoices=lys.nvoices, device=dev)
print(json.dumps({"digests": {
    "config5_sha256": sha(bank.to_int16(bank.render_song(vp, total))),
    "sparse_workload_sha256": sha(VoiceBank.to_int16(
        bs.render_song_sparse(vps, int(300.0 * SR)))),
    "midi_sha256": sha(midi.render_midi(bench_song.gm_file(3000, 180.0, 0),
                                        device=dev))}}))
"""


def sass_counts(root: Path) -> dict:
    """{kernel: SASS operations} of the newest library under root/build."""
    libs = sorted(glob.glob(str(root / "build" / "voicebank_render_*.so")),
                  key=os.path.getmtime)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not libs or not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", libs[-1]], capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            sym = found.group(1)
            name = ("setup_kernel" if "setup_kernel" in sym else
                    "render_kernel<true>" if "ILb1E" in sym else
                    "render_kernel<false>")
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    return counts


def digests(root: Path) -> dict:
    """``DIGESTS`` run in root, against root's package and kernels."""
    res = subprocess.run([sys.executable, "-c", DIGESTS], cwd=root,
                         capture_output=True, text=True)
    for line in res.stdout.splitlines():
        if line.startswith('{"digests"'):
            return json.loads(line)["digests"]
    return {"failed": (res.stdout + res.stderr)[-1000:]}


def run_tree(root: Path) -> dict:
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True)
    out = {"rc": res.returncode, "ptxas": {}}
    entry = None
    for line in res.stdout.splitlines():
        if line.startswith('{"kernels"'):
            out["kernels"] = json.loads(line)["kernels"]
        found = re.match(r"\s+ptxas: (setup_kernel|render_kernel<[^>]*>)",
                         line)
        if found:
            entry = found.group(1)
        if "ptxas" in line and entry:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_bytes", r"(\d+) bytes spill stores")):
                got = re.search(pat, line)
                if got:
                    out["ptxas"].setdefault(entry, {})[key] = int(got.group(1))
    if res.returncode != 0:
        out["tail"] = (res.stdout + res.stderr)[-2000:]
    out["sass_ops"] = sass_counts(root)
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    parent = Path(argv[0]).resolve()
    change = (Path(argv[1]) if len(argv) > 1
              else Path(__file__).resolve().parents[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    runs = []
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        got = run_tree(root)
        runs.append({"tree": label, **got})
        print(f"[{label}] rc {got['rc']}  ptxas {got['ptxas']}  "
              f"SASS operations {got['sass_ops']}")
        for kernel in got.get("kernels", ()):
            shown = {k: kernel[k] for k in KEYS if k in kernel}
            print(f"  {kernel['name']}: {shown}")
        if got["rc"] != 0:
            print(got["tail"])
    sums = {label: digests(root)
            for label, root in (("parent", parent), ("change", change))}
    for label, got in sums.items():
        print(f"[{label}] digests {got}")
    print(json.dumps({"card": card, "digests": sums, "runs": runs}))
    same = sums["parent"] == sums["change"] and "failed" not in sums["parent"]
    print("digests equal" if same else "DIGESTS DIFFER")
    return 0 if same and all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
