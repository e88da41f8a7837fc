"""Hold two trees of this repository against each other on one card.

    python3 -m synthesizer_tpu_torch.ab_smoke [--kernels | --reverb] PARENT_DIR [CHANGE_DIR]

runs each tree's ``chip_smoke.py`` in the order parent, change, change,
parent (so that a drift of the card over the call shows as a difference
between a tree's two runs, not between the trees), each from its own root
so that each builds and loads its own kernels.  It prints, per tree and
run, the numbers of the ``{"kernels": [...]}`` line that the trees are
compared on, the sha256 of the int16 bytes of three flat renders and two
bus renders (rendered once more by each tree's package after the timed
runs, so that a parent whose ``chip_smoke.py`` prints no digest is held
too), and ptxas' registers and
spill bytes and the count of SASS operations of each kernel in the tree's
built library (from ``cuobjdump -sass``).  It ends with one JSON line of
everything and a line that says whether the two trees' digests are equal.
A tree's run that fails, or digests that differ, make the exit code 1.

With ``--kernels`` each run is ``KERNEL_TIMES`` instead of the whole
``chip_smoke.py`` (about a minute a run instead of eight): the tree's
build, ptxas' lines and the kernels' device times on config 5, the sparse
workload and the MIDI file, and the bus renders' (``BUS_BANKS``: the demo
song 14 times, the MIDI bank on three buses, the server's batch of eight
requests on 1, 2 and 8 buses) under the profiler, in the same order of
runs.
With ``--reverb`` each run is ``REVERB_TIMES``: the streaming reverb (the
stereo Freeverb networks from zero state, in chunks of 1470) with the
tree's ``ops.effects``, its host wall clock and its device operations and
busy time a chunk, and how far it lies from the whole-signal reverb.

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
        "midi_bound_ms", "midi_fallback_share", "bus_ms", "bus_curves_ms",
        "server_batch_ms", "bus_sweep_less_writes_ms", "song_mix_ms")

#: the bus renders' banks, each -> (bank, vp, seg, nseg, frames), built with
#: the package of the tree the snippet runs in (so only with what every
#: tree since the buses has): the demo song 14 times as long (its synth
#: voices, the clean bus and one a track with fx), the MIDI file's bank with
#: each note on the bus of its channel mod 3 (padding rows on bus 0), and
#: the server's batch of eight config-5 requests, each transposed, tagged
#: as ``RenderBatcher`` tags them (request k on bus k * nseg // 8)
BUS_BANKS = """
import dataclasses, tempfile
import numpy as np
import torch
from synthesizer_tpu_torch import bench_song, midi
from synthesizer_tpu_torch import sequencer as Q
from synthesizer_tpu_torch.models.voicebank import VoiceBank, pack_voices
def demo_bus_bank(dev):
    kit = tempfile.mkdtemp(prefix="bus_demo")
    bench_song.make_demo_kit(kit, device=dev)
    song = Q.Song.from_string(bench_song.repeated(bench_song.DEMO_INI, 14),
                              kit, device=dev)
    voices, tracks = song.compile_synth_voices(return_tracks=True)
    bank, vp, seg, fx = song._synth_fx_groups(voices, tracks, 32768)
    return bank, vp, seg, len(fx) + 1, song.duration_frames(0.3)
def midi_bus_bank(dev, data):
    notes = midi.parse_midi(data, release_grace=midi.release_grace_for(None))
    voices = midi.midi_to_voices(notes)
    vp = pack_voices(voices, 44100, num_harmonics=8, device=dev)
    V = vp.wave.shape[0]
    bank = VoiceBank.for_voices(voices, 44100, num_harmonics=8, nvoices=V,
                                device=dev)
    seg = np.zeros(V, np.int32)
    seg[:len(notes)] = [n.channel % 3 for n in notes]
    return (bank, vp, torch.from_numpy(seg).to(dev), 3,
            midi.song_frames(voices, 44100))
def server_bus_bank(dev, nseg=8):
    song = bench_song.build_song(64, 60.0)
    allv, tags = [], []
    for k in range(8):
        up = 2 ** ((k + 1) / 12)
        allv += [dataclasses.replace(v, frequency=v.frequency * up)
                 for v in song]
        tags += [k * nseg // 8] * len(song)
    vp, layout, seg = pack_voices(allv, 44100, num_harmonics=8,
                                  sort_by_wave=True, tags=tags, device=dev)
    bank = VoiceBank.for_voices(allv, 44100, num_harmonics=8, layout=layout,
                                nvoices=layout.nvoices, device=dev)
    return bank, vp, seg, nseg, int(60.0 * 44100)
def grouped(b):
    return b[0].render_song_grouped(b[1], b[2], b[3], b[4])
"""


def bus_banks() -> dict:
    """``BUS_BANKS``' functions, with this tree's package."""
    ns = {}
    exec(BUS_BANKS, ns)
    return ns


#: renders config 5, the sparse workload, the MIDI file and the two bus
#: renders with the package of the tree it is run in, and prints the sha256
#: of their int16 bytes
DIGESTS = BUS_BANKS + """
import hashlib, json
dev, SR = torch.device("cuda"), 44100
sha = lambda pcm: hashlib.sha256(pcm.cpu().numpy().tobytes()).hexdigest()
bank, vp, total = bench_song.song_bank(device=dev)
sv = bench_song.sparse_voices()
vps, lys = pack_voices(sv, SR, num_harmonics=8, sort_by_wave=True, device=dev)
bs = VoiceBank.for_voices(sv, SR, num_harmonics=8, layout=lys,
                          chunk_frames=bench_song.CHUNK_FRAMES,
                          nvoices=lys.nvoices, device=dev)
data = bench_song.gm_file(3000, 180.0, 0)
print(json.dumps({"digests": {
    "config5_sha256": sha(bank.to_int16(bank.render_song(vp, total))),
    "sparse_workload_sha256": sha(VoiceBank.to_int16(
        bs.render_song_sparse(vps, int(300.0 * SR)))),
    "midi_sha256": sha(midi.render_midi(data, device=dev).torch_frames),
    "bus_demo_sha256": sha(VoiceBank.to_int16(grouped(demo_bus_bank(dev)))),
    "bus_midi_sha256": sha(VoiceBank.to_int16(
        grouped(midi_bus_bank(dev, data))))}}))
"""


def kernel_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol (or a ptxas line that holds
    it): ``setup_kernel``, ``span_kernel`` (the bus render's span pass),
    or ``render_kernel<curves>`` with ``, buses`` for the bus mode (a tree
    from before the buses has the curve flag only)."""
    if "setup_kernel" in symbol:
        return "setup_kernel"
    if "span_kernel" in symbol:
        return "span_kernel"
    found = re.search(r"ILb([01])E(?:Lb([01])E)?", symbol)
    curves = bool(found) and found.group(1) == "1"
    buses = bool(found) and found.group(2) == "1"
    return (f"render_kernel<{'true' if curves else 'false'}"
            f"{', buses' if buses else ''}>")


#: the kernels' device times with the package of the tree it is run in:
#: config 5 (render and setup kernels), the sparse workload and the MIDI
#: file (render kernel), and the bus renders of ``BUS_BANKS`` (the render
#: kernel and, where the tree has it, its span pass), profiler, printed as
#: chip_smoke.py prints them (ptxas' lines raw: ``run_tree`` names their
#: kernels); ``bus_sweep_less_writes_ms`` is each bus count's time less
#: its output's bytes over 3.35 TB/s
KERNEL_TIMES = BUS_BANKS + """
import json
from torch.profiler import ProfilerActivity, profile
from synthesizer_tpu_torch.ops import kernels as K
_, log = K.build_library()
for line in log.splitlines():
    if ("Compiling entry" in line or "registers" in line
            or "spill" in line):
        print("  ptxas:", line.strip())
dev, SR = torch.device("cuda"), 44100
def ms(fn, words, reps):
    words = (words,) if isinstance(words, str) else words
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(w in e.key for w in words)) / 1e3 / reps
bus = ("render_kernel", "span_kernel")
bank, vp, total = bench_song.song_bank(device=dev)
sv = bench_song.sparse_voices()
vps, lys = pack_voices(sv, SR, num_harmonics=8, sort_by_wave=True, device=dev)
bs = VoiceBank.for_voices(sv, SR, num_harmonics=8, layout=lys,
                          chunk_frames=bench_song.CHUNK_FRAMES,
                          nvoices=lys.nvoices, device=dev)
data = bench_song.gm_file(3000, 180.0, 0)
song = lambda: bank.render_song(vp, total)
sparse = lambda: bs.render_song_sparse(vps, int(300.0 * SR))
mid = lambda: midi.render_midi(data, device=dev)
demo, midb = demo_bus_bank(dev), midi_bus_bank(dev, data)
sweep = {}
for n in (1, 2, 8):
    batch = server_bus_bank(dev, n)
    sweep[n] = ms(lambda: grouped(batch), bus, 10)
print(json.dumps({"kernels": [
    {"name": "voicebank_setup", "ms": ms(song, "setup_kernel", 20),
     "midi_ms": ms(mid, "setup_kernel", 5)},
    {"name": "voicebank_render", "ms": ms(song, "render_kernel", 20),
     "sparse_workload_render_ms": ms(sparse, "render_kernel", 20),
     "midi_render_ms": ms(mid, "render_kernel", 5),
     "bus_ms": ms(lambda: grouped(demo), bus, 10),
     "bus_curves_ms": ms(lambda: grouped(midb), bus, 10),
     "server_batch_ms": sweep[8], "bus_sweep_ms": sweep,
     "bus_sweep_less_writes_ms": {
         n: t - int(60.0 * 44100) * n * 8 / 3.35e12 * 1e3
         for n, t in sweep.items()}}]}))
"""


#: the streaming reverb of ``ops.effects`` in the tree it is run in: both
#: channels' networks from zero state over CHUNKS chunks of 1470 frames of
#: seeded noise -- one ``reverb_networks_apply`` a chunk where the tree has
#: it, else one ``reverb_network_apply`` a channel -- host wall clock a
#: chunk (median of 3 passes), device operations and busy time a chunk
#: under the profiler, and the largest difference from the whole-signal
#: networks (``_reverb_networks_whole``)
REVERB_TIMES = """
import json, statistics, time, torch
from torch.profiler import ProfilerActivity, profile
from synthesizer_tpu_torch.ops import coeffs as C, effects as E
dev, SR, CHUNK, CHUNKS = torch.device("cuda"), 44100, 1470, 60
gen = torch.Generator().manual_seed(0)
mono = (torch.rand(CHUNK * CHUNKS, generator=gen) - 0.5).to(dev)
feedback, damp, _, _ = C.reverb_params(0.8, 0.5, 0.3, 1.0)
nets = [C.reverb_delays(SR, ch) for ch in range(2)]
def stream():
    states = [E.reverb_zero_state(c, a, dev) for c, a in nets]
    outs = []
    for k in range(CHUNKS):
        x = mono[k * CHUNK:(k + 1) * CHUNK]
        if hasattr(E, "reverb_networks_apply"):
            states, r = E.reverb_networks_apply(states, x, nets, feedback,
                                                damp)
        else:
            r = []
            for i, (c, a) in enumerate(nets):
                states[i], y = E.reverb_network_apply(states[i], x, c, a,
                                                      feedback, damp)
                r.append(y)
        outs.append(torch.stack(r))
    return torch.cat(outs, dim=1)
got = stream()
whole = torch.stack(E._reverb_networks_whole(mono, nets, feedback, damp))
torch.cuda.synchronize()
wall = []
for _ in range(3):
    t = time.perf_counter()
    stream()
    torch.cuda.synchronize()
    wall.append((time.perf_counter() - t) * 1e3 / CHUNKS)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    stream()
    torch.cuda.synchronize()
ops = busy = 0.0
for ev in prof.key_averages():
    if str(getattr(ev, "device_type", "")).split(".")[-1] == "CUDA":
        ops += ev.count
        busy += ev.self_device_time_total / 1e3
print(json.dumps({"reverb": {
    "chunks": CHUNKS, "wall_ms_a_chunk": statistics.median(wall),
    "wall_ms_a_chunk_range": [min(wall), max(wall)],
    "device_operations_a_chunk": ops / CHUNKS,
    "device_busy_ms_a_chunk": busy / CHUNKS,
    "max_abs_diff_from_whole": float((got - whole).abs().max()),
    "peak": float(whole.abs().max())}}))
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
            name = kernel_name(found.group(1))
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


def run_tree(root: Path, snippet: str = "") -> dict:
    """One run in root: ``chip_smoke.py``, or ``snippet`` given."""
    cmd = ["-c", snippet] if snippet else ["chip_smoke.py"]
    res = subprocess.run([sys.executable, *cmd], cwd=root,
                         capture_output=True, text=True)
    out = {"rc": res.returncode, "ptxas": {}}
    entry = None
    for line in res.stdout.splitlines():
        if line.startswith('{"kernels"'):
            out["kernels"] = json.loads(line)["kernels"]
        if line.startswith('{"reverb"'):
            out["reverb"] = json.loads(line)["reverb"]
        found = re.match(r"\s+ptxas: (setup_kernel|render_kernel<[^>]*>)",
                         line)
        if "Compiling entry" in line:
            entry = kernel_name(line)
        elif found:
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
    modes = {"--kernels": KERNEL_TIMES, "--reverb": REVERB_TIMES}
    snippet = next((modes[a] for a in argv if a in modes), "")
    argv = [a for a in argv if a not in modes]
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
        got = run_tree(root, snippet)
        runs.append({"tree": label, **got})
        print(f"[{label}] rc {got['rc']}  ptxas {got['ptxas']}  "
              f"SASS operations {got['sass_ops']}")
        for kernel in got.get("kernels", ()):
            shown = {k: kernel[k] for k in KEYS if k in kernel}
            print(f"  {kernel['name']}: {shown}")
        if "reverb" in got:
            print(f"  streaming reverb: {got['reverb']}")
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
