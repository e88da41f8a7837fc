#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's Hopper kernel from ``synthesizer_tpu_torch/csrc`` (nvcc,
into ``build/``), drives the main path — config 5, the 64-voice 60 s song,
through ``VoiceBank.render_song`` and ``to_int16`` to a WAV file — and
holds the kernel against its plain PyTorch version on the card:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the kernel's build time and ptxas resource lines;
3. per-wave battery: kernel vs plain for each of the 13 waveforms, FM,
   glide, polyBLEP under glide, pluck excluded from glide, the wavetable
   gather and the mixed (ungrouped) layout;
4. config 5 at full width: the main path with its launch count, kernel vs
   plain <= 1 LSB at int16, streaming (render_chunk) == offline and
   run-to-run results bit-exact, the output's sha256 and peak;
5. scale: 1024 voices for 10 s, and a window of a 600 s song past 2^24
   frames, kernel vs plain <= 1 LSB;
6. timing: kernel and plain on config 5 with CUDA events (one warm-up,
   median of 5, taken in turns).

It prints a ``{"kernels": [...]}`` line and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  There is no CPU fallback: without a CUDA device it
exits non-zero at once.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100
FAILURES = []
#: sha256 of config 5's int16 output from the plain path on the CPU:
#: python -c "import hashlib; from synthesizer_tpu_torch import bench_song as b;
#:   k, vp, n = b.song_bank(device='cpu');
#:   print(hashlib.sha256(k.to_int16(k.render_song(vp, n)).numpy().tobytes()).hexdigest())"
CONFIG5_SHA256 = ("3294c70b55a4ba87991a4feefb9f38d6"
                  "04ee8ec402f1668b91d70d34581735d4")


def check(ok, what):
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")

    from synthesizer_tpu_torch import bench_song
    from synthesizer_tpu_torch.models.voicebank import (Voice, VoiceBank,
                                                        pack_voices)
    from synthesizer_tpu_torch.ops import kernels as K
    from synthesizer_tpu_torch.utils.wavio import read_wav, write_wav

    dev = torch.device("cuda")

    # -- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("[1] device")
    print(smi[0] if smi else "nvidia-smi: no output")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")

    # -- 2. build --------------------------------------------------------
    print("[2] build")
    t0 = time.perf_counter()
    path, log = K.build_library()
    K._library()
    print(f"  built {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    def to16(x):
        return VoiceBank.to_int16(x).to(torch.int32)

    def compare(name, kern, plain, lsb_max=1):
        torch.cuda.synchronize()
        err = (kern - plain).abs().max().item()
        lsb = (to16(kern) - to16(plain)).abs().max().item()
        finite = bool(torch.isfinite(kern).all())
        same = torch.equal(kern, plain)
        check(finite and lsb <= lsb_max,
              f"{name}: max f32 diff {err:.3g}, {lsb} LSB"
              f"{' (bit-exact)' if same else ''}, peak "
              f"{kern.abs().max().item():.4f}")
        return err, lsb

    def bank_pair(voices, nframes, grouped=True):
        if grouped:
            vp, ly = pack_voices(voices, SR, num_harmonics=8,
                                 sort_by_wave=True, device=dev)
        else:
            vp, ly = pack_voices(voices, SR, num_harmonics=8, device=dev), None
        bank = VoiceBank.for_voices(voices, SR, chunk_frames=nframes,
                                    num_harmonics=8, layout=ly, device=dev)
        layout = bank._kernel_layout(vp)
        kern = bank.render_chunk(vp, 0)
        plain = K.render_stereo_reference(vp, 0, nframes=nframes,
                                          samplerate=SR, layout=layout,
                                          use_glide=bank.use_glide)
        return kern, plain

    # -- 3. per-wave battery ---------------------------------------------
    print("[3] per-wave battery (kernel vs plain, 1 s)")
    rng = np.random.default_rng(5)
    waves = ["sine", "triangle", "square", "sawtooth", "pulse", "semicircle",
             "pointy", "white_noise", "harmonics", "sawtooth_bl", "square_bl",
             "wavetable", "pluck"]

    def wave_voices(wave, count=8, **extra):
        out = []
        for i in range(count):
            kw = dict(extra)
            if wave == "harmonics":
                kw["harmonics"] = [1.0, 0.5, 0.33, 0.25, 0.2, 0.16, 0.14, 0.125]
            if wave == "pulse":
                kw["pulse_width"] = float(rng.uniform(0.1, 0.9))
            if wave in ("white_noise", "pluck"):
                kw["seed"] = int(rng.integers(0, 1000))
            if wave == "pluck":
                kw["damping"] = float(rng.uniform(0.3, 3.0))
            if wave == "wavetable":
                kw["table"] = tuple(float(x) for x in rng.uniform(
                    -1, 1, int(rng.integers(3, 300))))
            out.append(Voice(
                wave=wave, frequency=float(rng.uniform(40, 4000)),
                amplitude=float(rng.uniform(0.05, 0.12)),
                phase=float(rng.uniform(0, 1)), pan=float(rng.uniform(-1, 1)),
                start=0.1 * i, duration=float(rng.uniform(0.1, 0.3)),
                attack=0.01, decay=0.03, sustain_level=0.6, release=0.05,
                **kw))
        return out

    for w in waves:
        compare(f"bank/{w}", *bank_pair(wave_voices(w), SR))
    fm = [Voice(w, 110.0 * (i + 1), amplitude=0.1, pan=0.3 * i - 0.6,
                fm_frequency=3.0 + i, fm_depth=0.005 * (i + 1),
                fm_phase=0.1 * i, start=0.1 * i, duration=0.4)
          for i, w in enumerate(["sine", "triangle", "square", "sawtooth",
                                 "pulse", "semicircle"])]
    compare("bank/fm", *bank_pair(fm, SR))
    glide = [Voice(wave=w, frequency=660.0, glide_from=330.0, glide_time=0.04,
                   start=0.005, duration=0.2, amplitude=0.2)
             for w in ("sine", "sawtooth", "square", "triangle")]
    glide.append(Voice(wave="sine", frequency=440.0, amplitude=0.2))
    compare("bank/glide", *bank_pair(glide, SR))
    blep = [Voice(wave=w, frequency=1760.0, glide_from=110.0, glide_time=0.15,
                  start=0.005, duration=0.2, amplitude=0.4)
            for w in ("sawtooth_bl", "square_bl")]
    compare("bank/glide_blep", *bank_pair(blep, SR))
    base = dict(wave="pluck", frequency=440.0, start=0.005, duration=0.3,
                amplitude=0.5, seed=7)
    kg, pg = bank_pair([Voice(glide_from=110.0, glide_time=0.05, **base)], SR)
    kn, _ = bank_pair([Voice(**base)], SR)
    compare("bank/pluck_glide", kg, pg)
    check(torch.equal(kg, kn), "bank/pluck_glide_excluded: glided pluck == "
          "unglided pluck, bit-exact")
    compare("bank/wavetable_gather", *bank_pair(
        wave_voices("wavetable", count=16, fm_frequency=4.0, fm_depth=0.01), SR))
    compare("bank/mixed_demo", *bank_pair(bench_song.demo_voices(64), SR,
                                          grouped=False))
    mixed = [v for w in waves for v in wave_voices(w, count=2)]
    compare("bank/mixed_all_waves", *bank_pair(mixed, SR, grouped=False))

    # -- 4. config 5 at full width ---------------------------------------
    print("[4] config 5: 64 voices, 60 s, chunk 131072, nharm 8")
    bank, vp, total = bench_song.song_bank(device=dev)
    layout = bank._kernel_layout(vp)
    print(f"  layout: {len(layout.groups)} groups {layout.groups}")
    K.render_stereo.launches = 0
    t0 = time.perf_counter()
    mix = bank.render_song(vp, total)
    pcm = bank.to_int16(mix)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = K.render_stereo.launches
    pcm_np = pcm.cpu().numpy()
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "config5.wav")
        write_wav(wav, pcm_np, SR, 2, 2)
        back, rate, width, nch = read_wav(wav)
    check(launches > 0, f"main path launched the kernel {launches} time(s) "
          f"({main_s:.3f} s host time for the first render + to_int16)")
    check(pcm.shape == (total, 2) and pcm.dtype == torch.int16
          and bool(torch.isfinite(mix).all()),
          f"output int16 {tuple(pcm.shape)}, finite f32 mix")
    check(rate == SR and width == 2 and nch == 2
          and np.array_equal(back, pcm_np), "WAV written and read back equal")
    plain = K.render_stereo_reference(vp, 0, nframes=total, samplerate=SR,
                                      layout=layout)
    max_err, max_lsb = compare("config5 kernel vs plain", mix, plain)
    chunks = [bank.render_chunk(vp, i * bank.chunk_frames)
              for i in range(-(-total // bank.chunk_frames))]
    streamed = torch.cat(chunks)[:total]
    check(len(chunks) == 21 and torch.equal(streamed, mix),
          f"render_chunk x{len(chunks)} concatenated == render_song, bit-exact")
    again = bank.render_song(vp, total)
    check(torch.equal(again, mix), "two render_song runs bit-identical")
    # the CPU plain path is the one the tests hold against the JAX
    # reference: tie the card's output to it on one chunk mid-song
    cpu_bank = VoiceBank.for_voices(bench_song.build_song(64, 60.0), SR,
                                    chunk_frames=bank.chunk_frames,
                                    num_harmonics=bank.num_harmonics,
                                    layout=bank.layout, device="cpu")
    c0 = 10 * bank.chunk_frames
    compare(f"config5 chunk at frame {c0}, kernel vs CPU plain",
            mix[c0:c0 + bank.chunk_frames].cpu(),
            cpu_bank.render_chunk(vp.to("cpu"), c0))
    peak = int(np.abs(pcm_np.astype(np.int64)).max())
    check(peak > 1000, f"peak {peak}")
    sha = hashlib.sha256(pcm_np.tobytes()).hexdigest()
    check(sha == CONFIG5_SHA256, f"sha256(int16) {sha} == the CPU plain "
          f"path's {CONFIG5_SHA256[:16]}...")

    # -- 5. scale --------------------------------------------------------
    print("[5] scale")
    b2, vp2, total2 = bench_song.song_bank(1024, 10.0, device=dev)
    k2 = b2.render_song(vp2, total2)
    p2 = K.render_stereo_reference(vp2, 0, nframes=total2, samplerate=SR,
                                   layout=b2._kernel_layout(vp2))
    e2, l2 = compare(f"1024 voices x 10 s ({b2._kernel_layout(vp2).nvoices} "
                     f"packed)", k2, p2)
    b3, vp3, _ = bench_song.song_bank(64, 600.0, device=dev)
    n0 = 400 * SR
    k3 = b3.render_chunk(vp3, n0)
    p3 = K.render_stereo_reference(vp3, n0, nframes=b3.chunk_frames,
                                   samplerate=SR, layout=b3._kernel_layout(vp3))
    e3, l3 = compare(f"600 s song, window at n0={n0} (> 2^24 = {2 ** 24})",
                     k3, p3)
    max_err, max_lsb = max(max_err, e2, e3), max(max_lsb, l2, l3)

    # -- 6. timing -------------------------------------------------------
    print("[6] timing on config 5 (CUDA events, median of 5, in turns)")

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def kernel_run():
        bank.render_song(vp, total)

    def plain_run():
        K.render_stereo_reference(vp, 0, nframes=total, samplerate=SR,
                                  layout=layout)

    timed(kernel_run)
    timed(plain_run)
    kt, pt = [], []
    for i in range(5):
        order = (kernel_run, plain_run) if i % 2 == 0 else (plain_run, kernel_run)
        for fn in order:
            (kt if fn is kernel_run else pt).append(timed(fn))
    ms, plain_ms = statistics.median(kt), statistics.median(pt)
    audio_s = total / SR
    print(f"  kernel {ms:.3f} ms ({audio_s / (ms / 1e3):.1f}x realtime), "
          f"runs {[round(t, 3) for t in kt]}")
    print(f"  plain  {plain_ms:.3f} ms ({audio_s / (plain_ms / 1e3):.1f}x "
          f"realtime), runs {[round(t, 3) for t in pt]}")

    print(json.dumps({"kernels": [{
        "name": "voicebank_render", "route": "cuda",
        "source": "synthesizer_tpu_torch/csrc/voicebank_render.cu",
        "replaces": "synthesizer_tpu/ops/kernels.py:58",
        "tpu": "synthesizer_tpu/ops/kernels.py::_kernel",
        "launches": launches, "max_abs_err": max_err, "max_lsb": max_lsb,
        "ms": ms, "plain_ms": plain_ms}]}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
