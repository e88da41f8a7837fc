#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's two Hopper kernels (``voicebank_setup`` and
``voicebank_render``, one source in ``synthesizer_tpu_torch/csrc``, nvcc
into ``build/``), drives the main path — config 5, the 64-voice 60 s song,
through ``VoiceBank.render_song`` and ``to_int16`` to a WAV file — and
holds both kernels against their plain PyTorch versions on the card:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the build time and ptxas resource lines of both kernels;
3. per-wave battery: kernel vs plain for each of the 13 waveforms, FM,
   glide, polyBLEP under glide, pluck excluded from glide, the wavetable
   gather and the mixed (ungrouped) layout;
4. cull battery: notes starting and ending on, just before and just after
   tile boundaries, with attack, decay, release or gate 0, at frame 0 and
   past 2^24; voices that are not cull-safe (non-finite amplitude, bias,
   harmonic or table value, pluck with negative damping), whose non-finite
   samples the kernel must reproduce; a 5000-voice bank; each with the
   setup kernel bit-exact to ``voice_constants`` and the voice-tiles the
   render evaluated equal to ``active_voice_tiles``;
5. config 5 at full width: the main path with both kernels' launch counts,
   kernel vs plain bit-exact, streaming (render_chunk) == offline and
   run-to-run results bit-exact, the output's sha256 and peak, and the
   voice-frames evaluated (<= 6% of all, equal to the plain predicate);
6. scale: 1024 voices for 10 s, and a window of a 600 s song past 2^24
   frames, kernel vs plain bit-exact;
7. timing: both kernels' device time (profiler), ``render_song`` over 20
   back-to-back calls (CUDA events), one 131072-frame ``render_chunk``,
   the main path's host wall clock to the int16 on the host with its
   device-time breakdown, the plain versions, and each kernel's bound.

It prints a ``{"kernels": [...]}`` line and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  There is no CPU fallback: without a CUDA device it
exits non-zero at once.
"""

import hashlib
import json
import math
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
#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and f32 operations/s
#: outside the tensor cores (67 TFLOP/s counts an FMA as two; the kernels
#: issue no FMA, so this bound is generous by up to 2x)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#: f32/int operations per audible voice-frame, counted from
#: csrc/voicebank_render.cu (each add, mul, compare, select, conversion
#: counts one; sin_turns is 16, expf about 8, an integer division about 20):
#: phase, note frame, ADSR, gain and pan sum for every voice ...
OPS_COMMON = 23
#: ... the FM phase offset where the voice has FM, the glide chirp ...
OPS_FM, OPS_GLIDE = 32, 14
#: ... and the waveform (8: per partial; 12: per sounding partial)
OPS_WAVE = {0: 18, 1: 6, 2: 2, 3: 4, 4: 2, 5: 9, 6: 8, 7: 32, 8: 21, 9: 22,
            10: 38, 11: 12, 12: 32}


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
    card = smi[0] if smi else "nvidia-smi: no output"
    print("[1] device")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")

    # -- 2. build --------------------------------------------------------
    print("[2] build")
    t0 = time.perf_counter()
    path, log = K.build_library()
    K._library()
    print(f"  built {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "Compiling entry" in line:
            print("  ptxas:", "setup_kernel" if "setup_kernel" in line
                  else "render_kernel")
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    def to16(x):
        return VoiceBank.to_int16(x).to(torch.int32)

    def compare(name, kern, plain, exact=True):
        """Kernel vs plain on the card: bit-exact required (the same f32
        operations in the same order).  Against the CPU plain path
        (exact=False): within 1 LSB at int16, as the CPU's libm may differ."""
        torch.cuda.synchronize()
        err = (kern - plain).abs().max().item()
        lsb = (to16(kern) - to16(plain)).abs().max().item()
        finite = bool(torch.isfinite(kern).all())
        same = torch.equal(kern, plain)
        check(finite and (same if exact else lsb <= 1),
              f"{name}: max f32 diff {err:.3g}, {lsb} LSB"
              f"{' (bit-exact)' if same else ''}, peak "
              f"{kern.abs().max().item():.4f}")
        return err

    def same_nonfinite(name, kern, plain):
        """For banks with non-finite parameters: the same NaN positions and
        bit-equal values everywhere else (infinities included)."""
        torch.cuda.synchronize()
        nan_k, nan_p = torch.isnan(kern), torch.isnan(plain)
        rest = ~nan_p
        ok = torch.equal(nan_k, nan_p) and torch.equal(kern[rest], plain[rest])
        check(ok and bool(nan_p.any()),
              f"{name}: NaN at the same {int(nan_p.sum())} samples, "
              f"{int(torch.isinf(plain).sum())} infinities, the rest bit-exact")

    def work_count(name, vp, layout, n0, nframes):
        """The render's voice-tile count against the plain predicate."""
        got = int(K.render_stereo.voice_tiles.item())
        want = int(K.active_voice_tiles(vp, n0, nframes, samplerate=SR,
                                        layout=layout).sum())
        check(got == want, f"{name}: {got} voice-tiles evaluated == "
              f"active_voice_tiles {want}")

    def setup_check(name, vp, layout):
        """Setup kernel vs voice_constants, every word bit-exact ->
        max |diff| over the f32 words."""
        got, _ = K.voice_setup(vp, SR, layout.num_harmonics)
        want = K.voice_constants(vp, SR, layout.num_harmonics)
        torch.cuda.synchronize()
        f0 = K.CONST_COLUMNS.index("amp")
        fk = slice(f0, K.CONST_BASE)
        diff = (got[:, fk].view(torch.float32)
                - want[:, fk].view(torch.float32)).abs()
        err = float(torch.nan_to_num(diff, nan=0.0).max())
        check(torch.equal(got, want), f"{name}: setup kernel == "
              f"voice_constants, all {got.numel()} words bit-exact")
        return err

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

    render_err = 0.0

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
            params = dict(
                wave=wave, frequency=float(rng.uniform(40, 4000)),
                amplitude=float(rng.uniform(0.05, 0.12)),
                phase=float(rng.uniform(0, 1)), pan=float(rng.uniform(-1, 1)),
                start=0.1 * i, duration=float(rng.uniform(0.1, 0.3)),
                attack=0.01, decay=0.03, sustain_level=0.6, release=0.05)
            out.append(Voice(**{**params, **kw}))
        return out

    def battery(name, *pair):
        nonlocal render_err
        render_err = max(render_err, compare(name, *pair))

    for w in waves:
        battery(f"bank/{w}", *bank_pair(wave_voices(w), SR))
    fm = [Voice(w, 110.0 * (i + 1), amplitude=0.1, pan=0.3 * i - 0.6,
                fm_frequency=3.0 + i, fm_depth=0.005 * (i + 1),
                fm_phase=0.1 * i, start=0.1 * i, duration=0.4)
          for i, w in enumerate(["sine", "triangle", "square", "sawtooth",
                                 "pulse", "semicircle"])]
    battery("bank/fm", *bank_pair(fm, SR))
    glide = [Voice(wave=w, frequency=660.0, glide_from=330.0, glide_time=0.04,
                   start=0.005, duration=0.2, amplitude=0.2)
             for w in ("sine", "sawtooth", "square", "triangle")]
    glide.append(Voice(wave="sine", frequency=440.0, amplitude=0.2))
    battery("bank/glide", *bank_pair(glide, SR))
    blep = [Voice(wave=w, frequency=1760.0, glide_from=110.0, glide_time=0.15,
                  start=0.005, duration=0.2, amplitude=0.4)
            for w in ("sawtooth_bl", "square_bl")]
    battery("bank/glide_blep", *bank_pair(blep, SR))
    base = dict(wave="pluck", frequency=440.0, start=0.005, duration=0.3,
                amplitude=0.5, seed=7)
    kg, pg = bank_pair([Voice(glide_from=110.0, glide_time=0.05, **base)], SR)
    kn, _ = bank_pair([Voice(**base)], SR)
    battery("bank/pluck_glide", kg, pg)
    check(torch.equal(kg, kn), "bank/pluck_glide_excluded: glided pluck == "
          "unglided pluck, bit-exact")
    battery("bank/wavetable_gather", *bank_pair(
        wave_voices("wavetable", count=16, fm_frequency=4.0, fm_depth=0.01), SR))
    battery("bank/mixed_demo", *bank_pair(bench_song.demo_voices(64), SR,
                                          grouped=False))
    mixed = [v for w in waves for v in wave_voices(w, count=2)]
    battery("bank/mixed_all_waves", *bank_pair(mixed, SR, grouped=False))

    # -- 4. cull battery -------------------------------------------------
    T = K.TILE
    print(f"[4] cull battery ({T}-frame tiles)")
    setup_err = 0.0

    def edge_bank(shift, grouped):
        """Every waveform, notes placed on, one before and one after tile
        boundaries (start and end), with zero attack, decay, release or
        gate among them; exact frames patched in after packing."""
        voices = []
        for i, w in enumerate(waves):
            for j in range(4):
                kw = dict(attack=0.004, decay=0.006, sustain_level=0.7,
                          release=0.003)
                kw[("attack", "decay", "release", "duration")[j]] = 0.0
                voices.extend(wave_voices(w, count=1, **kw))
        if grouped:
            vp, ly = pack_voices(voices, SR, num_harmonics=8,
                                 sort_by_wave=True, device=dev)
        else:
            vp = pack_voices(voices, SR, num_harmonics=8, device=dev)
            ly = None
        V = vp.wave.shape[0]
        i = np.arange(V)
        start = shift + T * (1 + i % 7) + (i % 3) - 1
        gate = np.where(vp.gate.cpu().numpy() == 0, 0,
                        T * (1 + (i // 3) % 3) + (i // 9) % 3 - 1)
        vp = vp._replace(
            start=torch.tensor(start, dtype=torch.int32, device=dev),
            gate=torch.tensor(gate, dtype=torch.int32, device=dev))
        bank = VoiceBank.for_voices(voices, SR, chunk_frames=T,
                                    num_harmonics=8, layout=ly, device=dev)
        return bank, vp, bank._kernel_layout(vp)

    def cull_case(name, bank, vp, layout, n0, nframes, exact=True):
        nonlocal render_err, setup_err
        kern = K.render_stereo(vp, n0, nframes=nframes, samplerate=SR,
                               layout=layout, use_glide=bank.use_glide)
        plain = K.render_stereo_reference(vp, n0, nframes=nframes,
                                          samplerate=SR, layout=layout,
                                          use_glide=bank.use_glide)
        if exact:
            render_err = max(render_err, compare(name, kern, plain))
        else:
            same_nonfinite(name, kern, plain)
        work_count(name, vp, layout, n0, nframes)
        setup_err = max(setup_err, setup_check(name, vp, layout))

    for grouped in (True, False):
        lay = "grouped" if grouped else "mixed"
        bank, vp, layout = edge_bank(0, grouped)
        cull_case(f"cull/edges_{lay}", bank, vp, layout, 0, 10 * T + 37)
        cull_case(f"cull/edges_{lay}_offset", bank, vp, layout, 300,
                  9 * T + 1)
        cull_case(f"cull/edges_{lay}_cut", bank, vp, layout, 0, 3 * T - 2)
        n0 = 2 ** 24 + 5 * T + 3
        bank, vp, layout = edge_bank(n0 - T, grouped)
        cull_case(f"cull/edges_{lay}_past_2^24", bank, vp, layout, n0,
                  10 * T)

    # voices that are not cull-safe: the plain version gives non-finite
    # samples on their silent frames too, and the kernel must evaluate them
    unsafe = [v for w in ("sine", "harmonics", "wavetable", "pluck", "square")
              for v in wave_voices(w, count=2)]
    vp, layout = pack_voices(unsafe, SR, num_harmonics=8, sort_by_wave=True,
                             device=dev)
    waves_of = vp.wave.cpu().numpy()
    amp, bias = vp.amp.clone(), vp.bias.clone()
    harm, table, damping = (vp.harm_amps.clone(), vp.table.clone(),
                            vp.damping.clone())
    first = {w: int(np.flatnonzero(waves_of == w)[0]) for w in (0, 2, 8, 11, 12)}
    amp[first[0]] = math.inf
    bias[first[2]] = math.nan
    harm[first[8], 3] = -math.inf
    table[first[11], 17] = math.nan
    damping[first[12]] = -1.0
    vp = vp._replace(amp=amp, bias=bias, harm_amps=harm, table=table,
                     damping=damping)
    flags = K.voice_constants(vp, SR, 8)[:, K.CONST_COLUMNS.index("flags")]
    fl = flags.cpu().numpy()
    check(all((fl[first[w]] & K.FLAG_SAFE) == 0 for w in (0, 2, 8, 11))
          and (fl[first[12]] & K.FLAG_PLUCK_SAFE) == 0,
          "cull/unsafe: the five poisoned voices are flagged not cull-safe")
    ubank = VoiceBank.for_voices(unsafe, SR, num_harmonics=8, layout=layout,
                                 device=dev)
    cull_case("cull/unsafe", ubank, vp, layout, 0, SR, exact=False)

    b5, vp5, total5 = bench_song.song_bank(5000, 4.0, device=dev)
    cull_case(f"cull/5000_voices ({b5._kernel_layout(vp5).nvoices} packed, "
              f"4 s)", b5, vp5, b5._kernel_layout(vp5), 0, total5)

    # -- 5. config 5 at full width ---------------------------------------
    print("[5] config 5: 64 voices, 60 s, chunk 131072, nharm 8")
    bank, vp, total = bench_song.song_bank(device=dev)
    layout = bank._kernel_layout(vp)
    print(f"  layout: {len(layout.groups)} groups {layout.groups}")
    K.voice_setup.launches = 0
    K.render_stereo.launches = 0
    t0 = time.perf_counter()
    mix = bank.render_song(vp, total)
    pcm = bank.to_int16(mix)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"voicebank_setup": K.voice_setup.launches,
                "voicebank_render": K.render_stereo.launches}
    tiles5 = int(K.render_stereo.voice_tiles.item())
    pcm_np = pcm.cpu().numpy()
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "config5.wav")
        write_wav(wav, pcm_np, SR, 2, 2)
        back, rate, width, nch = read_wav(wav)
    check(all(n > 0 for n in launches.values()),
          f"main path launched {launches} ({main_s:.3f} s host time for the "
          f"first render + to_int16)")
    check(pcm.shape == (total, 2) and pcm.dtype == torch.int16
          and bool(torch.isfinite(mix).all()),
          f"output int16 {tuple(pcm.shape)}, finite f32 mix")
    check(rate == SR and width == 2 and nch == 2
          and np.array_equal(back, pcm_np), "WAV written and read back equal")
    active = K.active_voice_tiles(vp, 0, total, samplerate=SR, layout=layout)
    dense = vp.wave.shape[0] * total
    check(tiles5 == int(active.sum()) and tiles5 * T <= 0.06 * dense,
          f"config5 work: {tiles5} voice-tiles = {tiles5 * T} voice-frames, "
          f"{100 * tiles5 * T / dense:.3f}% of {dense}; active_voice_tiles "
          f"{int(active.sum())}")
    plain = K.render_stereo_reference(vp, 0, nframes=total, samplerate=SR,
                                      layout=layout)
    render_err = max(render_err, compare("config5 kernel vs plain", mix, plain))
    setup_err = max(setup_err, setup_check("config5", vp, layout))
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
            cpu_bank.render_chunk(vp.to("cpu"), c0), exact=False)
    peak = int(np.abs(pcm_np.astype(np.int64)).max())
    check(peak > 1000, f"peak {peak}")
    sha = hashlib.sha256(pcm_np.tobytes()).hexdigest()
    check(sha == CONFIG5_SHA256, f"sha256(int16) {sha} == the CPU plain "
          f"path's {CONFIG5_SHA256[:16]}...")

    # -- 6. scale --------------------------------------------------------
    print("[6] scale")
    b2, vp2, total2 = bench_song.song_bank(1024, 10.0, device=dev)
    l2 = b2._kernel_layout(vp2)
    k2 = b2.render_song(vp2, total2)
    work_count(f"1024 voices x 10 s ({l2.nvoices} packed)", vp2, l2, 0, total2)
    p2 = K.render_stereo_reference(vp2, 0, nframes=total2, samplerate=SR,
                                   layout=l2)
    render_err = max(render_err, compare(
        f"1024 voices x 10 s ({l2.nvoices} packed)", k2, p2))
    setup_err = max(setup_err, setup_check("1024 voices", vp2, l2))
    b3, vp3, _ = bench_song.song_bank(64, 600.0, device=dev)
    n0 = 400 * SR
    k3 = b3.render_chunk(vp3, n0)
    p3 = K.render_stereo_reference(vp3, n0, nframes=b3.chunk_frames,
                                   samplerate=SR, layout=b3._kernel_layout(vp3))
    render_err = max(render_err, compare(
        f"600 s song, window at n0={n0} (> 2^24 = {2 ** 24})", k3, p3))
    del b5, vp5, k2, p2, plain, chunks, streamed

    # -- 7. timing -------------------------------------------------------
    print(f"[7] timing on config 5 ({card})")
    from torch.profiler import ProfilerActivity, profile

    def events_ms(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def spread(xs):
        return (f"median {statistics.median(xs):.6f} ms (min {min(xs):.6f}, "
                f"max {max(xs):.6f}, n={len(xs)})")

    def profiled(fn, reps):
        """Device time by kernel over reps calls -> ({name: ms per call},
        device-busy ms per call, wall ms per call)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / reps
        by_name = {}
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / reps
        return by_name, sum(by_name.values()), wall

    def pick(by_name, word):
        return sum(v for k, v in by_name.items() if word in k)

    def song():
        bank.render_song(vp, total)

    def chunk():
        bank.render_chunk(vp, 10 * bank.chunk_frames)

    def main_path():
        bank.to_int16(bank.render_song(vp, total)).cpu()

    def setup_only():
        K.voice_setup(vp, SR, layout.num_harmonics)

    def plain_setup():
        K.voice_constants(vp, SR, layout.num_harmonics)

    def plain_render():
        K.render_stereo_reference(vp, 0, nframes=total, samplerate=SR,
                                  layout=layout)

    prof_song, _, _ = profiled(song, 20)
    render_ms = pick(prof_song, "render_kernel")
    setup_ms = pick(prof_song, "setup_kernel")
    prof_chunk, _, _ = profiled(chunk, 20)
    chunk_kernel_ms = pick(prof_chunk, "render_kernel")
    check(render_ms > 0.0 and setup_ms > 0.0 and chunk_kernel_ms > 0.0,
          "the profiler shows both kernels' device time")
    render_ms, setup_ms = max(render_ms, 1e-9), max(setup_ms, 1e-9)
    print(f"  profiler, 20 render_song calls: render_kernel {render_ms:.6f} "
          f"ms, setup_kernel {setup_ms:.6f} ms a call")
    print(f"  profiler, 20 render_chunk calls (131072 frames at frame "
          f"{10 * bank.chunk_frames}): render_kernel {chunk_kernel_ms:.6f} ms")

    events_ms(song, 3)
    song_ms = [events_ms(song, 20) for _ in range(5)]
    print(f"  render_song, 20 back to back (CUDA events): {spread(song_ms)}")
    events_ms(chunk, 3)
    chunk_ms = [events_ms(chunk, 1) for _ in range(20)]
    print(f"  one render_chunk (CUDA events): {spread(chunk_ms)}")
    setup_ev = [events_ms(setup_only, 20) for _ in range(5)]
    print(f"  voice_setup, 20 back to back (CUDA events): {spread(setup_ev)}")

    main_path()
    torch.cuda.synchronize()
    wall = []
    for _ in range(10):
        t = time.perf_counter()
        main_path()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    print(f"  main path to_int16(render_song).cpu(), host wall clock: "
          f"{spread(wall)}")
    prof_main, busy, pwall = profiled(main_path, 5)
    print(f"  main path under the profiler: {pwall:.6f} ms wall a call, "
          f"device busy {busy:.6f} ms ({100 * busy / pwall:.1f}%), idle "
          f"{100 * (1 - busy / pwall):.1f}%")
    for name, ms in sorted(prof_main.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:.6f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")

    plain_setup()
    plain_setup_ms = statistics.median(events_ms(plain_setup, 5)
                                       for _ in range(3))
    plain_render()
    plain_ms_runs = [events_ms(plain_render, 1) for _ in range(3)]
    plain_ms = statistics.median(plain_ms_runs)
    print(f"  plain voice_constants {plain_setup_ms:.6f} ms; plain render "
          f"{spread(plain_ms_runs)}")

    # bounds from this run's inputs: operations on the audible voice-frames
    # (the frames of each voice whose envelope time is in [0, t4)) and the
    # bytes each kernel must read once and write once
    c = K.voice_constants(vp, SR, layout.num_harmonics)
    col = {name: c[:, j] for j, name in enumerate(K.CONST_COLUMNS)}
    t4 = col["t4"].view(torch.float32)
    n = torch.arange(total, device=dev)
    sr_r = float(np.float32(1.0 / SR))
    ops = 0
    for v in range(vp.wave.shape[0]):
        t = (n - vp.start[v]).to(torch.float32) * sr_r
        audible = int(((t >= 0) & (t < t4[v])).sum())
        wid = int(vp.wave[v])
        per = (OPS_COMMON + OPS_WAVE.get(wid, 0)
               * (layout.num_harmonics if wid == 8 else
                  int(col["pluck_ka"][v]) if wid == 12 else 1)
               + (OPS_FM if int(col["flags"][v]) & K.FLAG_FM_ON else 0)
               + (OPS_GLIDE if bank.use_glide and int(vp.glide_frames[v]) > 0
                  else 0))
        ops += audible * per
    V, C = c.shape
    in_bytes = sum(getattr(vp, f).numel() * getattr(vp, f).element_size()
                   for f in K.KERNEL_COLUMNS)
    aux_bytes = (vp.table.numel() * 4
                 + vp.harm_amps[:, :layout.num_harmonics].numel() * 4)
    render_bytes = total * 8 + V * C * 4 + aux_bytes
    setup_bytes = in_bytes + aux_bytes + V * C * 4
    # setup: about 60 ops a voice, 30 a partial for the denominator, one
    # test per harmonic and table value, about 90 a sounding partial
    # (cosf, logf, two hashes, a division)
    H, Kp = layout.num_harmonics, (C - K.CONST_BASE) // 3
    setup_ops = (V * (60 + 30 * Kp + H + vp.table.shape[1])
                 + 90 * int(col["pluck_ka"].sum()))
    render_bound = max(render_bytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
    setup_bound = max(setup_bytes / HBM_BYTES_S, setup_ops / F32_OPS_S) * 1e3
    print(f"  render bound: {ops:.4g} ops / {F32_OPS_S:.3g} op/s and "
          f"{render_bytes} B / {HBM_BYTES_S:.3g} B/s -> {render_bound:.6f} ms "
          f"({'operations' if ops / F32_OPS_S > render_bytes / HBM_BYTES_S else 'bytes'}"
          f"); kernel at {100 * render_bound / render_ms:.1f}% of it")
    print(f"  setup bound: {setup_bound:.6f} ms; kernel at "
          f"{100 * setup_bound / setup_ms:.2f}% of it")

    src = "synthesizer_tpu_torch/csrc/voicebank_render.cu"
    print(json.dumps({"kernels": [
        {"name": "voicebank_setup", "route": "cuda", "source": src,
         "replaces": "synthesizer_tpu/ops/kernels.py:58",
         "launches": launches["voicebank_setup"], "max_abs_err": setup_err,
         "ms": setup_ms, "plain_ms": plain_setup_ms, "bound_ms": setup_bound,
         "bound_by": ("operations" if setup_ops / F32_OPS_S
                      > setup_bytes / HBM_BYTES_S else "bytes"),
         "library_ms": None},
        {"name": "voicebank_render", "route": "cuda", "source": src,
         "replaces": "synthesizer_tpu/ops/kernels.py:58",
         "launches": launches["voicebank_render"], "max_abs_err": render_err,
         "ms": render_ms, "plain_ms": plain_ms, "bound_ms": render_bound,
         "bound_by": ("operations" if ops / F32_OPS_S
                      > render_bytes / HBM_BYTES_S else "bytes"),
         "library_ms": None, "voice_tiles": tiles5,
         "render_song_ms": statistics.median(song_ms),
         "render_chunk_ms": statistics.median(chunk_ms),
         "main_path_ms": statistics.median(wall)}]}))
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
