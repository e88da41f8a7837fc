#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's two Hopper kernels (``voicebank_setup`` and
``voicebank_render``, one source in ``synthesizer_tpu_torch/csrc``, nvcc
into ``build/``), drives the four paths the port has -- config 5, the
64-voice 60 s song, through ``VoiceBank.render_song`` and ``to_int16`` to a
WAV file; a General-MIDI file through ``midi.render_midi``; and a sound made
with ``WaveSynth``, shaped with ``Sample`` ops and written as a WAV; and
``Sample``'s resampling and effects ops (plain PyTorch on the card: these
paths have no hand-written kernel) -- and holds
both kernels against their plain PyTorch versions on the card:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the build time and ptxas' registers and spill bytes of the
   three kernels (``setup_kernel``, ``render_kernel<false>`` for curve-free
   banks, ``render_kernel<true>`` for banks with curves);
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
   device-time breakdown, the plain versions, and each kernel's bound;
8. curves battery: every waveform under a pitch, an amplitude and an
   FM-depth curve, alone and all together, grouped and mixed, kernel vs
   plain, setup kernel vs ``voice_constants`` and its per-segment buffer
   vs ``curve_constants``, bit-exact; then banks that force each path of
   the curve kernel's per-tile segment windows -- one segment a tile,
   exactly ``WINDOW``, one more (the search of the whole row), unsorted
   rows, segment starts on, one before and one after tile edges, note
   frames that wrap i32 inside a tile, a note past frame 2^24 -- with the
   windows the kernel looked up and those without a window equal to
   ``tile_segment_windows``; banks with harmonics of weight +0 and -0
   (which the curve kernel skips) and a sustain level above 1;
9. sparse rows on the sparse workload of ``bench.py`` (600 notes, 300 s,
   seed 5): ``render_song_sparse`` (one launch with per-chunk rows) equal
   to the flat ``render_song`` bit for bit, to the plain version on a
   window, voice-tiles evaluated and candidates tested both ways, times;
10. the MIDI path: a seeded General-MIDI file (16 channels, percussion,
    about 3000 notes over 180 s, bend sweeps, CC7/CC11 fades, CC1 and
    pressure vibrato) through ``midi.render_midi`` on the card, with both
    kernels' launch counts; the whole file twice with identical bytes; the
    kernel vs plain on three windows (the start, the window with the most
    curve voices, the release tail); its wall clock split into parse,
    pack, plan, kernels, ``to_int16`` and the copy; the render kernel's
    device time with and without the rows, and its bound; the histogram
    of window widths, the share of (voice, tile, curve) lookups that
    search the whole row, and the time of the setup kernel's per-segment
    pass;
11. pcm: every function of ``ops.pcm`` on seeded int8 / int16 / int32
    tensors of 1 M elements with the extremes in them, on the card and on
    the CPU through the same functions: the integer and single-product ops
    bit-identical, ``to_mono`` within 1 LSB, ``rms_mean_square`` within a
    relative 1e-6 and run-to-run bit-exact on the card;
12. wavesynth at full width: config 1 of ``bench.py``
    (``WaveSynth().sine(440.0, 2.0)`` at 44.1 kHz, 16 bit) and config 4 (its
    FM + amplitude-modulation + echo patch as 30 chunks of 1470 frames
    through ``block_stream`` and as one offline render): streaming ==
    offline and card == CPU bit for bit, the noise digest, two Biquad
    patches card against CPU within their budgets, and each one's time by
    CUDA events and by wall clock (median of 10);
13. sample: the chain sine -> amplify -> fadein -> fadeout -> stereo ->
    mix_at -> pan -> write_wav on the card, its bytes equal to the CPU
    chain's; config 5's main path through ``Sample.from_torch(...)
    .get_frame_array()`` into one pinned buffer with the pinned sha256;
    and the main path's wall clock and ``Memcpy DtoH`` time with a
    pageable copy against the pinned one;
14. resample at full width: the MIDI render (7,905,280 stereo frames)
    through the exact ratecv and the windowed-sinc resampler at 44100 ->
    48000 and 48000 -> 44100, card == CPU bit for bit, streamed in chunks
    of 1470 and 65536 == whole, and on a 1 s excerpt in chunks of 1, 7, 160
    and 997; the ratecv at 22050 -> 44100 and 44100 -> 44101 at widths 1, 2
    and 4 on 1 M frames; times by CUDA events, wall clock and profiler;
15. config 3 of ``bench.py`` (16 sines rendered at 22050 Hz, resampled to
    44100, amplified, faded, made stereo and mixed) on the card == on the
    CPU bit for bit, and its wall clock (median of 10);
16. effects: 21 ``Sample`` ops (the 20 of the effects rack, the compressor
    also with a sidechain and a soft knee) on a 10 s excerpt of the render,
    card against CPU within each op's ``goldref.effects`` budget
    (``ops.effects.BUDGETS``), two card runs bit-identical, and each op's
    device operations under the profiler; then a mastering chain (high-pass, EQ,
    compressor, reverb, limiter, ``normalize_lufs``) on the whole render,
    timed step by step, its loudness and true peak card against CPU.

It prints a ``{"kernels": [...]}`` line and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  There is no CPU fallback: without a CUDA device it
exits non-zero at once.
"""

import dataclasses
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100
FAILURES = []
STARTED = time.perf_counter()
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


def bound(ops, nbytes):
    """-> (bound ms, "operations" or "bytes", the bound with the operations
    at half the rate: what a kernel without FMA can reach)"""
    t_ops, t_bytes = ops / F32_OPS_S, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes",
            max(2 * t_ops, t_bytes) * 1e3)
#: f32/int operations per audible voice-frame, counted from
#: csrc/voicebank_render.cu (each add, mul, compare, select, conversion
#: counts one; sin_turns is 16, expf about 8, an integer division about 20):
#: phase, note frame, ADSR, gain and pan sum for every voice ...
OPS_COMMON = 23
#: ... the FM phase offset where the voice has FM, the glide chirp ...
OPS_FM, OPS_GLIDE = 32, 14
#: ... and the waveform (8: per partial of nonzero weight; 12: per sounding
#: partial)
OPS_WAVE = {0: 18, 1: 6, 2: 2, 3: 4, 4: 2, 5: 9, 6: 8, 7: 32, 8: 21, 9: 22,
            10: 38, 11: 12, 12: 32}
#: ... the closed forms of the curves, without the segment search: the bend
#: chirp and its BLEP increment, the amplitude ramp and its product with
#: the envelope, and the depth curve's five per-frame trig evaluations and
#: sums (the three at the segment's first frame are the setup kernel's)
OPS_BEND, OPS_AMP, OPS_DMOD = 16, 5, 110
#: the setup kernel's per-segment pass: operations a segment of a pitch, an
#: amplitude and a depth curve (three trig evaluations)
OPS_SEGMENT = (4, 3, 60)


def check(ok, what):
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def head(title):
    """A phase's heading, with the seconds since the script started."""
    print(f"{title}  (+{time.perf_counter() - STARTED:.1f} s)", flush=True)


#: (name, op on a Sample, card-vs-CPU budget from ops.effects.BUDGETS):
#: frames in LSB at 16 bit, meter values in LU / dB
def _fx_ops(key, ir):
    from synthesizer_tpu_torch.ops.effects import BUDGETS as B
    return [
        ("compress", lambda s: s.compress(-18.0, 4.0, 0.003, 0.08, 3.0),
         B["compress"]),
        ("compress sidechain= knee_db=", lambda s: s.compress(
            -24.0, 6.0, knee_db=6.0, sidechain=key), B["compress"]),
        ("reverb", lambda s: s.reverb(), B["reverb"]),
        ("chorus", lambda s: s.chorus(), B["chorus"]),
        ("filter lowpass 1000", lambda s: s.filter("lowpass", 1000.0),
         B["filter"]),
        ("eq", lambda s: s.eq(4.0, -6.0, 3.0, 150.0, 900.0, 1.4, 5000.0),
         B["eq"]),
        ("gate", lambda s: s.gate(-30.0, 60.0), B["gate"]),
        ("feedback_echo", lambda s: s.feedback_echo(0.25, 0.5),
         B["feedback_echo"]),
        ("tremolo", lambda s: s.tremolo(), B["tremolo"]),
        ("autopan", lambda s: s.autopan(), B["autopan"]),
        ("stereo_width", lambda s: s.stereo_width(1.7), B["stereo_width"]),
        ("limit", lambda s: s.limit(-6.0), B["limit"]),
        ("phaser", lambda s: s.phaser(), B["phaser"]),
        ("convolve", lambda s: s.convolve(ir), B["convolve"]),
        ("granulate", lambda s: s.granulate(5.0), B["granulate"]),
        ("stretch", lambda s: s.stretch(1.3), B["stretch"]),
        ("pitch_shift", lambda s: s.pitch_shift(3.0), B["pitch_shift"]),
        ("normalize_lufs", lambda s: s.normalize_lufs(-14.0),
         B["normalize_lufs"]),
        ("loudness_lufs", lambda s: s.loudness_lufs(), B["loudness"]),
        ("loudness_stats", lambda s: s.loudness_stats(), B["loudness"]),
        ("true_peak_dbtp", lambda s: s.true_peak_dbtp(), B["true_peak"]),
    ]


def resample_and_effects(dev, card, render, spread, timed, profiled):
    """Phases 14-16: the resamplers, config 3 and the effects rack on the
    card, each against the same code on the CPU.  ``render`` is the MIDI
    path's int16 [n, 2] result on the card."""
    import torch
    from synthesizer_tpu_torch import bench_song
    from synthesizer_tpu_torch.ops import loudness as LD
    from synthesizer_tpu_torch.ops import pcm as P
    from synthesizer_tpu_torch.ops import resample as RS
    from synthesizer_tpu_torch.sample import Sample

    def described(fn, reps=10):
        """Run fn under CUDA events and the wall clock (medians of reps)
        and under the profiler (3 calls) -> a line's worth of text."""
        ev, wl = timed(fn, reps)
        _, busy, pwall = profiled(fn, 3)
        return (f"CUDA events {spread(ev)}; wall clock {spread(wl)}; "
                f"{profiled.launches:.0f} device operations a call, device "
                f"busy {busy:.6f} of {pwall:.6f} ms "
                f"({100 * busy / pwall:.1f}%)"), statistics.median(wl)

    def lsb(a, b):
        return int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64))
                   .abs().max()) if a.numel() else 0

    # -- 14. resample ------------------------------------------------------
    head(f"[14] resample at full width: the MIDI render, {render.shape[0]} "
         f"stereo frames ({card})")
    x_g = render
    x_c = render.cpu()
    n = x_g.shape[0]

    def linear(a, b):
        return lambda x: RS.resample_tensor(x, a, b)

    def hq(a, b):
        g = math.gcd(a, b)
        M, L = a // g, b // g
        return lambda x: RS.hq_resample(x, L, M, RS.nframes_out(
            x.shape[0], M, L))

    def stream(kind, a, b, x, chunk):
        if kind == "linear":
            rs = RS.StreamingResampler(a, b, x.shape[1], x.dtype, x.device)
        else:
            rs = RS.StreamingHQResampler(a, b, x.shape[1], x.dtype, x.device)
        out = [rs.push(x[i:i + chunk])[0] for i in range(0, x.shape[0], chunk)]
        if kind == "hq":
            out.append(rs.flush()[0])
        return torch.cat(out)

    excerpt = x_g[60 * SR:61 * SR]
    for a, b in ((44100, 48000), (48000, 44100)):
        for kind, make in (("linear", linear), ("hq", hq)):
            fn = make(a, b)
            y_g = fn(x_g)
            y_c = fn(x_c)
            check(y_g.device.type == "cuda" and torch.equal(y_g.cpu(), y_c),
                  f"{kind} {a} -> {b}: {y_g.shape[0]} frames, card == CPU bit "
                  f"for bit")
            text, _ = described(lambda: fn(x_g))
            print(f"  {kind} {a} -> {b} on the card: {text}")
            for chunk in (1470, 65536):
                t = time.perf_counter()
                same = torch.equal(stream(kind, a, b, x_g, chunk), y_g)
                check(same, f"{kind} {a} -> {b}: streamed in chunks of "
                      f"{chunk} == whole, bit for bit "
                      f"({time.perf_counter() - t:.2f} s)")
            whole = fn(excerpt)
            t = time.perf_counter()
            bad = [c for c in (1, 7, 160, 997)
                   if not torch.equal(stream(kind, a, b, excerpt, c), whole)]
            check(not bad, f"{kind} {a} -> {b} on a 1 s excerpt: streamed in "
                  f"chunks of 1, 7, 160 and 997 == whole, bit for bit"
                  f"{'' if not bad else ', EXCEPT ' + str(bad)} "
                  f"({time.perf_counter() - t:.2f} s)")
    one_m = x_g[:1 << 20]
    for width in (1, 2, 4):
        xw = P.lin2lin(one_m, width)
        for a, b in ((22050, 44100), (44100, 44101)):
            fn = linear(a, b)
            y_g = fn(xw)
            check(torch.equal(y_g.cpu(), fn(xw.cpu())),
                  f"linear {a} -> {b}, width {width}, {xw.shape[0]} frames: "
                  f"card == CPU bit for bit")
            if width == 2:
                text, _ = described(lambda: fn(xw))
                print(f"  linear {a} -> {b} on 1 M frames: {text}")

    # -- 15. config 3 --------------------------------------------------------
    head(f"[15] config 3 of bench.py: 16 tracks resampled and mixed ({card})")
    c3_g = bench_song.config3(SR, dev)
    c3_c = bench_song.config3(SR, "cpu")
    a3 = c3_g.get_frame_array()
    check(c3_g.device.type == "cuda" and np.array_equal(
        a3, c3_c.get_frame_array()) and a3.shape == (c3_c.nframes, 2)
        and int(np.abs(a3.astype(np.int64)).max()) > 1000,
        f"config 3: {a3.shape[0]} frames ({c3_g.duration:.3f} s), card == "
        f"CPU bit for bit, peak {int(np.abs(a3.astype(np.int64)).max())}")
    text, wall3 = described(
        lambda: bench_song.config3(SR, dev).get_frame_array())
    print(f"  config 3 to the host: {text}; {c3_g.duration / wall3 * 1e3:.1f}x "
          f"realtime by the median wall clock")

    # -- 16. effects ---------------------------------------------------------
    head(f"[16] effects: each op on a 10 s excerpt, card against CPU; a "
         f"mastering chain on the whole render ({card})")
    ex_g = x_g[40 * SR:50 * SR].clone()
    key_g = x_g[80 * SR:90 * SR].clone()
    ir_np = np.random.default_rng(16).standard_normal((SR // 10, 1)) \
        * np.exp(-np.arange(SR // 10) / 800.0)[:, None] * 8000.0
    ir_g = torch.from_numpy(ir_np.astype(np.int16)).to(dev)
    ops_g = _fx_ops(Sample.from_torch(key_g, SR, 2),
                    Sample.from_torch(ir_g, SR, 2))
    ops_c = _fx_ops(Sample.from_torch(key_g.cpu(), SR, 2),
                    Sample.from_torch(ir_g.cpu(), SR, 2))
    for (name, op, budget), (_, op_c, _) in zip(ops_g, ops_c):
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs.append(op(Sample.from_torch(ex_g, SR, 2)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        ref = op_c(Sample.from_torch(ex_g.cpu(), SR, 2))
        cpu_ms = (time.perf_counter() - t) * 1e3
        if isinstance(ref, Sample):
            a, b = runs[0].torch_frames, runs[1].torch_frames
            d = lsb(a, ref.torch_frames) if a.shape == ref.torch_frames.shape \
                else float("inf")
            again = torch.equal(a, b)
            unit = "LSB"
        elif isinstance(ref, dict):
            d = max(abs(runs[0][k] - ref[k]) if runs[0][k] != ref[k] else 0.0
                    for k in ref)
            again, unit = runs[0] == runs[1], "LU"
        else:
            d = abs(runs[0] - ref) if runs[0] != ref else 0.0
            again, unit = runs[0] == runs[1], "dB"
        profiled(lambda: op(Sample.from_torch(ex_g, SR, 2)), 1, cpu=False)
        check(d <= budget and again,
              f"{name}: card vs CPU {d:.6g} {unit} (budget {budget}), two "
              f"card runs bit-identical; {ms:.3f} ms on the card, "
              f"{cpu_ms:.3f} ms on the CPU; {profiled.launches:.0f} device "
              f"operations a call (profiler)")

    def chain(s, steps=None):
        """filter -> eq -> compress -> reverb -> limit -> normalize_lufs;
        with ``steps`` each stage is synchronised and timed into it."""
        stages = (("filter highpass 30", lambda s: s.filter("highpass", 30.0)),
                  ("eq", lambda s: s.eq(2.0, -1.5, 2.5)),
                  ("compress", lambda s: s.compress(-18.0, 3.0, 0.01, 0.15,
                                                    2.0)),
                  ("reverb", lambda s: s.reverb(0.5, 0.5, 0.15, 0.9, 1.0,
                                                1.5)),
                  ("limit", lambda s: s.limit(-1.0)),
                  ("normalize_lufs -14", lambda s: s.normalize_lufs(-14.0)))
        for name, op in stages:
            t = time.perf_counter()
            op(s)
            if steps is not None:
                torch.cuda.synchronize()
                steps[name] = (time.perf_counter() - t) * 1e3
        return s

    steps = {}
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    start.record()
    out = chain(Sample.from_torch(x_g, SR, 2), steps)
    tp = out.true_peak_dbtp()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    print(f"  the chain on {n} frames ({n / SR:.1f} s): CUDA events "
          f"{start.elapsed_time(end):.3f} ms, wall clock {wall:.3f} ms; "
          f"synchronised steps (ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in steps.items()))
    y = out.torch_frames
    li_g = LD.loudness_integrated(y, SR)
    li_c = LD.loudness_integrated(y.cpu(), SR)
    tp_c = 20.0 * math.log10(LD.true_peak_norm(y.cpu()))
    check(y.shape == (n + int(1.5 * SR), 2) and li_g < -14.0 + 0.1
          and tp <= -1.0 + 0.1 and abs(li_g - li_c) <= 0.01
          and abs(tp - tp_c) <= 0.01,
          f"mastering chain: {y.shape[0]} frames, {li_g:.4f} LUFS on the "
          f"card, {li_c:.4f} on the CPU (budget 0.01); true peak "
          f"{tp:.4f} dBTP, {tp_c:.4f} on the CPU")
    # under the profiler on the 10 s excerpt: a whole-render pass records
    # about a million device operations, whose trace takes minutes to read
    by_name, busy, pwall = profiled(
        lambda: chain(Sample.from_torch(ex_g, SR, 2)), 1, cpu=False)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    print(f"  the chain on the 10 s excerpt under the profiler: "
          f"{profiled.launches:.0f} device operations, device busy "
          f"{busy:.3f} of {pwall:.3f} ms ({100 * busy / pwall:.1f}%); most "
          f"device time: " + "; ".join(f"{ms:.3f} ms {k[:60]}"
                                         for k, ms in top))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")

    from synthesizer_tpu_torch import bench_song
    from synthesizer_tpu_torch.models.voicebank import (Voice, VoiceBank,
                                                        pack_voices)
    from synthesizer_tpu_torch.ops import kernels as K
    from synthesizer_tpu_torch.sample import Sample
    from synthesizer_tpu_torch.utils.device import pinned_like
    from synthesizer_tpu_torch.utils.wavio import read_wav

    dev = torch.device("cuda")

    def sha16(pcm):
        return hashlib.sha256(pcm.cpu().numpy().tobytes()).hexdigest()

    # -- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    head("[1] device")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")

    # -- 2. build --------------------------------------------------------
    head("[2] build")
    t0 = time.perf_counter()
    path, log = K.build_library()
    K._library()
    print(f"  built {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s")
    ptxas, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = ("setup_kernel" if "setup_kernel" in line
                     else "render_kernel<true>" if "ILb1E" in line
                     else "render_kernel<false>")
            ptxas[entry] = {}
            print("  ptxas:", entry)
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_bytes", r"(\d+) bytes spill stores"),
                             ("smem_bytes", r"(\d+) bytes smem")):
                found = re.search(pat, line)
                if found and entry:
                    ptxas[entry][key] = int(found.group(1))
    kernel_names = ("setup_kernel", "render_kernel<false>",
                    "render_kernel<true>")
    check(all(set(ptxas.get(k, ())) >= {"registers", "spill_bytes"}
              for k in kernel_names),
          f"ptxas resources of the three kernels: {ptxas}")

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
        got, _, seg = K.voice_setup(vp, SR, layout.num_harmonics,
                                    segments=True)
        want = K.voice_constants(vp, SR, layout.num_harmonics)
        torch.cuda.synchronize()
        f0 = K.CONST_COLUMNS.index("amp")
        fk = slice(f0, K.CONST_BASE)
        diff = (got[:, fk].view(torch.float32)
                - want[:, fk].view(torch.float32)).abs()
        err = float(torch.nan_to_num(diff, nan=0.0).max())
        check(torch.equal(got, want), f"{name}: setup kernel == "
              f"voice_constants, all {got.numel()} words bit-exact")
        # the per-segment pass: the rows of the voices that carry the curve
        flags = want[:, K.CONST_COLUMNS.index("flags")]
        views = K.segment_views(seg, vp.wave.shape[0], vp.bend_start.shape[1],
                                vp.acurve_start.shape[1],
                                vp.dcurve_start.shape[1])
        rows = [(flags & bit) != 0
                for bit in (K.FLAG_BEND, K.FLAG_AMP, K.FLAG_DC)]
        plain = K.curve_constants(vp)
        torch.cuda.synchronize()
        check(all(torch.equal(g[r], w[r])
                  for g, w, r in zip(views, plain, rows)),
              f"{name}: per-segment buffer == curve_constants on "
              f"{[int(r.sum()) for r in rows]} bend/amp/depth rows, bit-exact")
        return err

    def window_count(name, vp, layout, n0, nframes, flags, idx=None,
                     chunk_frames=0):
        """The curve windows the last render looked up, and those it left
        to the search of the whole row, against the plain predicate ->
        (looked up, without a window, {curve: histogram of widths})."""
        got = [int(x) for x in K.render_stereo.windows.tolist()]
        act = K.active_voice_tiles(vp, n0, nframes, samplerate=SR,
                                   layout=layout, idx=idx,
                                   chunk_frames=chunk_frames)
        need = K.curve_voices(vp, layout, use_bend=flags["use_bend"],
                              use_amp=flags["use_amp"],
                              use_dmod=flags["use_dmod"])
        wins = K.tile_segment_windows(vp, n0, nframes)
        looked = whole = 0
        hist = {}
        for i, curve in enumerate(K.CURVES):
            first, last, fallback = wins[curve]
            on = act & need[i][:, None]
            looked += int(on.sum())
            whole += int((on & fallback).sum())
            hist[curve] = torch.bincount((last - first + 1)[on],
                                         minlength=K.WINDOW + 2).tolist()
        check(got == [looked, whole],
              f"{name}: curve windows looked up {got[0]}, without a window "
              f"{got[1]} == tile_segment_windows {looked}, {whole}")
        return looked, whole, hist

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
                                          **bank._flags())
        return kern, plain

    render_err = 0.0

    # -- 3. per-wave battery ---------------------------------------------
    head("[3] per-wave battery (kernel vs plain, 1 s)")
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
    head(f"[4] cull battery ({T}-frame tiles)")
    setup_err = 0.0

    def edge_bank(shift, grouped, amp_curve=()):
        """Every waveform, notes placed on, one before and one after tile
        boundaries (start and end), with zero attack, decay, release or
        gate among them, and an amplitude curve if given; exact frames
        patched in after packing."""
        voices = []
        for i, w in enumerate(waves):
            for j in range(4):
                kw = dict(attack=0.004, decay=0.006, sustain_level=0.7,
                          release=0.003, amp_curve=amp_curve)
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
                               layout=layout, **bank._flags())
        plain = K.render_stereo_reference(vp, n0, nframes=nframes,
                                          samplerate=SR, layout=layout,
                                          **bank._flags())
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
        # amplitude curves keep the voices cull-safe (every gain in range)
        # and ramp across the tile edges
        bank, vp, layout = edge_bank(0, grouped, amp_curve=(
            (0.0, 0.5), (0.002, 1.5), (0.005, 0.8)))
        check(bank.use_amp, "cull/edges_amp: the bank renders amp curves")
        cull_case(f"cull/edges_{lay}_amp_curve", bank, vp, layout, 0,
                  10 * T + 37)

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
    head("[5] config 5: 64 voices, 60 s, chunk 131072, nharm 8")
    bank, vp, total = bench_song.song_bank(device=dev)
    config5 = (bank, vp, total)     # later phases rebind the three names
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
    song_smp = Sample.from_torch(pcm, SR, 2, name="config5")
    pcm_np = song_smp.get_frame_array()
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "config5.wav")
        song_smp.write_wav(wav)
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
    head("[6] scale")
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
    head(f"[7] timing on config 5 ({card})")
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

    def profiled(fn, reps, cpu=True):
        """Device time by kernel over reps calls -> ({name: ms per call},
        device-busy ms per call, wall ms per call).  ``cpu=False`` records
        the device's activity only (for calls of a million launches)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU] * cpu
                     + [ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / reps
        by_name = {}
        profiled.launches = 0.0     # device operations a call, copies included
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / reps
            profiled.launches += ev.count / reps
        return by_name, sum(by_name.values()), wall

    def pick(by_name, word):
        return sum(v for k, v in by_name.items() if word in k)

    def song():
        bank.render_song(vp, total)

    def chunk():
        bank.render_chunk(vp, 10 * bank.chunk_frames)

    # the int16 result crosses to the host through Sample.get_frame_array
    # into one pinned buffer, allocated once (phase 13 holds it against a
    # pageable copy)
    pinned = pinned_like(pcm)

    def main_path():
        bench_song.song_sample(*config5).get_frame_array(out=pinned)

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
    print(f"  main path Sample.from_torch(to_int16(render_song))"
          f".get_frame_array(out=pinned), host wall clock: {spread(wall)}")
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
               * (int((vp.harm_amps[v, :layout.num_harmonics] != 0).sum())
                  if wid == 8 else
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
    render_bound, render_by, render_nofma = bound(ops, render_bytes)
    setup_bound, setup_by, setup_nofma = bound(setup_ops, setup_bytes)
    print(f"  render bound: {ops:.4g} ops / {F32_OPS_S:.3g} op/s and "
          f"{render_bytes} B / {HBM_BYTES_S:.3g} B/s -> {render_bound:.6f} ms "
          f"({render_by}; {render_nofma:.6f} ms at {F32_OPS_S / 2:.3g} op/s, "
          f"the rate without FMA); kernel at "
          f"{100 * render_bound / render_ms:.1f}% of it")
    print(f"  setup bound: {setup_bound:.6f} ms ({setup_by}; "
          f"{setup_nofma:.6f} ms without FMA); kernel at "
          f"{100 * setup_bound / setup_ms:.2f}% of it")

    def song_bound(vpx, cols, bankx, totalx, extra_bytes):
        """The render bound on a song: the closed forms on each voice's
        audible frames [start, start + t4 * sr) inside the song, and the
        bytes read once and written once -> (ops, bytes, *bound(...))."""
        flx = cols["flags"]
        t4x = cols["t4"].view(torch.float32).double()
        startx = vpx.start.long()
        endx = torch.clamp(startx + torch.ceil(t4x * SR).long(), max=totalx)
        audible = torch.clamp(endx - torch.clamp(startx, min=0), min=0)
        widx = vpx.wave.long()
        per = torch.full_like(audible, OPS_COMMON)
        sounding = (vpx.harm_amps[:, :bankx.num_harmonics] != 0).sum(dim=1)
        for w_, o_ in OPS_WAVE.items():
            per += (widx == w_) * o_ * (
                sounding if w_ == 8 else
                cols["pluck_ka"].long() if w_ == 12 else 1)
        per += ((flx & K.FLAG_FM_ON) != 0).long() * OPS_FM
        per += ((flx & K.FLAG_BEND) != 0).long() * OPS_BEND
        per += ((flx & K.FLAG_AMP) != 0).long() * OPS_AMP
        per += ((flx & K.FLAG_DC) != 0).long() * OPS_DMOD
        opsx = int((audible * per).sum())
        nbytes = totalx * 8 + extra_bytes
        return (opsx, nbytes) + bound(opsx, nbytes)

    # -- 8. curves battery ----------------------------------------------
    head("[8] curves battery (kernel vs plain, 1 s, every wave x {bend, "
          "amp, depth, all})")
    crng = np.random.default_rng(8)

    def curves(kind):
        kw = {}
        if kind in ("bend", "all"):
            kw["pitch_curve"] = ((0.0, 1.0),
                                 (0.05, float(crng.uniform(0.6, 1.7))),
                                 (0.12, float(crng.uniform(0.6, 1.7))),
                                 (0.2, 1.0))
        if kind in ("amp", "all"):
            kw["amp_curve"] = ((0.0, float(crng.uniform(0.1, 1.0))),
                               (0.04, float(crng.uniform(0.5, 1.6))),
                               (0.15, float(crng.uniform(0.0, 1.0))))
        if kind in ("depth", "all"):
            kw["fm_frequency"] = float(crng.uniform(3.0, 9.0))
            kw["fm_depth_curve"] = ((0.0, 0.0),
                                    (0.06, float(crng.uniform(0.005, 0.03))),
                                    (0.2, float(crng.uniform(0.0, 0.03))))
        return kw

    curve_tiles = 0
    for kind in ("bend", "amp", "depth", "all"):
        for w in waves:
            voices = wave_voices(w, count=6)
            voices = [dataclasses.replace(v, **curves(kind))
                      if i % 3 != 2 else v for i, v in enumerate(voices)]
            grouped = waves.index(w) % 2 == 0
            kern, plain = bank_pair(voices, SR, grouped=grouped)
            battery(f"curves/{kind}/{w}", kern, plain)
            curve_tiles += int(K.render_stereo.voice_tiles.item())
        mixed = [dataclasses.replace(v, **curves(kind))
                 for w in waves for v in wave_voices(w, count=1)]
        battery(f"curves/{kind}/mixed_all_waves",
                *bank_pair(mixed, SR, grouped=False))
        vpc, lyc = pack_voices(mixed, SR, num_harmonics=8, sort_by_wave=True,
                               device=dev)
        setup_err = max(setup_err, setup_check(f"curves/{kind}", vpc, lyc))
    print(f"  {curve_tiles} voice-tiles evaluated over the per-wave banks")

    # the per-tile segment windows, each path forced: every voice carries
    # all three curves, whose segment starts are patched in after packing
    W = K.WINDOW
    I32 = 2 ** 31 - 1
    patterns = {
        "one segment a tile": ([0, 3 * T + 100, 6 * T + 100, 9 * T + 100],
                               "none"),
        f"exactly {W} a tile": (
            [0] + [T + 10 + 100 * k for k in range(W - 1)]
            + [5 * T + 1 + k for k in range(W - 1)], "none"),
        f"{W + 1} a tile": ([0] + [2 * T + 10 + 10 * k for k in range(W)],
                            "some"),
        "unsorted rows": ([0, 4 * T, 2 * T, 6 * T], "all"),
        "starts at tile edges": ([0, T - 1, T, T + 1, 3 * T - 1, 3 * T,
                                  4 * T, 4 * T + 1], "none"),
    }
    nine = [0.03 * k for k in range(9)]
    many = dict(
        pitch_curve=tuple((t, 1.0 + 0.05 * ((k * 7) % 5 - 2))
                          for k, t in enumerate(nine)),
        amp_curve=tuple((t, 0.3 + 0.1 * ((k * 3) % 7))
                        for k, t in enumerate(nine)),
        fm_frequency=5.0,
        fm_depth_curve=tuple((t, 0.004 * ((k * 5) % 6))
                             for k, t in enumerate(nine)),
        duration=0.3)
    win_waves = ("sine", "sawtooth_bl", "harmonics", "square_bl", "triangle",
                 "pluck", "wavetable")

    def window_bank(starts, grouped, note_start, odd_start=None):
        """-> (bank, vp, layout): one voice a waveform, each curve row's
        starts replaced by ``starts`` (then INT32_MAX), every note at the
        absolute frame ``note_start`` (every other one at ``odd_start``)."""
        voices = [v for w in win_waves for v in wave_voices(w, 1, **many)]
        if grouped:
            vp, ly = pack_voices(voices, SR, num_harmonics=8,
                                 sort_by_wave=True, device=dev)
        else:
            vp, ly = pack_voices(voices, SR, num_harmonics=8, device=dev), None
        V = vp.wave.shape[0]

        def patched(row):
            new = torch.full_like(row, I32)
            new[:, :len(starts)] = torch.tensor(starts, dtype=torch.int32,
                                                device=dev)
            return new

        check(min(vp.bend_start.shape[1], vp.acurve_start.shape[1],
                  vp.dcurve_start.shape[1]) >= len(starts),
              f"the curve rows hold {len(starts)} starts")
        note = torch.full((V,), note_start, dtype=torch.int32, device=dev)
        if odd_start is not None:
            note[1::2] = odd_start
        vp = vp._replace(
            start=note,
            bend_start=patched(vp.bend_start),
            acurve_start=patched(vp.acurve_start),
            dcurve_start=patched(vp.dcurve_start))
        bank = VoiceBank.for_voices(voices, SR, chunk_frames=T,
                                    num_harmonics=8, layout=ly, device=dev)
        return bank, vp, bank._kernel_layout(vp)

    def window_case(name, bank, vp, layout, n0, nframes, expect):
        nonlocal render_err, setup_err
        flags = bank._flags()
        kern = K.render_stereo(vp, n0, nframes=nframes, samplerate=SR,
                               layout=layout, **flags)
        looked, whole, hist = window_count(name, vp, layout, n0, nframes,
                                           flags)
        plain = K.render_stereo_reference(vp, n0, nframes=nframes,
                                          samplerate=SR, layout=layout,
                                          **flags)
        render_err = max(render_err, compare(name, kern, plain))
        setup_err = max(setup_err, setup_check(name, vp, layout))
        check(looked > 0 and {"none": whole == 0, "all": whole == looked,
                              "some": 0 < whole < looked}[expect],
              f"{name}: {whole} of {looked} lookups search the whole row "
              f"(expected: {expect}); widths {hist}")

    for pname, (starts, expect) in patterns.items():
        for grouped in (True, False):
            lay = "grouped" if grouped else "mixed"
            bank, vp, layout = window_bank(starts, grouped, 0)
            window_case(f"windows/{pname}/{lay}", bank, vp, layout, 0,
                        12 * T + 37, expect)
    # a note that starts inside the first tile, past frame 2^24: tiles
    # before the note, the tile that straddles its start, the depth curve's
    # hoisted LFO phase at a large absolute frame
    n0 = 2 ** 24 + 5 * T + 3
    starts = patterns["starts at tile edges"][0]
    bank, vp, layout = window_bank(starts, False, n0 + T + 7)
    window_case("windows/past 2^24, tiles before the note", bank, vp, layout,
                n0, 12 * T, "none")
    # note-relative frames that wrap i32 inside tile 1 (the note "started"
    # 2^31 - 700 frames before frame 0): that tile searches the whole row;
    # the other half of the voices starts at frame 0
    bank, vp, layout = window_bank(starts, False, 0, -2 ** 31 + 700)
    window_case("windows/i32 wrap inside a tile", bank, vp, layout, 0,
                6 * T, "some")

    # harmonics of weight +0 and -0, which the curve kernel skips, under a
    # short gate and a long release, and a sustain level above 1 (clipped)
    def zero_weight_bank(grouped, **env):
        voices = []
        for i, w in enumerate(("sine", "sawtooth_bl", "harmonics",
                               "square_bl", "harmonics", "pluck")):
            v = wave_voices(w, 1)[0]
            kw = dict(curves("all" if i % 2 == 0 else "amp"), start=0.0,
                      duration=0.06, attack=0.005, decay=0.01, release=0.08)
            if w == "harmonics":
                kw["harmonics"] = ([1.0, 0.0, 0.33, 0.0, 0.2, 0.0, 0.0, 0.0],
                                   [0.0, -0.0, 0.0, 0.5, -0.0, 0.0, 0.25,
                                    0.0])[i // 4]
            voices.append(dataclasses.replace(v, **{**kw, **env}))
        if grouped:
            vp, ly = pack_voices(voices, SR, num_harmonics=8,
                                 sort_by_wave=True, device=dev)
        else:
            vp, ly = pack_voices(voices, SR, num_harmonics=8, device=dev), None
        bank = VoiceBank.for_voices(voices, SR, chunk_frames=T,
                                    num_harmonics=8, layout=ly, device=dev)
        return bank, vp, bank._kernel_layout(vp)

    for grouped in (True, False):
        for ename, env in (("", {}), (", sustain level 1.5",
                                      {"sustain_level": 1.5})):
            name = (f"zero-weight harmonics/"
                    f"{'grouped' if grouped else 'mixed'}{ename}")
            bank, vp, layout = zero_weight_bank(grouped, **env)
            window_case(name, bank, vp, layout, 0, 16 * T + 5, "none")

    # -- 9. sparse rows -----------------------------------------------------
    head("[9] sparse rows: bench.py's sparse workload (600 notes, 300 s, "
          "seed 5, chunk 131072)")
    sv = bench_song.sparse_voices()
    vps, lys = pack_voices(sv, SR, num_harmonics=8, sort_by_wave=True,
                           device=dev)
    bs = VoiceBank.for_voices(sv, SR, chunk_frames=bench_song.CHUNK_FRAMES,
                              num_harmonics=8, layout=lys,
                              nvoices=lys.nvoices, device=dev)
    total_s = int(300.0 * SR)
    plan = bs.sparse_plan(vps, total_s)
    check(plan is not None, "sparse workload takes the bucketed route")
    fn_s, idx_s, pad_s, nch_s = plan
    Vs, Ks = vps.wave.shape[0], idx_s.shape[1]
    flat_s = bs.render_song(vps, total_s)
    tiles_flat = int(K.render_stereo.voice_tiles.item())
    K.voice_setup.launches = K.render_stereo.launches = 0
    sparse_s = bs.render_song_sparse(vps, total_s)
    tiles_sparse = int(K.render_stereo.voice_tiles.item())
    check(K.render_stereo.launches == 1 and K.voice_setup.launches == 1,
          f"render_song_sparse: one launch of each kernel "
          f"({K.voice_setup.launches}, {K.render_stereo.launches})")
    check(torch.equal(sparse_s, flat_s), f"sparse == flat, bit-exact "
          f"({Vs} voices, K={Ks} rows of {nch_s} chunks)")
    sparse_sha = sha16(VoiceBank.to_int16(sparse_s))
    print(f"  sha256(int16) {sparse_sha}")
    ntiles_s = -(-nch_s * bs.chunk_frames // T)
    lay1 = K.BankLayout.ungrouped(Vs, bs.num_harmonics, bs.use_fm)
    want = int(K.active_voice_tiles(vps, 0, nch_s * bs.chunk_frames,
                                    samplerate=SR, layout=lay1, idx=idx_s,
                                    chunk_frames=bs.chunk_frames).sum())
    check(tiles_sparse == want == tiles_flat,
          f"voice-tiles evaluated: rows {tiles_sparse}, flat {tiles_flat}, "
          f"active_voice_tiles {want}; candidates tested: rows "
          f"{ntiles_s * Ks}, flat {-(-total_s // T) * Vs}")
    win = 4 * bs.chunk_frames
    plain_s = K.render_stereo_reference(vps, 0, nframes=win, samplerate=SR,
                                        layout=lay1, idx=idx_s,
                                        chunk_frames=bs.chunk_frames,
                                        **bs._flags())
    render_err = max(render_err, compare(
        f"sparse rows, kernel vs plain on frames [0, {win})",
        sparse_s[:win], plain_s))
    prof_sp, _, _ = profiled(lambda: bs.render_song_sparse(vps, total_s), 10)
    prof_fl, _, _ = profiled(lambda: bs.render_song(vps, total_s), 10)
    sparse_kernel_ms = pick(prof_sp, "render_kernel")
    flat_kernel_ms = pick(prof_fl, "render_kernel")
    print(f"  render_kernel device time: rows {sparse_kernel_ms:.6f} ms, "
          f"flat {flat_kernel_ms:.6f} ms (profiler, 10 calls each)")
    sparse_call_ms = statistics.median(
        events_ms(lambda: fn_s(vps, idx_s, pad_s, nch_s), 10)
        for _ in range(3))
    print(f"  the plan's fn, 10 back to back (CUDA events): "
          f"{sparse_call_ms:.6f} ms a call")
    cs = K.voice_constants(vps, SR, bs.num_harmonics)
    cols_s = {name: cs[:, j] for j, name in enumerate(K.CONST_COLUMNS)}
    ops_s, bytes_s, sparse_bound, sparse_by, sparse_nofma = song_bound(
        vps, cols_s, bs, total_s, cs.numel() * 4 + idx_s.numel() * 4)
    print(f"  sparse workload render bound: {ops_s:.4g} ops and {bytes_s} B "
          f"-> {sparse_bound:.6f} ms ({sparse_by}; {sparse_nofma:.6f} ms "
          f"without FMA); kernel at "
          f"{100 * sparse_bound / max(sparse_kernel_ms, 1e-9):.1f}% of it")
    del flat_s, sparse_s, plain_s

    # -- 10. the MIDI path ----------------------------------------------------
    head("[10] MIDI path: seeded GM file, ~3000 notes, 180 s, 16 channels")
    from synthesizer_tpu_torch import midi as M
    t = time.perf_counter()
    data = bench_song.gm_file(3000, 180.0, 0)
    print(f"  gm_file: {len(data)} bytes in "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    K.voice_setup.launches = 0
    K.render_stereo.launches = 0
    t = time.perf_counter()
    midi_smp = M.render_midi(data, device=dev)
    midi_pcm = midi_smp.get_frame_array()
    midi_first_s = time.perf_counter() - t
    midi_launches = {"voicebank_setup": K.voice_setup.launches,
                     "voicebank_render": K.render_stereo.launches}
    check(all(n > 0 for n in midi_launches.values()),
          f"MIDI path launched {midi_launches} ({midi_first_s:.3f} s host "
          f"time, first call)")
    again = M.render_midi(data, device=dev).get_frame_array()
    check(np.array_equal(again, midi_pcm), "the whole file rendered twice, "
          "identical bytes")
    del again       # its pinned buffer goes back to PyTorch's host cache
    midi_sha = hashlib.sha256(midi_pcm.tobytes()).hexdigest()
    print(f"  sha256(int16) {midi_sha}")
    mp = midi_pcm.astype(np.int64)
    clip = float((np.abs(mp) >= 32767).mean())
    check(isinstance(midi_smp, Sample) and midi_smp.samplerate == SR
          and midi_smp.samplewidth == 2 and midi_smp.device.type == "cuda"
          and midi_pcm.dtype == np.int16 and midi_pcm.shape[1] == 2
          and np.abs(mp).max() > 1000,
          f"MIDI output a Sample, int16 {tuple(midi_pcm.shape)}, peak "
          f"{np.abs(mp).max()}, {100 * clip:.4f}% of samples at full scale")

    # the same path step by step, each step synchronised and timed
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = (time.perf_counter() - t) * 1e3
        return out

    grace = M.release_grace_for(None)
    notes = step("parse", lambda: M.parse_midi(data, release_grace=grace))
    voices = step("voices", lambda: M.midi_to_voices(notes))
    vpm = step("pack", lambda: pack_voices(voices, SR, num_harmonics=8,
                                           device=dev))
    Vm = vpm.wave.shape[0]
    bm = VoiceBank.for_voices(voices, SR, num_harmonics=8, nvoices=Vm,
                              device=dev)
    total_m = M.song_frames(voices, SR)
    plan = step("plan", lambda: bm.sparse_plan(
        vpm, total_m, ranges=M.note_ranges(voices, Vm, SR)))
    check(plan is not None, "the MIDI file takes the sparse route")
    fn_m, idx_m, pad_m, nch_m = plan
    f32m = step("kernels", lambda: fn_m(vpm, idx_m, pad_m, nch_m))
    tiles_m = int(K.render_stereo.voice_tiles.item())
    windows_m = K.render_stereo.windows
    q16 = step("to_int16", lambda: VoiceBank.to_int16(f32m[:total_m]))
    host16 = step("copy", lambda: Sample.from_torch(
        q16, SR, 2).get_frame_array())
    check(np.array_equal(host16, midi_pcm), "step by step == render_midi, "
          "bit-exact")
    print("  steps (ms, synchronised): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    cm = K.voice_constants(vpm, SR, bm.num_harmonics)
    colm = {name: cm[:, j] for j, name in enumerate(K.CONST_COLUMNS)}
    fl = colm["flags"]
    nb, na, nd = (int(((fl & f) != 0).sum())
                  for f in (K.FLAG_BEND, K.FLAG_AMP, K.FLAG_DC))
    check(bm.use_bend and bm.use_amp and bm.use_dmod and min(nb, na, nd) > 0,
          f"{Vm} voices: {nb} bent, {na} with CC7/CC11 curves, {nd} with "
          f"CC1/pressure depth curves; K={idx_m.shape[1]} rows of {nch_m} "
          f"chunks; curve widths S={vpm.bend_start.shape[1]}, "
          f"KA={vpm.acurve_start.shape[1]}, KD={vpm.dcurve_start.shape[1]}")
    weights_m = vpm.harm_amps[vpm.wave == 8][:, :bm.num_harmonics]
    zero_weights = int((weights_m == 0).sum())
    print(f"  {weights_m.shape[0]} harmonics voices: {zero_weights} of their "
          f"{weights_m.numel()} weights are 0 (the curve kernel skips them)")
    lay_m = K.BankLayout.ungrouped(Vm, bm.num_harmonics, bm.use_fm)
    want = int(K.active_voice_tiles(vpm, 0, nch_m * bm.chunk_frames,
                                    samplerate=SR, layout=lay_m, idx=idx_m,
                                    chunk_frames=bm.chunk_frames).sum())
    check(tiles_m == want, f"MIDI voice-tiles evaluated {tiles_m} == "
          f"active_voice_tiles {want}")
    K.render_stereo.windows = windows_m
    looked_m, whole_m, hist_m = window_count(
        "MIDI rows", vpm, lay_m, 0, nch_m * bm.chunk_frames, bm._flags(),
        idx=idx_m, chunk_frames=bm.chunk_frames)
    fallback_share = whole_m / max(looked_m, 1)
    check(fallback_share < 0.05,
          f"MIDI segment windows ({K.WINDOW} segments wide): widths "
          f"{hist_m}; {whole_m} of {looked_m} (voice, tile, curve) lookups "
          f"search the whole row, {100 * fallback_share:.4f}%")
    flat_m = K.render_stereo(vpm, 0, nframes=nch_m * bm.chunk_frames,
                             samplerate=SR, layout=lay_m, **bm._flags())
    tiles_mflat = int(K.render_stereo.voice_tiles.item())
    check(torch.equal(flat_m, f32m) and tiles_mflat == tiles_m,
          f"MIDI rows == flat kernel render, bit-exact; voice-tiles "
          f"{tiles_mflat}; candidates tested: rows "
          f"{-(-nch_m * bm.chunk_frames // T) * idx_m.shape[1]}, flat "
          f"{-(-nch_m * bm.chunk_frames // T) * Vm}")
    del flat_m
    # the plain version on three windows of 4 chunks each
    cf = bm.chunk_frames
    ok_rows = (idx_m >= 0) & (idx_m < Vm)
    curvy = ((fl & (K.FLAG_BEND | K.FLAG_AMP | K.FLAG_DC)) != 0)
    per_chunk = (curvy[idx_m.clamp(0, Vm - 1).long()] & ok_rows).sum(dim=1)
    mid = int(per_chunk.argmax())
    windows = {"start": 0, "most curves": max(0, mid - 1) * cf,
               "release tail": max(0, nch_m - 4) * cf}
    midi_plain_ms = 0.0
    for wname, w0 in windows.items():
        wn = min(4 * cf, nch_m * cf - w0)
        t = time.perf_counter()
        pw = K.render_stereo_reference(vpm, w0, nframes=wn, samplerate=SR,
                                       layout=lay_m, idx=idx_m,
                                       chunk_frames=cf, **bm._flags())
        torch.cuda.synchronize()
        midi_plain_ms += (time.perf_counter() - t) * 1e3
        render_err = max(render_err, compare(
            f"MIDI {wname} window [{w0}, {w0 + wn}), kernel vs plain",
            f32m[w0:w0 + wn], pw))
    plain_frames = sum(min(4 * cf, nch_m * cf - w0) for w0 in windows.values())
    print(f"  plain version on the windows ({plain_frames} frames): "
          f"{midi_plain_ms:.3f} ms wall")

    def midi_path():
        M.render_midi(data, device=dev).get_frame_array()

    midi_wall = []
    for _ in range(5):
        t = time.perf_counter()
        midi_path()
        torch.cuda.synchronize()
        midi_wall.append((time.perf_counter() - t) * 1e3)
    print(f"  render_midi(...).get_frame_array(), host wall clock: "
          f"{spread(midi_wall)}")
    prof_midi, busy_m, pwall_m = profiled(midi_path, 3)
    midi_render_ms = max(pick(prof_midi, "render_kernel"), 1e-9)
    midi_setup_ms = max(pick(prof_midi, "setup_kernel"), 1e-9)
    print(f"  under the profiler: {pwall_m:.3f} ms wall a call, device busy "
          f"{busy_m:.6f} ms ({100 * busy_m / pwall_m:.1f}%); render_kernel "
          f"{midi_render_ms:.6f} ms, setup_kernel {midi_setup_ms:.6f} ms")
    for name, ms in sorted(prof_midi.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {ms:.6f} ms  {100 * ms / busy_m:5.1f}%  {name[:90]}")
    prof_mflat, _, _ = profiled(lambda: K.render_stereo(
        vpm, 0, nframes=nch_m * cf, samplerate=SR, layout=lay_m,
        **bm._flags()), 3)
    midi_flat_ms = pick(prof_mflat, "render_kernel")
    print(f"  render_kernel without the rows (flat, same bank): "
          f"{midi_flat_ms:.6f} ms")

    # the setup kernel with and without its per-segment pass
    Hm = bm.num_harmonics
    prof_seg, _, _ = profiled(lambda: K.voice_setup(vpm, SR, Hm, True), 10)
    prof_noseg, _, _ = profiled(lambda: K.voice_setup(vpm, SR, Hm), 10)
    seg_setup_ms = pick(prof_seg, "setup_kernel")
    noseg_setup_ms = pick(prof_noseg, "setup_kernel")
    print(f"  setup_kernel alone (profiler, 10 calls each): "
          f"{seg_setup_ms:.6f} ms with the per-segment pass, "
          f"{noseg_setup_ms:.6f} ms without: the pass takes "
          f"{seg_setup_ms - noseg_setup_ms:.6f} ms")

    # the bounds on the MIDI song: the render reads the curve rows of the
    # voices that carry the curve, from the per-segment buffer
    seg_rows = [int(((fl & bit) != 0).sum()) * width for bit, width in (
        (K.FLAG_BEND, vpm.bend_start.shape[1]),
        (K.FLAG_AMP, vpm.acurve_start.shape[1]),
        (K.FLAG_DC, vpm.dcurve_start.shape[1]))]
    seg_bytes = sum(4 * n * w for n, w in zip(seg_rows, K.SEGMENT_WORDS))
    ops_m, bytes_m, midi_bound, midi_bound_by, midi_nofma = song_bound(
        vpm, colm, bm, total_m,
        cm.numel() * 4 + seg_bytes + idx_m.numel() * 4)
    print(f"  MIDI render bound: {ops_m:.4g} ops and {bytes_m} B -> "
          f"{midi_bound:.6f} ms ({midi_bound_by}; {midi_nofma:.6f} ms "
          f"without FMA); kernel at "
          f"{100 * midi_bound / midi_render_ms:.1f}% of it")
    # the setup kernel reads every voice's segment starts (the flag and the
    # sorted test), and the other curve columns (three int64 of a bend
    # segment, two f32 of an amplitude and three of a depth segment) only
    # of the voices that carry the curve
    curve_bytes = (sum(getattr(vpm, f).numel() * 4 for f in (
        "bend_start", "acurve_start", "dcurve_start"))
        + sum(n * b for n, b in zip(seg_rows, (24, 8, 12))))
    Cm = cm.shape[1]
    msetup_bytes = (sum(getattr(vpm, f).numel() * getattr(vpm, f).element_size()
                        for f in K.KERNEL_COLUMNS) + vpm.table.numel() * 4
                    + vpm.harm_amps[:, :Hm].numel() * 4 + cm.numel() * 4
                    + curve_bytes + seg_bytes)
    msetup_ops = (Vm * (60 + 30 * ((Cm - K.CONST_BASE) // 3) + Hm
                        + vpm.table.shape[1])
                  + 90 * int(colm["pluck_ka"].sum())
                  + 2 * sum(getattr(vpm, f).numel() for f in (
                      "bend_start", "acurve_start", "dcurve_start"))
                  + sum(n * o for n, o in zip(seg_rows, OPS_SEGMENT)))
    msetup_bound, msetup_by, msetup_nofma = bound(msetup_ops, msetup_bytes)
    print(f"  MIDI setup bound: {msetup_ops:.4g} ops and {msetup_bytes} B -> "
          f"{msetup_bound:.6f} ms ({msetup_by}; {msetup_nofma:.6f} ms "
          f"without FMA); kernel at "
          f"{100 * msetup_bound / midi_setup_ms:.1f}% of it")
    midi = {"midi_launches": midi_launches,
            "midi_setup_ms": midi_setup_ms, "midi_render_ms": midi_render_ms,
            "midi_sha256": midi_sha, "sparse_workload_sha256": sparse_sha,
            "midi_render_flat_ms": midi_flat_ms,
            "midi_voice_tiles": tiles_m, "midi_bound_ms": midi_bound,
            "midi_bound_by": midi_bound_by,
            "midi_bound_nofma_ms": midi_nofma,
            "midi_windows": looked_m, "midi_window_hist": hist_m,
            "midi_fallback_share": fallback_share,
            "midi_zero_harmonic_weights": zero_weights,
            "midi_harmonic_weights": weights_m.numel(),
            "midi_registers": ptxas["render_kernel<true>"]["registers"],
            "midi_spill_bytes": ptxas["render_kernel<true>"]["spill_bytes"],
            "sparse_workload_bound_ms": sparse_bound,
            "sparse_workload_bound_by": sparse_by,
            "sparse_workload_bound_nofma_ms": sparse_nofma,
            "midi_plain_window_ms": midi_plain_ms,
            "midi_plain_window_frames": plain_frames,
            "midi_wall_ms": statistics.median(midi_wall),
            "midi_steps_ms": steps,
            "sparse_workload_render_ms": sparse_kernel_ms,
            "sparse_workload_flat_render_ms": flat_kernel_ms}


    # -- 11. pcm ---------------------------------------------------------------
    head("[11] pcm: ops/pcm.py on 1 M samples, the card against the CPU")
    from synthesizer_tpu_torch.ops import pcm as P
    NEL = 1 << 20
    prng = np.random.default_rng(11)

    def lsb_between(a, b):
        return int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())

    for width in (1, 2, 4):
        lo, hi = P.MINVAL[width], P.MAXVAL[width]
        ext = [lo, hi, -1, 0, 1, lo + 1, hi - 1]

        def samples():
            a = prng.integers(lo, hi + 1, size=NEL, dtype=np.int64)
            a[:49] = np.repeat(ext, 7)
            return a

        a_np, b_np = samples(), samples()
        b_np[:49] = np.tile(ext, 7)          # every pair of extremes meets
        npdt = {1: np.int8, 2: np.int16, 4: np.int32}[width]
        a_c = torch.from_numpy(a_np.astype(npdt))
        b_c = torch.from_numpy(b_np.astype(npdt))
        g_c = torch.from_numpy(prng.uniform(-2.0, 2.0, NEL // 2)
                               .astype(np.float32))[:, None]
        f_c = torch.from_numpy(np.concatenate([
            prng.uniform(-1.5, 1.5, NEL - 8) * (hi + 1.0),
            [3.0e9, -3.0e9, 2147483520.0, 2147483648.0, -2147483648.0,
             -2147483904.0, hi + 0.5, lo - 0.5]]).astype(np.float32))
        a_g, b_g, g_g, f_g = (t.to(dev) for t in (a_c, b_c, g_c, f_c))
        exact = {
            "sat_add": lambda a, b, g, f: P.sat_add(a, b),
            "bias_wrap": lambda a, b, g, f: torch.stack(
                [P.bias_wrap(a, k) for k in (1, -1, 100, hi, lo, 40000)]),
            **{f"lin2lin_{nw}": (lambda a, b, g, f, nw=nw: P.lin2lin(a, nw))
               for nw in (1, 2, 4)},
            "floor_clamp": lambda a, b, g, f: P.floor_clamp(
                f, width, P.DTYPES[width]),
            "mul_floor": lambda a, b, g, f: torch.stack(
                [P.mul_floor(a, k) for k in (0.5, -1.0, 1.7, 1.0 / 3.0,
                                             -3.0e9)]),
            "gain_apply": lambda a, b, g, f: P.gain_apply(
                a.reshape(-1, 2), g),
            "to_stereo": lambda a, b, g, f: P.to_stereo(a[:, None], 0.7, -1.3),
            "peak": lambda a, b, g, f: torch.stack(
                [P.peak(a), P.peak(a[100:] // 3), P.peak(a[:0])]),
        }
        bad = [name for name, fn in exact.items()
               if not torch.equal(fn(a_g, b_g, g_g, f_g).cpu(),
                                  fn(a_c, b_c, g_c, f_c))]
        check(not bad and P.width_of(a_g) == width,
              f"pcm width {width}: {sorted(exact)} on the card bit-identical "
              f"to the CPU{'' if not bad else ', EXCEPT ' + str(bad)}")
        mono_tol = 1 if width <= 2 else 256   # one f32 ulp below 2^31
        mono = max(lsb_between(P.to_mono(a_g.reshape(-1, 2), lf, rf),
                               P.to_mono(a_c.reshape(-1, 2), lf, rf))
                   for lf, rf in ((1.0, 1.0), (0.3, 0.9), (-1.0, 0.25)))
        check(mono <= mono_tol, f"pcm width {width}: to_mono card vs CPU "
              f"{mono} (tolerance {mono_tol}: 1 LSB)")
        ms_g = P.rms_mean_square(a_g)
        ms_c = float(P.rms_mean_square(a_c))
        rel = abs(float(ms_g) - ms_c) / max(ms_c, 1e-30)
        check(rel <= 1e-6 and torch.equal(ms_g, P.rms_mean_square(a_g)),
              f"pcm width {width}: rms_mean_square relative difference "
              f"{rel:.3g} (<= 1e-6), run-to-run bit-exact on the card")
        vu_g = P.vu_levels(a_g.reshape(-1, 2)).cpu()
        vu_c = P.vu_levels(a_c.reshape(-1, 2))
        check(torch.equal(vu_g[:2], vu_c[:2]) and bool(
            ((vu_g[2:] - vu_c[2:]).abs() <= 1e-6 * vu_c[2:]).all()),
            f"pcm width {width}: vu_levels peaks equal, mean squares within "
            f"1e-6")
    del a_g, b_g, g_g, f_g

    # -- 12. wavesynth ---------------------------------------------------------
    head(f"[12] wavesynth at full width: bench.py's configs 1 and 4 ({card})")
    from synthesizer_tpu_torch import WaveSynth, oscillators
    from synthesizer_tpu_torch.models import graph as G
    from synthesizer_tpu_torch.models import spec as S

    def timed(fn, reps=10):
        """-> (median ms by CUDA events, median ms by wall clock) of fn,
        each call synchronised; one warm-up call first."""
        fn()
        torch.cuda.synchronize()
        ev, wl = [], []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            wl.append((time.perf_counter() - t) * 1e3)
            ev.append(start.elapsed_time(end))
        return ev, wl

    ws_g, ws_c = WaveSynth(SR, 2, device=dev), WaveSynth(SR, 2, device="cpu")
    sine_g = ws_g.sine(440.0, 2.0)
    sine_c = ws_c.sine(440.0, 2.0)
    check(sine_g.device.type == "cuda" and sine_g.nframes == 2 * SR
          and sine_g.nchannels == 1 and sine_g.samplewidth == 2
          and np.array_equal(sine_g.get_frame_array(),
                             sine_c.get_frame_array())
          and int(np.abs(sine_c.get_frame_array().astype(np.int64)).max())
          > 32000,
          "config 1, WaveSynth().sine(440.0, 2.0): card == CPU bit for bit, "
          f"{sine_g.nframes} frames")
    noise_node = S.Osc("white_noise", SR, 0.5, seed=42)
    noise_g = G.render_patch(noise_node, 10000, SR, device=dev)
    noise_sha = hashlib.sha256(
        noise_g.cpu().numpy().tobytes()).hexdigest()[:16]
    check(noise_sha == "7d5f6f9b694b18a5" and torch.equal(
        noise_g.cpu(), G.render_patch(noise_node, 10000, SR, device="cpu")),
        f"noise digest on the card {noise_sha} == 7d5f6f9b694b18a5, == CPU")
    patch4 = S.Echo(
        S.AmpMod(S.Osc("sawtooth", 330.0, 0.7,
                       fm_lfo=S.Osc("sine", 5.0, 0.01)),
                 S.Osc("sine", 2.0, amplitude=0.4, bias=0.6)),
        0.05, 4, 0.07, 0.6)
    CH, NCH = 1470, 30

    def stream4(device):
        out = []
        for blk in G.block_stream(patch4, SR, CH, device=device):
            out.append(blk)
            if len(out) == NCH:
                return np.concatenate(out)

    def offline4(device):
        return G.render_patch(patch4, CH * NCH, SR, device=device)

    st_g, off_g = stream4(dev), offline4(dev).cpu().numpy()
    off_c = offline4("cpu").numpy()
    check(st_g.shape == (CH * NCH,) and np.array_equal(st_g, off_g),
          f"config 4: {NCH} chunks of {CH} through block_stream == one "
          f"offline render, bit for bit (peak {np.abs(off_g).max():.4f})")
    check(np.array_equal(off_g, off_c) and np.array_equal(
        stream4("cpu"), off_c), "config 4: card == CPU bit for bit, "
        "streaming and offline")
    ints = []
    for smp in ws_g.oscillator_gen(oscillators.Oscillator(patch4, SR), CH):
        ints.append(smp.torch_frames)
        if len(ints) == NCH:
            break
    check(torch.equal(torch.cat(ints)[:, 0],
                      G.to_int_device(offline4(dev), 2)),
          "config 4: oscillator_gen chunks (on the card) == the offline "
          "render quantized")
    src_b = S.Osc("sawtooth", 330.0, 0.8)
    for bname, node, tol in (
            ("lowpass 1000 Hz q 0.7071", S.Biquad(src_b, "lowpass", 1000.0,
                                                  0.7071), 2),
            ("swept lowpass 800 Hz q 0.7071", S.Biquad(
                S.Osc("sawtooth", 110.0, 0.8), "lowpass", 800.0, 0.7071,
                cutoff_lfo=S.Osc("sine", 0.5, amplitude=2.0)), 3)):
        bq_g = G.render_patch(node, SR // 2, SR, 2048, device=dev).cpu()
        bq_c = G.render_patch(node, SR // 2, SR, 2048, device="cpu")
        d = float((torch.round(bq_g.double() * 32767)
                   - torch.round(bq_c.double() * 32767)).abs().max())
        check(bool(torch.isfinite(bq_g).all()) and d <= tol
              and float(bq_g.abs().max()) > 0.1,
              f"Biquad {bname}: card vs CPU {d:.0f} LSB (budget {tol})")
    for tname, fn in (
            ("config 1: WaveSynth.sine(440, 2.0), 88200 frames",
             lambda: ws_g.sine(440.0, 2.0)),
            ("config 1 to the host (get_frame_array)",
             lambda: ws_g.sine(440.0, 2.0).get_frame_array()),
            (f"config 4: {NCH} chunks of {CH} through block_stream, to the "
             f"host", lambda: stream4(dev)),
            (f"config 4: one offline render_patch, {CH * NCH} frames",
             lambda: offline4(dev))):
        ev, wl = timed(fn)
        _, busy12, pwall12 = profiled(fn, 3)
        print(f"  {tname}: CUDA events {spread(ev)}; wall clock {spread(wl)}; "
              f"under the profiler {profiled.launches:.0f} device operations "
              f"a call, device busy {busy12:.6f} ms of {pwall12:.6f} ms wall "
              f"({100 * busy12 / pwall12:.1f}%)")

    # -- 13. sample ------------------------------------------------------------
    head(f"[13] sample: a chain to a WAV, and the pinned host copy ({card})")
    def chain(ws):
        other = ws.triangle(660.0, 0.5, amplitude=0.4).stereo(0.8, 0.5)
        smp = (ws.sine(440.0, 2.0).amplify(0.7).fadein(0.3).fadeout(0.5, 0.1)
               .stereo().mix_at(0.75, other).pan(-0.3))
        bio = io.BytesIO()
        smp.write_wav(bio)
        return smp, bio.getvalue()

    smp_g, wav_g = chain(ws_g)
    smp_c, wav_c = chain(ws_c)
    check(smp_g.device.type == "cuda" and wav_g == wav_c
          and len(wav_g) == 44 + 2 * SR * 4,
          f"chain sine -> amplify -> fadein -> fadeout -> stereo -> mix_at "
          f"-> pan -> write_wav: {len(wav_g)} bytes on the card == the CPU "
          f"chain's")
    ev, wl = timed(lambda: chain(ws_g))
    print(f"  the chain, render to WAV bytes: CUDA events {spread(ev)}; wall "
          f"clock {spread(wl)}")
    song5 = bench_song.song_sample(*config5)
    host5 = song5.get_frame_array(out=pinned)
    sha5 = hashlib.sha256(host5.tobytes()).hexdigest()
    check(pinned.is_pinned() and sha5 == CONFIG5_SHA256
          and np.array_equal(song5.get_frame_array(), host5),
          f"config 5 through Sample.from_torch(...).get_frame_array(out="
          f"pinned): sha256 {sha5[:16]}... == {CONFIG5_SHA256[:16]}...; the "
          f"sample's own pinned buffer holds the same bytes")

    def main_pageable():
        bank5, vp5, total5 = config5
        bank5.to_int16(bank5.render_song(vp5, total5)).cpu()

    def main_own_buffer():
        bench_song.song_sample(*config5).get_frame_array()

    copies = {"pageable (.cpu())": main_pageable,
              "pinned, one buffer (out=)": main_path,
              "pinned, a buffer per call (caching allocator)":
              main_own_buffer}
    copy_stats = {k: {"wall": [], "dtoh": [], "busy": [], "pwall": []}
                  for k in copies}
    # two rounds in mirrored order, so that a drift of the host's clock
    # falls on each side alike
    order = list(copies) + list(copies)[::-1]
    for name in order:
        fn = copies[name]
        fn()
        torch.cuda.synchronize()
        for _ in range(10):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            copy_stats[name]["wall"].append((time.perf_counter() - t) * 1e3)
        by_name, busy, pwall = profiled(fn, 5)
        copy_stats[name]["dtoh"].append(pick(by_name, "Memcpy DtoH"))
        copy_stats[name]["busy"].append(busy)
        copy_stats[name]["pwall"].append(pwall)
    nbytes5 = pinned.numel() * pinned.element_size()
    for name, st in copy_stats.items():
        dtoh = statistics.mean(st["dtoh"])
        print(f"  main path, {name}: wall clock {spread(st['wall'])}; under "
              f"the profiler Memcpy DtoH {dtoh:.6f} ms a call "
              f"({nbytes5 / max(dtoh, 1e-9) / 1e6:.1f} GB/s for {nbytes5} B), "
              f"device busy {statistics.mean(st['busy']):.6f} ms of "
              f"{statistics.mean(st['pwall']):.6f} ms wall")
    t = time.perf_counter()
    fresh = torch.empty(6 * nbytes5, dtype=torch.uint8, pin_memory=True)
    alloc_ms = (time.perf_counter() - t) * 1e3
    print(f"  a fresh pinned buffer of {fresh.numel()} B (no cached block of "
          f"its size): {alloc_ms:.3f} ms of host time to allocate; the "
          f"buffers above are reused or come from PyTorch's pinned cache")
    del fresh
    dtoh_page = statistics.mean(copy_stats["pageable (.cpu())"]["dtoh"])
    dtoh_pin = statistics.mean(
        copy_stats["pinned, one buffer (out=)"]["dtoh"])
    check(dtoh_page > 0.0 and dtoh_pin > 0.0,
          f"the profiler shows the copies: Memcpy DtoH pageable "
          f"{dtoh_page:.6f} ms, pinned {dtoh_pin:.6f} ms")

    resample_and_effects(dev, card, midi_smp.torch_frames, spread, timed,
                         profiled)

    src = "synthesizer_tpu_torch/csrc/voicebank_render.cu"
    print(json.dumps({"kernels": [
        {"name": "voicebank_setup", "route": "cuda", "source": src,
         "replaces": "synthesizer_tpu/ops/kernels.py:58",
         "launches": launches["voicebank_setup"], "max_abs_err": setup_err,
         "ms": setup_ms, "plain_ms": plain_setup_ms, "bound_ms": setup_bound,
         "bound_by": setup_by, "library_ms": None,
         "bound_nofma_ms": setup_nofma, **ptxas["setup_kernel"],
         "midi_launches": midi_launches["voicebank_setup"],
         "midi_ms": midi_setup_ms, "midi_bound_ms": msetup_bound,
         "midi_bound_by": msetup_by, "midi_bound_nofma_ms": msetup_nofma,
         "midi_segment_pass_ms": seg_setup_ms - noseg_setup_ms,
         "midi_ms_without_segment_pass": noseg_setup_ms},
        {"name": "voicebank_render", "route": "cuda", "source": src,
         "replaces": "synthesizer_tpu/ops/kernels.py:58",
         "launches": launches["voicebank_render"], "max_abs_err": render_err,
         "ms": render_ms, "plain_ms": plain_ms, "bound_ms": render_bound,
         "bound_by": render_by, "library_ms": None,
         "bound_nofma_ms": render_nofma, **ptxas["render_kernel<false>"],
         "voice_tiles": tiles5,
         "render_song_ms": statistics.median(song_ms),
         "render_chunk_ms": statistics.median(chunk_ms),
         "main_path_ms": statistics.median(wall),
         **{k: v for k, v in midi.items() if k != "midi_launches"},
         "midi_launches": midi_launches["voicebank_render"]}]}))
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
