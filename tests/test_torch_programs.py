"""The port's compiled programs (``utils.program.Program``, the counterpart
of ``jax.jit``) on the CPU.

A CUDA graph replays the launches it captured with whatever the captured
buffers hold, so a program's body must read every dynamic number from its
inputs and nothing from the host.  On the CPU the tests hold each body to
that through ``Program.trace_cpu`` (``make_fx`` on fake tensors, the CPU
analogue of a capture): traced once on one set of inputs and replayed on
another -- another first frame, another knob value, a carried state a few
blocks on -- it must equal the eager body bit for bit.  Then the cache
keys, and the counterparts of the JAX package's fusion tests, with the
port's program launches counted beside the JAX package's.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from synthesizer_tpu import sample as JSM
from synthesizer_tpu.synth import WaveSynth as JWaveSynth
from synthesizer_tpu.utils import profiling as jprof
from synthesizer_tpu_torch import bench_song
from synthesizer_tpu_torch import effects as E
from synthesizer_tpu_torch import sample as SM
from synthesizer_tpu_torch import voice as V
from synthesizer_tpu_torch.models import graph as G
from synthesizer_tpu_torch.models import spec as S
from synthesizer_tpu_torch.ops import coeffs as C
from synthesizer_tpu_torch.ops import effects as F
from synthesizer_tpu_torch.oscillators import Oscillator
from synthesizer_tpu_torch.synth import WaveSynth
from synthesizer_tpu_torch.utils import profiling
from synthesizer_tpu_torch.utils import program as P
from synthesizer_tpu_torch.utils.program import Flat, Program

SR = 44100
CPU = torch.device("cpu")
B = 64          # frames a block or chunk: small, so that the traces are cheap


def _same(x, y) -> bool:
    a, b = pytree.tree_leaves(x), pytree.tree_leaves(y)
    return len(a) == len(b) and all(
        p.shape == q.shape and p.dtype == q.dtype and torch.equal(p, q)
        for p, q in zip(a, b))


def _chunks(n, seed=0, frames=B, nch=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n * frames)[:, None] / SR
    x = 0.3 * np.sin(2 * np.pi * 330.0 * t + np.array([0.0, 0.5])[:nch]) \
        + 0.05 * rng.standard_normal((n * frames, nch))
    return list(torch.from_numpy(np.rint(x * 32767).astype(np.int16))
                .split(frames))


def _processor(proc, frames=B, nch=2):
    """The processor's program and the (args, kw) of its calls on chunks 1
    and 2 (after a first chunk).  The biquads' scans trace thousands of
    operations a chunk: they take 4-frame mono chunks, as do the reverb
    and the phaser."""
    xs = _chunks(3, frames=frames, nch=nch)
    proc.process(xs[0])
    calls, real = [], proc._prog

    def record(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    proc._prog = record
    proc.process(xs[1])
    proc.process(xs[2])
    proc._prog = real
    return real, calls[0], calls[1]


def _stream_step():
    init, prog = G._stream_step(bench_song.config4_patch(), SR, B, 2, CPU)
    st = init
    for k in range(3):
        _, st = prog.eager(st, i=(k * B,))
    return prog, ((init,), {"i": (0,)}), ((st,), {"i": (3 * B,)})


def _voice_block():
    rv = V.RealtimeVoice(Oscillator(bench_song.config4_patch(), SR), 0.001,
                         0.002, 0.7, 0.01, blocksize=B,
                         echo=(0.001, 2, 0.0005, 0.5), device="cpu")
    c = rv._carry
    for k in range(3):
        _, c = rv._program.eager(c, f=(1.0,), i=(k * B, V._HELD))
    return (rv._program, ((rv._carry,), {"f": (1.0,), "i": (0, V._HELD)}),
            ((c,), {"f": (0.625,), "i": (3 * B, 3 * B + 20)}))


def _nets():
    return tuple((tuple(c), tuple(a)) for c, a in (
        C.reverb_delays(SR, ch) for ch in range(2)))


def _mono(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(n) * 0.1)
                            .astype(np.float32))


def _reverb_whole():
    nets = _nets()
    F._reverb_networks_whole(_mono(1200, 1), nets, 0.84, 0.2)
    prog = P.program("reverb_whole", nets, None, CPU)
    return (prog, ((_mono(1200, 1),), {"f": (0.84, 0.2)}),
            ((_mono(1200, 2),), {"f": (0.9, 0.3)}))


def _reverb_networks():
    nets = _nets()
    states = [F.reverb_zero_state(c, a, CPU) for c, a in nets]
    st2, _ = F.reverb_networks_apply(states, _mono(B, 1), nets, 0.84, 0.2)
    prog = P.program("reverb_networks", (nets, False), None, CPU)
    return (prog, ((states, _mono(B, 1), ()), {"f": (0.84, 0.2)}),
            ((st2, _mono(B, 2), ()), {"f": (0.9, 0.3)}))


def _render_patch():
    """patch_values' program: three blocks a replay."""
    init, prog = G._stream_step(S.Osc("sine", 440.0, 0.5), SR, 128, None, CPU,
                                blocks=3)
    _, st = prog.eager(init, i=(0,))
    return prog, ((init,), {"i": (0,)}), ((st,), {"i": (384,)})


def _reverb_combs():
    """The slab program of a long signal's comb stage: 3 steps a slab."""
    nets = _nets()
    ds = tuple(D for c, _ in nets for D in c)
    rows = F._comb_rows(_mono(4000, 3), ds, 6)
    z = torch.zeros((len(ds), max(ds)))
    zf = torch.zeros(len(ds))
    prog = P.program("reverb_combs", ds, lambda: (
        lambda brow, fs, x, f, i: F._comb_loop(x, brow, fs, ds, f[0], f[1],
                                               1.0 - f[1])), CPU)
    _, b1, f1 = prog.eager(z, zf, rows[:3], f=(0.84, 0.2))
    return (prog, ((z, zf, rows[:3]), {"f": (0.84, 0.2)}),
            ((b1, f1, rows[3:]), {"f": (0.9, 0.3)}))


def _sample_chain():
    def staged(seed, knobs):
        x = torch.from_numpy((np.random.default_rng(seed).standard_normal(
            (300, 2)) * 6000).astype(np.int16))
        s = SM.Sample.from_torch(x, SR, 2)
        s.compress(threshold_db=knobs[0], ratio=knobs[1]).chorus() \
            .reverb(roomsize=knobs[2], tail=0.005).fadeout(0.001) \
            .amplify(knobs[3]).pan(knobs[4])
        return s
    a = staged(1, (-15.0, 4.0, 0.3, 0.9, -0.3))
    b = staged(2, (-9.0, 2.0, 0.9, 0.7, 0.4))
    return (SM._compile_program(tuple(a._ops), CPU),
            ((a._base, ()), {"f": a._dyn}), ((b._base, ()), {"f": b._dyn}))


CV = dict(tickf=50.0)
#: every program of the port's five program paths, at a small size
PROGRAMS = {
    "stream_step": _stream_step,
    "render_patch": _render_patch,
    "voice_block": _voice_block,
    "reverb_whole": _reverb_whole,
    "reverb_networks": _reverb_networks,
    "reverb_combs": _reverb_combs,
    "sample_chain": _sample_chain,
    "fx_compress": lambda: _processor(E.StreamingCompressor(
        SR, makeup_curve=[(0, 0.0), (3, 6.0)],
        threshold_curve=[(0, -20.0), (3, -10.0)],
        attack_curve=[(0, 0.005), (3, 0.02)], **CV, device="cpu")),
    "fx_biquad": lambda: _processor(E.StreamingBiquad(
        SR, 1, "lowpass", 5000.0, device="cpu"), 4, 1),
    "fx_biquad_ff": lambda: _processor(E.StreamingBiquad(
        SR, 1, "lowshelf", 60.0, gain_db=6.0, device="cpu"), 4, 1),
    "fx_eq": lambda: _processor(E.StreamingEQ(
        SR, 1, mid_db=-2.0, mid_freq=4000.0,
        high_curve=[(0, 0.0), (3, 6.0)], tickf=10.0, device="cpu"), 4, 1),
    "fx_swept_eq_band": lambda: _processor(E.SweptEQBand(
        SR, 1, "highshelf", 8000.0, 0.7071, [(0, -6.0), (3, 6.0)], 10.0,
        device="cpu"), 4, 1),
    "fx_swept_gain_kind": lambda: _processor(E.SweptGainKindBiquad(
        SR, 1, "highshelf", 1.0, 4.0, [(0, 3000.0), (3, 8000.0)], 10.0,
        device="cpu"), 4, 1),
    "fx_swept_biquad": lambda: _processor(E.SweptStreamingBiquad(
        SR, 1, "lowpass", 1.0, [(0, 200.0), (3, 2000.0)], 10.0,
        device="cpu"), 4, 1),
    "fx_gate": lambda: _processor(E.StreamingGate(
        SR, threshold_curve=[(0, -40.0), (3, -20.0)], **CV, device="cpu")),
    "fx_reverb": lambda: _processor(E.StreamingReverb(
        SR, 1, wet_curve=[(0, 0.2), (3, 0.5)],
        roomsize_curve=[(0, 0.5), (3, 0.9)], tickf=10.0, device="cpu"),
        4, 1),
    "fx_chorus": lambda: _processor(E.StreamingChorus(
        SR, 2, rate_curve=[(0, 0.5), (3, 2.0)],
        depth_curve=[(0, 0.001), (3, 0.003)], wet_curve=[(0, 0.2), (3, 0.6)],
        **CV, device="cpu")),
    "fx_convolve": lambda: _processor(E.StreamingConvolver(
        np.random.default_rng(3).standard_normal(40).astype(np.float32)
        * 0.1, device="cpu")),
    "fx_echo": lambda: _processor(E.StreamingFeedbackEcho(
        SR, 2, delay=0.001, feedback_curve=[(0, 0.2), (3, 0.6)], **CV,
        device="cpu")),
    "fx_width": lambda: _processor(E.StreamingWidth(
        SR, 2, amount_curve=[(0, 0.5), (3, 2.0)], **CV, device="cpu")),
    "fx_limiter": lambda: _processor(E.StreamingLimiter(
        SR, 2, ceiling_curve=[(0, -3.0), (3, -1.0)],
        release_curve=[(0, 0.05), (3, 0.1)], lookahead=0.0005, **CV,
        device="cpu")),
    "fx_phaser": lambda: _processor(E.StreamingPhaser(
        SR, 1, stages=2, wet_curve=[(0, 0.2), (3, 0.6)], tickf=10.0,
        device="cpu"), 4, 1),
    "fx_tremolo": lambda: _processor(E.StreamingTremolo(SR, 2,
                                                        device="cpu")),
    "fx_autopan": lambda: _processor(E.StreamingAutopan(SR, 2,
                                                        device="cpu")),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_traced_body_replays_new_inputs_bit_for_bit(name):
    """The body traced on the first inputs, replayed on the second (another
    first frame, other knobs, a state some blocks on), equals the eager
    body on the second: no number of the first call was baked in and
    nothing was read back from the device."""
    prog, (aa, ka), (ab, kb) = PROGRAMS[name]()
    traced = prog.trace_cpu(*aa, **ka)
    want = prog.eager(*ab, **kb)
    assert _same(traced(*ab, **kb), want)
    assert not _same(prog.eager(*aa, **ka), want)


def test_a_baked_number_fails_the_check():
    """A body that takes its first frame as a Python number (held outside
    its inputs, as the eager step took ``n0``) traces that number in: the
    replay on another frame repeats the old block."""
    init, step = G.lower(bench_song.config4_patch(), SR, B, CPU)
    frame = {"n0": 0}
    prog = Program(lambda st, f, i: step(st, frame["n0"]), "baked", CPU)
    traced = prog.trace_cpu(init)
    frame["n0"] = 5 * B
    assert not _same(traced(init), prog.eager(init))
    # the same step with the frame as a device scalar passes
    good = Program(lambda st, f, i: step(st, i[0]), "step", CPU)
    traced = good.trace_cpu(init, i=(0,))
    assert _same(traced(init, i=(5 * B,)), good.eager(init, i=(5 * B,)))


@pytest.mark.parametrize("read", ["float", "item", "tolist", "bool"])
def test_a_host_read_in_the_body_raises(read):
    """Reading a device value on the host inside a body (what a capture
    cannot replay) raises at the trace."""
    body = {
        "float": lambda x, f, i: x * float(x.max()),
        "item": lambda x, f, i: x if x.sum().item() > 0 else -x,
        "tolist": lambda x, f, i: x[:len([v for v in x.tolist() if v > 0])],
        "bool": lambda x, f, i: x if bool((x > 0).any()) else -x,
    }[read]
    with pytest.raises(Exception, match="data-dependent|[Dd]ata.?[Dd]ep"):
        Program(body, read, CPU).trace_cpu(torch.arange(4.0))


def test_cache_keys():
    """One program a configuration, one key a chunk shape: a second stream
    of a patch reuses its program, processors that differ only in their
    knobs share one, and a new chunk shape makes a new entry."""
    node = bench_song.config4_patch()
    assert G._stream_step(node, SR, B, 2, CPU)[1] \
        is G._stream_step(node, SR, B, 2, CPU)[1]
    assert G._stream_step(node, SR, B, 2, CPU)[1] \
        is not G._stream_step(node, SR, 2 * B, 2, CPU)[1]
    a = E.StreamingCompressor(SR, -18.0, 4.0, device="cpu")
    b = E.StreamingCompressor(SR, -9.0, 2.0, attack=0.02, device="cpu")
    assert a._prog is b._prog
    xs = _chunks(2)
    a.process(xs[0])
    n = len(a._prog)
    b.process(xs[1])
    assert len(a._prog) == n
    a.process(xs[0][:B // 2])
    assert len(a._prog) == n + 1


def test_flat_round_trip_keeps_bits():
    tree = ((torch.tensor(7, dtype=torch.int64), torch.arange(3.0)),
            (), torch.tensor([True, False]), torch.zeros(2, dtype=torch.int16))
    flat = Flat(tree, CPU)
    buf = flat.pack(tree)
    assert buf.dtype == torch.uint8 and buf.numel() == flat.nbytes == 8 + 12 \
        + 2 + 4
    assert _same(flat.unpack(buf), tree)


def _frames(n=2000, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, 2)) * 5000) \
        .astype(np.int16)


def _pair(n=2000, seed=0, nch=2):
    a = _frames(n, seed)[:, :nch].copy()
    return (JSM.Sample.from_raw_frames(a.tobytes(), 2, SR, nch),
            SM.Sample.from_raw_frames(a.tobytes(), 2, SR, nch, device="cpu"))


def _count(mod, fn):
    with mod.count_program_launches() as n:
        fn()
    return n[0]


def test_effects_chain_fuses_to_one_program():
    """tests/test_effects.py::test_effects_chain_fuses_to_one_program on the
    port: staged until read, then ONE program, as in the JAX package."""
    counts = []
    for smp, prof in zip(_pair(), (jprof, profiling)):
        def run():
            smp.compress(threshold_db=-15.0).chorus().reverb(tail=0.1) \
                .fadeout(0.01).amplify(0.9)
            assert smp.nframes == 2000 + int(0.1 * SR)
        counts.append((_count(prof, run), _count(prof, smp.get_frame_array)))
    assert counts[1] == counts[0] == (0, 1)


def test_effect_knobs_reuse_compiled_program():
    """The same chain shape with other knob values reuses the program."""
    def chain(s, thr, ratio, room):
        s.compress(threshold_db=thr, ratio=ratio).reverb(roomsize=room,
                                                         tail=0.1)
        s.get_frame_array()
    _, t1 = _pair(1000)
    chain(t1, -15.0, 4.0, 0.3)
    progs = {id(p): len(p) for p in P.programs("sample_chain")}
    _, t2 = _pair(1000, seed=1)
    chain(t2, -9.0, 2.0, 0.9)
    assert {id(p): len(p) for p in P.programs("sample_chain")} == progs


def test_new_fx_stage_lazily():
    """The strip of feedback echo, phaser, width and limiter fuses into one
    program in both packages."""
    counts = []
    for smp, prof in zip(_pair(), (jprof, profiling)):
        counts.append(_count(prof, lambda: (
            smp.feedback_echo(0.01, 0.4, 0.4, tail=0.05).phaser(rate=1.0)
            .stereo_width(1.3).limit(-2.0).get_frame_array())))
    assert counts[1] == counts[0] == 1


def test_pan_sample_lfo_fuses():
    """pan(lfo=Sample) with a pending op on the LFO fuses the LFO's chain
    in as a sub-program: one program, as in the JAX package, and the same
    frames within 1 LSB."""
    n = 2000
    lfo = (np.sin(np.arange(n) * 0.002) * 32767).astype(np.int16)
    counts, out = [], []
    for pkg, prof, kw in ((JSM, jprof, {}), (SM, profiling,
                                            {"device": "cpu"})):
        smp = pkg.Sample.from_raw_frames(_frames(n).tobytes(), 2, SR, 2,
                                         **kw)
        dlfo = pkg.Sample.from_raw_frames(lfo.tobytes(), 2, SR, 1, **kw)
        dlfo.amplify(1.0)
        counts.append(_count(prof, lambda: out.append(
            smp.pan(lfo=dlfo).get_frame_array())))
    assert counts[1] == counts[0] == 1
    assert np.abs(out[0].astype(np.int64) - out[1].astype(np.int64)).max() \
        <= 1


def test_config3_chain_program_count_matches_jax():
    """tests/test_sequencer.py:175's chain: 16 synthesized tracks,
    resampled, shaped and mixed; the port launches as many programs as the
    JAX package (one), and the frames agree within 1 LSB."""
    counts, out = [], []
    for pkg, synth, prof, kw in (
            (JSM, JWaveSynth(samplerate=22050, samplewidth=2), jprof, {}),
            (SM, WaveSynth(samplerate=22050, samplewidth=2, device="cpu"),
             profiling, {"device": "cpu"})):
        def run():
            total = pkg.Sample.from_raw_frames(b"", 2, SR, 2, **kw)
            for t in range(16):
                s = synth.sine(100.0 + 50 * t, 0.25, amplitude=0.4)
                s.resample(SR).amplify(0.5 + 0.02 * t).fadein(0.02) \
                    .fadeout(0.05).stereo()
                total.mix_at(0.05 * t, s)
            out.append(total.get_frame_array())
        counts.append(_count(prof, run))
    assert counts[1] == counts[0] <= 3
    assert out[0].shape == out[1].shape
    assert np.abs(out[0].astype(np.int64) - out[1].astype(np.int64)).max() \
        <= 1


def test_max_pending_materializes_the_161st_op():
    _, smp = _pair(100)
    with profiling.count_program_launches() as n:
        for _ in range(SM._MAX_PENDING):
            smp.amplify(1.0)
        assert n[0] == 0 and len(smp._ops) == SM._MAX_PENDING
        smp.amplify(1.0)
    assert n[0] == 1 and not smp._ops


def test_metadata_reads_without_a_run():
    """nframes, duration and the format follow the staged ops without
    running them, as in the JAX package."""
    meta = []
    for smp, prof in zip(_pair(), (jprof, profiling)):
        def run():
            smp.reverb(tail=0.1).stretch(1.5, frame=256, hop=64) \
                .resample(22050).mono().make_32bit()
            meta.append((smp.nframes, smp.duration, smp.nchannels,
                         smp.samplewidth, smp.samplerate))
        assert _count(prof, run) == 0
    assert meta[0] == meta[1]


def test_long_reverb_replays_slabs_bit_for_bit(monkeypatch):
    """A whole-signal reverb of more than WHOLE_STEPS comb steps runs its
    comb stage as replays of one SLAB_STEPS program (the last slab padded
    with zero rows): the same bits as the one program's unrolled loop."""
    nets = _nets()
    x = _mono(30000, 5)
    want = F._reverb_networks_whole(x, nets, 0.84, 0.2)
    assert F.whole_reverb_route(30000, nets) == "one"
    monkeypatch.setattr(F, "WHOLE_STEPS", 4)
    for slab in (3, 8):
        monkeypatch.setattr(F, "SLAB_STEPS", slab)
        assert F.whole_reverb_route(30000, nets) == "slabs"
        got = F._reverb_networks_whole(x, nets, 0.84, 0.2)
        assert _same(got, want)
    ds = tuple(D for c, _ in nets for D in c)
    slab = P.program("reverb_combs", ds, None, CPU)
    assert len(slab) == 2        # one key a slab length, whatever the signal


def test_long_reverb_runs_after_the_chain(monkeypatch):
    """Sample.reverb over more comb steps than one program unrolls does not
    stage: the chain before it materialises, the reverb runs its slabs,
    and the frames equal those of the staged reverb."""
    def chain():
        _, smp = _pair(3000)
        smp.amplify(0.8).reverb(tail=0.05)
        staged = len(smp._ops)
        return staged, smp.get_frame_array()
    staged, want = chain()
    assert staged == 2
    monkeypatch.setattr(F, "WHOLE_STEPS", 2)
    monkeypatch.setattr(F, "SLAB_STEPS", 2)
    with profiling.count_program_launches() as n:
        staged, got = chain()
    assert staged == 0 and n[0] >= 2
    np.testing.assert_array_equal(got, want)


def test_patch_render_in_groups_of_blocks(monkeypatch):
    """patch_values steps at most RENDER_BLOCKS blocks a program: a longer
    render replays it (and one program of the rest), bit for bit the
    render of one program, and the key does not hold the length."""
    node = bench_song.config4_patch()
    want = G.patch_values(node, 7 * B - 5, SR, B, CPU)
    monkeypatch.setattr(G, "RENDER_BLOCKS", 2)
    with profiling.count_program_launches() as n:
        got = G.patch_values(node, 7 * B - 5, SR, B, CPU)
    assert n[0] == 4 and torch.equal(got, want)
    assert G._stream_step(node, SR, B, None, CPU, blocks=2)[1] \
        is G._stream_step(node, SR, B, None, CPU, blocks=2)[1]


def test_keys_are_bounded(monkeypatch):
    """Past MAX_KEYS the least recently used key is dropped (its next call
    starts again from an eager first call); a key in use stays."""
    monkeypatch.setattr(P, "MAX_KEYS", 3)
    prog = Program(lambda x, f, i: x * f[0], "bounded", CPU)
    xs = [torch.ones(k) for k in range(1, 6)]
    for x in xs[:3]:
        prog(x, f=(2.0,))
    prog(xs[0], f=(2.0,))                       # key 1 is the newest now
    prog(xs[3], f=(2.0,))                       # drops key 2, the oldest
    assert len(P._LRU) <= 3 and len(prog) == 3
    assert sorted(k[1][0][0] for k in prog._entries) == [(1,), (3,), (4,)]
    calls = prog.eager_calls
    assert torch.equal(prog(xs[1], f=(3.0,)), 3.0 * xs[1])
    assert prog.eager_calls == calls + 1 and len(prog) == 3


def test_inputs_on_another_device_are_refused():
    """The key holds each input's device; an input on another device than
    the program's is refused, not run."""
    prog = Program(lambda x, f, i: x + 1, "device", CPU)
    prog(torch.zeros(2))
    assert next(iter(prog._entries))[1][0][2] == CPU
    with pytest.raises(ValueError, match="on cpu"):
        prog(torch.zeros(2, device="meta"))


def test_streaming_reverb_runs_a_long_chunk_in_pieces(monkeypatch):
    """A chunk of more than SLAB_STEPS comb blocks (a whole song offline)
    runs in pieces of as many blocks, one program call each: the comb
    blocks are the whole chunk's, only the allpasses' scans regroup (f32
    rounding), and the carried state goes on to the next chunk."""
    x = _chunks(1, frames=5000)[0]

    def run():
        proc = E.StreamingReverb(SR, 2, wet_curve=[(0, 0.2), (3, 0.5)],
                                 roomsize_curve=[(0, 0.5), (3, 0.9)],
                                 tickf=1000.0, device="cpu")
        with profiling.count_program_launches() as n:
            y = torch.cat([proc.process(x), proc.process(x[:1000])])
        return y.numpy().astype(np.int64), n[0]
    whole, n_whole = run()
    monkeypatch.setattr(F, "SLAB_STEPS", 1)
    pieces, n_pieces = run()
    assert (n_whole, n_pieces) == (2, 6)
    assert np.abs(whole - pieces).max() <= 1
