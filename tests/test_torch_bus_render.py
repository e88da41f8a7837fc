"""The segment-bus render's admission, held on the CPU through its plain
versions (synthesizer_tpu_torch.ops.kernels): ``bus_span_candidates``
(the span pass, ``span_kernel``) and ``bus_tile_lists`` (the voices the
bus render kernel evaluates on a tile, bucketed by bus) against
brute-force numpy loops, and a render over those lists against
``render_stereo_reference(seg=, nseg=)`` bit for bit.  The banks hold
voices that are not cull-safe, plucks (one not cull-safe as a pluck), bus
ids outside [0, nseg) and nseg = 1, 3 and V; the windows start at frame 0
and at a chunk of the sequencer's banks (32768 frames, n0 > 0).  The CUDA
kernels themselves run only on the card: chip_smoke.py holds the span
kernel's lists against ``bus_span_candidates`` and the render against its
plain version there."""

import re

import numpy as np
import pytest
import torch

from synthesizer_tpu_torch import bench_song
from synthesizer_tpu_torch.models import voicebank as T
from synthesizer_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

SR = 44100
TILE = K.TILE
CHUNK = 32768            # the sequencer banks' chunk
WINDOWS = {"head": (0, 20 * TILE + 100), "chunk": (CHUNK, CHUNK)}


def _i32(x: int) -> int:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _bank():
    """A song's voices over 2 s, plucks (one with negative damping: not
    cull-safe as a pluck), a voice whose amplitude puts it outside the
    cull-safe range and a wavetable voice, packed grouped by wave."""
    voices = bench_song.build_song(40, 2.0, SR)
    for i in range(4):
        voices.append(T.Voice("pluck", 110.0 * (i + 2), amplitude=0.2,
                              start=0.1 + 0.3 * i, duration=0.2,
                              release=0.05, damping=-0.5 if i == 1 else 0.3,
                              harmonics=[1.0, 0.5]))
    voices.append(T.Voice("sine", 330.0, amplitude=2.0 ** 40, start=0.9,
                          duration=0.1, release=0.01))
    rng = np.random.default_rng(3)
    voices.append(T.Voice("wavetable", 220.0, amplitude=0.3, start=0.5,
                          duration=0.4, table=tuple(rng.uniform(-1, 1, 32))))
    vp, ly = T.pack_voices(voices, SR, num_harmonics=8, sort_by_wave=True,
                           device="cpu")
    flags = T.VoiceBank.for_voices(voices, SR, num_harmonics=8, layout=ly,
                                   device="cpu")._flags()
    return vp, ly, flags


BANK = _bank()


def _seg(nseg_name, V):
    """Seeded bus ids; two voices on ids outside [0, nseg)."""
    rng = np.random.default_rng(11)
    nseg = V if nseg_name == "V" else nseg_name
    seg = (rng.permutation(V) if nseg == V
           else rng.integers(0, nseg, V)).astype(np.int32)
    seg[2], seg[V // 2] = -1, nseg
    return seg, nseg


CASES = [(w, n) for w in WINDOWS for n in (1, 3, "V")]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-nseg{c[1]}")
def case(request):
    vp, ly, flags = BANK
    seg, nseg = _seg(request.param[1], vp.wave.shape[0])
    n0, nframes = WINDOWS[request.param[0]]
    return vp, ly, flags, seg, nseg, n0, nframes


def _slots(vp, ly):
    """(voice, raw wave id, wave code) in the layout's walk order."""
    wave = vp.wave.numpy()
    out = []
    for (gw, fm, start, count) in ly.groups:
        for v in range(start, start + count):
            wid = int(wave[v]) if gw < 0 else gw
            out.append((v, wid, wid | (0x100 if fm else 0)))
    return out


def _brute_spans(vp, ly, seg, nseg, n0, nframes, span):
    """The span lists, one voice and one span at a time in numpy."""
    c = K.voice_constants(vp, SR, ly.num_harmonics).numpy()
    col = {name: c[:, j] for j, name in enumerate(K.CONST_COLUMNS)}
    sr_r = np.float32(1.0 / SR)
    frames = span * TILE
    spans = []
    for s in range(-(-nframes // frames)):
        a, b = s * frames, min((s + 1) * frames, nframes) - 1
        rows = []
        for v, wid, code in _slots(vp, ly):
            bus = int(seg[v])
            if not 0 <= bus < nseg:
                continue
            flags, start = int(col["flags"][v]), int(col["start"][v])
            t4 = col["t4"][v:v + 1].view(np.float32)[0]
            safe = bool(flags & K.FLAG_SAFE) and (
                wid != 12 or bool(flags & K.FLAG_PLUCK_SAFE))
            mf, ml = _i32(n0 + a - start), _i32(n0 + b - start)
            silent = safe and mf <= ml and (np.float32(ml) * sr_r < 0
                                            or np.float32(mf) * sr_r >= t4)
            if not silent:
                key = (bus | (code & 0x1ff) << 16
                       | (0 if safe else 1 << 25))
                rows.append((v, key, start, int(col["t4"][v])))
        spans.append(rows)
    return spans


def _brute_tiles(spans, n0, nframes, span):
    """Each tile's admitted (voice, bus, code), in bus order and packed
    order within a bus."""
    sr_r = np.float32(1.0 / SR)
    out = []
    for j in range(-(-nframes // TILE)):
        a, b = j * TILE, min((j + 1) * TILE, nframes) - 1
        rows = []
        for pos, (v, key, start, t4) in enumerate(spans[j // span]):
            t4 = np.int32(t4).view(np.float32)
            mf, ml = _i32(n0 + a - start), _i32(n0 + b - start)
            silent = (not key & (1 << 25)) and mf <= ml and (
                np.float32(ml) * sr_r < 0 or np.float32(mf) * sr_r >= t4)
            if not silent:
                rows.append((key & 0xffff, pos, v, (key >> 16) & 0x1ff))
        out.append([(v, bus, code) for bus, _, v, code in sorted(rows)])
    return out


@pytest.mark.parametrize("span", [None, 4])
def test_span_candidates_match_brute_force(case, span):
    vp, ly, _, seg, nseg, n0, nframes = case
    cand, counts = K.bus_span_candidates(vp, n0, nframes, samplerate=SR,
                                         layout=ly, seg=torch.from_numpy(seg),
                                         nseg=nseg, span=span)
    span = span or K.span_tiles(nframes, ly.nvoices)
    want = _brute_spans(vp, ly, seg, nseg, n0, nframes, span)
    assert cand.dtype == counts.dtype == torch.int32
    assert cand.shape == (len(want), ly.nvoices, 4)
    assert counts.tolist() == [len(w) for w in want]
    for s, rows in enumerate(want):
        got = cand[s, :len(rows)].tolist()
        assert got == [list(r) for r in rows], s
        assert not cand[s, len(rows):].any()        # zero beyond the count
        voices = [r[0] for r in rows]
        assert voices == sorted(voices)             # packed order


def test_span_lists_keep_what_the_kernel_must_evaluate(case):
    """Every voice that is not cull-safe, on a bus in range, is in every
    span's list; a voice on an id outside [0, nseg) is in none."""
    vp, ly, _, seg, nseg, n0, nframes = case
    cand, counts = K.bus_span_candidates(vp, n0, nframes, samplerate=SR,
                                         layout=ly, seg=torch.from_numpy(seg),
                                         nseg=nseg)
    flags = K.voice_constants(vp, SR, 8)[:, K.CONST_COLUMNS.index("flags")]
    wid = {v: w for v, w, _ in _slots(vp, ly)}
    unsafe = {v for v in range(vp.wave.shape[0]) if 0 <= seg[v] < nseg and (
        not flags[v] & K.FLAG_SAFE
        or (wid[v] == 12 and not flags[v] & K.FLAG_PLUCK_SAFE))}
    assert len(unsafe) >= 2                       # the loud voice, the pluck
    for s in range(cand.shape[0]):
        listed = set(cand[s, :int(counts[s]), 0].tolist())
        assert unsafe <= listed
        assert not listed & {2, vp.wave.shape[0] // 2}


def test_tile_lists_match_brute_force(case):
    vp, ly, _, seg, nseg, n0, nframes = case
    span = K.span_tiles(nframes, ly.nvoices)
    got = K.bus_tile_lists(vp, n0, nframes, samplerate=SR, layout=ly,
                           seg=torch.from_numpy(seg), nseg=nseg)
    want = _brute_tiles(_brute_spans(vp, ly, seg, nseg, n0, nframes, span),
                        n0, nframes, span)
    assert [g.tolist() for g in got] == [[list(r) for r in w] for w in want]
    assert sum(len(w) for w in want) > 0


def test_tile_lists_count_the_flat_voice_tiles(case):
    """The lists hold the voices the flat render evaluates on each tile
    (those on a bus in range): the bus render's voice-tile count is the
    flat render's."""
    vp, ly, _, seg, nseg, n0, nframes = case
    lists = K.bus_tile_lists(vp, n0, nframes, samplerate=SR, layout=ly,
                             seg=torch.from_numpy(seg), nseg=nseg)
    flat = K.active_voice_tiles(vp, n0, nframes, samplerate=SR, layout=ly)
    on_bus = torch.from_numpy((seg >= 0) & (seg < nseg))
    assert sum(len(t) for t in lists) == int(flat[on_bus].sum())
    for j, t in enumerate(lists):
        assert sorted(t[:, 0].tolist()) == torch.nonzero(
            flat[:, j] & on_bus).flatten().tolist()


def test_render_over_tile_lists_is_the_reference(case):
    """Each tile's buses rendered from its list alone -- a bus's voices in
    list order, each with its wave code -- equal the plain version bit for
    bit; a bus without a voice on a tile is +0 there."""
    vp, ly, flags, seg, nseg, n0, nframes = case
    want = K.render_stereo_reference(vp, n0, nframes=nframes, samplerate=SR,
                                     layout=ly, seg=torch.from_numpy(seg),
                                     nseg=nseg, **flags)
    lists = K.bus_tile_lists(vp, n0, nframes, samplerate=SR, layout=ly,
                             seg=torch.from_numpy(seg), nseg=nseg)
    got = torch.zeros_like(want)
    for j, rows in enumerate(lists):
        a, b = j * TILE, min((j + 1) * TILE, nframes)
        for bus in torch.unique(rows[:, 1]).tolist():
            mine = rows[rows[:, 1] == bus]
            voices, codes = mine[:, 0], mine[:, 2].tolist()
            assert voices.tolist() == sorted(voices.tolist())
            sub = T.VoiceParams(*(f.index_select(0, voices) for f in vp))
            sly = T.BankLayout(tuple((c & 0xff, bool(c & 0x100), i, 1)
                                     for i, c in enumerate(codes)),
                               len(codes), ly.num_harmonics)
            got[a:b, bus] = T.render_block(sub, n0 + a, b - a, SR,
                                           ly.num_harmonics, sly, **flags)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(want.abs().max()) > 0.01


def test_span_tiles_bound_the_lists():
    assert K.span_tiles(CHUNK, 512) == K.SPAN_TILES
    assert K.span_tiles(1, 10 ** 6) == K.SPAN_TILES
    tiles = -(-600 * SR // TILE)
    span = K.span_tiles(600 * SR, 16384)
    assert -(-tiles // span) * 16384 <= K.SPAN_ENTRIES
    assert -(-tiles // (span // 2)) * 16384 > K.SPAN_ENTRIES
    assert span & (span - 1) == 0


def test_span_entry_layout_matches_source():
    src = K._SRC.read_text()
    assert f"kKeyCodeShift = {K.KEY_CODE_SHIFT};" in src
    assert K.KEY_UNSAFE == 1 << int(re.search(
        r"kKeyUnsafe = 1 << (\d+);", src).group(1))
    assert K.KEY_UNSAFE > 0xffff << 0 and K.KEY_UNSAFE > 0x1ff << 16
    assert "(code & 0x1ff) << kKeyCodeShift" in src
