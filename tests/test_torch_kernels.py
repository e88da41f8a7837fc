"""Port's fused-render wrapper (synthesizer_tpu_torch.ops.kernels).

On the CPU ``render_stereo`` runs its plain version; it is held here
against the TPU kernel ``render_stereo_pallas`` in interpret mode, as
tests/test_pallas_kernel.py runs it.  The CUDA kernels themselves run only
on the card, where chip_smoke.py holds them against their plain versions;
what surrounds them (the column pointer table, input checks, the layouts
shared with the source) is checked here, the culling in test_torch_cull.py.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu.ops.kernels import render_stereo_pallas
from synthesizer_tpu_torch.models import voicebank as T
from synthesizer_tpu_torch.ops import kernels as K
from test_pallas_kernel import VOICES

torch.set_num_threads(1)

SR = 44100


@pytest.fixture(scope="module")
def packed():
    vpj, ly = J.pack_voices(VOICES, SR, num_harmonics=8, sort_by_wave=True)
    vpt = T.voice_params_from_numpy({k: np.asarray(v)
                                     for k, v in vpj._asdict().items()},
                                    device="cpu")
    return vpj, ly, vpt, T.BankLayout(ly.groups, ly.nvoices, ly.num_harmonics)


def test_render_stereo_cpu_matches_pallas_interpret(packed):
    vpj, ly, vpt, tly = packed
    before = K.render_stereo.launches
    got = K.render_stereo(vpt, 0, nframes=4096, samplerate=SR, layout=tly)
    assert K.render_stereo.launches == before == 0    # plain path: no launch
    want = np.asarray(render_stereo_pallas(vpj, 0, nframes=4096,
                                           samplerate=SR, layout=ly,
                                           tile=1024))
    got = got.numpy()
    assert got.shape == (4096, 2) and got.dtype == np.float32
    # the budget of test_pallas_matches_xla_engine: the Pallas kernel's
    # folded int32 phase costs a few LSB on isolated samples at the
    # semicircle's vertical edges (the port keeps the u32 phase)
    w16 = np.clip(np.rint(want * 32767), -32768, 32767)
    g16 = np.clip(np.rint(got * 32767), -32768, 32767)
    d = np.abs(g16 - w16)
    assert d.max() <= 16, f"f32 max diff {np.abs(got - want).max():.3g}"
    assert (d > 1).mean() < 1e-3


def test_render_stereo_offset(packed):
    _, _, vpt, tly = packed
    whole = K.render_stereo(vpt, 0, nframes=3000, samplerate=SR, layout=tly)
    part = K.render_stereo(vpt, 1024, nframes=1000, samplerate=SR, layout=tly)
    assert torch.equal(part, whole[1024:2024])


def _enum(src, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
    return [t.strip() for t in body.split(",") if t.strip()]


def test_column_pointers_match_source(packed):
    # the setup kernel reads VoiceParams columns through a table of device
    # pointers in enum Col order, each as the type kColType names
    _, _, vpt, _ = packed
    src = K._SRC.read_text()
    names = _enum(src, "Col")
    assert names[-1] == "kCols" and len(names) - 1 == len(K.KERNEL_COLUMNS)
    aliases = {"SUSTAIN": "sustain_level"}
    for c, name in zip(names, K.KERNEL_COLUMNS):
        assert aliases.get(c, c.lower()) == name
    types = re.search(r"kColType\[kCols\] = \{([^}]*)\}", src).group(1)
    types = [t.strip() for t in types.split(",") if t.strip()]
    assert len(types) == len(K.KERNEL_COLUMNS)
    for t, name in zip(types, K.KERNEL_COLUMNS):
        want = ("U32" if name in T.U32_FIELDS
                else "I32" if name in T.I32_FIELDS else "F32")
        assert t == want, name
        f = getattr(vpt, name)
        assert f.dtype == {"U32": torch.int64, "I32": torch.int32,
                           "F32": torch.float32}[t], name
    ptrs = list(K._column_pointers(vpt))
    assert ptrs == [getattr(vpt, name).data_ptr()
                    for name in K.KERNEL_COLUMNS]


def test_kernel_columns_match_source():
    src = K._SRC.read_text()
    consts = _enum(src, "Const")
    assert consts[-1] == "kBase" and len(consts) - 1 == K.CONST_BASE
    for c, name in zip(consts, K.CONST_COLUMNS):
        assert c == "K_" + name.upper()
    assert consts.index("K_AMP") == K.CONST_COLUMNS.index("amp")
    # one tile size, two block shapes: each kernel's threads divide the tile
    assert int(re.search(r"kTile = (\d+);", src).group(1)) == K.TILE
    assert "kFrames = kTile / kThreads;" in src
    for name in ("kPlainThreads", "kCurveThreads"):
        threads = int(re.search(rf"{name} = (\d+);", src).group(1))
        assert K.TILE % threads == 0 and threads % 32 == 0
    for flag, value in (("kSafe", K.FLAG_SAFE),
                        ("kPluckSafe", K.FLAG_PLUCK_SAFE),
                        ("kFmOn", K.FLAG_FM_ON)):
        assert f"{flag} = {value}u;" in src
    assert "kCullMax = 4294967296.0f;" in src and K.CULL_MAX == 2.0 ** 32
    assert f"kMaxGroups = {K.MAX_GROUPS};" in src
    assert f"kTableLen = {T.BANK_TABLE_LEN};" in src
    assert "--use_fast_math" not in K.NVCC_FLAGS
    assert "-fmad=false" in K.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in K.NVCC_FLAGS
    assert K.const_width(0) == K.const_width(1) == K.CONST_BASE + 3
    assert K.const_width(8) == K.CONST_BASE + 24


def test_check_inputs_rejects(packed):
    _, _, vpt, tly = packed
    K._check_inputs(vpt, 0, 4096, tly)
    with pytest.raises(ValueError, match="frame range"):
        K._check_inputs(vpt, 2 ** 31 - 100, 4096, tly)
    with pytest.raises(ValueError, match="groups"):
        K._check_inputs(vpt, 0, 64, dataclasses.replace(
            tly, groups=((0, False, 0, 1),) * (K.MAX_GROUPS + 1)))
    with pytest.raises(ValueError, match="bad group"):
        K._check_inputs(vpt, 0, 64, dataclasses.replace(
            tly, groups=((0, False, 0, tly.nvoices + 1),)))
    with pytest.raises(ValueError, match="amp"):
        K._check_inputs(vpt._replace(amp=vpt.amp.double()), 0, 64, tly)
    with pytest.raises(ValueError, match="harm_amps"):
        K._check_inputs(vpt._replace(harm_amps=vpt.harm_amps[:, :2]), 0, 64,
                        tly)
    # the setup kernel reads each column through its raw pointer
    strided = torch.stack([vpt.pan, vpt.pan], dim=1)[:, 0]
    with pytest.raises(ValueError, match="pan: expected contiguous"):
        K._check_inputs(vpt._replace(pan=strided), 0, 64, tly)


def test_render_stereo_has_no_fallback(packed):
    # a tensor on neither the CPU nor a CUDA card is refused, not rendered
    _, _, vpt, tly = packed
    with pytest.raises(ValueError, match="CPU or CUDA"):
        K.render_stereo(vpt.to("meta"), 0, nframes=64, samplerate=SR,
                        layout=tly)
    assert K.render_stereo.launches == 0 and K.voice_setup.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.voice_setup(vpt, SR, 8)
    assert K.voice_setup.launches == 0


def test_curve_columns_and_flags_match_source(packed):
    # both kernels read the curve arrays through a second pointer table in
    # struct Curves order; the flag and mode bits are shared with the source
    _, _, vpt, _ = packed
    src = K._SRC.read_text()
    body = re.search(r"struct Curves \{([^}]*)\}", src).group(1)
    fields = re.findall(r"\*\s*(\w+);", body)
    assert tuple(fields) == K.CURVE_COLUMNS
    assert f"kCurveCols = {len(K.CURVE_COLUMNS)};" in src
    for line in body.splitlines():
        m = re.search(r"const (\w+)\* (\w+);", line)
        if m:
            want = {"int32_t": torch.int32, "int64_t": torch.int64,
                    "float": torch.float32}[m.group(1)]
            assert getattr(vpt, m.group(2)).dtype == want, m.group(2)
    assert list(K._column_pointers(vpt, K.CURVE_COLUMNS)) == [
        getattr(vpt, name).data_ptr() for name in K.CURVE_COLUMNS]
    assert list(K._curve_dims(vpt)) == [vpt.bend_start.shape[1],
                                        vpt.acurve_start.shape[1],
                                        vpt.dcurve_start.shape[1]]
    for flag, value in (("kBend", K.FLAG_BEND), ("kAmpCurve", K.FLAG_AMP),
                        ("kDc", K.FLAG_DC), ("kBendSorted", K.FLAG_BEND_SORTED),
                        ("kAmpSorted", K.FLAG_AMP_SORTED),
                        ("kDcSorted", K.FLAG_DC_SORTED)):
        assert f"{flag} = {value}u;" in src
    assert (f"kGlide = {K.MODE_GLIDE}, kUseBend = {K.MODE_BEND}, "
            f"kUseAmp = {K.MODE_AMP}, kUseDmod = {K.MODE_DMOD};") in src
    assert K._modes(True, False, True, False) == K.MODE_GLIDE | K.MODE_AMP


def test_check_inputs_rejects_bad_rows_and_curves(packed):
    _, _, vpt, tly = packed
    V = vpt.wave.shape[0]
    one = T.BankLayout.ungrouped(V, tly.num_harmonics)
    idx = torch.zeros((4, 8), dtype=torch.int32)
    K._check_inputs(vpt, 0, 4 * 1024, one, idx, 1024)
    K._check_inputs(vpt, 2048, 1024, one, idx, 1024)
    for n0, nframes, cf, lay, rows, what in (
            (0, 1024, 1000, one, idx, "multiple"),      # tiles straddle
            (512, 1024, 1024, one, idx, "multiple"),    # window off a chunk
            (0, 5 * 1024, 1024, one, idx, "covering"),  # too few rows
            (0, 1024, 1024, tly, idx, "one-group"),
            (0, 1024, 1024, one, idx.long(), "idx"),
            (0, 1024, 1024, one, idx[:, :0], "idx")):
        with pytest.raises(ValueError, match=what):
            K._check_inputs(vpt, n0, nframes, lay, rows, cf)
    with pytest.raises(ValueError, match="bend_phase"):
        K._check_inputs(vpt._replace(bend_phase=vpt.bend_phase.int()), 0,
                        64, tly)
    with pytest.raises(ValueError, match="acurve_dg"):
        K._check_inputs(vpt._replace(acurve_dg=vpt.acurve_dg[:1]), 0, 64, tly)
