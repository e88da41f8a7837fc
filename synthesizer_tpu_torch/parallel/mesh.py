"""Voice-axis data parallelism over a list of devices (port of
``synthesizer_tpu.parallel.mesh``).

The JAX package shards the voice bank over a 1-D ``jax.sharding.Mesh`` with
``shard_map``: each device renders its block of voices and one ``psum``
merges the stereo partials.  PyTorch has no ``shard_map``; the JAX package
is one process driving many devices, and so is this module:

* a :class:`VoiceMesh` is an ordered tuple of ``torch.device``\\ s (a
  device may appear more than once: several shards on one card);
* shard i is the contiguous block of rows ``[i*V/n, (i+1)*V/n)`` of the
  packed ``VoiceParams`` (or of the hit rows), as ``PartitionSpec('voices')``
  lays them out, and lives on ``mesh.devices[i]``;
* each shard renders through the port's own ``VoiceBank`` / ``render_stereo``
  (the Hopper kernels on a CUDA device, the plain version on the CPU) and the
  per-shard int32 scatters and chunk bodies of ``sequencer``;
* the partials are summed on ``mesh.devices[0]`` in shard order 0..n-1, one
  add a shard (:func:`_psum`): never atomics, ``index_add_`` or a reduction
  whose order is not fixed, so a sharded render gives the same bytes every
  run.  The f32 sums differ from the single-device serial sum by rounding
  only (within 1 LSB at int16); the int32 merges are exact in any order.

The static render flags (``used_waves``, ``use_fm``, ``use_glide``,
``use_bend``, ``use_amp``, ``use_dmod``) come from the WHOLE voice list
(:func:`song_synth_shards`) and go to every shard's bank, so every shard runs
the same kernel specialisation.

Deliberate differences from the reference: :func:`voice_mesh` has no CPU
fallback (with fewer devices than asked for and no ``devices=`` it raises),
and there is no ``_sharded_fn_cache``: the reference caches JAX compiles,
and the closures here compile nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.voicebank import (ALL_WAVES, WAVE_IDS, VoiceBank, VoiceParams,
                                pack_voices)

AXIS = "voices"

__all__ = ["AXIS", "VoiceMesh", "voice_mesh", "shard_voice_params",
           "song_synth_shards", "song_synth_shards_grouped",
           "render_song_sharded", "render_song_grouped_sharded",
           "render_chunk_sharded_fn", "render_chunk_grouped_sharded_fn",
           "scatter_mix_sharded", "stream_chunk_sharded_fn",
           "pitched_chunk_sharded_fn", "pitched_song_sharded"]


class VoiceMesh:
    """A 1-D mesh over the voice axis: an ordered tuple of devices."""

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    def __repr__(self) -> str:
        return f"VoiceMesh({[str(d) for d in self.devices]})"


def voice_mesh(n_devices: Optional[int] = None, devices=None) -> VoiceMesh:
    """A 1-D mesh over ``devices`` (every CUDA device by default), cut to
    the first ``n_devices``.  There is no CPU fallback: with fewer devices
    than asked for the call raises; a caller that wants CPU shards names
    them (``devices=[torch.device("cpu")] * 8``)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return VoiceMesh(devices)


def _rows(t: torch.Tensor, mesh: VoiceMesh, dim: int = 0) -> List[torch.Tensor]:
    """Shard i of ``t`` along ``dim`` (equal contiguous blocks), on
    ``mesh.devices[i]``."""
    n = mesh.size
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"{size} rows not divisible by mesh size {n}")
    k = size // n
    return [t.narrow(dim, i * k, k).contiguous().to(d)
            for i, d in enumerate(mesh.devices)]


def _psum(parts: Sequence[torch.Tensor], mesh: VoiceMesh) -> torch.Tensor:
    """The partials summed on ``mesh.devices[0]`` in shard order 0..n-1,
    one add a shard: the same bytes every run."""
    d0 = mesh.devices[0]
    acc = parts[0].to(d0)
    for p in parts[1:]:
        acc = acc + p.to(d0)
    return acc


class _Replicas:
    """A replicated tensor's copy on each device, made once per device
    while the caller passes the same tensor (the streaming fns get the
    same bank every chunk)."""

    def __init__(self):
        self._src = None
        self._copies = {}

    def on(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        if t is not self._src:
            self._src, self._copies = t, {}
        if device not in self._copies:
            self._copies[device] = t.to(device)
        return self._copies[device]


def shard_voice_params(vp: VoiceParams, mesh: VoiceMesh) -> List[VoiceParams]:
    """Every parameter array cut into ``mesh.size`` blocks of voices, block
    i on ``mesh.devices[i]``."""
    V = int(vp.wave.shape[0])
    if V % mesh.size:
        raise ValueError(f"voice count {V} not divisible by mesh size "
                         f"{mesh.size}")
    cols = [_rows(f, mesh) for f in vp]
    return [VoiceParams(*(c[i] for c in cols)) for i in range(mesh.size)]


def _shards(vp, mesh: VoiceMesh) -> List[VoiceParams]:
    """``vp`` as per-device shards: a packed ``VoiceParams`` is sharded,
    a list of shards (from :func:`song_synth_shards`) is checked."""
    if isinstance(vp, VoiceParams):
        return shard_voice_params(vp, mesh)
    shards = list(vp)
    if len(shards) != mesh.size or any(
            s.device != d for s, d in zip(shards, mesh.devices)):
        raise ValueError(f"{len(shards)} voice shards for {mesh}")
    return shards


def _any_glide(voices) -> bool:
    return any(v.glide_from > 0.0 and v.glide_time > 0.0
               and v.frequency > 0.0 for v in voices)


def _flags(voices) -> tuple:
    """(used_waves, use_fm, use_glide) of the whole voice list."""
    used = tuple(sorted({WAVE_IDS[v.wave] for v in voices}))
    return (used, any(v.fm_depth != 0.0 for v in voices),
            _any_glide(voices))


def song_synth_shards(voices, samplerate: int, mesh: VoiceMesh,
                      num_harmonics: int = 8):
    """Pack a song's synth voices for the mesh -> (voice shards,
    used_waves, use_fm, use_glide, use_bend, use_amp, use_dmod).  The pack
    is unsorted, padded with silent voices to a multiple of the mesh size;
    the flags come from the whole voice list and hold for every shard (the
    curve flags carry MIDI bend, CC7+CC11 and CC1+pressure onto the
    mesh)."""
    vp = pack_voices(voices, samplerate, num_harmonics=num_harmonics,
                     pad_to=mesh.size, device="cpu")
    return (shard_voice_params(vp, mesh), *_flags(voices),
            any(v.pitch_curve for v in voices),
            any(v.amp_curve for v in voices),
            any(v.fm_depth_curve for v in voices))


def song_synth_shards_grouped(voices, vtracks, fx_tracks, samplerate: int,
                              mesh: VoiceMesh, num_harmonics: int = 8):
    """Pack a song's synth voices with per-track bus tags for the mesh ->
    (voice shards, tag shards int32, used_waves, use_fm, use_glide).

    Bus 0 is the shared clean bus; bus i+1 is ``fx_tracks[i]``'s own stereo
    bus.  The tags shard over the same voice axis as the params; padding
    voices are silent and carry tag 0, so the clean bus receives exact
    zeros from them."""
    seg_index = {n: i + 1 for i, n in enumerate(fx_tracks)}
    tags = [seg_index.get(t, 0) for t in vtracks]
    vp = pack_voices(voices, samplerate, num_harmonics=num_harmonics,
                     pad_to=mesh.size, device="cpu")
    V = int(vp.base_inc.shape[0])
    seg = torch.from_numpy(np.asarray(tags + [0] * (V - len(tags)),
                                      np.int32))
    return (shard_voice_params(vp, mesh), _rows(seg, mesh), *_flags(voices))


def _banks(mesh: VoiceMesh, shards: Sequence[VoiceParams], samplerate: int,
           chunk_frames: int, num_harmonics: int, used_waves: tuple,
           use_fm: bool, **flags) -> List[VoiceBank]:
    """One ungrouped bank per shard, each with the whole song's flags."""
    return [VoiceBank(int(vp.wave.shape[0]), samplerate, chunk_frames,
                      num_harmonics, used_waves=used_waves, use_fm=use_fm,
                      device=d, **flags)
            for vp, d in zip(shards, mesh.devices)]


def render_song_sharded(vp, total_frames: int, samplerate: int = 44100,
                        chunk_frames: int = 8192, num_harmonics: int = 8,
                        mesh: Optional[VoiceMesh] = None,
                        used_waves: tuple = ALL_WAVES, use_fm: bool = True,
                        use_glide: bool = False, use_bend: bool = False,
                        use_amp: bool = False,
                        use_dmod: bool = False) -> torch.Tensor:
    """Offline mixdown with the voice axis sharded over the mesh -> f32
    [total_frames, 2] on ``mesh.devices[0]``.

    Each shard renders the whole song over its voices (on a CUDA device
    one setup and one render launch); the partials add in shard order.
    Matches the single-device render up to the f32 summation order across
    shards.  ``used_waves``/``use_fm`` and the curve flags are the static
    flags of every shard's bank."""
    if mesh is None:
        mesh = voice_mesh()
    shards = _shards(vp, mesh)
    banks = _banks(mesh, shards, samplerate, chunk_frames, num_harmonics,
                   used_waves, use_fm, use_glide=use_glide,
                   use_bend=use_bend, use_amp=use_amp, use_dmod=use_dmod)
    return _psum([b.render_song(s, total_frames)
                  for b, s in zip(banks, shards)], mesh)


def render_song_grouped_sharded(vp, seg, nseg: int, total_frames: int,
                                samplerate: int, chunk_frames: int,
                                num_harmonics: int, mesh: VoiceMesh,
                                used_waves: tuple, use_fm: bool,
                                use_glide: bool = False) -> torch.Tensor:
    """Offline grouped mixdown over the mesh: each shard renders its
    voices into their buses (the kernel's bus mode on the card) and the
    [total, nseg, 2] partial bus stacks add in shard order -> f32
    [total_frames, nseg, 2] on ``mesh.devices[0]``."""
    shards = _shards(vp, mesh)
    banks = _banks(mesh, shards, samplerate, chunk_frames, num_harmonics,
                   used_waves, use_fm, use_glide=use_glide)
    return _psum([b.render_song_grouped(s, g, nseg, total_frames)
                  for b, s, g in zip(banks, shards, seg)], mesh)


def render_chunk_grouped_sharded_fn(mesh: VoiceMesh, chunk_frames: int,
                                    samplerate: int, num_harmonics: int,
                                    used_waves: tuple, use_fm: bool,
                                    nseg: int, use_glide: bool = False):
    """(voice shards, tag shards, c0) -> the summed [chunk, nseg, 2] bus
    stack: the streaming counterpart of :func:`render_song_grouped_sharded`."""
    def fn(vp, seg, c0: int) -> torch.Tensor:
        shards = _shards(vp, mesh)
        banks = _banks(mesh, shards, samplerate, chunk_frames, num_harmonics,
                       used_waves, use_fm, use_glide=use_glide)
        return _psum([b.render_chunk_grouped(s, g, nseg, int(c0))
                      for b, s, g in zip(banks, shards, seg)], mesh)
    return fn


def render_chunk_sharded_fn(mesh: VoiceMesh, chunk_frames: int,
                            samplerate: int, num_harmonics: int,
                            used_waves: tuple, use_fm: bool,
                            use_glide: bool = False, use_bend: bool = False,
                            use_amp: bool = False, use_dmod: bool = False):
    """(voice shards, c0) -> the summed stereo chunk [chunk, 2]: the
    streaming counterpart of :func:`render_song_sharded`, with the same
    static flags."""
    def fn(vp, c0: int) -> torch.Tensor:
        shards = _shards(vp, mesh)
        banks = _banks(mesh, shards, samplerate, chunk_frames, num_harmonics,
                       used_waves, use_fm, use_glide=use_glide,
                       use_bend=use_bend, use_amp=use_amp, use_dmod=use_dmod)
        return _psum([b.render_chunk(s, int(c0))
                      for b, s in zip(banks, shards)], mesh)
    return fn


def scatter_mix_sharded(bank: torch.Tensor, hits_inst, hits_start,
                        total: int, mesh: VoiceMesh,
                        hits_gain=None) -> torch.Tensor:
    """Sharded song scatter-add -> int32 [total, C] on ``mesh.devices[0]``.

    The hits are padded to a multiple of the mesh size with rows that
    start at ``total`` (dropped by the scatter) and gain 0; each device
    scatters its block of hits from its copy of the (small) instrument
    bank, and the int32 partials add exactly, so the result is bit-exact
    against the single-device scatter however the hits fall."""
    from ..sequencer import _mixdown_kernel
    n = mesh.size
    inst = np.asarray(hits_inst, np.int64).reshape(-1)
    H = int(inst.shape[0])
    C = int(bank.shape[2])
    pad = -H % n if H else n
    inst = np.concatenate([inst, np.zeros(pad, np.int64)])
    start = np.concatenate([np.asarray(hits_start, np.int64).reshape(-1),
                            np.full(pad, total, np.int64)])
    gain = (np.ones((H, C), np.float32) if hits_gain is None
            else np.asarray(hits_gain, np.float32).reshape(H, C))
    gain = np.concatenate([gain, np.zeros((pad, C), np.float32)])
    rows = [_rows(torch.from_numpy(a), mesh) for a in (inst, start, gain)]
    return _psum([_mixdown_kernel(bank.to(d), i, s, total, g)
                  for d, i, s, g in zip(mesh.devices, *rows)], mesh)


def stream_chunk_sharded_fn(mesh: VoiceMesh, cf: int):
    """Sharded streaming drum chunk: (bank, inst_k, start_k, valid_k,
    gain_k, c0) -> int32 [cf, C]; the K hit rows shard over the mesh and
    the int32 partials add exactly."""
    from ..sequencer import _stream_chunk
    banks = _Replicas()

    def fn(bank, inst_k, start_k, valid_k, gain_k, c0: int) -> torch.Tensor:
        rows = [_rows(r, mesh) for r in (inst_k, start_k, valid_k, gain_k)]
        return _psum([_stream_chunk(banks.on(bank, d), *r, int(c0), cf)
                      for d, *r in zip(mesh.devices, *rows)], mesh)
    return fn


def pitched_chunk_sharded_fn(mesh: VoiceMesh, cf: int):
    """Sharded pitched-sampler chunk: (bank, lens, idx_k, start_k, rate_k,
    gain_k, valid_k, loopf_k, loopu_k, c0) -> int32 [cf, C]; the note rows
    shard over the mesh and the int32 partials add exactly (each note is
    rounded before the add)."""
    from ..sequencer import _pitched_chunk_body
    banks, lens_r = _Replicas(), _Replicas()

    def fn(bank, lens, *rows_and_c0) -> torch.Tensor:
        *rows, c0 = rows_and_c0
        sh = [_rows(r, mesh) for r in rows]
        return _psum([_pitched_chunk_body(banks.on(bank, d),
                                          lens_r.on(lens, d), *r, int(c0), cf)
                      for d, *r in zip(mesh.devices, *sh)], mesh)
    return fn


def pitched_song_sharded(bank, lens, idx_b, start_b, rate_b, gain_b,
                         valid_b, loopf_b, loopu_b, c0s, cf: int,
                         mesh: VoiceMesh) -> torch.Tensor:
    """Sharded offline pitched mixdown: the bucketed note rows [nchunks, K,
    ...] shard over the mesh on their K axis; each device walks all chunks
    over its rows and the int32 partials add exactly -> int32
    [nchunks * cf, C] on ``mesh.devices[0]``."""
    from ..sequencer import _pitched_chunk_body
    sh = [_rows(r, mesh, dim=1) for r in (idx_b, start_b, rate_b, gain_b,
                                          valid_b, loopf_b, loopu_b)]
    parts = []
    for i, d in enumerate(mesh.devices):
        b, ln = bank.to(d), lens.to(d)
        parts.append(torch.cat([
            _pitched_chunk_body(b, ln, *(r[i][c] for r in sh), int(c0), cf)
            for c, c0 in enumerate(c0s)]))
    return _psum(parts, mesh)
