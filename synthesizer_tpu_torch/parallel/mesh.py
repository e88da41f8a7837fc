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
  int32 scatter and chunk bodies of ``ops.hits``;
* the partials are summed on ``mesh.devices[0]`` in shard order 0..n-1, one
  add a shard (:func:`_psum`): never atomics, ``index_add_`` or a reduction
  whose order is not fixed, so a sharded render gives the same bytes every
  run.  The f32 sums differ from the single-device serial sum by rounding
  only (within 1 LSB at int16); the int32 merges are exact in any order.

The static render flags (``used_waves``, ``use_fm``, ``use_glide``,
``use_bend``, ``use_amp``, ``use_dmod``) come from the WHOLE voice list
(:func:`voice_flags`) and go to every shard's bank, so every shard runs the
same kernel specialisation.

A song or MIDI pass with ``mesh=`` renders through :meth:`VoiceMesh.renderer`
(:class:`ShardedRender`), whose methods are those of the single-device
``sequencer.LocalRender``: it packs and shards the voices, works out their
flags, pads the hit rows to a multiple of the mesh size, and merges the
partials onto the pass's device.

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
from ..ops.hits import _mixdown_kernel, _pitched_chunk_body, _stream_chunk

AXIS = "voices"

__all__ = ["AXIS", "VoiceMesh", "voice_mesh", "shard_voice_params",
           "voice_flags", "voice_shards", "render_song_sharded",
           "ShardedRender"]


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

    def renderer(self, device, samplerate: int) -> "ShardedRender":
        """A pass's renders over this mesh, with results on ``device``."""
        return ShardedRender(self, device, samplerate)


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


def _split(t: torch.Tensor, mesh: VoiceMesh, dim: int = 0
           ) -> List[torch.Tensor]:
    """Hit rows padded along ``dim`` to a multiple of the mesh size with
    zero rows, then sharded.  A zero row is invalid or has gain 0, so it
    adds an exact 0 to the int32 sum."""
    pad = -t.shape[dim] % mesh.size
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim)
    return _rows(t, mesh, dim)


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
    a list of shards (from :func:`voice_shards`) is checked."""
    if isinstance(vp, VoiceParams):
        return shard_voice_params(vp, mesh)
    shards = list(vp)
    if len(shards) != mesh.size or any(
            s.device != d for s, d in zip(shards, mesh.devices)):
        raise ValueError(f"{len(shards)} voice shards for {mesh}")
    return shards


def voice_flags(voices) -> dict:
    """The static render flags of the whole voice list, for every shard's
    bank (the curve flags carry MIDI bend, CC7+CC11 and CC1+pressure)."""
    return dict(used_waves=tuple(sorted({WAVE_IDS[v.wave] for v in voices})),
                use_fm=any(v.fm_depth != 0.0 for v in voices),
                use_glide=any(v.glide_from > 0.0 and v.glide_time > 0.0
                              and v.frequency > 0.0 for v in voices),
                use_bend=any(v.pitch_curve for v in voices),
                use_amp=any(v.amp_curve for v in voices),
                use_dmod=any(v.fm_depth_curve for v in voices))


def voice_shards(voices, samplerate: int, mesh: VoiceMesh, tags=None):
    """Pack voices for the mesh -> (voice shards, bus tag shards int32 or
    None).  The pack is unsorted, 8 harmonics, padded with silent voices to
    a multiple of the mesh size; ``tags`` (each voice's bus) shard over the
    same voice axis, the padding voices on bus 0, so the clean bus receives
    exact zeros from them."""
    vp = pack_voices(voices, samplerate, num_harmonics=8, pad_to=mesh.size,
                     device="cpu")
    shards = shard_voice_params(vp, mesh)
    if tags is None:
        return shards, None
    V = int(vp.base_inc.shape[0])
    seg = torch.from_numpy(np.asarray(list(tags) + [0] * (V - len(tags)),
                                      np.int32))
    return shards, _rows(seg, mesh)


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


class ShardedRender:
    """A pass's renders over ``mesh``, with the methods of
    ``sequencer.LocalRender`` and results on ``device``.

    The hit rows pad to a multiple of the mesh size and shard as contiguous
    blocks; each device runs the ``ops.hits`` body over its block and the
    int32 partials add exactly, so drums and pitched rows are bit-exact
    against one device.  The synth voices shard as :func:`voice_shards`
    packs them, every bank with the whole list's :func:`voice_flags`, and
    the f32 partials (or bus stacks) add in shard order."""

    def __init__(self, mesh: VoiceMesh, device, samplerate: int):
        self.mesh = mesh
        self.device = device
        self.samplerate = samplerate
        # the streaming bodies get the same banks every chunk
        self._drum_banks = _Replicas()
        self._pitched_banks = _Replicas()
        self._lens = _Replicas()

    def _merge(self, parts) -> torch.Tensor:
        return _psum(parts, self.mesh).to(self.device)

    def scatter(self, bank, inst, start, gain, total: int) -> torch.Tensor:
        """Sharded song scatter-add of host hit rows -> int32 [total, C]:
        each device scatters its block of hits from its copy of the (small)
        instrument bank."""
        rows = [_split(torch.from_numpy(np.ascontiguousarray(a)), self.mesh)
                for a in (np.asarray(inst, np.int64),
                          np.asarray(start, np.int64),
                          np.asarray(gain, np.float32))]
        return self._merge([_mixdown_kernel(bank.to(d), i, s, total, g)
                            for d, i, s, g in zip(self.mesh.devices, *rows)])

    def pitched_song(self, bank, lens, rows, cf: int) -> torch.Tensor:
        """Sharded offline pitched mixdown: the bucketed rows [nchunks, K,
        ...] shard on their K axis and each device walks all chunks over
        its rows -> int32 [nchunks * cf, C]."""
        sh = [_split(r, self.mesh, dim=1) for r in rows]
        parts = []
        for i, d in enumerate(self.mesh.devices):
            b, ln = bank.to(d), lens.to(d)
            parts.append(torch.cat([
                _pitched_chunk_body(b, ln, *(r[i][c] for r in sh), c * cf, cf)
                for c in range(len(rows[0]))]))
        return self._merge(parts)

    def drum_chunk(self, bank, inst_k, start_k, valid_k, gain_k, c0: int,
                   cf: int) -> torch.Tensor:
        """Sharded streaming drum chunk -> int32 [cf, C]."""
        rows = [_split(r, self.mesh) for r in (inst_k, start_k, valid_k,
                                               gain_k)]
        return self._merge([
            _stream_chunk(self._drum_banks.on(bank, d), *r, int(c0), cf)
            for d, *r in zip(self.mesh.devices, *rows)])

    def pitched_chunk(self, bank, lens, idx_k, start_k, rate_k, gain_k,
                      valid_k, loopf_k, loopu_k, c0: int,
                      cf: int) -> torch.Tensor:
        """Sharded pitched-sampler chunk -> int32 [cf, C] (each note is
        rounded before the add)."""
        rows = [_split(r, self.mesh) for r in (idx_k, start_k, rate_k,
                                               gain_k, valid_k, loopf_k,
                                               loopu_k)]
        return self._merge([
            _pitched_chunk_body(self._pitched_banks.on(bank, d),
                                self._lens.on(lens, d), *r, int(c0), cf)
            for d, *r in zip(self.mesh.devices, *rows)])

    def _banks(self, voices, chunk_frames: int, tags=None):
        """(a bank per shard, voice shards, bus tag shards or None)."""
        shards, seg = voice_shards(voices, self.samplerate, self.mesh, tags)
        return (_banks(self.mesh, shards, self.samplerate, chunk_frames, 8,
                       **voice_flags(voices)), shards, seg)

    def synth_song(self, voices, total: int,
                   chunk_frames: int) -> torch.Tensor:
        """The voices' offline mixdown -> f32 [total, 2]."""
        banks, shards, _ = self._banks(voices, chunk_frames)
        return self._merge([b.render_song(s, total)
                            for b, s in zip(banks, shards)])

    def grouped_song(self, voices, tags, nseg: int, total: int,
                     chunk_frames: int) -> torch.Tensor:
        """The voices' offline mixdown into their buses: each shard renders
        its voices into the buses (the kernel's bus mode on the card) ->
        f32 [total, nseg, 2]."""
        banks, shards, segs = self._banks(voices, chunk_frames, tags)
        return self._merge([b.render_song_grouped(s, g, nseg, total)
                            for b, s, g in zip(banks, shards, segs)])

    def synth_chunks(self, voices, cf: int):
        """c0 -> the voices' chunk [cf, 2] at frame c0."""
        banks, shards, _ = self._banks(voices, cf)

        def chunk(c0):
            return self._merge([b.render_chunk(s, int(c0))
                                for b, s in zip(banks, shards)])
        return chunk

    def grouped_chunks(self, voices, tags, nseg: int, cf: int):
        """c0 -> the voices' bus stack [cf, nseg, 2] at frame c0."""
        banks, shards, segs = self._banks(voices, cf, tags)

        def chunk(c0):
            return self._merge([b.render_chunk_grouped(s, g, nseg, int(c0))
                                for b, s, g in zip(banks, shards, segs)])
        return chunk
