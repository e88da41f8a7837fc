"""The sequencer's device bodies for sample hits (port of the device
functions of ``synthesizer_tpu.sequencer``): the whole-song drum scatter
(``_mixdown_kernel``), one streaming chunk of drum hits (``_stream_chunk``)
and one chunk of pitched-sampler rows (``_pitched_chunk_body``).

Each body runs on the device of its bank and sums its rows in int32, exact
in any order.  ``sequencer`` calls them on the song's device and
``parallel.mesh`` on each shard's device; neither layer is imported here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .wave import U32, f32_to_i32


#: cap on the materialized [batch, Lmax, C] gather per scatter step:
#: ~32 M elements (128 MB of int32) whatever the song's length
_SCATTER_BATCH_ELEMS = 32 * 1024 * 1024


def _sum_rows(vals: torch.Tensor) -> torch.Tensor:
    """Sum int32 rows [K, n, C] -> [n, C] with int32 wrap-around (summed in
    int64, then wrapped: the same value in any order)."""
    return vals.sum(dim=0, dtype=torch.int64).to(torch.int32)


def _scale_hits(vals: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Velocity-scale gathered int32 hit waveforms: f32 product, rounded
    half to even.  Bank values are int16-scale (exact in f32), so a gain
    of 1.0 is the identity and the no-automation path stays exact."""
    return torch.round(vals.to(torch.float32) * gains).to(torch.int32)


def _mixdown_kernel(bank: torch.Tensor, hits_inst: torch.Tensor,
                    hits_start: torch.Tensor, total: int,
                    hits_gain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All hits -> one int32 [total, C] song buffer on bank's device.

    bank: [S, Lmax, C] int32; hits: [H].  Each batch of hits gathers its
    [batch, Lmax, C] waveforms, velocity-scales them by ``hits_gain``
    (None == all ones == the exact integer path) and adds them at their
    frames with one ``index_add_``; frames past ``total`` go to a spare
    row that is cut off.  Batches of at most ``_SCATTER_BATCH_ELEMS``
    elements bound the memory; integer adds make the result independent of
    the batching and of the card's order."""
    dev = bank.device
    H = int(hits_inst.shape[0])
    Lmax, C = int(bank.shape[1]), int(bank.shape[2])
    if hits_gain is None:
        hits_gain = torch.ones((H, C), dtype=torch.float32, device=dev)
    out = torch.zeros((total + 1, C), dtype=torch.int32, device=dev)
    arange_l = torch.arange(Lmax, dtype=torch.int64, device=dev)[None, :]
    batch = max(1, min(H, _SCATTER_BATCH_ELEMS // max(Lmax * C, 1)))
    for b0 in range(0, H, batch):
        ib = hits_inst[b0:b0 + batch].to(torch.int64)
        vals = _scale_hits(bank[ib], hits_gain[b0:b0 + batch, None, :])
        idx = (hits_start[b0:b0 + batch].to(torch.int64)[:, None]
               + arange_l).clamp_(max=total)
        out.index_add_(0, idx.reshape(-1), vals.reshape(-1, C))
    return out[:total]


def _stream_chunk(bank: torch.Tensor, inst_k, start_k, valid_k, gain_k,
                  c0: int, cf: int) -> torch.Tensor:
    """One streaming chunk of drum hits: rows [K] of (instrument, start,
    valid, gains) -> int32 [cf, C] at absolute frames [c0, c0 + cf)."""
    lmax = int(bank.shape[1])
    pos = (c0 + torch.arange(cf, dtype=torch.int64, device=bank.device)
           )[None, :] - start_k.to(torch.int64)[:, None]
    inrange = (pos >= 0) & (pos < lmax) & valid_k[:, None]
    vals = bank[inst_k.to(torch.int64)[:, None], pos.clamp(0, lmax - 1)]
    vals = _scale_hits(vals, gain_k[:, None, :])
    vals = torch.where(inrange[:, :, None], vals, torch.zeros_like(vals))
    return _sum_rows(vals)


def _pitched_chunk_body(bank, lens, idx_k, start_k, rate_k, gain_k, valid_k,
                        loopf_k, loopu_k, c0: int, cf: int) -> torch.Tensor:
    """One chunk of pitched-sampler playback -> int32 [cf, C]: each row
    reads its WAV at pos = (n - start) * rate with f32 linear interpolation
    (n relative to the note start), velocity/pan gains per channel, rows
    summed in int32.  Stateless in the absolute frame, so streaming ==
    offline.

    Looped rows (loopf = (flag, ls, lp, gate_total, fade_r); loopu = (inc,
    p0) as u32 in int64): past the loop end the read position comes from
    a 32-bit DDS phase over the loop, pos = ls + x(p0 + n_rel*inc) * lp,
    and a linear release fade gates the note after its tie length,
    g = clip((gate_total - n_rel) * fade_r, 0, 1).  bank is pair-packed
    [P, Lmax, 2C]: position i holds (wav[i], wav[i+1])."""
    dev = bank.device
    C = bank.shape[2] // 2
    n_rel = (c0 + torch.arange(cf, dtype=torch.int64, device=dev)
             )[None, :] - start_k.to(torch.int64)[:, None]
    n_rel_f = n_rel.to(torch.float32)
    pos = n_rel_f * rate_k[:, None]                            # [K, cf]
    lens_k = lens[idx_k.to(torch.int64)].to(torch.int64)
    last = (lens_k - 1).to(torch.float32)[:, None]
    flag = loopf_k[:, 0:1] > 0
    ls = loopf_k[:, 1:2]
    lp = loopf_k[:, 2:3]
    gate_total = loopf_k[:, 3:4]
    fade_r = loopf_k[:, 4:5]
    phase = (loopu_k[:, 1:2] + (n_rel & U32) * loopu_k[:, 0:1]) & U32
    pos_loop = ls + phase.to(torch.float32) * float(2.0 ** -32) * lp
    use_loop = flag & (pos > ls + lp)
    pos = torch.where(use_loop, pos_loop, pos)
    # a loop region ending at the sample's last frame sweeps pos through
    # (len-1, len): clamp to the final frame instead of extrapolating
    pos = torch.where(flag, torch.minimum(pos, last), pos)
    one = torch.ones((), dtype=torch.float32, device=dev)
    env = torch.where(flag, torch.clamp((gate_total - n_rel_f) * fade_r,
                                        0.0, 1.0), one)
    inr = (n_rel >= 0) & valid_k[:, None] & torch.where(
        flag, n_rel_f < gate_total, pos <= last)
    hi = torch.clamp_min(lens_k - 2, 0)[:, None]
    i = torch.minimum(torch.clamp_min(f32_to_i32(pos), 0), hi)
    frac = pos - i.to(torch.float32)
    v01 = bank[idx_k.to(torch.int64)[:, None], i].to(torch.float32)
    v0 = v01[..., :C]
    v1 = v01[..., C:]
    vals = v0 + (v1 - v0) * frac[:, :, None]
    vals = torch.round(vals * (gain_k[:, None, :] * env[:, :, None])
                       ).to(torch.int32)
    vals = torch.where(inr[:, :, None], vals, torch.zeros_like(vals))
    return _sum_rows(vals)
