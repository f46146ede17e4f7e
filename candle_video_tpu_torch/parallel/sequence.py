"""Sequence parallelism over ``torch.distributed``
(``candle_video_tpu/parallel/sequence.py``).

Every rank is handed the same full tensors, takes its own slice (video
tokens by sp coordinate, batch rows by dp coordinate), works on it, and
all-gathers the result, so every rank returns the same full output as the
JAX functions return one global array.

- ``sequence_parallel_attention``: q shards over the ring, K/V are
  all-gathered (``all_gather_into_tensor``) and each rank runs the port's
  ``attention()`` on its q block against the full K/V.
- ``ring_attention``: K/V stay sharded and rotate around the ring
  (``ops/ring.py``); no rank holds the full K/V.
- ``denoise_loop_sp``: the whole Euler loop with the DiT's self-attention
  on the ring; cross-attention, norms, FF, AdaLN and the step are
  token-local.  The guidance rescale's standard deviation is taken over the
  whole sequence with two all-reduces over the ring, so the loop equals
  ``pipeline.denoise_loop`` (the JAX loop takes it over each shard).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..ops.attention import attention
from ..ops.ring import ring_self_attention
from .mesh import Mesh


def _gather(x, group, n: int, dim: int):
    """All-gather ``x`` over ``group`` and concatenate the n pieces, in rank
    order, along ``dim``."""
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _shard(x, rank: int, n: int, dim: int):
    size = x.shape[dim] // n
    return x.narrow(dim, rank * size, size)


def _check_divisible(s: int, sp: int):
    if s % sp:
        raise ValueError(f"sequence length {s} not divisible by sp={sp}")


def sequence_parallel_attention(q, k, v, scale: float, mesh: Mesh, bias=None):
    """q/k/v [B, S, H, D], S divisible by sp; bias broadcastable to
    [B, H, S_q_local, K] (a key bias [B, 1, 1, K]).  Returns the full output
    [B, S, H, D] on every rank."""
    _check_divisible(q.shape[1], mesh.sp)
    local = [_shard(t, mesh.sp_rank, mesh.sp, 1) for t in (q, k, v)]
    kg = _gather(local[1], mesh.sp_group, mesh.sp, 1)
    vg = _gather(local[2], mesh.sp_group, mesh.sp, 1)
    out = attention(local[0], kg, vg, scale, bias=bias)
    return _gather(out, mesh.sp_group, mesh.sp, 1)


def ring_attention(q, k, v, scale: float, mesh: Mesh):
    """Streaming ring attention: q/k/v [B, S, H, D], S divisible by sp.
    Each rank keeps its S/sp chunk of q and folds the K/V chunks in as they
    come round the ring (``ops/ring.py``).  Returns the full output on every
    rank."""
    _check_divisible(q.shape[1], mesh.sp)
    qc, kc, vc = (_shard(t, mesh.sp_rank, mesh.sp, 1) for t in (q, k, v))
    out = ring_self_attention(qc, kc, vc, scale, mesh.sp_group)
    return _gather(out, mesh.sp_group, mesh.sp, 1)


def _ring_std(group, n_total: int):
    """The unbiased standard deviation per row over the whole sequence, from
    each rank's [B, S_local, ...] shard: two all-reduces over the ring."""
    def std(x):
        flat = x.reshape(x.shape[0], -1)
        total = flat.sum(1)
        dist.all_reduce(total, group=group)
        sq = (flat - (total / n_total)[:, None]).square().sum(1)
        dist.all_reduce(sq, group=group)
        return (sq / (n_total - 1)).sqrt().reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return std


def denoise_loop_sp(transformer, latents, encoder_hidden_states, encoder_attention_mask,
                    schedule, rope_cos, rope_sin, *, mesh: Mesh, num_conds: int = 1,
                    guidance_scale: float = 1.0, guidance_rescale: float = 0.0,
                    stg_scale: float = 0.0, skip_layer_mask=None,
                    step_seconds: list | None = None):
    """Sequence-parallel Euler loop: ``pipeline.denoise_loop``'s arguments
    (latents [B, S, C], guidance rows [num_conds·B, ...], RoPE tables
    [1, S, inner], skip mask [L, num_conds·B]) plus the mesh.  Latents and
    RoPE tables shard along S by sp rank; the guidance rows regroup as
    [num_conds, B] and B shards by dp rank.  Returns the final latents
    [B, S, C] f32, gathered over sp and dp, on every rank."""
    from ..models.ltx_video import scheduler as S
    from ..models.ltx_video.pipeline import _sync, guidance_combine

    b, s, _ = latents.shape
    _check_divisible(s, mesh.sp)
    if b % mesh.dp:
        raise ValueError(f"batch {b} not divisible by dp={mesh.dp}")
    bl = b // mesh.dp

    def rows(x, lead=()):
        """Regroup [..lead, num_conds·B, ...] rows as [num_conds, B] and keep
        this rank's dp slice of B."""
        x = x.reshape(*lead, num_conds, b, *x.shape[len(lead) + 1:])
        x = _shard(x, mesh.dp_rank, mesh.dp, len(lead) + 1)
        return x.reshape(*lead, num_conds * bl, *x.shape[len(lead) + 2:])

    lat = _shard(_shard(latents, mesh.dp_rank, mesh.dp, 0), mesh.sp_rank, mesh.sp, 1).float()
    enc = rows(encoder_hidden_states)
    mask = None if encoder_attention_mask is None else rows(encoder_attention_mask)
    skip = None if skip_layer_mask is None else rows(skip_layer_mask, (skip_layer_mask.shape[0],))
    cos, sin = (_shard(t, mesh.sp_rank, mesh.sp, 1) for t in (rope_cos, rope_sin))
    std = _ring_std(mesh.sp_group, s * latents.shape[2])

    n = schedule.timesteps.shape[0]
    for i in range(n):
        t0 = time.perf_counter()
        t, sigma, sigma_next = (float(schedule.timesteps[i]), float(schedule.sigmas[i]),
                                float(schedule.sigmas[i + 1]))
        lat_in = lat.repeat(num_conds, 1, 1)
        timestep = torch.full((num_conds * bl,), t, dtype=torch.float32, device=lat.device)
        pred = transformer(lat_in, enc, timestep, cos, sin, encoder_attention_mask=mask,
                           skip_layer_mask=skip, ring=mesh.sp_group).float()
        combined = guidance_combine(pred, bl, num_conds, guidance_scale, guidance_rescale,
                                    stg_scale, std=std)
        lat = S.step(lat, combined, sigma, sigma_next)
        if step_seconds is not None:
            _sync(lat.device)
            step_seconds.append(time.perf_counter() - t0)
    lat = _gather(lat, mesh.sp_group, mesh.sp, 1)
    return _gather(lat, mesh.dp_group, mesh.dp, 0)
