"""Pipeline parallelism of the DiT block stack over ``torch.distributed``
(``candle_video_tpu/parallel/pipeline.py``).

The 48-layer stack is split into ``pp`` stages, one a rank of the pp
group; microbatches (the guidance rows of a step) stream through them.  The
schedule is the JAX package's: GPipe's fill/steady/drain loop of
``M + pp - 1`` ticks for M microbatches, or the interleaved one with
``interleave = v`` virtual chunks a stage (``M + v·pp - 1`` ticks of a
1/v-sized chunk, M ≤ pp).  At each tick every stage runs its chunk on its
current activation, then hands it to the next rank of the pp group with
``batch_isend_irecv`` (the JAX ``ppermute``; the last stage wraps to the
first, which runs its next chunk on it).  A pipeline of one stage makes no
exchange.

- Every rank runs the pre-block and post-block compute (``embed``,
  ``finish``) itself, and the stage's blocks are the model's own blocks:
  there is no second copy of the math.
- The last stage's outputs reach every rank by a broadcast over the pp
  group (the JAX psum of zeros elsewhere, exact and cheaper).
- PP × TP: on a (pp, tp) grid each stage's blocks are also cut over the
  stage's tp group (``mesh.shard_transformer``); the tp all-reduces then
  run inside each stage.
- ``denoise_loop_pp`` is ``pipeline.denoise_loop`` with the pipelined
  forward as its transformer: the same Euler, guidance and stochastic step
  and the same noise key chain.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .mesh import _group, default_device, shard_transformer


@dataclasses.dataclass(frozen=True)
class PipelineMesh:
    """This rank's place in a (pp, tp) grid of ranks: row-major as the JAX
    ``devices.reshape(pp, tp)``, rank ``r`` is stage ``r // tp`` and tp
    coordinate ``r % tp``.  ``pp_group`` is this rank's column (the
    stages), ``tp_group`` its row (one stage's tensor-parallel ranks)."""

    pp: int
    pp_rank: int
    pp_group: object
    device: torch.device
    tp: int = 1
    tp_rank: int = 0
    tp_group: object = None


def make_pipeline_mesh(pp: int, tp: int = 1, device=None) -> PipelineMesh:
    """The (pp, tp) mesh over every rank of the initialised process group
    (``device`` as ``make_mesh``'s).  Every rank must call this, in the same
    order as any other group creation."""
    if pp < 1 or tp < 1:
        raise ValueError(f"pp={pp} and tp={tp} must be at least 1")
    if not dist.is_initialized():
        raise RuntimeError("make_pipeline_mesh needs an initialised torch.distributed "
                           "process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if pp * tp != world:
        raise ValueError(f"need {pp * tp} ranks for pp={pp}, tp={tp}; the world has {world}")
    pp_group = tp_group = None
    for col in range(tp):  # every rank creates every group, in one order
        g = _group([i * tp + col for i in range(pp)], world)
        pp_group = g if col == rank % tp else pp_group
    for row in range(pp):
        g = _group([row * tp + j for j in range(tp)], world)
        tp_group = g if row == rank // tp else tp_group
    return PipelineMesh(pp=pp, pp_rank=rank // tp, pp_group=pp_group,
                        device=torch.device(device or default_device()), tp=tp,
                        tp_rank=rank % tp, tp_group=tp_group if tp > 1 else None)


def interleave_layer_order(num_layers: int, pp: int, interleave: int) -> np.ndarray:
    """Layer permutation for the interleaved (virtual-stage) schedule.

    With ``v = interleave`` virtual chunks per device, virtual stage
    ``vs = c*pp + s`` (chunk c, device s) owns layers
    ``[vs*Lc, (vs+1)*Lc)``.  The stacked layer axis is reordered so device
    s's contiguous shard holds its v chunks back to back:
    position ``s*(v*Lc) + c*Lc + l`` <- layer ``(c*pp + s)*Lc + l``.
    """
    lc = num_layers // (pp * interleave)
    order = np.empty(num_layers, np.int64)
    pos = 0
    for s in range(pp):
        for c in range(interleave):
            vs = c * pp + s
            order[pos:pos + lc] = np.arange(vs * lc, (vs + 1) * lc)
            pos += lc
    return order


def schedule_ticks(pp: int, num_microbatches: int, interleave: int = 1) -> dict:
    """Analytic schedule accounting (per-microbatch work normalized to 1).

    GPipe (interleave=1): M + pp - 1 ticks of a FULL per-device stage
    (L/pp layers) -> time = (M + pp - 1) * (L/pp); bubble (pp-1)/(M+pp-1).
    Interleaved: M + v*pp - 1 ticks of a 1/v stage (L/(v*pp) layers) ->
    time = (M + v*pp - 1) * L/(v*pp) = (M/v + pp - 1/v) * (L/pp) — the
    fill/drain cost shrinks by v.  Requires M <= pp (conflict-free naive
    interleaving).
    """
    m, v = num_microbatches, interleave
    ticks = m + v * pp - 1
    time_units = ticks / v  # in full-stage (L/pp-layer) units
    ideal = m  # M full-stage units of real work per device
    return {
        "ticks": ticks,
        "time_stage_units": time_units,
        "bubble_fraction": (time_units - ideal) / time_units,
    }


def _stage_layers(num_layers: int, pp: int, v: int, stage: int) -> tuple:
    """The layers stage ``stage`` holds, in its blocks' order: its
    contiguous shard of ``interleave_layer_order``."""
    if num_layers % (pp * v) != 0:
        raise ValueError(f"num_layers {num_layers} not divisible by pp*v={pp * v}")
    per = num_layers // pp
    order = interleave_layer_order(num_layers, pp, v)
    return tuple(int(i) for i in order[stage * per:(stage + 1) * per])


@torch.no_grad()
def shard_transformer_pp(model, mesh: PipelineMesh, interleave: int = 1):
    """Cut the DiT ``model`` in place to this rank's stage: the layers of
    its contiguous shard of the interleaved order
    (``interleave_layer_order``), its v chunks back to back, the others
    dropped; on a (pp, tp) mesh its blocks are then cut over the stage's tp
    group.  Returns the model.  Calling it again with the same mesh and
    interleave does nothing."""
    pp, v, stage = mesh.pp, int(interleave), mesh.pp_rank
    L = model.cfg.num_layers
    layers = _stage_layers(L, pp, v, stage)
    if model.pp is not None:
        if model.pp != (pp, v, stage, layers):
            raise ValueError(f"the model is already cut for pp={model.pp[0]} "
                             f"interleave={model.pp[1]} stage {model.pp[2]}, not pp={pp} "
                             f"interleave={v} stage {stage}")
    else:
        if len(model.blocks) != L:
            raise ValueError(f"the model holds {len(model.blocks)} of {L} layers")
        model.blocks = nn.ModuleList(model.blocks[i] for i in layers)
        model.pp = (pp, v, stage, layers)
    return shard_transformer(model, mesh)


def _exchange(y, mesh: PipelineMesh):
    """Send ``y`` to the next stage and receive the previous stage's into a
    new buffer (the last stage sends to the first)."""
    if mesh.pp == 1:
        return y
    group, n, s = mesh.pp_group, mesh.pp, mesh.pp_rank
    y = y.contiguous()
    buf = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, dist.get_global_rank(group, (s + 1) % n), group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (s - 1) % n), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return buf


def pipeline_transformer_forward(model, hidden_states, encoder_hidden_states, timestep,
                                 rope_cos, rope_sin, *, mesh: PipelineMesh,
                                 num_microbatches=None, encoder_attention_mask=None,
                                 skip_layer_mask=None, interleave: int = 1):
    """The DiT forward of ``model`` (cut by ``shard_transformer_pp(model,
    mesh, interleave)``) with its block stack pipelined over ``mesh``'s pp
    group; every rank of the mesh calls it with the same full inputs and
    returns the same output, ``forward``'s.  Needs ``num_layers % (pp·v)
    == 0``, ``B % num_microbatches == 0`` (M defaults to min(B, pp), as
    JAX's), M ≤
    pp when v > 1, batch-shared RoPE tables [1, S, inner] and one timestep
    a row."""
    pp, v = mesh.pp, int(interleave)
    L = model.cfg.num_layers
    layers = _stage_layers(L, pp, v, mesh.pp_rank)
    B = hidden_states.shape[0]
    M = num_microbatches if num_microbatches is not None else min(B, pp)
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by num_microbatches={M}")
    if v > 1 and M > pp:
        raise ValueError(f"interleave={v} needs num_microbatches<={pp} (got {M})")
    if rope_cos.shape[0] != 1 or rope_sin.shape[0] != 1:
        raise ValueError("pipeline forward needs batch-shared rope tables (leading dim 1)")
    if model.pp != (pp, v, mesh.pp_rank, layers):
        raise ValueError(f"the model is not cut for this stage: call "
                         f"shard_transformer_pp(model, mesh, interleave={v}) first")
    mb, lc = B // M, L // (pp * v)

    x, enc, temb6, emb, enc_bias = model.embed(hidden_states, encoder_hidden_states,
                                               timestep, encoder_attention_mask)
    if temb6.shape[1] != 1:
        raise ValueError("the pipeline forward takes one timestep a row")
    rope = model.local_rope(rope_cos, rope_sin)
    skip = None
    if skip_layer_mask is not None:
        # the stage's rows of the mask, in its layers' (interleaved) order
        skip = skip_layer_mask[torch.as_tensor(layers, device=skip_layer_mask.device)]

    def rows(t, m):
        return None if t is None else t[m * mb:(m + 1) * mb]

    stage = mesh.pp_rank
    outs = torch.empty_like(x)  # the last stage's outputs, then every rank's
    buf = None
    for t in range(M + v * pp - 1):
        # stage s at tick t runs the unique chunk c with microbatch
        # m = t - s - c*pp in [0, M) (unique since M <= pp when v > 1)
        work = [(c, t - stage - c * pp) for c in range(v) if 0 <= t - stage - c * pp < M]
        y = buf
        if work:
            c, m = work[0]
            y = rows(x, m) if stage == 0 and c == 0 else buf
            for j in range(c * lc, (c + 1) * lc):
                y = model.blocks[j](y, rows(enc, m), rows(temb6, m), rope, rows(enc_bias, m),
                                    None if skip is None else rows(skip[j], m))
            if stage == pp - 1 and c == v - 1:
                outs[m * mb:(m + 1) * mb] = y
        if y is None:  # this stage has not started: it sends a placeholder
            y = torch.zeros_like(rows(x, 0))
        buf = _exchange(y, mesh)
    if pp > 1:
        dist.broadcast(outs, src=dist.get_global_rank(mesh.pp_group, pp - 1),
                       group=mesh.pp_group)
    return model.finish(outs, emb)


def denoise_loop_pp(transformer, latents, encoder_hidden_states, encoder_attention_mask,
                    schedule, rope_cos, rope_sin, *, mesh: PipelineMesh,
                    num_microbatches=None, interleave: int = 1, num_conds: int = 1,
                    **loop_kw):
    """``pipeline.denoise_loop`` with the DiT forward pipelined over
    ``mesh`` (the model is cut by ``shard_transformer_pp`` first); the
    guidance rows (num_conds·B) are the microbatches, M defaulting to the
    largest divisor of the rows up to pp (JAX's min(rows, pp), which fails
    where it does not divide them: 3 rows at pp = 2).  ``loop_kw`` are ``denoise_loop``'s: guidance,
    skip mask, ``stochastic`` with ``noise_key`` (the same key chain),
    ``step_seconds``, ``interrupted``.  Returns the final latents [B, S, C]
    f32 on every rank."""
    from ..models.ltx_video.pipeline import denoise_loop

    shard_transformer_pp(transformer, mesh, interleave)
    rows, M = num_conds * latents.shape[0], num_microbatches
    if M is None:  # JAX's min(rows, pp) where it divides the rows
        M = max(m for m in range(1, min(rows, mesh.pp) + 1) if rows % m == 0)
    forward = functools.partial(pipeline_transformer_forward, transformer, mesh=mesh,
                                num_microbatches=M, interleave=interleave)
    return denoise_loop(forward, latents, encoder_hidden_states, encoder_attention_mask,
                        schedule, rope_cos, rope_sin, num_conds=num_conds, **loop_kw)
