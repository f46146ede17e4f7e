"""The process mesh over ``torch.distributed`` and tensor parallelism
(``candle_video_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh(('dp', 'tp'))`` or a
``Mesh(('dp', 'sp'))``; here each process is one device and the mesh is a
grid of ranks, row-major as the JAX array ``devices.reshape(dp, n)`` with
``n`` the tp or the sp extent (tp and sp are not combined): rank ``r`` has
dp coordinate ``r // n`` and tp or sp coordinate ``r % n``.  The ranks of
one dp row form the ring (``sp_group``) or the tensor-parallel group
(``tp_group``), the ranks of one column the data-parallel group
(``dp_group``).  The process group must be initialised first (NCCL on the
card, gloo on the CPU).

Tensor parallelism (``shard_transformer``, the counterpart of
``transformer_shardings`` + ``shard_transformer_params``): each rank keeps
its slice of the attention heads and of the FF hidden dim.  q/k/v and
``ff.net_0_proj`` are column-sharded (their output rows), ``to_out`` and
``ff.net_2`` row-sharded (their input columns, ``RowShardedLinear``: the
partial products are all-reduced over the tp group and the bias added once
after).  The QK-RMSNorm's weights are cut to the rank's lanes and its
statistics all-reduced (``transformer.Attention``); GSPMD all-gathers the
activations there instead, which is the same math.  Everything else is
replicated.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.quant_linear import Int4Linear, Int8Linear, W8A8Linear
from ..utils import debug


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, sp) or (dp, tp) grid of ranks and its
    groups."""

    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    sp_group: object  # torch.distributed ProcessGroup: this rank's ring
    dp_group: object  # torch.distributed ProcessGroup: this rank's column
    device: torch.device
    tp: int = 1
    tp_rank: int = 0
    tp_group: object = None  # torch.distributed ProcessGroup: this rank's tp row


def _group(ranks, world: int):
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def default_device():
    """The current CUDA device under NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, device=None) -> Mesh:
    """The (dp, tp) or (dp, sp) mesh over every rank of the initialised
    process group, the axes in the JAX ``make_mesh``'s order.  ``device``
    defaults to the current CUDA device under NCCL and to the CPU
    otherwise.  Every rank must call this, in the same order as any other
    group creation, since it creates the groups of every row and column."""
    if tp > 1 and sp > 1:
        raise ValueError(
            "tp and sp cannot be combined in one mesh (weight sharding "
            "inside the ring shard_map is not wired); use dp x tp or dp x sp")
    if min(dp, tp, sp) < 1:
        raise ValueError(f"dp={dp}, tp={tp} and sp={sp} must be at least 1")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = tp * sp  # the row's extent: tp or sp
    if dp * n != world:
        raise ValueError(f"dp={dp} x tp={tp} x sp={sp} = {dp * n} ranks, but the world "
                         f"has {world}")
    row_group = col_group = None
    for row in range(dp):  # every rank creates every group, in one order
        g = _group([row * n + j for j in range(n)], world)
        row_group = g if row == rank // n else row_group
    for col in range(n):
        g = _group([i * n + col for i in range(dp)], world)
        col_group = g if col == rank % n else col_group
    tp_axis = tp > 1
    return Mesh(dp=dp, sp=sp, dp_rank=rank // n, sp_rank=0 if tp_axis else rank % n,
                sp_group=None if tp_axis else row_group, dp_group=col_group,
                device=torch.device(device or default_device()), tp=tp,
                tp_rank=rank % n if tp_axis else 0, tp_group=row_group if tp_axis else None)


def shard_batch(x, mesh: Mesh, axis: int = 0):
    """This dp rank's rows of ``x`` along ``axis`` (the JAX ``shard_batch``
    places the same rows on the rank's devices)."""
    if x.shape[axis] % mesh.dp:
        raise ValueError(f"batch {x.shape[axis]} not divisible by dp={mesh.dp}")
    size = x.shape[axis] // mesh.dp
    return x.narrow(axis, mesh.dp_rank * size, size)


def replicate(x, mesh: Mesh):
    """``x`` itself: every rank already holds the whole tensor."""
    return x


class RowShardedLinear(nn.Module):
    """A linear whose input dim is sharded over ``group``: ``weight`` [out,
    in/tp] is this rank's columns.  The partial products are all-reduced in
    the activations' dtype (bf16 on the card, as Megatron-LM reduces): each
    partial is the local matmul's own output, already rounded once, so a
    sum in f32 would carry no more of the product and move twice the bytes.
    The bias is added once, after the reduction."""

    def __init__(self, weight, bias, group):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.group = group

    def forward(self, x):
        with debug.span("matmul"):
            y = F.linear(x, self.weight)
        dist.all_reduce(y, group=self.group)
        return y if self.bias is None else y + self.bias


def _cut(t, dim: int, rank: int, n: int):
    """This rank's contiguous 1/n of ``t`` along ``dim``, in new storage, so
    that the other shards go when ``t`` goes."""
    size = t.shape[dim] // n
    return t.detach().narrow(dim, rank * size, size).clone()


def _column_shard(lin: nn.Linear, rank: int, n: int):
    lin.weight = nn.Parameter(_cut(lin.weight, 0, rank, n), requires_grad=False)
    if lin.bias is not None:
        lin.bias = nn.Parameter(_cut(lin.bias, 0, rank, n), requires_grad=False)
    lin.out_features = lin.weight.shape[0]


def _row_shard(lin: nn.Linear, rank: int, n: int, group):
    bias = None if lin.bias is None else lin.bias.detach()
    return RowShardedLinear(_cut(lin.weight, 1, rank, n), bias, group)


_QUANTIZED = (Int8Linear, Int4Linear, W8A8Linear)


@torch.no_grad()
def shard_transformer(model, mesh):
    """Cut the DiT ``model`` (``transformer.LtxTransformer3D``) in place to
    this rank's tensor-parallel shard of ``mesh`` (a ``Mesh``, or a
    ``pipeline.PipelineMesh`` whose stage is tp-sharded too); returns it.
    One linear at a time gives up its other shards, so a rank's peak stays
    near one full copy.  A mesh with tp = 1 leaves the model whole."""
    n, rank, group = mesh.tp, mesh.tp_rank, mesh.tp_group
    if n == 1:
        return model
    if model.tp is not None:
        if model.tp != (n, rank):
            raise ValueError(f"the model is already sharded for tp={model.tp[0]} rank "
                             f"{model.tp[1]}, not tp={n} rank {rank}")
        return model
    cfg = model.cfg
    if cfg.num_attention_heads % n:
        raise ValueError(f"{cfg.num_attention_heads} attention heads not divisible by tp={n}")
    for name, mod in model.named_modules():
        if isinstance(mod, _QUANTIZED):
            raise ValueError(
                f"no TP sharding rule for quantized linear {name!r} "
                f"({type(mod).__name__}): int8 trees are a SINGLE-CHIP capacity path; "
                "with 2+ GPUs the BF16 tree already fits sharded (about half of it a "
                "GPU at tp=2). Load dense params for multi-chip meshes.")
    for blk in model.blocks:
        for attn in (blk.attn1, blk.attn2):
            for lin in (attn.to_q, attn.to_k, attn.to_v):
                _column_shard(lin, rank, n)
            attn.to_out = _row_shard(attn.to_out, rank, n, group)
            attn.norm_q = nn.Parameter(_cut(attn.norm_q, 0, rank, n), requires_grad=False)
            attn.norm_k = nn.Parameter(_cut(attn.norm_k, 0, rank, n), requires_grad=False)
            attn.heads //= n
            attn.tp_group = group
        _column_shard(blk.ff.net_0_proj, rank, n)
        blk.ff.net_2 = _row_shard(blk.ff.net_2, rank, n, group)
    model.tp = (n, rank)
    return model
