"""The process mesh of the sequence-parallel path over ``torch.distributed``
(``candle_video_tpu/parallel/mesh.py::make_mesh``).

The JAX package lays its devices out as a ``Mesh(('dp', 'sp'))``; here each
process is one device and the mesh is a grid of ranks, row-major as the
JAX array ``devices.reshape(dp, sp)``: rank ``r`` has dp coordinate
``r // sp`` and sp coordinate ``r % sp``.  The ranks of one dp row form the
ring (``sp_group``), the ranks of one sp column the data-parallel group
(``dp_group``).  The process group must be initialised first (NCCL on the
card, gloo on the CPU).  Tensor parallelism is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, sp) grid of ranks and its two groups."""

    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    sp_group: object  # torch.distributed ProcessGroup: this rank's ring
    dp_group: object  # torch.distributed ProcessGroup: this rank's sp column
    device: torch.device


def _group(ranks, world: int):
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, device=None) -> Mesh:
    """The (dp, sp) mesh over every rank of the initialised process group.
    ``device`` defaults to the current CUDA device under NCCL and to the CPU
    otherwise.  Every rank must call this, in the same order as any other
    group creation, since it creates the groups of every row and column."""
    if tp > 1:
        raise ValueError("tensor parallelism (tp > 1) is not yet ported: ROADMAP item 13 "
                         "(mesh.py TP, shard_transformer_params)")
    if dp < 1 or sp < 1:
        raise ValueError(f"dp={dp} and sp={sp} must be at least 1")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * sp != world:
        raise ValueError(f"dp={dp} x sp={sp} = {dp * sp} ranks, but the world has {world}")
    sp_group = dp_group = None
    for row in range(dp):  # every rank creates every group, in one order
        g = _group([row * sp + j for j in range(sp)], world)
        sp_group = g if row == rank // sp else sp_group
    for col in range(sp):
        g = _group([i * sp + col for i in range(dp)], world)
        dp_group = g if col == rank % sp else dp_group
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(dp=dp, sp=sp, dp_rank=rank // sp, sp_rank=rank % sp, sp_group=sp_group,
                dp_group=dp_group, device=torch.device(device))
