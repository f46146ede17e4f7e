"""Multi-GPU paths over ``torch.distributed`` (``candle_video_tpu/parallel``):
the (dp, tp) / (dp, sp) process mesh with tensor parallelism, sequence
parallelism, and pipeline parallelism over a (pp, tp) mesh."""

from .mesh import Mesh, RowShardedLinear, make_mesh, replicate, shard_batch, shard_transformer
from .pipeline import (
    PipelineMesh,
    denoise_loop_pp,
    interleave_layer_order,
    make_pipeline_mesh,
    pipeline_transformer_forward,
    schedule_ticks,
    shard_transformer_pp,
)
from .sequence import denoise_loop_sp, ring_attention, sequence_parallel_attention

__all__ = [
    "Mesh",
    "PipelineMesh",
    "RowShardedLinear",
    "denoise_loop_pp",
    "denoise_loop_sp",
    "interleave_layer_order",
    "make_mesh",
    "make_pipeline_mesh",
    "pipeline_transformer_forward",
    "replicate",
    "ring_attention",
    "schedule_ticks",
    "sequence_parallel_attention",
    "shard_batch",
    "shard_transformer",
    "shard_transformer_pp",
]
