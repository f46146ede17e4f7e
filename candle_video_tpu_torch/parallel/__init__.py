"""Multi-GPU paths over ``torch.distributed`` (``candle_video_tpu/parallel``):
the (dp, sp) process mesh and sequence parallelism.  Tensor and pipeline
parallelism are not ported yet."""

from .mesh import Mesh, make_mesh
from .sequence import denoise_loop_sp, ring_attention, sequence_parallel_attention

__all__ = [
    "Mesh",
    "denoise_loop_sp",
    "make_mesh",
    "ring_attention",
    "sequence_parallel_attention",
]
