"""Ring self-attention over the local sequence shards of one process group
(``candle_video_tpu/ops/ring.py``).

Each rank holds its q, k, v chunks ``[B, S_local, H, D]``.  K/V rotate
around the ring (rank i sends to rank (i + 1) mod n of ``group`` with
``torch.distributed.batch_isend_irecv``, the JAX ``ppermute``) while every
rank folds each chunk it holds into a blockwise online softmax against its
own q.  After n steps every rank has seen every chunk.  Non-causal and
bias-free: softmax over keys is permutation-invariant, so the chunks'
order needs no bookkeeping.  A ring of one makes no exchange.

As in the JAX body, the exchange of the current chunk into the next
buffers is posted before the chunk's math and waited on after it; the
last step, whose chunk would come back to its owner, posts none.

Each chunk is folded in by ``ring_chunk_update`` (``ops/kernels/ring_chunk.py``):
K5 on CUDA tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .kernels.ring_chunk import init_ring_state, ring_chunk_update


def _post_rotation(k, v, group, n: int):
    """Post this rank's (k, v) to the next rank and the previous rank's into
    new buffers; returns (k_next, v_next, pending work)."""
    rank = dist.get_rank(group)
    to = dist.get_global_rank(group, (rank + 1) % n)
    frm = dist.get_global_rank(group, (rank - 1) % n)
    k_next, v_next = torch.empty_like(k), torch.empty_like(v)
    ops = [dist.P2POp(dist.isend, k, to, group), dist.P2POp(dist.isend, v, to, group),
           dist.P2POp(dist.irecv, k_next, frm, group),
           dist.P2POp(dist.irecv, v_next, frm, group)]
    return k_next, v_next, dist.batch_isend_irecv(ops)


def _chunks(k, v, group, n: int):
    """Yield the ring's n (k, v) chunks in turn, this rank's own first; the
    exchange of the next chunk is in flight while the caller computes on the
    current one."""
    for i in range(n):
        work = ()
        if i + 1 < n:
            k_next, v_next, work = _post_rotation(k, v, group, n)
        yield k, v
        for w in work:
            w.wait()
        if work:
            k, v = k_next, v_next


def ring_self_attention(q, k, v, scale: float, group):
    """Streaming ring attention over local shards q, k, v [B, S_local, H, D]
    of the ring ``group`` (a ``torch.distributed`` process group); returns
    this rank's output [B, S_local, H, D] in q's dtype."""
    n = dist.get_world_size(group)
    b, sq, h, d = q.shape
    q3 = q.reshape(b, sq, h * d).contiguous()
    m, l, acc = init_ring_state(b, sq, h, d, device=q.device)
    for kc, vc in _chunks(k.reshape(b, -1, h * d).contiguous(),
                          v.reshape(b, -1, h * d).contiguous(), group, n):
        ring_chunk_update(q3, kc, vc, m, l, acc, num_heads=h, scale=scale)
    out = acc.view(b, sq, h, d) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)
