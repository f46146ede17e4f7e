"""K5: one ring-attention step — the CUDA kernel and its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/ring_chunk.py``.  One step of
the sequence-parallel ring: the local q chunk ``[B, Sq, H·D]`` (already
rotated, no bias) attends to one K/V chunk ``[B, Sc, H·D]`` and the result
is folded into the carried online-softmax state.

The state is plain, not lane-packed as on the TPU: running max ``m`` and
running sum ``l`` f32 ``[B, H, Sq]``, unnormalised output ``acc`` f32
``[B, Sq, H·D]``, from ``init_ring_state``.  ``ring_chunk_update`` updates
it in place and returns it; after the last step the caller returns
``acc / l`` in q's dtype.

The kernel is the ``RING = true`` instance of the attention template in
``csrc/flash_attention_packed.cu`` (its source note says what bounds it).
CPU tensors take ``ring_chunk_update_plain``; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "ring_chunk_update"
HEAD_DIMS = (64, 128)
LOG2E = 1.4426950408889634
NEG_INF = -1e30  # finite, so that m_old - m_new is never -inf - (-inf)


def init_ring_state(b: int, sq: int, h: int, d: int, device=None):
    """(m, l, acc) start values: running max -1e30, running sum 0, acc 0."""
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=device)
    acc = torch.zeros((b, sq, h * d), dtype=torch.float32, device=device)
    return m, l, acc


def ring_chunk_update_plain(q, k, v, m, l, acc, *, num_heads: int, scale: float):
    """Plain PyTorch version, the TPU kernel's algorithm: per head f32 scores
    over the chunk's keys, their row max ``m_i``, ``p = exp2((s - m_i)·log2e)``,
    ``l_i = Σp``, ``pv = p.astype(v.dtype)·v`` in f32, then the merge
    ``m_new = max(m, m_i)``, ``l = l·a + l_i·b``, ``acc = acc·a + pv·b`` with
    ``a, b = exp2((m - m_new)·log2e), exp2((m_i - m_new)·log2e)``.  Updates
    the state in place and returns it."""
    b, sq, hd = q.shape
    sc = k.shape[1]
    d = hd // num_heads
    qf = q.reshape(b, sq, num_heads, d).float()
    kf = k.reshape(b, sc, num_heads, d).float()
    s = torch.einsum("bshd,bkhd->bhsk", qf, kf) * scale
    m_i = s.amax(-1)
    p = torch.exp2((s - m_i[..., None]) * LOG2E)
    l_i = p.sum(-1)
    vf = v.reshape(b, sc, num_heads, d).float()
    pv = torch.einsum("bhsk,bkhd->bshd", p.to(v.dtype).float(), vf)
    m_new = torch.maximum(m, m_i)
    a = torch.exp2((m - m_new) * LOG2E)
    bb = torch.exp2((m_i - m_new) * LOG2E)
    l.mul_(a).add_(l_i * bb)
    acc4 = acc.view(b, sq, num_heads, d)
    acc4.mul_(a.transpose(1, 2)[..., None]).add_(pv * bb.transpose(1, 2)[..., None])
    m.copy_(m_new)
    return m, l, acc


def _check(q, k, v, m, l, acc, num_heads):
    b, sq, hd = q.shape
    sc = k.shape[1]
    if hd % num_heads or hd // num_heads not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {hd}/{num_heads} not in {HEAD_DIMS}")
    if k.shape != (b, sc, hd) or v.shape != (b, sc, hd) or sq == 0 or sc == 0:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not share [B, *, H*D]")
    if m.shape != (b, num_heads, sq) or l.shape != m.shape or acc.shape != q.shape:
        raise ValueError(f"{NAME}: state m {tuple(m.shape)} l {tuple(l.shape)} "
                         f"acc {tuple(acc.shape)} is not [B, H, Sq], [B, H, Sq], "
                         f"[B, Sq, H*D] for q {tuple(q.shape)}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{NAME}: q/k/v must be bfloat16, got {t.dtype}")
    for t in (m, l, acc):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: the state must be float32, got {t.dtype}")
    for t in (q, k, v, m, l, acc):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{NAME}: every input must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte aligned")


def ring_chunk_update(q, k, v, m, l, acc, *, num_heads: int, scale: float):
    """q [B,Sq,H·D] (rotated), k/v [B,Sc,H·D], state (m, l [B,H,Sq], acc
    [B,Sq,H·D]) f32: one ring step, in place.  Returns (m, l, acc)."""
    if q.device.type == "cpu":
        return ring_chunk_update_plain(q, k, v, m, l, acc, num_heads=num_heads, scale=scale)
    _check(q, k, v, m, l, acc, num_heads)
    b, sq, hd = q.shape
    err = _build.lib().cvt_ring_chunk_update(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        b, sq, k.shape[1], num_heads, hd // num_heads, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return m, l, acc
