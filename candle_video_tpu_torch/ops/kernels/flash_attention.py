"""K6: classic flash attention over ``[B, S, H, D]`` — the CUDA kernel and
its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, both Pallas bodies): non-causal ``softmax(q kᵀ·scale +
bias)·v`` with the true row max, an optional f32 key bias ``[B, 1, 1, K]``,
p rounded to v's dtype before P·V and f32 accumulation, output in q's
dtype.  The TPU kernel's block sizes and ``[B·H, S, D]`` transposes were
tiling choices and are not carried: the kernel reads the natural layout
with any H.  ``ops/attention.py`` sends it the shapes the lane-packed kernels
do not take (``packed_viable`` false) above ``_SHORT_KV`` keys.

The kernel is the ``ROPE = false`` instance of ``csrc/flash_attention_packed.cu``
(``cvt_flash_attention``).  CPU tensors take the plain version; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "flash_attention"
HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, scale: float, bias=None):
    """Plain PyTorch version: f32 scores, exact row max, ``p = exp(s - m)``
    rounded to v's dtype for P·V (f32 accumulation), divided by the f32 row
    sum; output in q's dtype."""
    s = torch.einsum("bshd,bkhd->bhsk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhsk,bkhd->bhsd", p.to(v.dtype).float(), v.float()) / l
    return o.transpose(1, 2).to(q.dtype)


def _check(q, k, v, bias):
    b, s, h, d = q.shape
    kv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, kv, h, d) or v.shape != (b, kv, h, d) or kv == 0 or s == 0:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not share [B, *, H, D]")
    tensors = [q, k, v]
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{NAME}: q/k/v must be bfloat16, got {t.dtype}")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.numel() != b * kv:
            raise ValueError(f"{NAME}: bias must be f32 [B,1,1,K], got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{NAME}: every input must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte aligned")


def flash_attention(q, k, v, *, scale: float, bias=None):
    """q [B,S,H,D], k/v [B,K,H,D], optional bias f32 [B,1,1,K] -> [B,S,H,D]
    in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, bias=bias)
    _check(q, k, v, bias)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    err = _build.lib().cvt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, s, k.shape[1], h, d, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out
