"""K1: lane-packed flash attention — CUDA kernel and its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/flash_attention_packed.py``
(``flash_attention_packed``).  Non-causal ``softmax(q kᵀ·scale + bias)·v`` on
the natural ``[B, S, H·D]`` projection layout, with the optional q-side
interleaved RoPE applied inside the kernel (k arrives rotated) and ragged
S/K masked.  The kernel is ``csrc/flash_attention_packed.cu``; the source
note there says what bounds it and how the design answers.

CPU tensors take the plain version (f32 softmax einsum, q rotated by
``apply_rotary_emb``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from ..rope import apply_rotary_emb
from . import _build

NAME = "flash_attention_packed"
HEAD_DIMS = (64, 128)


def flash_attention_packed_plain(q, k, v, *, num_heads: int, scale: float,
                                 bias=None, rope_q=None):
    """Plain PyTorch version: f32 scores and softmax, output in q's dtype."""
    if rope_q is not None:
        q = apply_rotary_emb(q, rope_q[0], rope_q[1])
    b, s, hd = q.shape
    kv = k.shape[1]
    d = hd // num_heads
    qf = q.reshape(b, s, num_heads, d).float()
    kf = k.reshape(b, kv, num_heads, d).float()
    vf = v.reshape(b, kv, num_heads, d).float()
    att = torch.einsum("bshd,bkhd->bhsk", qf, kf) * scale
    if bias is not None:
        att = att + bias.float()
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhsk,bkhd->bshd", att, vf)
    return out.reshape(b, s, hd).to(q.dtype)


def _check(q, k, v, num_heads, bias, rope_q):
    b, s, hd = q.shape
    kv = k.shape[1]
    if hd % num_heads or hd // num_heads not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {hd}/{num_heads} not in {HEAD_DIMS}")
    if k.shape != (b, kv, hd) or v.shape != (b, kv, hd) or kv == 0 or s == 0:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not share [B, *, H*D]")
    tensors = [q, k, v]
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{NAME}: q/k/v must be bfloat16, got {t.dtype}")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.numel() != b * kv:
            raise ValueError(f"{NAME}: bias must be f32 [B,1,1,K], got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    if rope_q is not None:
        for t in rope_q:
            if t.dtype != torch.float32 or t.shape[1:] != (s, hd) or \
                    t.shape[0] not in (1, b):
                raise ValueError(f"{NAME}: rope tables must be f32 "
                                 f"[1|B, S, H*D], got {t.dtype} {tuple(t.shape)}")
        if rope_q[0].shape != rope_q[1].shape:
            raise ValueError(f"{NAME}: cos and sin tables differ in shape")
        tensors.extend(rope_q)
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{NAME}: every input must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte aligned")


def flash_attention_packed(q, k, v, *, num_heads: int, scale: float, bias=None,
                           rope_q=None):
    """q [B,S,H·D], k/v [B,K,H·D] (k already rotated), bias f32 [B,1,1,K],
    rope_q (cos, sin) f32 [1|B,S,H·D] meaning q is not yet rotated.
    Returns [B,S,H·D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, num_heads=num_heads,
                                            scale=scale, bias=bias, rope_q=rope_q)
    _check(q, k, v, num_heads, bias, rope_q)
    b, s, hd = q.shape
    kv = k.shape[1]
    out = torch.empty_like(q)
    cos, sin = rope_q if rope_q is not None else (None, None)
    rope_bstride = 0 if cos is None or cos.shape[0] == 1 else s * hd
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.lib().cvt_flash_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias), ptr(cos), ptr(sin),
        out.data_ptr(), b, s, kv, num_heads, hd // num_heads, rope_bstride,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out
