"""Attention dispatch (``candle_video_tpu/ops/attention.py``).

- ``attention_xla``: plain f32-softmax attention, the correctness oracle.
- ``attention_xla_bf16``: operands in the working dtype, f32 scores and
  softmax, p cast back for P·V.  Carries cross-attention (K = 128 caption
  tokens), which the JAX package also leaves unfused below ``_SHORT_KV``.
- ``attention``: routes as the JAX ``attention(impl="pallas")`` does.
  Shapes the lane-packed layout takes (``packed_viable``) go to
  ``flash_attention_packed`` (``ops/kernels/flash_attention_packed.py``),
  which routes to K1, or to K2 above 8192 padded keys; k is rotated here
  and q inside the kernel.  The other shapes (heads that do not fill
  128-lane groups, as the SVD UNet's 5 heads of 64) go to K6
  (``ops/kernels/flash_attention.py``) with q and k rotated here.  Short key
  lengths without RoPE take ``attention_xla_bf16``.
"""

from __future__ import annotations

import torch

from .kernels.flash_attention import flash_attention
from .kernels.flash_attention_packed import flash_attention_packed, packed_viable
from .rope import apply_rotary_emb

# at or below this key length the unfused path carries the attention
_SHORT_KV = 512


def attention_xla(q, k, v, scale: float, bias=None):
    """q [B,S,H,D], k/v [B,K,H,D], bias broadcastable to [B,H,S,K]; f32 math."""
    att = torch.einsum("bshd,bkhd->bhsk", q.float(), k.float()) * scale
    if bias is not None:
        att = att + bias.float()
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhsk,bkhd->bshd", att, v.float()).to(q.dtype)


def attention_xla_bf16(q, k, v, scale: float, bias=None):
    """Working-dtype operands, f32 scores and softmax, p in q's dtype."""
    att = torch.einsum("bshd,bkhd->bhsk", q, k).float() * scale
    if bias is not None:
        att = att + bias.float()
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhsk,bkhd->bshd", att, v)


def attention(q, k, v, scale: float, bias=None, rope=None):
    """Scaled dot-product attention over [B, S, H, D].

    ``rope``: optional full-width (cos, sin) tables [1|B, S, H·D]; q and k
    then arrive unrotated.  On the packed route k rotates here and q inside
    the kernel; on K6's route both rotate here."""
    b, s, h, d = q.shape
    kv = k.shape[1]
    if rope is None and kv <= _SHORT_KV:
        return attention_xla_bf16(q, k, v, scale, bias=bias)
    if not packed_viable(s, kv, h, d):
        if rope is not None:
            q = apply_rotary_emb(q.reshape(b, s, h * d), rope[0], rope[1]).reshape(q.shape)
            k = apply_rotary_emb(k.reshape(b, kv, h * d), rope[0], rope[1]).reshape(k.shape)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
                               bias=bias)
    if rope is not None:
        k = apply_rotary_emb(k.reshape(b, kv, h * d), rope[0], rope[1])
    out = flash_attention_packed(
        q.reshape(b, s, h * d).contiguous(), k.reshape(b, kv, h * d).contiguous(),
        v.reshape(b, kv, h * d).contiguous(),
        num_heads=h, scale=scale, bias=bias, rope_q=rope,
    )
    return out.reshape(b, s, h, d)
