"""K1 and K2: lane-packed flash attention — CUDA kernels and their plain
versions.

Counterpart of ``candle_video_tpu/ops/pallas/flash_attention_packed.py``.
Non-causal ``softmax(q kᵀ·scale + bias)·v`` on the natural ``[B, S, H·D]``
projection layout, with the optional q-side interleaved RoPE applied inside
the kernel (k arrives rotated) and ragged S/K masked.

- K1 (``flash_attention_packed_onepass``; the TPU's one-pass ``_kernel``):
  online softmax.
- K2 (``flash_attention_packed_long``; the TPU's ``_packed_long``): the same
  contract with a FIXED softmax shift, the per-(batch, 128-lane group)
  Cauchy-Schwarz bound of ``group_score_bounds`` plus the key bias's global
  max, so the numerator and denominator are plain sums over key blocks.
- ``flash_attention_packed`` routes as the JAX function does: K2 once the
  key length rounded up to 128 exceeds ``_ONEPASS_KP_MAX``, else K1.

Both kernels are ``csrc/flash_attention_packed.cu`` (one template); the
source note there says what bounds them and how the design answers.  CPU
tensors take the plain versions; CUDA tensors launch a kernel or raise.
"""

from __future__ import annotations

import torch

from ..rope import apply_rotary_emb
from . import _build

NAME = "flash_attention_packed"
NAME_LONG = "flash_attention_packed_long"
HEAD_DIMS = (64, 128)
LOG2E = 1.4426950408889634
# the bound may exceed the realized row max by the exp underflow headroom
# (~86 nats) without changing the result; it is clipped far below that
_BOUND_CLIP = 40.0
# above this padded key length the JAX package leaves the one-pass kernel
# for the long one; the port routes at the same point
_ONEPASS_KP_MAX = 8192


def packed_viable(s_len: int, kv_len: int, num_heads: int, head_dim: int) -> bool:
    """True when the lane-packed kernels apply, as the JAX ``packed_viable``
    decides: the head dim divides 128 and the heads fill 128-lane groups
    (sequence lengths do not matter)."""
    if head_dim > 128 or 128 % head_dim != 0:
        return False
    return num_heads % (128 // head_dim) == 0


def uses_long_kernel(kv_len: int) -> bool:
    """True when ``flash_attention_packed`` takes K2 for ``kv_len`` keys."""
    return -(-kv_len // 128) * 128 > _ONEPASS_KP_MAX


def _group_max_norms(x3, n_groups: int):
    """``max_j ||x_j,group||_2`` per (batch, 128-lane group) -> f32 [B, G],
    in one f32 reduction over x's own dtype (no f32 copy of x)."""
    b, s, inner = x3.shape
    x4 = x3.reshape(b, s, n_groups, inner // n_groups)
    return torch.linalg.vector_norm(x4, dim=-1, dtype=torch.float32).amax(1)


def group_score_bounds(q3, k3, scale: float, n_groups: int):
    """Per-(batch, 128-lane group) upper bound on the scaled scores,
    ``scale·max_i||q_i,g||·max_j||k_j,g||`` (Cauchy-Schwarz), clipped at
    ``_BOUND_CLIP``.  RoPE is orthogonal within a head, so q's norms before
    its rotation serve."""
    bound = scale * _group_max_norms(q3, n_groups) * _group_max_norms(k3, n_groups)
    return bound.clamp_max(_BOUND_CLIP)


def long_shift(q, k, *, num_heads: int, scale: float, bias=None):
    """K2's fixed softmax shift, f32 [B, G]: the group bounds plus the
    bias's global max per batch (the shift must be the same for every key
    block of a row, so the bias max is folded in here)."""
    n_groups = num_heads // (128 // (q.shape[-1] // num_heads))
    bounds = group_score_bounds(q, k, scale, n_groups)
    if bias is not None:
        bounds = bounds + bias.float().reshape(q.shape[0], -1).amax(-1, keepdim=True)
    return bounds


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


def flash_attention_packed_long_plain(q, k, v, *, num_heads: int, scale: float,
                                      bias=None, rope_q=None, block_k: int = 1024):
    """Plain PyTorch version of K2: f32 scores over key blocks of
    ``block_k``, ``p = exp2((s - m)·log2e)`` with the fixed shift ``m`` of
    ``long_shift``, ``l += Σp`` and ``o += p·v``, then ``o / l``.  Memory is
    O(S·block_k), not O(S·K)."""
    m = long_shift(q, k, num_heads=num_heads, scale=scale, bias=bias)
    if rope_q is not None:
        q = apply_rotary_emb(q, rope_q[0], rope_q[1])
    b, s, hd = q.shape
    kv = k.shape[1]
    d = hd // num_heads
    m = m.repeat_interleave(128 // d, dim=1)[:, :, None, None]  # [B, H, 1, 1]
    qf = q.reshape(b, s, num_heads, d).float()
    kf = k.reshape(b, kv, num_heads, d).float()
    vf = v.reshape(b, kv, num_heads, d).float()
    o = torch.zeros(b, num_heads, s, d, device=q.device)
    l = torch.zeros(b, num_heads, s, 1, device=q.device)
    for k0 in range(0, kv, block_k):
        sc = torch.einsum("bshd,bkhd->bhsk", qf, kf[:, k0:k0 + block_k]) * scale
        if bias is not None:
            sc = sc + bias.float().reshape(b, 1, 1, kv)[..., k0:k0 + block_k]
        p = torch.exp2((sc - m) * LOG2E)
        l += p.sum(-1, keepdim=True)
        o += torch.einsum("bhsk,bkhd->bhsd", p, vf[:, k0:k0 + block_k])
    return (o / l).permute(0, 2, 1, 3).reshape(b, s, hd).to(q.dtype)


def _check(q, k, v, num_heads, bias, rope_q, name=NAME):
    b, s, hd = q.shape
    kv = k.shape[1]
    if hd % num_heads or hd // num_heads not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}/{num_heads} not in {HEAD_DIMS}")
    if k.shape != (b, kv, hd) or v.shape != (b, kv, hd) or kv == 0 or s == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not share [B, *, H*D]")
    tensors = [q, k, v]
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: q/k/v must be bfloat16, got {t.dtype}")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.numel() != b * kv:
            raise ValueError(f"{name}: bias must be f32 [B,1,1,K], got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    if rope_q is not None:
        for t in rope_q:
            if t.dtype != torch.float32 or t.shape[1:] != (s, hd) or \
                    t.shape[0] not in (1, b):
                raise ValueError(f"{name}: rope tables must be f32 "
                                 f"[1|B, S, H*D], got {t.dtype} {tuple(t.shape)}")
        if rope_q[0].shape != rope_q[1].shape:
            raise ValueError(f"{name}: cos and sin tables differ in shape")
        tensors.extend(rope_q)
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: every input must be on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")


def flash_attention_packed(q, k, v, *, num_heads: int, scale: float, bias=None,
                           rope_q=None):
    """q [B,S,H·D], k/v [B,K,H·D] (k already rotated), bias f32 [B,1,1,K],
    rope_q (cos, sin) f32 [1|B,S,H·D] meaning q is not yet rotated.
    Returns [B,S,H·D] in q's dtype, from K2 above ``_ONEPASS_KP_MAX`` padded
    keys and from K1 below."""
    fn = (flash_attention_packed_long if uses_long_kernel(k.shape[1])
          else flash_attention_packed_onepass)
    return fn(q, k, v, num_heads=num_heads, scale=scale, bias=bias, rope_q=rope_q)


def flash_attention_packed_onepass(q, k, v, *, num_heads: int, scale: float, bias=None,
                                   rope_q=None):
    """K1 at any key length (the routing function's arguments)."""
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


def flash_attention_packed_long(q, k, v, *, num_heads: int, scale: float, bias=None,
                                rope_q=None):
    """K2 at any key length (the routing function's arguments).  The fixed
    shift is computed here, in torch, as the JAX package computes it in XLA
    outside the Pallas kernel."""
    if q.device.type == "cpu":
        return flash_attention_packed_long_plain(q, k, v, num_heads=num_heads,
                                                 scale=scale, bias=bias, rope_q=rope_q)
    _check(q, k, v, num_heads, bias, rope_q, NAME_LONG)
    b, s, hd = q.shape
    kv = k.shape[1]
    d = hd // num_heads
    if num_heads % (128 // d):
        raise ValueError(f"{NAME_LONG}: {num_heads} heads do not fill 128-lane groups")
    shift = long_shift(q, k, num_heads=num_heads, scale=scale, bias=bias).contiguous()
    out = torch.empty_like(q)
    cos, sin = rope_q if rope_q is not None else (None, None)
    rope_bstride = 0 if cos is None or cos.shape[0] == 1 else s * hd
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.lib().cvt_flash_attention_packed_long(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias), ptr(cos), ptr(sin),
        shift.data_ptr(), out.data_ptr(), b, s, kv, num_heads, d, rope_bstride,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, NAME_LONG)
    _build.LAUNCHES[NAME_LONG] += 1
    return out
