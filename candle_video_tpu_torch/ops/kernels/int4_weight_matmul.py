"""K4: weight-only int4 matmul (W4A16) — CUDA kernel and its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/int4_weight_matmul.py``.  The
weight is packed nibbles in the K-half planar layout: byte ``j`` of column
``n`` holds logical row ``j`` in its low nibble and row ``K/2 + j`` in its
high nibble.  Each group of ``qblock`` logical rows has an affine scale and
min per column, ``w = s·q + m`` with ``q`` in [0, 15] (GGUF Q4_K's form).

Two dequant orders exist, as in the JAX package, and they are kept apart:

- the kernel route (``w4_matmul``, its plain version ``w4_matmul_plain``):
  ``bf16(f32(q)·f32(s) + f32(m))``, rounded once;
- the transient route (``w4_matmul_xla_equivalent``): the JAX package's
  ``w4_matmul_xla``, computing ``q·s + m`` in ``compute_dtype``.  With
  bf16 (the DiT's choice) the product and the sum are each rounded to bf16,
  which differs from the kernel route in over a third of the weights.

CPU tensors take the plain version.  CUDA tensors launch the kernel, or,
for a qblock the kernel is not built for (``qblock_ok``), chosen by shape
before any launch, take the transient route in the kernel's f32 order
(counted as ``w4_matmul_dequant``), so every qblock the JAX ``w4_matmul``
takes runs.  The kernel is the W4 instance of ``csrc/weight_only_matmul_hopper.cu``
(K3 is its other format), on the plan ``plan_w4``: K3's ``plan_weight_only``
over the K/2 packed rows, with two x boxes a step (the low and the high
half of K) and four scale tiles (s and m of both halves).  A payload whose
N is not a multiple of 16 is padded with zero columns per call.
``w4_matmul_auto`` keeps the JAX dispatch: from ``W4_XLA_MIN_M`` rows on,
the transient route; below it (T5's 128-token encode, the DiT's
cross-attention k/v over 128 caption tokens) the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .int8_weight_matmul import (H100_CLUSTERS, cluster_slots, count_dequant_route, dot_bf16,
                                 pad_columns, plan_weight_only, qblock_ok)

NAME = "w4_matmul"
DEQUANT_NAME = "w4_matmul_dequant"  # the transient route on the card
QBLOCK4 = 32  # GGUF Q4_K sub-block size along K
W4_XLA_MIN_M = 1024
_SCALE_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Producers (numpy, as in the JAX module)
# ---------------------------------------------------------------------------


def pack_nibbles(q):
    """[.., K, N] int codes in [0, 15] -> packed uint8 [.., K//2, N]
    (K-half planar: byte j = row j | row K/2+j << 4)."""
    q = np.asarray(q)
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"K={k} must be even to pack nibbles")
    if q.min() < 0 or q.max() > 15:
        raise ValueError("nibble codes must be in [0, 15]")
    qu = q.astype(np.uint8)
    return (qu[..., : k // 2, :] | (qu[..., k // 2:, :] << 4)).astype(np.uint8)


def quantize_int4_blockwise(w, qblock: int = QBLOCK4, scale_dtype=torch.float32):
    """[.., K, N] float -> (packed uint8 [.., K//2, N], s [.., K//qblock, N],
    m [.., K//qblock, N]) as CPU tensors, ``w ≈ s·q + m`` per (group of
    ``qblock`` along K, column), q in [0, 15].  The numpy math of the JAX
    producer; a ``scale_dtype`` of bfloat16 rounds s and m to nearest even
    before the codes are chosen, so the codes fit the rounded scales.  The
    payloads are C-contiguous whatever the layout of ``w``."""
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape[-2], w.shape[-1]
    if k % (2 * qblock):
        raise ValueError(f"K={k} must be a multiple of 2*qblock={2 * qblock} (K-half "
                         "planar packing: groups must not straddle the halves)")
    g = w.reshape(*w.shape[:-2], k // qblock, qblock, n)
    lo_v = g.min(axis=-2)
    hi_v = g.max(axis=-2)
    s = torch.from_numpy(np.maximum((hi_v - lo_v) / 15.0, 1e-12)).to(scale_dtype)
    m = torch.from_numpy(np.ascontiguousarray(lo_v)).to(scale_dtype)
    sf = s.float().numpy()[..., :, None, :]
    mf = m.float().numpy()[..., :, None, :]
    q = np.clip(np.round((g - mf) / sf), 0, 15).astype(np.uint8)
    return torch.from_numpy(pack_nibbles(q.reshape(*w.shape[:-2], k, n))), s, m


def dequantize_int4_blockwise(packed, s, m, qblock: int = QBLOCK4):
    """Unfused numpy dequant: -> f32 [.., K, N]."""
    packed = np.asarray(packed)
    kh, n = packed.shape[-2], packed.shape[-1]
    k = kh * 2
    q = np.concatenate([(packed & 0xF).astype(np.float32),
                        (packed >> 4).astype(np.float32)], axis=-2)
    g = q.reshape(*packed.shape[:-2], k // qblock, qblock, n)
    sf = np.asarray(s, np.float32)[..., :, None, :]
    mf = np.asarray(m, np.float32)[..., :, None, :]
    return (g * sf + mf).reshape(*packed.shape[:-2], k, n)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _codes(w_p):
    """Packed [K/2, N] -> codes [K, N] uint8 (low nibbles, then high)."""
    return torch.cat([w_p & 0xF, w_p >> 4], dim=0)


def dequantize(w_p, s_w, m_w, qblock: int = QBLOCK4, compute_dtype=torch.float32):
    """Packed weight -> bf16 [K, N].  ``compute_dtype`` f32 is the kernel's
    order (one rounding); bf16 rounds ``q·s`` and then ``+ m``."""
    q = _codes(w_p)
    k, n = q.shape
    w = q.reshape(k // qblock, qblock, n).to(compute_dtype) * \
        s_w.to(compute_dtype)[:, None, :] + m_w.to(compute_dtype)[:, None, :]
    return w.reshape(k, n).to(torch.bfloat16)


def _with_bias(y, bias, out_dtype):
    y = y.to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def w4_matmul_plain(x, w_p, s_w, m_w, bias=None, qblock: int = QBLOCK4, out_dtype=None):
    """Plain PyTorch version of K4: f32-order dequant to bf16, bf16 x, f32
    accumulation, the bias added after the output rounding."""
    out_dtype = out_dtype or x.dtype
    w = dequantize(w_p, s_w, m_w, qblock)
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float())
    return _with_bias(y, bias, out_dtype)


def w4_matmul_xla_equivalent(x, w_p, s_w, m_w, bias=None, qblock: int = QBLOCK4,
                             out_dtype=None, compute_dtype=torch.float32):
    """The JAX ``w4_matmul_xla`` route: dequant in ``compute_dtype`` into a
    transient bf16 weight, then one matmul with f32 accumulation."""
    count_dequant_route(x, DEQUANT_NAME)
    out_dtype = out_dtype or x.dtype
    w = dequantize(w_p, s_w, m_w, qblock, compute_dtype)
    return _with_bias(dot_bf16(x, w, out_dtype), bias, out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def plan_w4(m: int, k: int, n: int, qblock: int = QBLOCK4, scale_bytes: int = 4,
            clusters: tuple = H100_CLUSTERS, *, bn: int | None = None,
            split: int | None = None) -> dict:
    """K4's launch for ``[m, k] · [k, n]`` with s and m of ``scale_bytes``
    (4: f32, 2: bf16): ``plan_weight_only`` over the k/2 packed rows,
    cached: treat the result as read-only."""
    return plan_weight_only(m, k // 2, n, qblock, x_boxes=2, scale_tiles=4,
                            scale_bytes=scale_bytes, clusters=clusters, bn=bn, split=split)


def _check(x, w_p, s_w, m_w, bias, qblock):
    m, k = x.shape
    n = w_p.shape[1]
    if x.dtype != torch.bfloat16 or w_p.dtype != torch.uint8 or \
            s_w.dtype not in _SCALE_DTYPES or m_w.dtype != s_w.dtype:
        raise TypeError(f"{NAME}: needs bf16 x, uint8 w_p, f32 or bf16 s and m of one "
                        f"dtype; got {x.dtype}, {w_p.dtype}, {s_w.dtype}, {m_w.dtype}")
    if (w_p.shape[0] * 2 != k or k % 16 or not qblock_ok(qblock) or k % (2 * qblock)
            or n % 8 or s_w.shape != (k // qblock, n) or m_w.shape != s_w.shape):
        raise ValueError(f"{NAME}: x {tuple(x.shape)} w_p {tuple(w_p.shape)} "
                         f"s {tuple(s_w.shape)} m {tuple(m_w.shape)} qblock {qblock}: "
                         "needs K % 16 == 0, K % (2*qblock) == 0 and N % 8 == 0, and a "
                         "qblock that is a multiple of 16 dividing 64 or a multiple of 64")
    tensors = [x, w_p, s_w, m_w]
    if bias is not None:
        if bias.dtype != torch.bfloat16 or bias.shape != (n,):
            raise ValueError(f"{NAME}: bias must be bf16 [N]")
        tensors.append(bias)
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{NAME}: every input must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte aligned")


def _launch(x, w_p, s_w, m_w, bias, qblock, plan=None):
    """One launch on ``plan`` (``plan_w4``'s for the shape unless one is
    given); the output is the only allocation, besides the zero-padded
    payload of a ragged N."""
    _check(x, w_p, s_w, m_w, bias, qblock)
    m, k = x.shape
    n = w_p.shape[1]
    if plan is None:
        plan = plan_w4(m, k, n, qblock, s_w.element_size(), cluster_slots(x.device.index))
    w_p, s_w, m_w = pad_columns(plan["n_pad"], w_p, s_w, m_w)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().cvt_w4_matmul(
        x.data_ptr(), w_p.data_ptr(), s_w.data_ptr(), m_w.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), m, k, n, plan["n_pad"],
        qblock, int(s_w.dtype == torch.bfloat16), plan["bn"], plan["stages"], plan["split"],
        plan["smem_bytes"], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return y


def w4_matmul(x, w_p, s_w, m_w, bias=None, qblock: int = QBLOCK4, out_dtype=None):
    """x [M, K], packed w_p uint8 [K/2, N], s_w and m_w [K/qblock, N] (f32 or
    bf16), bias [N] -> [M, N]."""
    if x.device.type == "cpu":
        return w4_matmul_plain(x, w_p, s_w, m_w, bias, qblock, out_dtype)
    if not qblock_ok(qblock):  # the transient route, in the kernel's f32 order
        return w4_matmul_xla_equivalent(x, w_p, s_w, m_w, bias, qblock, out_dtype)
    if out_dtype not in (None, torch.bfloat16):
        raise TypeError(f"{NAME}: the kernel writes bfloat16, not {out_dtype}")
    return _launch(x, w_p, s_w, m_w, None if bias is None else bias.to(torch.bfloat16), qblock)


def w4_matmul_auto(x, w_p, s_w, m_w, bias=None, qblock: int = QBLOCK4, out_dtype=None,
                   compute_dtype=torch.float32):
    """The kernel below ``W4_XLA_MIN_M`` rows (weight-bandwidth bound); the
    transient route, dequantizing in ``compute_dtype``, from there on."""
    if x.shape[0] >= W4_XLA_MIN_M:
        return w4_matmul_xla_equivalent(x, w_p, s_w, m_w, bias, qblock, out_dtype,
                                        compute_dtype)
    return w4_matmul(x, w_p, s_w, m_w, bias, qblock, out_dtype)
