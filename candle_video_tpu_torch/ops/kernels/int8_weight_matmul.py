"""K3: weight-only int8 matmul (W8A16) — CUDA kernel and its plain version.

Counterpart of ``candle_video_tpu/ops/pallas/int8_weight_matmul.py``:
``y = x · bf16(f32(w_q) · s[k // qblock, n])`` with f32 accumulation, the
result in the output dtype, an optional bias added after.  The kernel is
``csrc/int8_weight_matmul.cu``; its source note says what bounds it.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
``w8_matmul_auto`` keeps the JAX package's dispatch: from ``W8_XLA_MIN_M``
rows on, the weight is dequantized into a transient bf16 buffer and the
product is a plain ``torch.matmul`` (the JAX package leaves that regime to
XLA); the T5 encode (M = 128) always takes the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

NAME = "w8_matmul"
QBLOCK = 32
W8_XLA_MIN_M = 1024
_BM, _BN, _BK = 128, 64, 32  # the kernel's tile (csrc/int8_weight_matmul.cu)
_CTAS_PER_SM = 4  # split-K target: enough CTAs to keep every SM's loads in flight


def quantize_int8_blockwise(w, qblock: int = QBLOCK):
    """[.., K, N] float -> (w_q int8 [.., K, N], s f32 [.., K//qblock, N]):
    symmetric per-(group of ``qblock`` along K, column) quantization, the
    numpy producer of the JAX package, with C-contiguous payloads whatever
    the layout of ``w``."""
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape[-2], w.shape[-1]
    if k % qblock:
        raise ValueError(f"K={k} must be a multiple of qblock={qblock}")
    g = w.reshape(*w.shape[:-2], k // qblock, qblock, n)
    s = np.maximum(np.abs(g).max(axis=-2), 1e-12) / 127.0
    q = np.clip(np.round(g / s[..., None, :]), -127, 127).astype(np.int8)
    return q.reshape(w.shape), s.astype(np.float32)


def dot_bf16(x, w_bf16, out_dtype):
    """x·w over bf16 operands with f32 accumulation, the result in
    ``out_dtype``: XLA's ``dot(bf16, bf16, preferred_element_type=f32)``
    followed by a cast.  A bf16 result is one bf16 matmul; any other takes
    the f32 product of the bf16 values, so it is not rounded to bf16."""
    xb = x.to(torch.bfloat16)
    if out_dtype == torch.bfloat16:
        return torch.matmul(xb, w_bf16)
    return torch.matmul(xb.float(), w_bf16.float()).to(out_dtype)


def dequantize(w_q, s_w, qblock: int = QBLOCK):
    """int8 [K, N] with f32 scales [K/qblock, N] -> bf16 [K, N]."""
    k, n = w_q.shape
    w = w_q.float().reshape(k // qblock, qblock, n) * s_w.float()[:, None, :]
    return w.reshape(k, n).to(torch.bfloat16)


def w8_matmul_plain(x, w_q, s_w, bias=None, qblock: int = QBLOCK, out_dtype=None):
    """Plain PyTorch version: bf16 operands, f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    w = dequantize(w_q, s_w, qblock)
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def _check(x, w_q, s_w, bias, qblock):
    m, k = x.shape
    n = w_q.shape[1]
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 or \
            s_w.dtype != torch.float32:
        raise TypeError(f"{NAME}: needs bf16 x, int8 w_q, f32 scales; got "
                        f"{x.dtype}, {w_q.dtype}, {s_w.dtype}")
    if w_q.shape[0] != k or k % 8 or k % qblock or s_w.shape != (k // qblock, n):
        raise ValueError(f"{NAME}: x {tuple(x.shape)} w_q {tuple(w_q.shape)} "
                         f"s {tuple(s_w.shape)} qblock {qblock}")
    tensors = [x, w_q, s_w]
    if bias is not None:
        if bias.dtype != torch.bfloat16 or bias.shape != (n,):
            raise ValueError(f"{NAME}: bias must be bf16 [N]")
        tensors.append(bias)
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{NAME}: every input must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: inputs must be contiguous and 16-byte aligned")


def split_k(m: int, k: int, n: int, sms: int):
    """(splits, k_per_split): K cut into 32-deep multiples so that about
    ``_CTAS_PER_SM`` CTAs per SM cover the output tiles."""
    tiles = -(-n // _BN) * -(-m // _BM)
    steps = -(-k // _BK)
    splits = max(1, min(steps, -(-_CTAS_PER_SM * sms // tiles)))
    per = -(-steps // splits) * _BK
    return -(-k // per), per


def w8_matmul(x, w_q, s_w, bias=None, qblock: int = QBLOCK, out_dtype=None):
    """x [M, K], w_q int8 [K, N], s_w f32 [K/qblock, N], bias [N] -> [M, N]."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, w_q, s_w, bias, qblock, out_dtype)
    if out_dtype not in (None, torch.bfloat16):
        raise TypeError(f"{NAME}: the kernel writes bfloat16, not {out_dtype}")
    if bias is not None:
        bias = bias.to(torch.bfloat16)
    _check(x, w_q, s_w, bias, qblock)
    m, k = x.shape
    n = w_q.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per = split_k(m, k, n, sms)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().cvt_w8_matmul(
        x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
        None if bias is None else bias.data_ptr(), ws.data_ptr(), y.data_ptr(),
        m, k, n, qblock, splits, per, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return y


def w8_matmul_auto(x, w_q, s_w, bias=None, qblock: int = QBLOCK, out_dtype=None):
    """Fused kernel for small M (weight-bandwidth bound); transient bf16
    dequant plus ``torch.matmul`` from ``W8_XLA_MIN_M`` rows on."""
    if x.shape[0] >= W8_XLA_MIN_M:
        out_dtype = out_dtype or x.dtype
        y = dot_bf16(x, dequantize(w_q, s_w, qblock), out_dtype)
        return y if bias is None else y + bias.to(out_dtype)
    return w8_matmul(x, w_q, s_w, bias, qblock, out_dtype)

