"""Weight-only quantized linears shared by the T5 encoder and the DiT.

The JAX package keeps these as parameter dicts read by
``transformer._apply_linear_w8`` / ``_apply_linear_w4`` and ``t5._linear``;
here each is a module whose buffers hold the payload in the kernels' K-major
``[K, N]`` layout (no transpose, unlike ``nn.Linear``'s ``[out, in]``).

- ``Int8Linear``: int8 ``w_q`` with f32 scales ``s`` per (group, column) on
  K3, plus the K-quant affine part ``b`` as a rank-G correction
  ``groupsum(x) @ b`` and an optional ``bias``.
- ``Int4Linear``: packed nibbles ``w4`` with affine ``w4_scale`` and
  ``w4_min`` on K4; ``compute_dtype`` picks the transient route's dequant
  order at large M (f32 for T5, bf16 for the DiT, as in the JAX package).
"""

from __future__ import annotations

import torch
from torch import nn

from .kernels.int4_weight_matmul import w4_matmul_auto
from .kernels.int8_weight_matmul import w8_matmul_auto


def _flat(x):
    return x.reshape(-1, x.shape[-1]).contiguous()


class Int8Linear(nn.Module):
    """``w_q`` int8 [K, N], ``s`` f32 [K/g, N], optionally ``b`` [K/g, N]
    (the affine part of a K-quant payload) and ``bias`` [N]."""

    def __init__(self, w_q, s, b=None, bias=None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("s", s)
        self.register_buffer("b", b)
        self.register_buffer("bias", bias)

    def forward(self, x):
        lead, k = x.shape[:-1], x.shape[-1]
        gs = k // self.s.shape[0]
        x2 = _flat(x)
        y = w8_matmul_auto(x2, self.w_q, self.s, bias=self.bias, qblock=gs,
                           out_dtype=x.dtype)
        if self.b is not None:
            gsum = x2.float().reshape(x2.shape[0], k // gs, gs).sum(-1)
            y = y + (gsum @ self.b.float()).to(y.dtype)
        return y.reshape(*lead, y.shape[-1])


class Int4Linear(nn.Module):
    """``w4`` packed uint8 [K/2, N], ``w4_scale`` and ``w4_min`` [K/g, N]
    (f32 or bf16), optionally ``bias`` [N]."""

    def __init__(self, w4, w4_scale, w4_min, bias=None, compute_dtype=torch.float32):
        super().__init__()
        self.register_buffer("w4", w4)
        self.register_buffer("w4_scale", w4_scale)
        self.register_buffer("w4_min", w4_min)
        self.register_buffer("bias", bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        lead, k = x.shape[:-1], x.shape[-1]
        y = w4_matmul_auto(_flat(x), self.w4, self.w4_scale, self.w4_min, bias=self.bias,
                           qblock=k // self.w4_scale.shape[0], out_dtype=x.dtype,
                           compute_dtype=self.compute_dtype)
        return y.reshape(*lead, y.shape[-1])
