"""Normalisations with the JAX package's pinned f32 internals
(``candle_video_tpu/ops/norms.py``): statistics in f32, cast back to the
input dtype, then the affine weight in that dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6):
    """GroupNorm over channels-first [N, C, *spatial]: f32 statistics, cast
    back to x's dtype, then the affine in that dtype."""
    y = F.group_norm(x.float(), num_groups, eps=eps).to(x.dtype)
    bshape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    if weight is not None:
        y = y * weight.to(x.dtype).reshape(bshape)
    if bias is not None:
        y = y + bias.to(x.dtype).reshape(bshape)
    return y


def rms_norm(x, weight=None, eps: float = 1e-6, dim: int = -1):
    """RMSNorm over ``dim``. f32 internals, cast back, then affine."""
    xf = x.float()
    y = xf / torch.sqrt(xf.square().mean(dim=dim, keepdim=True) + eps)
    y = y.to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype)
    return y


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last axis (f32 internals, torch-compatible)."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    y = xc / torch.sqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    y = y.to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y
