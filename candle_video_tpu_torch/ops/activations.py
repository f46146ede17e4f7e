"""Activations (``candle_video_tpu/ops/activations.py``): tanh-GELU runs in
f32 and casts back; SiLU stays in the input dtype.  The SVD family adds the
exact (erf) GELU of its GEGLU feed-forwards and CLIP's quick-GELU."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_tanh(x):
    """0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))), computed in f32
    (PyTorch's op math for bf16 inputs) and rounded once to x's dtype."""
    return F.gelu(x, approximate="tanh")


def gelu(x):
    """Exact GELU, 0.5·x·(1 + erf(x/√2)) (``jax.nn.gelu(approximate=False)``)."""
    return F.gelu(x)


def quick_gelu(x):
    """CLIP's x·sigmoid(1.702·x)."""
    return x * torch.sigmoid(1.702 * x)


def silu(x):
    return x * torch.sigmoid(x)
