"""Video-coordinate 3-axis RoPE (``candle_video_tpu/ops/rope.py``).

``dim // 6`` frequencies per axis, ``theta ** linspace(0, 1) * pi/2``; the
grid is mapped to ``2g - 1``; angles interleave freq-major across the
(frame, height, width) axes, repeat twice, and the ``dim % 6`` leftover
lanes pad at the front with cos = 1, sin = 0.  Tables are full width
``[.., S, H·D]`` f32 and rotate interleaved pairs.  The JAX package's split
lane layout (a TPU 128-lane roll trick) is deliberately not carried over.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rope_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    """The ``dim // 6`` base angular frequencies, f32."""
    steps = dim // 6
    if steps <= 1:
        lin = np.zeros((max(steps, 1),), dtype=np.float32)
    else:
        lin = (np.arange(steps, dtype=np.float32) / np.float32(steps - 1)).astype(
            np.float32)
    freqs = np.exp(lin * np.float32(math.log(theta))).astype(np.float32)
    return freqs * np.float32(math.pi / 2.0)


def rope_cos_sin(grid, dim: int, theta: float = 10000.0):
    """grid [..., S, 3] (normalised) -> (cos, sin), each [..., S, dim] f32."""
    freqs = torch.from_numpy(rope_freqs(dim, theta)).to(grid.device)
    steps = freqs.shape[0]
    g = grid.float()[..., None] * 2.0 - 1.0  # [..., S, 3, 1]
    ang = (g * freqs).transpose(-1, -2).reshape(*grid.shape[:-1], 3 * steps)
    cos = torch.cos(ang).repeat_interleave(2, dim=-1)
    sin = torch.sin(ang).repeat_interleave(2, dim=-1)
    rem = dim % 6
    if rem:
        pad = (*cos.shape[:-1], rem)
        cos = torch.cat([cos.new_ones(pad), cos], dim=-1)
        sin = torch.cat([sin.new_zeros(pad), sin], dim=-1)
    return cos, sin


def apply_rotary_emb(x, cos, sin):
    """x [..., S, C], tables [..., S, C]: (x0, x1) -> (x0 c - x1 s, x1 c + x0 s)
    in f32, cast back to x's dtype."""
    xf = x.float()
    x2 = xf.unflatten(-1, (-1, 2))
    x_rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    return (xf * cos.float() + x_rot * sin.float()).to(x.dtype)
