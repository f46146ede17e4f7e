"""Sinusoidal timestep embedding (``candle_video_tpu/ops/embeddings.py``):
f32 math, frequencies 1/10000^(i/(half - downscale_freq_shift)), output
ordered [cos, sin].  LTX uses no shift; SVD shifts by 1."""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoidal_timestep_embedding(timesteps, embedding_dim: int = 256,
                                  downscale_freq_shift: float = 0.0):
    """timesteps [N] -> [N, embedding_dim] f32 on the timesteps' device
    (flip_sin_to_cos, max period 10000)."""
    half = embedding_dim // 2
    exponent = -math.log(10000.0) * np.arange(half, dtype=np.float32)
    exponent = exponent / np.float32(half - downscale_freq_shift)
    inv_freq = torch.from_numpy(np.exp(exponent).astype(np.float32))
    freqs = timesteps.float()[:, None] * inv_freq.to(timesteps.device)[None, :]
    emb = torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
