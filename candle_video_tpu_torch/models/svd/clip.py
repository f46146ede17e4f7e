"""CLIP vision encoder with projection: SVD's image conditioning
(``candle_video_tpu/models/svd/clip.py``), as ``nn.Module``s with the names
of HF ``CLIPVisionModelWithProjection``.

Patch conv embedding + class token + learned positions, pre-LN blocks with
quick-GELU MLPs, post-LN pooled class token, bias-less projection.  The
attention (ViT-H/14: 257 tokens, 16 heads of 80) is plain torch with f32
scores and softmax, as the JAX package computes it.

``resize_bilinear`` is ``jax.image.resize(..., "bilinear")`` (antialiased
when it downsamples): the same triangle-kernel weight matrices, built in
numpy and applied as two matmuls.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ...ops.activations import quick_gelu
from .configs import ClipEncoderConfig
from .loader import load_into
from .unet import LayerNorm, init_random_

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize_for_clip(images):
    """[B,3,H,W] in [0,1] -> CLIP-normalised."""
    mean = torch.from_numpy(CLIP_MEAN).reshape(1, 3, 1, 1).to(images)
    std = torch.from_numpy(CLIP_STD).reshape(1, 3, 1, 1).to(images)
    return (images - mean) / std


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] f32 weights of the antialiased triangle kernel, computed as
    ``jax.image.compute_weight_mat`` computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(images, height: int, width: int):
    """[B,C,H,W] -> [B,C,height,width], bilinear, antialiased when
    downsampling (``jax.image.resize`` semantics); a dimension that keeps its
    size is left alone."""
    _, _, h, w = images.shape
    out = images
    if w != width:
        out = out @ torch.from_numpy(_resize_weights(w, width)).to(out)
    if h != height:
        out = torch.from_numpy(_resize_weights(h, height)).to(out).t() @ out
    return out


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int, dtype=None):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d, dtype=dtype)
        self.k_proj = nn.Linear(d, d, dtype=dtype)
        self.v_proj = nn.Linear(d, d, dtype=dtype)
        self.out_proj = nn.Linear(d, d, dtype=dtype)

    def forward(self, x):
        b, s, d = x.shape
        h = self.heads
        hd = d // h
        q, k, v = (proj(x).reshape(b, s, h, hd).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        att = (q.float() * hd ** -0.5) @ k.float().transpose(-1, -2)
        att = torch.softmax(att, dim=-1).to(x.dtype)
        out = (att @ v).transpose(1, 2).reshape(b, s, d)
        return self.out_proj(out)


class _Mlp(nn.Module):
    def __init__(self, d: int, inner: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(d, inner, dtype=dtype)
        self.fc2 = nn.Linear(inner, d, dtype=dtype)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: ClipEncoderConfig, dtype=None):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = LayerNorm(d, eps=eps, dtype=dtype)
        self.self_attn = _Attention(d, cfg.num_attention_heads, dtype)
        self.layer_norm2 = LayerNorm(d, eps=eps, dtype=dtype)
        self.mlp = _Mlp(d, cfg.intermediate_size, dtype)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: ClipEncoderConfig, dtype=None):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(d, dtype=dtype))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, p, stride=p, bias=False,
                                         dtype=dtype)
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, d, dtype=dtype)

    def forward(self, pixel_values):
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixel_values.to(w.dtype)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.reshape(1, 1, -1).expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class _Encoder(nn.Module):
    def __init__(self, cfg: ClipEncoderConfig, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg, dtype) for _ in range(cfg.num_hidden_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipEncoderConfig, dtype=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.embeddings = _Embeddings(cfg, dtype)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=eps, dtype=dtype)
        self.encoder = _Encoder(cfg, dtype)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=eps, dtype=dtype)


class ClipVisionModelWithProjection(nn.Module):
    def __init__(self, cfg: ClipEncoderConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg, dtype)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                           dtype=dtype)

    def forward(self, pixel_values):
        """pixel_values [B,3,H,W], already CLIP-normalised -> image embeddings
        [B, projection_dim] in the model dtype."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixel_values))
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def empty_clip(cfg: ClipEncoderConfig, device, dtype=torch.bfloat16):
    with torch.device("meta"):
        model = ClipVisionModelWithProjection(cfg, dtype)
    return model.to_empty(device=device)


def init_random(cfg: ClipEncoderConfig, device, dtype=torch.bfloat16,
                generator: torch.Generator | None = None):
    """A random-weight encoder on ``device`` (``unet.init_random_``)."""
    return init_random_(empty_clip(cfg, device, dtype), generator)


# names HF checkpoints carry that are not weights
_NOT_WEIGHTS = ("vision_model.embeddings.position_ids",)


def params_from_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: ClipEncoderConfig,
                              device="cpu", dtype=torch.float32):
    """An HF CLIPVisionModelWithProjection state dict -> the encoder on
    ``device`` in ``dtype``."""
    sd = {k: v for k, v in sd.items() if k not in _NOT_WEIGHTS}
    return load_into(empty_clip(cfg, device, dtype), sd)

