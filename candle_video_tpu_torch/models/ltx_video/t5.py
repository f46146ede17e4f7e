"""T5-XXL encoder (``candle_video_tpu/models/ltx_video/t5.py``).

24 pre-norm blocks, relative position bias from layer 0 shared by all,
gated-GELU FFN, no 1/sqrt(d) attention scaling, f32 softmax and einsums,
final RMSNorm.  Each linear is dense (``nn.Linear``) or the int8 carry
``{w_q, s[, b]}``: weights resident as int8 with per-(group, column) f32
scales, multiplied on K3 (``ops/kernels/int8_weight_matmul.py``), with the
K-quant affine part as a rank-G correction ``groupsum(x) @ b``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops.activations import gelu_tanh
from ...ops.kernels.int8_weight_matmul import w8_matmul_auto
from ...ops.norms import rms_norm
from .configs import T5Config


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """HF bidirectional bucket formula."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


def position_bias(rel_bias, cfg: T5Config, seq_len: int):
    """[1, heads, S, S] f32 additive bias from the layer-0 table [buckets, H]."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    buckets = relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                       cfg.relative_attention_max_distance)
    bias = rel_bias[torch.from_numpy(buckets).to(rel_bias.device)]  # [S, S, H]
    return bias.permute(2, 0, 1)[None].float()


class Int8Linear(nn.Module):
    """Weight-only int8 linear: ``w_q`` int8 [K, N], ``s`` f32 [K/g, N], and
    optionally the affine part ``b`` [K/g, N] of a K-quant payload."""

    def __init__(self, w_q, s, b=None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("s", s)
        self.register_buffer("b", b)

    def forward(self, x):
        lead, k = x.shape[:-1], x.shape[-1]
        gs = k // self.s.shape[0]
        x2 = x.reshape(-1, k).contiguous()
        y = w8_matmul_auto(x2, self.w_q, self.s, qblock=gs, out_dtype=x.dtype)
        if self.b is not None:
            gsum = x2.float().reshape(x2.shape[0], k // gs, gs).sum(-1)
            y = y + (gsum @ self.b.float()).to(y.dtype)
        return y.reshape(*lead, y.shape[-1])


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, linears: dict, attn_norm, ffn_norm):
        super().__init__()
        self.cfg = cfg
        for name in ("q", "k", "v", "o", "wi_0", "wi_1", "wo"):
            setattr(self, name, linears[name])
        self.attn_norm = nn.Parameter(attn_norm, requires_grad=False)
        self.ffn_norm = nn.Parameter(ffn_norm, requires_grad=False)

    def _attention(self, x, bias):
        b, s, _ = x.shape
        h, dk = self.cfg.num_heads, self.cfg.d_kv
        q = self.q(x).reshape(b, s, h, dk).float()
        k = self.k(x).reshape(b, s, h, dk).float()
        v = self.v(x).reshape(b, s, h, dk).float()
        scores = torch.einsum("bshd,bkhd->bhsk", q, k)  # no 1/sqrt(d)
        if bias is not None:
            scores = scores + bias
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhsk,bkhd->bshd", w, v).to(x.dtype)
        return self.o(out.reshape(b, s, h * dk))

    def forward(self, x, bias):
        eps = self.cfg.layer_norm_epsilon
        x = x + self._attention(rms_norm(x, self.attn_norm, eps=eps), bias)
        normed = rms_norm(x, self.ffn_norm, eps=eps)
        return x + self.wo(gelu_tanh(self.wi_0(normed)) * self.wi_1(normed))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, embedding, blocks, rel_bias, final_norm):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(embedding, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.rel_bias = nn.Parameter(rel_bias, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)

    def forward(self, input_ids, attention_mask=None):
        """input_ids [B, S] -> final hidden states [B, S, d_model] in the
        embedding dtype."""
        x = self.embedding[input_ids]
        bias = position_bias(self.rel_bias, self.cfg, input_ids.shape[1])
        if attention_mask is not None:
            ext = (1.0 - attention_mask.float()) * -1e9
            bias = bias + ext[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, bias)
        return rms_norm(x, self.final_norm, eps=self.cfg.layer_norm_epsilon)


def dense_linear(weight_in_out):
    """nn.Linear (no bias) from a JAX-layout [in, out] weight."""
    lin = nn.Linear(*weight_in_out.shape, bias=False, device="meta")
    lin.weight = nn.Parameter(weight_in_out.t().contiguous(), requires_grad=False)
    return lin


def _int8_fill(seed: int, k: int, n: int, device):
    """Deterministic int8 [k, n] payload in the style of the JAX bench's T5
    fill: ``int8((i * 2654435761 + seed) mod 2^32 mod 255) - 64`` with int8
    wrap-around."""
    i = torch.arange(k * n, device=device, dtype=torch.int64)
    v = ((i * 2654435761 + seed) & 0xFFFFFFFF) % 255
    return ((v + 64) % 256 - 128).to(torch.int8).reshape(k, n)


@torch.no_grad()
def init_random_int8(cfg: T5Config, device, dtype=torch.bfloat16,
                     scale: float = 1e-4) -> T5Encoder:
    """Full-size T5 with every linear in the int8 carry (groups of 32),
    filled deterministically on the device; norms 1, relative bias 0."""
    d, ff = cfg.d_model, cfg.d_ff

    def qlin(seed, k, n):
        s = torch.full((k // 32, n), scale, dtype=torch.float32, device=device)
        return Int8Linear(_int8_fill(seed, k, n, device), s)

    blocks = []
    for i in range(cfg.num_layers):
        shapes = {"q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d),
                  "wi_0": (d, ff), "wi_1": (d, ff), "wo": (ff, d)}
        lins = {name: qlin(7 * i + j + 1, *kn) for j, (name, kn) in enumerate(shapes.items())}
        ones = torch.ones(d, dtype=dtype, device=device)
        blocks.append(T5Block(cfg, lins, ones, ones.clone()))
    emb = (_int8_fill(99, cfg.vocab_size, d, device).to(dtype) * 0.02)
    rel = torch.zeros(cfg.relative_attention_num_buckets, cfg.num_heads,
                      dtype=torch.float32, device=device)
    return T5Encoder(cfg, emb, blocks, rel, torch.ones(d, dtype=dtype, device=device)).eval()
