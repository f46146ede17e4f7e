"""LTX-Video 3D DiT (``candle_video_tpu/models/ltx_video/transformer.py``).

proj_in → AdaLN-single time embedding → caption projection → N blocks
(RMSNorm + 6-way AdaLN modulation, RoPE'd self-attention on K1, unnormed
cross-attention, tanh-GELU FF) → final scale/shift modulation → proj_out.

The JAX package stacks the blocks as ``[L, ...]`` arrays under ``lax.scan``;
here they are a ``ModuleList`` walked by a Python loop.  Linear weights are
``nn.Linear`` (``[out, in]``): ``convert.py`` transposes the JAX ``[in, out]``
arrays.  BF16 weights only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops.activations import gelu_tanh, silu
from ...ops.attention import attention
from ...ops.embeddings import sinusoidal_timestep_embedding
from ...ops.norms import layer_norm, rms_norm
from .configs import LtxTransformerConfig


class Attention(nn.Module):
    """LTXVideoAttnProcessor: QK-RMSNorm (eps 1e-5, affine, across the full
    inner dim) → RoPE → SDPA → to_out."""

    def __init__(self, cfg: LtxTransformerConfig, dtype):
        super().__init__()
        d = cfg.inner_dim
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.attention_head_dim
        self.norm_q = nn.Parameter(torch.empty(d, dtype=dtype))
        self.norm_k = nn.Parameter(torch.empty(d, dtype=dtype))
        self.to_q = nn.Linear(d, d, bias=cfg.attention_bias, dtype=dtype)
        self.to_k = nn.Linear(d, d, bias=cfg.attention_bias, dtype=dtype)
        self.to_v = nn.Linear(d, d, bias=cfg.attention_bias, dtype=dtype)
        self.to_out = nn.Linear(d, d, bias=cfg.attention_out_bias, dtype=dtype)

    def forward(self, hidden, encoder_hidden=None, bias=None, rope=None):
        b, s, _ = hidden.shape
        enc = hidden if encoder_hidden is None else encoder_hidden
        kv = enc.shape[1]
        q = rms_norm(self.to_q(hidden), self.norm_q, eps=1e-5)
        k = rms_norm(self.to_k(enc), self.norm_k, eps=1e-5)
        v = self.to_v(enc)
        h, hd = self.heads, self.head_dim
        out = attention(q.reshape(b, s, h, hd), k.reshape(b, kv, h, hd),
                        v.reshape(b, kv, h, hd), 1.0 / math.sqrt(hd),
                        bias=bias, rope=rope)
        return self.to_out(out.reshape(b, s, h * hd))


class FeedForward(nn.Module):
    def __init__(self, d: int, dtype):
        super().__init__()
        self.net_0_proj = nn.Linear(d, 4 * d, dtype=dtype)
        self.net_2 = nn.Linear(4 * d, d, dtype=dtype)

    def forward(self, x):
        return self.net_2(gelu_tanh(self.net_0_proj(x)))


class TransformerBlock(nn.Module):
    """One LtxVideoTransformerBlock with the T = 1 (one timestep per row)
    AdaLN modulation."""

    def __init__(self, cfg: LtxTransformerConfig, dtype):
        super().__init__()
        self.eps = cfg.norm_eps
        self.attn1 = Attention(cfg, dtype)
        self.attn2 = Attention(cfg, dtype)
        self.ff = FeedForward(cfg.inner_dim, dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(6, cfg.inner_dim, dtype=dtype))

    def forward(self, hidden, encoder_hidden, temb6, rope, enc_bias, skip_row=None):
        b, d = hidden.shape[0], hidden.shape[-1]
        orig = hidden
        ada = self.scale_shift_table[None, None] + temb6.reshape(b, -1, 6, d)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = ada.unbind(2)

        norm = rms_norm(hidden, eps=self.eps) * (1.0 + scale_msa) + shift_msa
        hidden = hidden + self.attn1(norm, rope=rope) * gate_msa
        # cross-attention: no pre-norm, no RoPE, no gate
        hidden = hidden + self.attn2(hidden, encoder_hidden, bias=enc_bias)
        norm = rms_norm(hidden, eps=self.eps) * (1.0 + scale_mlp) + shift_mlp
        hidden = hidden + self.ff(norm) * gate_mlp
        if skip_row is not None:
            m = skip_row.reshape(b, 1, 1).to(hidden.dtype)  # 1 = skip the block
            hidden = hidden * (1.0 - m) + orig * m
        return hidden


class _TwoLinear(nn.Module):
    def __init__(self, d_in: int, d: int, dtype):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d, dtype=dtype)
        self.linear_2 = nn.Linear(d, d, dtype=dtype)


class LtxTransformer3D(nn.Module):
    def __init__(self, cfg: LtxTransformerConfig, dtype=torch.bfloat16):
        super().__init__()
        d = cfg.inner_dim
        self.cfg = cfg
        self.proj_in = nn.Linear(cfg.in_channels, d, dtype=dtype)
        self.timestep_embedder = _TwoLinear(256, d, dtype)
        self.time_linear = nn.Linear(d, 6 * d, dtype=dtype)
        self.caption_projection = _TwoLinear(cfg.caption_channels, d, dtype)
        self.blocks = nn.ModuleList(TransformerBlock(cfg, dtype)
                                    for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(torch.empty(2, d, dtype=dtype))
        self.proj_out = nn.Linear(d, cfg.out_channels or cfg.in_channels, dtype=dtype)

    def _timestep_embedding(self, timestep, dtype):
        """AdaLayerNormSingle: the sinusoid runs on the f32 timestep."""
        te = self.timestep_embedder
        proj = sinusoidal_timestep_embedding(timestep, 256).to(dtype)
        emb = te.linear_2(silu(te.linear_1(proj)))
        return self.time_linear(silu(emb)), emb

    def forward(self, hidden_states, encoder_hidden_states, timestep, rope_cos,
                rope_sin, encoder_attention_mask=None, skip_layer_mask=None):
        """hidden [B,S,C_in], caption states [B,K,C_cap], timestep [B] f32,
        rope tables [1|B,S,inner] f32, mask [B,K] (1 keep / 0 pad), skip
        mask [L,B] (1 = skip).  Returns [B,S,C_out] in the model dtype."""
        dtype = self.proj_in.weight.dtype
        b = hidden_states.shape[0]
        x = self.proj_in(hidden_states.to(dtype))
        cp = self.caption_projection
        enc = cp.linear_2(gelu_tanh(cp.linear_1(encoder_hidden_states.to(dtype))))
        temb6, emb = self._timestep_embedding(timestep.reshape(-1).float(), dtype)
        temb6 = temb6.reshape(b, -1, temb6.shape[-1])
        emb = emb.reshape(b, -1, emb.shape[-1])

        enc_bias = None
        if encoder_attention_mask is not None:
            mask = encoder_attention_mask.float()
            enc_bias = ((1.0 - mask) * -10000.0)[:, None, None, :].contiguous()

        rope = (rope_cos, rope_sin)
        for i, blk in enumerate(self.blocks):
            skip_row = None if skip_layer_mask is None else skip_layer_mask[i]
            x = blk(x, enc, temb6, rope, enc_bias, skip_row)

        ss = self.scale_shift_table.to(emb.dtype)[None, None] + emb[:, :, None, :]
        shift, scale = ss[:, :, 0], ss[:, :, 1]
        x = layer_norm(x, eps=1e-6) * (1.0 + scale) + shift
        return self.proj_out(x)


def empty_transformer(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16):
    """The module with uninitialised storage on ``device`` (no default init)."""
    with torch.device("meta"):
        model = LtxTransformer3D(cfg, dtype)
    return model.to_empty(device=device)


@torch.no_grad()
def init_random(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16,
                generator: torch.Generator | None = None):
    """Random-init DiT with the JAX init's std values: linears N(0, 0.02),
    biases 0, QK-norm weights 1, modulation tables N(0, 1/sqrt(inner))."""
    model = empty_transformer(cfg, device, dtype)
    table_std = 1.0 / math.sqrt(cfg.inner_dim)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf in ("norm_q", "norm_k"):
            p.fill_(1.0)
        elif leaf == "scale_shift_table":
            p.normal_(0.0, table_std, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model.eval()


def build_skip_layer_mask(num_layers: int, batch: int, skip_blocks) -> np.ndarray:
    """[L, B] STG perturbation mask: 1 = skip."""
    mask = np.zeros((num_layers, batch), dtype=np.float32)
    for idx in skip_blocks or ():
        if 0 <= idx < num_layers:
            mask[idx, :] = 1.0
    return mask
