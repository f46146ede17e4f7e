"""LTX-Video 3D DiT (``candle_video_tpu/models/ltx_video/transformer.py``).

proj_in → AdaLN-single time embedding → caption projection → N blocks
(RMSNorm + 6-way AdaLN modulation, RoPE'd self-attention on K1, unnormed
cross-attention, tanh-GELU FF) → final scale/shift modulation → proj_out.
With ``ring`` (a ``torch.distributed`` group, the sequence-parallel loop of
``parallel/sequence.py``) the hidden states are this rank's token shard and
self-attention runs over the ring (``ops/ring.py``, K5 on the card).  A
model cut by ``parallel.shard_transformer`` holds this rank's heads and FF
lanes (tensor parallelism); one cut by ``parallel.shard_transformer_pp``
holds this pipeline stage's layers and runs only through
``parallel.pipeline_transformer_forward``, which shares ``embed``, the
blocks and ``finish`` with ``forward``.

The JAX package stacks the blocks as ``[L, ...]`` arrays under ``lax.scan``;
here they are a ``ModuleList`` walked by a Python loop.  Linear weights are
``nn.Linear`` (``[out, in]``): ``convert.py`` transposes the JAX ``[in, out]``
arrays.

Quantized tiers: weight-only (``quantize_transformer_w8`` / ``_w4``,
``init_random_w8`` / ``_w4``) and W8A8 (``quantize_transformer_w8a8``,
``init_random_w8a8``, on K7).  The block linears (attn1/attn2 QKVO and FF)
become ``ops/quant_linear.py`` modules; everything else stays in the model
dtype.  ``forward`` is the same for every tier.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ...ops.activations import gelu_tanh, silu
from ...ops.attention import attention
from ...ops.embeddings import sinusoidal_timestep_embedding
from ...ops.kernels.int4_weight_matmul import quantize_int4_blockwise
from ...ops.kernels.int8_matmul import quantize_weight as quantize_w8a8_weight
from ...ops.kernels.int8_weight_matmul import quantize_int8_blockwise
from ...ops.norms import layer_norm, rms_norm
from ...ops.quant_linear import Int4Linear, Int8Linear, W8A8Linear
from ...ops.ring import ring_self_attention
from ...ops.rope import apply_rotary_emb
from ...utils import debug
from .configs import LtxTransformerConfig


def _linear(lin, x):
    """``lin(x)``; while spans are recorded a dense ``nn.Linear``'s product
    is a ``matmul`` span (the quantized linears open theirs around their own
    products).  The flag is tested here first: this runs 287 times a 2B
    step, where the host has little time to spare."""
    if debug.RECORDING and isinstance(lin, nn.Linear):
        with debug.span("matmul"):
            return lin(x)
    return lin(x)


class Attention(nn.Module):
    """LTXVideoAttnProcessor: QK-RMSNorm (eps 1e-5, affine, across the full
    inner dim) → RoPE → SDPA → to_out.  With ``ring``, self-attention rotates
    q and k here and runs over the ring's K/V chunks; cross-attention stays
    local.  With ``tp_group`` (set by ``parallel.shard_transformer``) the
    module holds ``heads`` of the model's heads, its lanes of the norms and
    the RoPE tables it is given, and a row-sharded ``to_out``."""

    def __init__(self, cfg: LtxTransformerConfig, dtype):
        super().__init__()
        d = cfg.inner_dim
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.attention_head_dim
        self.tp_group = None
        self.norm_q = nn.Parameter(torch.empty(d, dtype=dtype))
        self.norm_k = nn.Parameter(torch.empty(d, dtype=dtype))
        self.to_q = nn.Linear(d, d, bias=cfg.attention_bias, dtype=dtype)
        self.to_k = nn.Linear(d, d, bias=cfg.attention_bias, dtype=dtype)
        self.to_v = nn.Linear(d, d, bias=cfg.attention_bias, dtype=dtype)
        self.to_out = nn.Linear(d, d, bias=cfg.attention_out_bias, dtype=dtype)

    def _qk_norm(self, q, k):
        """The QK-RMSNorm over the full inner dim.  Under tensor parallelism
        each rank holds 1/tp of the lanes: the f32 sums of squares of q and
        k, in one tensor, are all-reduced over the tp group and divided by
        the full width."""
        if self.tp_group is None:
            return rms_norm(q, self.norm_q, eps=1e-5), rms_norm(k, self.norm_k, eps=1e-5)
        qf, kf = q.float(), k.float()
        sums = torch.cat([qf.square().sum(-1).flatten(), kf.square().sum(-1).flatten()])
        dist.all_reduce(sums, group=self.tp_group)
        width = q.shape[-1] * dist.get_world_size(self.tp_group)
        sq, sk = sums.split([qf[..., 0].numel(), kf[..., 0].numel()])
        out = []
        for xf, s, w, x in ((qf, sq, self.norm_q, q), (kf, sk, self.norm_k, k)):
            ms = s.reshape(xf.shape[:-1] + (1,)) / width
            out.append((xf / torch.sqrt(ms + 1e-5)).to(x.dtype) * w.to(x.dtype))
        return out

    def forward(self, hidden, encoder_hidden=None, bias=None, rope=None, ring=None):
        b, s, _ = hidden.shape
        enc = hidden if encoder_hidden is None else encoder_hidden
        kv = enc.shape[1]
        q, k = self._qk_norm(_linear(self.to_q, hidden), _linear(self.to_k, enc))
        v = _linear(self.to_v, enc)
        h, hd = self.heads, self.head_dim
        if ring is not None and encoder_hidden is None:
            if rope is not None:
                q, k = (apply_rotary_emb(t, rope[0], rope[1]) for t in (q, k))
            out = ring_self_attention(q.reshape(b, s, h, hd), k.reshape(b, kv, h, hd),
                                      v.reshape(b, kv, h, hd), 1.0 / math.sqrt(hd), ring)
        else:
            out = attention(q.reshape(b, s, h, hd), k.reshape(b, kv, h, hd),
                            v.reshape(b, kv, h, hd), 1.0 / math.sqrt(hd),
                            bias=bias, rope=rope)
        return _linear(self.to_out, out.reshape(b, s, h * hd))


class FeedForward(nn.Module):
    def __init__(self, d: int, dtype):
        super().__init__()
        self.net_0_proj = nn.Linear(d, 4 * d, dtype=dtype)
        self.net_2 = nn.Linear(4 * d, d, dtype=dtype)

    def forward(self, x):
        return _linear(self.net_2, gelu_tanh(_linear(self.net_0_proj, x)))


class TransformerBlock(nn.Module):
    """One LtxVideoTransformerBlock.  ``temb6`` [B, T, 6·D] modulates with
    T = 1 (one timestep per row, text-to-video) or T = S (one per token,
    the image-conditioned loop)."""

    def __init__(self, cfg: LtxTransformerConfig, dtype):
        super().__init__()
        self.eps = cfg.norm_eps
        self.attn1 = Attention(cfg, dtype)
        self.attn2 = Attention(cfg, dtype)
        self.ff = FeedForward(cfg.inner_dim, dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(6, cfg.inner_dim, dtype=dtype))

    def forward(self, hidden, encoder_hidden, temb6, rope, enc_bias, skip_row=None,
                ring=None):
        b, d = hidden.shape[0], hidden.shape[-1]
        orig = hidden
        ada = self.scale_shift_table[None, None] + temb6.reshape(b, -1, 6, d)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = ada.unbind(2)

        norm = rms_norm(hidden, eps=self.eps) * (1.0 + scale_msa) + shift_msa
        with debug.span("attn1"):
            attn = self.attn1(norm, rope=rope, ring=ring)
        hidden = hidden + attn * gate_msa
        # cross-attention: no pre-norm, no RoPE, no gate
        with debug.span("attn2"):
            attn = self.attn2(hidden, encoder_hidden, bias=enc_bias)
        hidden = hidden + attn
        norm = rms_norm(hidden, eps=self.eps) * (1.0 + scale_mlp) + shift_mlp
        with debug.span("ff"):
            ff = self.ff(norm)
        hidden = hidden + ff * gate_mlp
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
        # (tp, rank) once parallel.shard_transformer has cut the model; the
        # pipeline stage's (pp, interleave, stage, layers) once
        # parallel.shard_transformer_pp has
        self.tp = None
        self.pp = None

    def _timestep_embedding(self, timestep, dtype):
        """AdaLayerNormSingle: the sinusoid runs on the f32 timestep."""
        te = self.timestep_embedder
        proj = sinusoidal_timestep_embedding(timestep, 256).to(dtype)
        emb = _linear(te.linear_2, silu(_linear(te.linear_1, proj)))
        return _linear(self.time_linear, silu(emb)), emb

    def local_rope(self, rope_cos, rope_sin):
        """The RoPE tables this rank's heads read: under tensor parallelism
        its 1/tp of the lanes, contiguous (K1 takes them so).  The tables
        span the whole inner dim with the ``dim % 6`` pad lanes at the
        front, so every rank's slice differs."""
        if self.tp is None:
            return rope_cos, rope_sin
        n, rank = self.tp
        width = rope_cos.shape[-1] // n
        return tuple(t[..., rank * width:(rank + 1) * width].contiguous()
                     for t in (rope_cos, rope_sin))

    def embed(self, hidden_states, encoder_hidden_states, timestep,
              encoder_attention_mask=None):
        """The pre-block compute: (x [B,S,D], caption states [B,K,D], temb6
        [B,T,6D], the final modulation's embedding [B,T,D], the caption bias
        [B,1,1,K] f32 or None), all in the model dtype but the bias."""
        dtype = self.proj_in.weight.dtype
        b = hidden_states.shape[0]
        x = _linear(self.proj_in, hidden_states.to(dtype))
        cp = self.caption_projection
        enc = _linear(cp.linear_2,
                      gelu_tanh(_linear(cp.linear_1, encoder_hidden_states.to(dtype))))
        temb6, emb = self._timestep_embedding(timestep.reshape(-1).float(), dtype)
        temb6 = temb6.reshape(b, -1, temb6.shape[-1])
        emb = emb.reshape(b, -1, emb.shape[-1])
        enc_bias = None
        if encoder_attention_mask is not None:
            mask = encoder_attention_mask.float()
            enc_bias = ((1.0 - mask) * -10000.0)[:, None, None, :].contiguous()
        return x, enc, temb6, emb, enc_bias

    def finish(self, x, emb):
        """The post-block compute: the final scale/shift modulation and
        proj_out."""
        ss = self.scale_shift_table.to(emb.dtype)[None, None] + emb[:, :, None, :]
        shift, scale = ss[:, :, 0], ss[:, :, 1]
        x = layer_norm(x, eps=1e-6) * (1.0 + scale) + shift
        return _linear(self.proj_out, x)

    def forward(self, hidden_states, encoder_hidden_states, timestep, rope_cos,
                rope_sin, encoder_attention_mask=None, skip_layer_mask=None, ring=None):
        """hidden [B,S,C_in], caption states [B,K,C_cap], timestep [B] f32
        (one per row) or [B,S] (one per token: the AdaLN modulations and the
        final scale/shift become per token),
        rope tables [1|B,S,inner] f32, mask [B,K] (1 keep / 0 pad), skip
        mask [L,B] (1 = skip), ``ring`` the sequence-parallel process group
        (S and the tables are then this rank's shard).  Returns [B,S,C_out]
        in the model dtype."""
        if self.pp is not None and self.pp[3] != tuple(range(self.cfg.num_layers)):
            raise ValueError("this model holds one pipeline stage's layers "
                             "(parallel.shard_transformer_pp): run it through "
                             "parallel.pipeline_transformer_forward")
        x, enc, temb6, emb, enc_bias = self.embed(hidden_states, encoder_hidden_states,
                                                  timestep, encoder_attention_mask)
        rope = self.local_rope(rope_cos, rope_sin)
        for i, blk in enumerate(self.blocks):
            skip_row = None if skip_layer_mask is None else skip_layer_mask[i]
            x = blk(x, enc, temb6, rope, enc_bias, skip_row, ring)
        return self.finish(x, emb)


def empty_transformer(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16):
    """The module with uninitialised storage on ``device`` (no default init)."""
    with torch.device("meta"):
        model = LtxTransformer3D(cfg, dtype)
    return model.to_empty(device=device)


def _init_dense_(model, generator) -> None:
    """The JAX init's std values: linears N(0, 0.02), biases 0, QK-norm
    weights 1, modulation tables N(0, 1/sqrt(inner))."""
    table_std = 1.0 / math.sqrt(model.cfg.inner_dim)
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


@torch.no_grad()
def init_random(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16,
                generator: torch.Generator | None = None):
    """Random-init DiT (``_init_dense_``)."""
    model = empty_transformer(cfg, device, dtype)
    _init_dense_(model, generator)
    return model.eval()


# (block attribute, linear) pairs the weight-only tiers quantize
QUANTIZED_LINEARS = tuple((attn, name) for attn in ("attn1", "attn2")
                          for name in ("to_q", "to_k", "to_v", "to_out")) + \
    (("ff", "net_0_proj"), ("ff", "net_2"))


def quantized_slots(model):
    """(parent module, attribute) of every block linear in
    ``QUANTIZED_LINEARS``."""
    for blk in model.blocks:
        for group, name in QUANTIZED_LINEARS:
            yield getattr(blk, group), name


def _bias_of(lin):
    return None if lin.bias is None else lin.bias.detach()


@torch.no_grad()
def quantize_transformer_w8(model, qblock: int = 128):
    """In place: the block linears to weight-only int8 (W8A16, symmetric
    per-(group of ``qblock`` along K, column) f32 scales), one linear at a
    time so the f32 temporaries stay one matrix big.  The payloads are the
    JAX ``quantize_transformer_params_w8``'s bit for bit."""
    for parent, name in quantized_slots(model):
        lin = getattr(parent, name)
        w_q, s = quantize_int8_blockwise(lin.weight.detach().t().float().cpu().numpy(),
                                         qblock)
        dev = lin.weight.device
        setattr(parent, name, Int8Linear(torch.from_numpy(w_q).to(dev),
                                         torch.from_numpy(s).to(dev), bias=_bias_of(lin)))
    return model


@torch.no_grad()
def quantize_transformer_w4(model, qblock: int = 32, scale_dtype=torch.bfloat16):
    """In place: the block linears to weight-only int4 (W4A16, packed
    nibbles with affine scale and min per group of ``qblock``, in
    ``scale_dtype``), one linear at a time.  The payloads are the JAX
    ``quantize_transformer_params_w4``'s bit for bit; the large-M route
    dequantizes in bf16, as the JAX DiT does."""
    for parent, name in quantized_slots(model):
        lin = getattr(parent, name)
        packed, s, m = quantize_int4_blockwise(
            lin.weight.detach().t().float().cpu().numpy(), qblock, scale_dtype)
        dev = lin.weight.device
        setattr(parent, name, Int4Linear(packed.to(dev), s.to(dev), m.to(dev),
                                         bias=_bias_of(lin), compute_dtype=torch.bfloat16))
    return model


@torch.no_grad()
def quantize_transformer_w8a8(model):
    """In place: the block linears to the W8A8 tier (int8 weights with one
    f32 scale per output channel, floored at 1e-8; activations quantized per
    token at run time, the product on K7), one linear at a time.  The
    payloads are the JAX ``quantize_transformer_params``' bit for bit,
    stored transposed (``[N, K]``), computed where the weights are."""
    for parent, name in quantized_slots(model):
        lin = getattr(parent, name)
        w_q, s = quantize_w8a8_weight(lin.weight.detach())
        setattr(parent, name, W8A8Linear(w_q, s, bias=_bias_of(lin)))
    return model


def quantized_skeleton(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16):
    """The DiT with every block linear of ``QUANTIZED_LINEARS`` left out
    (an ``nn.Identity`` in its place) and the rest allocated on ``device``,
    uninitialised: the dense block weights are never allocated.  Returns
    (model, slots), a slot being (parent module, attribute, the linear's
    name in the model, in features, out features, whether the config gives
    it a bias)."""
    with torch.device("meta"):
        model = LtxTransformer3D(cfg, dtype)
    slots = []
    for i, blk in enumerate(model.blocks):
        for group, name in QUANTIZED_LINEARS:
            parent = getattr(blk, group)
            lin = getattr(parent, name)
            slots.append((parent, name, f"blocks.{i}.{group}.{name}", lin.in_features,
                          lin.out_features, lin.bias is not None))
            setattr(parent, name, nn.Identity())
    return model.to_empty(device=device), slots


def _init_random_quantized(cfg, device, dtype, generator, make_linear):
    """Random DiT whose block linears come from ``make_linear(d_in, d_out,
    bias)``; the dense block weights are never allocated."""
    model, slots = quantized_skeleton(cfg, device, dtype)
    _init_dense_(model, generator)
    for parent, name, _, d_in, d_out, has_bias in slots:
        bias = torch.zeros(d_out, dtype=dtype, device=device) if has_bias else None
        setattr(parent, name, make_linear(d_in, d_out, bias))
    return model.eval()


@torch.no_grad()
def init_random_w4(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16,
                   generator: torch.Generator | None = None):
    """Random DiT with the block linears made directly as int4 on the
    device, groups of 32: uniform bytes (so uniform nibbles, std 4.61, mean
    7.5), bf16 scale ``0.02 / 4.61`` and min ``-7.5 * scale`` (weights of
    std 0.02 centred at 0), as the JAX ``init_params_w4``.  The bf16 block
    tree never exists."""
    s_val = 0.02 / 4.61
    m_val = -7.5 * s_val

    def make(d_in, d_out, bias):
        w4 = torch.randint(0, 256, (d_in // 2, d_out), generator=generator, device=device,
                           dtype=torch.uint8)
        s = torch.full((d_in // 32, d_out), s_val, dtype=torch.bfloat16, device=device)
        return Int4Linear(w4, s, torch.full_like(s, m_val), bias=bias,
                          compute_dtype=torch.bfloat16)

    return _init_random_quantized(cfg, device, dtype, generator, make)


@torch.no_grad()
def init_random_w8(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16,
                   generator: torch.Generator | None = None):
    """Random DiT with the block linears made directly as int8 on the
    device, groups of 128: uniform bytes (std 73.9) with f32 scale
    ``0.02 / 73.9``, as the JAX ``init_params_w8``."""
    def make(d_in, d_out, bias):
        w_q = torch.randint(-128, 128, (d_in, d_out), generator=generator, device=device,
                            dtype=torch.int8)
        s = torch.full((d_in // 128, d_out), 0.02 / 73.9, dtype=torch.float32,
                       device=device)
        return Int8Linear(w_q, s, bias=bias)

    return _init_random_quantized(cfg, device, dtype, generator, make)


def build_skip_layer_mask(num_layers: int, batch: int, skip_blocks) -> np.ndarray:
    """[L, B] STG perturbation mask: 1 = skip."""
    mask = np.zeros((num_layers, batch), dtype=np.float32)
    for idx in skip_blocks or ():
        if 0 <= idx < num_layers:
            mask[idx, :] = 1.0
    return mask


@torch.no_grad()
def init_random_w8a8(cfg: LtxTransformerConfig, device, dtype=torch.bfloat16,
                     generator: torch.Generator | None = None):
    """Random DiT on the W8A8 tier, the block linears made directly on the
    device: uniform int8 in [-127, 127] (std 73.6) with the f32 scale
    ``0.02 / 73.6`` per output channel (weights of std 0.02, the dense
    init's).  The bf16 block tree never exists."""
    def make(d_in, d_out, bias):
        w_q = torch.randint(-127, 128, (d_out, d_in), generator=generator, device=device,
                            dtype=torch.int8)
        s = torch.full((d_out,), 0.02 / 73.6, dtype=torch.float32, device=device)
        return W8A8Linear(w_q, s, bias=bias)

    return _init_random_quantized(cfg, device, dtype, generator, make)
