"""T5-XXL encoder (``candle_video_tpu/models/ltx_video/t5.py``).

24 pre-norm blocks, relative position bias from layer 0 shared by all,
gated-GELU FFN, no 1/sqrt(d) attention scaling, f32 softmax and einsums,
final RMSNorm.  Each linear is dense (``nn.Linear``) or a weight-only carry
(``ops/quant_linear.py``): the int8 carry ``{w_q, s[, b]}`` on K3, with the
K-quant affine part as a rank-G correction ``groupsum(x) @ b``, or the
true-4-bit Q4_K carry ``{w4, w4_scale, w4_min}`` on K4, whose min is fused
in the dequant (no correction).  ``t5_from_gguf`` loads a GGUF file into
either form.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops.activations import gelu_tanh
from ...ops.kernels.int4_weight_matmul import pack_nibbles
from ...ops.kernels.int8_weight_matmul import quantize_int8_blockwise
from ...ops.norms import rms_norm
from ...ops.quant_linear import Int4Linear, Int8Linear
from ...utils.device import loader_device
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


def _fill_index(seed: int, count: int, device):
    """``(i * 2654435761 + seed) mod 2^32`` for i < count, as int64 (the JAX
    bench's deterministic uint32 fill)."""
    i = torch.arange(count, device=device, dtype=torch.int64)
    return (i * 2654435761 + seed) & 0xFFFFFFFF


def _int8_fill(seed: int, k: int, n: int, device):
    """Deterministic int8 [k, n] payload in the style of the JAX bench's T5
    fill: ``int8((i * 2654435761 + seed) mod 2^32 mod 255) - 64`` with int8
    wrap-around."""
    v = _fill_index(seed, k * n, device) % 255
    return ((v + 64) % 256 - 128).to(torch.int8).reshape(k, n)


def _random_t5(cfg: T5Config, device, dtype, qlin) -> T5Encoder:
    """Full-size T5 whose linears come from ``qlin(seed, k, n)``; norms 1,
    relative bias 0, a deterministic embedding."""
    d, ff = cfg.d_model, cfg.d_ff
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


@torch.no_grad()
def init_random_int8(cfg: T5Config, device, dtype=torch.bfloat16,
                     scale: float = 1e-4) -> T5Encoder:
    """Full-size T5 with every linear in the int8 carry (groups of 32),
    filled deterministically on the device."""
    def qlin(seed, k, n):
        s = torch.full((k // 32, n), scale, dtype=torch.float32, device=device)
        return Int8Linear(_int8_fill(seed, k, n, device), s)

    return _random_t5(cfg, device, dtype, qlin)


@torch.no_grad()
def init_random_w4(cfg: T5Config, device, dtype=torch.bfloat16, scale: float = 1e-4,
                   minimum: float = -7.5e-4) -> T5Encoder:
    """Full-size T5 with every linear in the Q4_K-form carry: packed bytes
    ``(i * 2654435761 + seed) mod 256`` (uniform nibbles), f32 scale and min
    per group of 32 (the dequant is centred at 0), made on the device."""
    def qlin(seed, k, n):
        w4 = (_fill_index(seed, (k // 2) * n, device) & 0xFF).to(torch.uint8)
        s = torch.full((k // 32, n), scale, dtype=torch.float32, device=device)
        return Int4Linear(w4.reshape(k // 2, n), s, torch.full_like(s, minimum))

    return _random_t5(cfg, device, dtype, qlin)


def _copy(arr):
    """A tensor that owns a C-ordered copy of ``arr`` (GGUF arrays may view
    the file's memory map, which is closed after loading)."""
    return torch.from_numpy(np.array(arr, order="C"))


def _gguf_linear(f, name: str, device, dtype, keep_quantized: bool):
    """One GGUF linear: dense ``nn.Linear``, or its payload carried as is."""
    from ...quant import dequant_np as DQ

    def t(arr, to=None):
        return _copy(arr).to(device=device, dtype=to)

    if not keep_quantized:
        return dense_linear(t(f.tensor(name).T, dtype))
    info = f.tensors[name]
    out_dim, in_dim = info.shape

    def kmajor(flat, group):
        """[out*in] flat fields -> [in, out] / [in//group, out]."""
        return np.ascontiguousarray(flat.reshape(out_dim, in_dim // group).T)

    if info.ggml_type == DQ.GGML_Q8_0:
        qs, d = DQ.extract_q8_0_fields(f.raw_tensor(name), info.n_elements)
        return Int8Linear(t(kmajor(qs, 1)), t(kmajor(d, DQ.QK8_0), torch.float32))
    if info.ggml_type == DQ.GGML_Q4_K:
        q, s, b = DQ.extract_q4_k_fields(f.raw_tensor(name), info.n_elements)
        return Int4Linear(t(pack_nibbles(kmajor(q, 1))), t(kmajor(s, 32), torch.float32),
                          t(kmajor(b, 32), torch.float32))
    if info.ggml_type == DQ.GGML_Q5_K:
        q, s, b = DQ.extract_q5_k_fields(f.raw_tensor(name), info.n_elements)
        return Int8Linear(t(kmajor(q, 1)), t(kmajor(s, 32)), t(kmajor(b, 32)))
    if info.ggml_type == DQ.GGML_Q6_K:
        q, s = DQ.extract_q6_k_fields(f.raw_tensor(name), info.n_elements)
        return Int8Linear(t(kmajor(q, 1)), t(kmajor(s, 16)))
    w_q, s = quantize_int8_blockwise(f.tensor(name).reshape(out_dim, in_dim).T)
    return Int8Linear(t(w_q), t(s))


@torch.no_grad()
def t5_from_gguf(path: str, cfg: T5Config, device="cuda", dtype=torch.bfloat16,
                 keep_quantized: bool = False) -> T5Encoder:
    """T5 encoder from a GGUF file with ``enc.blk.N.*`` names (the JAX
    ``params_from_gguf``).  ``keep_quantized=False`` dequantizes each linear
    once into a dense ``dtype`` ``nn.Linear``.  ``keep_quantized=True``
    carries each payload as it is stored: Q8_0 as int8 with its scales, Q4_K
    as packed nibbles with f32 (s, m), Q5_K as int8 codes with (s, b) in
    groups of 32, Q6_K as int8 with scales in groups of 16; a float tensor
    is quantized to int8 in groups of 32.  Layers may mix payload types.
    The GGUF reader (``quant/gguf.py``, numpy only) is imported here so
    that the encoder's other paths do not load it."""
    from ...quant.gguf import GGUFFile

    device = loader_device(device)
    f = GGUFFile(path)
    try:
        def norm(name):
            return _copy(f.tensor(name)).to(device=device, dtype=dtype)

        blocks = []
        for i in range(cfg.num_layers):
            pre = f"enc.blk.{i}"
            names = {"q": "attn_q", "k": "attn_k", "v": "attn_v", "o": "attn_o",
                     "wi_0": "ffn_gate", "wi_1": "ffn_up", "wo": "ffn_down"}
            lins = {k: _gguf_linear(f, f"{pre}.{v}.weight", device, dtype, keep_quantized)
                    for k, v in names.items()}
            blocks.append(T5Block(cfg, lins, norm(f"{pre}.attn_norm.weight"),
                                  norm(f"{pre}.ffn_norm.weight")))
        # GGUF stores the relative bias as [num_buckets, num_heads]
        rel = _copy(f.tensor("enc.blk.0.attn_rel_b.weight")).to(device=device,
                                                                 dtype=torch.float32)
        return T5Encoder(cfg, norm("token_embd.weight"), blocks, rel,
                         norm("enc.output_norm.weight")).eval()
    finally:
        f.close()
