"""Carry the JAX package's parameter trees into the port's modules.

The trees arrive as nested dicts/lists of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), with the split-rope permutation off.
JAX linear weights are ``[in, out]``; they are transposed into
``nn.Linear``'s ``[out, in]``.  Quantized payloads (``w8``/``w8_scale``,
``w4``/``w4_scale``/``w4_min``, the T5 ``w_q``/``s``/``b``) are K-major
``[K, N]`` on both sides and are carried as they are, except the W8A8
tier's ``weight_q`` (``quantize_transformer_params``), which K7 reads as
``[N, K]``: it is transposed once here, its ``w_scale`` carried as it is.  Conv weights are
already in torch's ``[O, I, kt, kh, kw]`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.quant_linear import Int4Linear, Int8Linear, W8A8Linear
from ...utils.device import loader_device
from . import t5 as T5
from . import transformer as TF
from . import vae as V
from .configs import LtxTransformerConfig, LtxVaeConfig, T5Config


def _t(x, device, dtype=None):
    arr = torch.from_numpy(np.array(x, np.float32, order="C"))
    return arr.to(device=device, dtype=dtype)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _load(module, state, device):
    """Copy ``state`` (name -> numpy, torch layout) into ``module``."""
    own = module.state_dict()
    missing = set(own) - set(state)
    extra = set(state) - set(own)
    if missing or extra:
        raise KeyError(f"tree/module mismatch: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    for name, arr in state.items():
        own[name].copy_(_t(arr, device, own[name].dtype).reshape(own[name].shape))
    return module.eval()


def _dtype_of(arr):
    return torch.bfloat16 if np.asarray(arr).dtype.name == "bfloat16" else torch.float32


_INT_DTYPES = {"uint8": torch.uint8, "int8": torch.int8}


def _tensor(arr, device):
    """Integer payloads keep their dtype; float ones stay bf16 or become f32."""
    arr = np.asarray(arr)
    if arr.dtype.name in _INT_DTYPES:
        return torch.from_numpy(np.array(arr, order="C")).to(device)
    return _t(arr, device, _dtype_of(arr))


def _empty_layer(arr, device, dtype=None):
    """An empty tensor shaped like one layer of a stacked leaf: integer
    payloads keep their dtype, floats take ``dtype`` or their own."""
    arr = np.asarray(arr)
    dt = _INT_DTYPES.get(arr.dtype.name) or dtype or _dtype_of(arr)
    return torch.empty(arr.shape[1:], dtype=dt, device=device)


def _empty_quantized(leaf, device, dtype):
    """The quantized module for one layer of the stacked JAX leaf ``{w8,
    w8_scale}``, ``{w4, w4_scale, w4_min}`` or ``{weight_q, w_scale}`` (plus
    ``bias``), with empty buffers; None for a dense leaf."""
    bias = _empty_layer(leaf["bias"], device, dtype) if "bias" in leaf else None
    if "weight_q" in leaf:
        k, n = np.asarray(leaf["weight_q"]).shape[1:]
        return W8A8Linear(torch.empty((n, k), dtype=torch.int8, device=device),
                          _empty_layer(leaf["w_scale"], device, torch.float32), bias=bias)
    if "w8" in leaf:
        return Int8Linear(_empty_layer(leaf["w8"], device),
                          _empty_layer(leaf["w8_scale"], device, torch.float32), bias=bias)
    if "w4" in leaf:
        return Int4Linear(_empty_layer(leaf["w4"], device),
                          _empty_layer(leaf["w4_scale"], device),
                          _empty_layer(leaf["w4_min"], device), bias=bias,
                          compute_dtype=torch.bfloat16)
    return None


# JAX DiT leaf name -> the quantized module's buffer name
_DIT_LEAVES = {"w8": "w_q", "w8_scale": "s", "weight_q": "w_q"}


@torch.no_grad()
def transformer_from_jax(tree, cfg: LtxTransformerConfig, device="cuda", dtype=None):
    """JAX DiT tree (stacked ``blocks`` [L, ...]) -> LtxTransformer3D."""
    device = loader_device(device)
    dtype = dtype or _dtype_of(tree["proj_in"]["weight"])
    top = {
        "proj_in": tree["proj_in"],
        "timestep_embedder.linear_1": tree["time_embed"]["emb"]["timestep_embedder"]["linear_1"],
        "timestep_embedder.linear_2": tree["time_embed"]["emb"]["timestep_embedder"]["linear_2"],
        "time_linear": tree["time_embed"]["linear"],
        "caption_projection.linear_1": tree["caption_projection"]["linear_1"],
        "caption_projection.linear_2": tree["caption_projection"]["linear_2"],
        "proj_out": tree["proj_out"],
    }
    state = {"scale_shift_table": tree["scale_shift_table"]}
    for name, p in top.items():
        state[f"{name}.weight"] = np.asarray(p["weight"], np.float32).T
        if "bias" in p:
            state[f"{name}.bias"] = p["bias"]
    model = TF.empty_transformer(cfg, device, dtype)
    for blk in model.blocks:
        for group, name in TF.QUANTIZED_LINEARS:
            quant = _empty_quantized(tree["blocks"][group][name], device, dtype)
            if quant is not None:
                setattr(getattr(blk, group), name, quant)
    for key, arr in _flatten(tree["blocks"]):
        arr = np.asarray(arr)
        if ".norm_q." in key or ".norm_k." in key:
            key = key[: -len(".weight")]
        head, dot, leaf = key.rpartition(".")
        key = head + dot + _DIT_LEAVES.get(leaf, leaf)
        linear = leaf in ("weight", "weight_q")  # [K, N] -> [N, K]
        for i in range(cfg.num_layers):
            state[f"blocks.{i}.{key}"] = arr[i].T if linear else arr[i]
    return _load(model, state, device)


@torch.no_grad()
def vae_decoder_from_jax(tree, cfg: LtxVaeConfig, device="cuda", dtype=None):
    """JAX VAE tree (``decoder`` plus ``latents_mean``/``latents_std``) ->
    LtxVaeDecoder.  A resnet's ``per_channel_scale1/2`` go into the scales
    ``cfg.decoder_inject_noise`` makes; scales without a place raise."""
    device = loader_device(device)
    dec = tree["decoder"]
    dtype = dtype or _dtype_of(dec["conv_in"]["weight"])
    state = {"latents_mean": tree["latents_mean"], "latents_std": tree["latents_std"]}
    for key, arr in _flatten(dec):
        key = key.replace("upsamplers.0.", "upsampler.")
        arr = np.asarray(arr, np.float32)
        if ".linear_" in key and key.endswith(".weight"):
            arr = arr.T
        state[key] = arr
    return _load(V.empty_decoder(cfg, device, dtype), state, device)


@torch.no_grad()
def vae_encoder_from_jax(tree, cfg: LtxVaeConfig, device="cuda", dtype=None):
    """JAX VAE tree (its ``encoder``; a ``norm_out`` there gives the module
    one) -> LtxVaeEncoder."""
    device = loader_device(device)
    enc = tree["encoder"]
    dtype = dtype or _dtype_of(enc["conv_in"]["weight"])
    state = {}
    for key, arr in _flatten(enc):
        key = key.replace("downsamplers.0.", "downsampler.")
        state["norm_out" if key == "norm_out.weight" else key] = np.asarray(arr, np.float32)
    model = V.empty_encoder(cfg, device, dtype, norm_out="norm_out" in enc)
    return _load(model, state, device)


def _linear(p, device, dtype):
    if "w_q" in p:
        b = p.get("b")
        return Int8Linear(_tensor(p["w_q"], device), _t(p["s"], device),
                          None if b is None else _t(b, device))
    if "w4" in p:
        return Int4Linear(_tensor(p["w4"], device), _tensor(p["w4_scale"], device),
                          _tensor(p["w4_min"], device))
    return T5.dense_linear(_t(p["weight"], device, dtype))


@torch.no_grad()
def t5_from_jax(tree, cfg: T5Config, device="cuda", dtype=None):
    """JAX T5 tree, per-layer list or stacked (``rel_bias``), dense
    ``{weight}``, int8 ``{w_q, s[, b]}`` or Q4_K-form ``{w4, w4_scale,
    w4_min}`` linears -> T5Encoder."""
    device = loader_device(device)
    dtype = dtype or _dtype_of(tree["embedding"])
    blocks = tree["blocks"]
    if isinstance(blocks, (list, tuple)):
        per_layer = list(blocks)
        rel = blocks[0]["attn"]["relative_attention_bias"]
    else:
        per_layer = [_index(blocks, i) for i in range(cfg.num_layers)]
        rel = tree["rel_bias"]
    mods = []
    for blk in per_layer:
        lins = {n: _linear(blk["attn"][n], device, dtype) for n in ("q", "k", "v", "o")}
        lins.update({n: _linear(blk["ffn"][n], device, dtype)
                     for n in ("wi_0", "wi_1", "wo")})
        mods.append(T5.T5Block(cfg, lins, _t(blk["attn_norm"]["weight"], device, dtype),
                               _t(blk["ffn_norm"]["weight"], device, dtype)))
    return T5.T5Encoder(cfg, _t(tree["embedding"], device, dtype), mods,
                        _t(rel, device), _t(tree["final_norm"]["weight"], device, dtype)).eval()


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
