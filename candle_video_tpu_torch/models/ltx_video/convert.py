"""Carry the JAX package's parameter trees into the port's modules.

The trees arrive as nested dicts/lists of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), with the split-rope permutation off.
JAX linear weights are ``[in, out]``; they are transposed into
``nn.Linear``'s ``[out, in]``.  Conv weights are already in torch's
``[O, I, kt, kh, kw]`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

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


@torch.no_grad()
def transformer_from_jax(tree, cfg: LtxTransformerConfig, device="cpu", dtype=None):
    """JAX DiT tree (stacked ``blocks`` [L, ...]) -> LtxTransformer3D."""
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
    for key, arr in _flatten(tree["blocks"]):
        arr = np.asarray(arr, np.float32)
        if ".norm_q." in key or ".norm_k." in key:
            key = key[: -len(".weight")]
        linear = key.endswith(".weight")
        for i in range(cfg.num_layers):
            state[f"blocks.{i}.{key}"] = arr[i].T if linear else arr[i]
    return _load(TF.empty_transformer(cfg, device, dtype), state, device)


@torch.no_grad()
def vae_decoder_from_jax(tree, cfg: LtxVaeConfig, device="cpu", dtype=None):
    """JAX VAE tree (``decoder`` plus ``latents_mean``/``latents_std``) ->
    LtxVaeDecoder."""
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


def _linear(p, device, dtype):
    if "w_q" in p:
        b = p.get("b")
        return T5.Int8Linear(
            torch.from_numpy(np.array(p["w_q"], np.int8, order="C")).to(device),
            _t(p["s"], device), None if b is None else _t(b, device))
    return T5.dense_linear(_t(p["weight"], device, dtype))


@torch.no_grad()
def t5_from_jax(tree, cfg: T5Config, device="cpu", dtype=None):
    """JAX T5 tree, per-layer list or stacked (``rel_bias``), dense
    ``{weight}`` or int8 ``{w_q, s[, b]}`` linears -> T5Encoder."""
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
