"""Carry the JAX package's SVD parameter trees (UNet, VAE, CLIP, as nested
dicts and lists of numpy arrays, for example ``jax.tree.map(np.asarray,
params)``) into the port's modules.

The JAX trees follow the diffusers / HF names with a few renames
(``to_out`` for ``to_out.0``, ``ff.proj`` / ``ff.proj_out`` for
``ff.net.0.proj`` / ``ff.net.2``, CLIP without its ``vision_model.encoder``
prefixes).  Their linear weights are ``[in, out]`` and are transposed into
``nn.Linear``'s ``[out, in]``; conv weights are already torch's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.device import loader_device
from ..ltx_video.convert import _flatten
from .configs import ClipEncoderConfig, SvdUnetConfig, SvdVaeConfig
from .clip import empty_clip
from .loader import count_keys, load_into
from .unet import empty_unet
from .vae import empty_vae

_RENAMES = ((".to_out.", ".to_out.0."), (".ff.proj.", ".ff.net.0.proj."),
            (".ff.proj_out.", ".ff.net.2."), (".ff_in.proj.", ".ff_in.net.0.proj."),
            (".ff_in.proj_out.", ".ff_in.net.2."))


def _is_linear(path: str, arr) -> bool:
    return path.endswith(".weight") and np.ndim(arr) == 2 and \
        not path.endswith("position_embedding.weight")


def state_dict_from_jax(tree, prefix_of=lambda path: path):
    """The JAX tree as a diffusers-named state dict of f32 numpy arrays,
    linear weights transposed; ``prefix_of`` maps each renamed path."""
    state = {}
    for path, arr in _flatten(tree):
        name = "." + path + "."
        for old, new in _RENAMES:
            name = name.replace(old, new)
        name = prefix_of(name[1:-1])
        arr = np.asarray(arr, np.float32)
        state[name] = np.ascontiguousarray(arr.T) if _is_linear(name, arr) else arr
    return state


def _dtype_of(tree_leaf, dtype):
    if dtype is not None:
        return dtype
    return torch.bfloat16 if np.asarray(tree_leaf).dtype.name == "bfloat16" else torch.float32


@torch.no_grad()
def unet_from_jax(tree, cfg: SvdUnetConfig, device="cuda", dtype=None):
    """JAX SVD UNet tree -> UNetSpatioTemporalConditionModel."""
    device = loader_device(device)
    dtype = _dtype_of(tree["conv_in"]["weight"], dtype)
    return load_into(empty_unet(cfg, device, dtype), state_dict_from_jax(tree))


@torch.no_grad()
def vae_from_jax(tree, cfg: SvdVaeConfig, device="cuda", dtype=None):
    """JAX SVD VAE tree (``encoder``, ``decoder``, ``quant_conv``) ->
    AutoencoderKLTemporalDecoder."""
    device = loader_device(device)
    dtype = _dtype_of(tree["quant_conv"]["weight"], dtype)
    state = state_dict_from_jax(tree)
    n_mid = count_keys(state, "decoder.mid_block.resnets.{}.spatial_res_block.conv1.weight")
    return load_into(empty_vae(cfg, device, dtype, n_mid), state)


def _clip_name(path: str) -> str:
    if path.startswith("visual_projection."):
        return path
    if path.startswith("layers."):
        path = "encoder." + path
    return "vision_model." + path


@torch.no_grad()
def clip_from_jax(tree, cfg: ClipEncoderConfig, device="cuda", dtype=None):
    """JAX CLIP tree -> ClipVisionModelWithProjection."""
    device = loader_device(device)
    dtype = _dtype_of(tree["visual_projection"]["weight"], dtype)
    return load_into(empty_clip(cfg, device, dtype), state_dict_from_jax(tree, _clip_name))
