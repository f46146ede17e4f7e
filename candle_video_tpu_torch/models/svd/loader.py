"""SVD checkpoint loading (``candle_video_tpu/models/svd/loader.py``): a
diffusers-layout state dict into the port's modules.

The modules carry the diffusers names and torch's ``[out, in]`` linear
layout, so a state dict loads as it is, cast to the module's dtype; the
structure comes from the config.  ``models/ltx_video/loader.py`` reads the
safetensors files.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ...utils.device import loader_device
from .configs import SvdUnetConfig
from .unet import empty_unet


def count_keys(sd, fmt: str) -> int:
    """How many of ``fmt.format(0)``, ``fmt.format(1)``, ... are in ``sd``."""
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


@torch.no_grad()
def load_into(module: nn.Module, sd) -> nn.Module:
    """Copy the state dict ``sd`` (tensors or numpy arrays) into ``module``,
    cast to the module's dtypes; every key must match."""
    own = module.state_dict()
    missing, extra = set(own) - set(sd), set(sd) - set(own)
    if missing or extra:
        raise KeyError(f"state dict/module mismatch: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    for name, value in sd.items():
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        own[name].copy_(value.reshape(own[name].shape))
    return module.eval()


def unet_params_from_state_dict(sd: Dict[str, torch.Tensor], cfg: SvdUnetConfig | None = None,
                                device="cuda", dtype=torch.float32):
    """A diffusers UNetSpatioTemporalConditionModel state dict -> the UNet
    of ``cfg`` on ``device`` (the GPU unless told otherwise) in ``dtype``."""
    return load_into(empty_unet(cfg or SvdUnetConfig(), loader_device(device), dtype), sd)
