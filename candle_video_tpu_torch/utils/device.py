"""The device a public loader puts a model on."""

from __future__ import annotations

import torch


def loader_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  The loaders default to ``"cuda"``,
    as the CLIs' ``--device`` does; without a GPU that default raises
    instead of loading the model to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the loaders put the model on the GPU by "
                           "default; pass device=\"cpu\" to load it to the CPU on purpose")
    return device
