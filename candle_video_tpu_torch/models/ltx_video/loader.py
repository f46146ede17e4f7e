"""Safetensors checkpoint reading (``candle_video_tpu/models/ltx_video/loader.py``:
``load_safetensors``, ``load_sharded``).

The format is read here directly, with no ``safetensors`` package: an 8-byte
little-endian header length, a JSON header mapping each name to its dtype,
shape and byte range, then the raw little-endian bytes.  A file is read
into one buffer and each tensor is a ``torch.frombuffer`` view of it (bf16
included).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


class LoaderError(Exception):
    pass


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors over one
    buffer holding the file's data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise LoaderError(f"{path}: {name} has dtype {info['dtype']}, not supported")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        flat = (torch.frombuffer(buf, dtype=dtype, count=count, offset=start)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def load_sharded(directory: str, index_name: str = "model.safetensors.index.json"):
    """A checkpoint directory: the shards an ``index.json`` names, else
    ``model.safetensors``, else every ``*.safetensors`` file in it."""
    index_path = os.path.join(directory, index_name)
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        out: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(load_safetensors(os.path.join(directory, shard)))
        return out
    single = os.path.join(directory, "model.safetensors")
    if os.path.exists(single):
        return load_safetensors(single)
    cands = sorted(p for p in os.listdir(directory) if p.endswith(".safetensors"))
    if not cands:
        raise LoaderError(f"no safetensors found in {directory}")
    out = {}
    for c in cands:
        out.update(load_safetensors(os.path.join(directory, c)))
    return out
