"""Weight I/O (``candle_video_tpu/models/ltx_video/loader.py``): safetensors
files, and diffusers-layout state dicts into the port's modules.

The format is read and written here directly, with no ``safetensors``
package: an 8-byte little-endian header length, a JSON header mapping each
name to its dtype, shape and byte range, then the raw little-endian bytes.
``load_safetensors`` maps the file copy-on-write (``mmap.ACCESS_COPY``: the
views are writable, so ``torch.frombuffer`` has no read-only buffer to warn
about, and a write never reaches the file) and returns a mapping whose
tensors are ``torch.frombuffer`` views made when they are asked for (bf16
included).  Each view holds a reference to the mapping, which is never
closed here: it is unmapped once the last view is gone.  So a loader that
reads one tensor at a time never holds the whole file in private memory.

The port renamed some diffusers modules (``blocks`` for
``transformer_blocks``, ``to_out`` for ``to_out.0``, ``ff.net_0_proj`` for
``ff.net.0.proj``, ...).  ``dit_checkpoint_name`` and
``vae_checkpoint_name`` map each of the port's parameter names to the
checkpoint's; the loaders read through them, and
``transformer_state_dict`` / ``vae_decoder_state_dict`` write through them.
"""

from __future__ import annotations

import itertools
import json
import mmap
import os
import struct
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch
from torch import nn

from ...ops.kernels.int4_weight_matmul import quantize_int4_blockwise
from ...ops.kernels.int8_weight_matmul import quantize_int8_blockwise
from ...ops.quant_linear import Int4Linear, Int8Linear
from ...utils.device import loader_device
from . import transformer as TF
from . import vae as V
from .configs import LtxTransformerConfig, LtxVaeConfig

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


class LoaderError(Exception):
    pass


# ---------------------------------------------------------------------------
# safetensors files
# ---------------------------------------------------------------------------


def _read_header(path: str):
    """(header without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsFile(Mapping):
    """The tensors of one ``.safetensors`` file as a read-on-demand mapping:
    each item is a CPU tensor viewing the file's copy-on-write mapping."""

    def __init__(self, path: str):
        self.path = path
        self.header, self._base = _read_header(path)
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""

    def __getitem__(self, name: str) -> torch.Tensor:
        info = self.header[name]
        if info["dtype"] not in _DTYPES:
            raise LoaderError(f"{self.path}: {name} has dtype {info['dtype']}, not supported")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        if not count:
            return torch.empty(info["shape"], dtype=dtype)
        flat = torch.frombuffer(self._map, dtype=dtype, count=count, offset=self._base + start)
        return flat.reshape(info["shape"])

    def __iter__(self):
        return iter(self.header)

    def __len__(self) -> int:
        return len(self.header)


def load_safetensors(path: str) -> SafetensorsFile:
    """Every tensor of a ``.safetensors`` file, each a CPU tensor viewing the
    file's mapping, made when it is asked for."""
    return SafetensorsFile(path)


def list_tensor_names(path: str) -> list[str]:
    """The tensor names of a file, from its header alone."""
    return sorted(_read_header(path)[0])


def get_tensor_info(path: str) -> Dict[str, tuple]:
    """name -> (shape, dtype string) from the header alone."""
    header = _read_header(path)[0]
    return {name: (tuple(info["shape"]), info["dtype"]) for name, info in sorted(header.items())}


def load_model_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str, metadata=None) -> None:
    """Write ``tensors`` (any device; written in name order, back to back)
    as a ``.safetensors`` file: the JSON header padded with spaces to a
    multiple of 8 bytes, then each tensor's little-endian bytes.
    ``metadata`` is a dict of strings, stored as ``__metadata__``."""
    header, offset = {}, 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise LoaderError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = dict(dtype=_NAMES[t.dtype], shape=list(t.shape),
                            data_offsets=[offset, offset + nbytes])
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


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


# ---------------------------------------------------------------------------
# the port's names -> the diffusers checkpoint's
# ---------------------------------------------------------------------------

# (where, the port's piece, the checkpoint's piece), applied in order
_DIT_RENAMES = (
    ("prefix", "blocks.", "transformer_blocks."),
    ("prefix", "timestep_embedder.", "time_embed.emb.timestep_embedder."),
    ("prefix", "time_linear.", "time_embed.linear."),
    ("infix", ".to_out.", ".to_out.0."),
    ("infix", ".ff.net_0_proj.", ".ff.net.0.proj."),
    ("infix", ".ff.net_2.", ".ff.net.2."),
    ("suffix", ".norm_q", ".norm_q.weight"),
    ("suffix", ".norm_k", ".norm_k.weight"),
)
# inside the decoder; every conv's parameters sit one level down, in ``conv``
_VAE_RENAMES = (
    ("infix", ".upsampler.", ".upsamplers.0."),
    ("infix", "time_embedder.", "time_embedder.timestep_embedder."),
) + tuple(("suffix", f"{conv}.{leaf}", f"{conv}.conv.{leaf}")
          for conv in ("conv_in", "conv_out", ".conv1", ".conv2", ".conv")
          for leaf in ("weight", "bias"))
_VAE_TOP = ("latents_mean", "latents_std")  # outside the decoder in the file


def _rename(name: str, renames) -> str:
    for where, ours, theirs in renames:
        if where == "prefix" and name.startswith(ours):
            name = theirs + name[len(ours):]
        elif where == "infix":
            name = name.replace(ours, theirs)
        elif where == "suffix" and name.endswith(ours):
            name = name[: -len(ours)] + theirs
            break
    return name


def dit_checkpoint_name(name: str) -> str:
    """The diffusers name of the ``LtxTransformer3D`` parameter ``name``."""
    return _rename(name, _DIT_RENAMES)


def vae_checkpoint_name(name: str) -> str:
    """The diffusers name of the ``LtxVaeDecoder`` parameter or buffer
    ``name`` (``decoder.*``, the latent statistics at the top level)."""
    return name if name in _VAE_TOP else "decoder." + _rename(name, _VAE_RENAMES)


def transformer_state_dict(model) -> Dict[str, torch.Tensor]:
    """A dense ``LtxTransformer3D``'s tensors under the checkpoint's names."""
    return {dit_checkpoint_name(k): v for k, v in model.state_dict().items()}


def vae_decoder_state_dict(model) -> Dict[str, torch.Tensor]:
    """An ``LtxVaeDecoder``'s tensors under the checkpoint's names."""
    return {vae_checkpoint_name(k): v for k, v in model.state_dict().items()}


def _take(sd, key):
    if key not in sd:
        raise LoaderError(f"missing tensor {key}")
    return sd[key]


def _fill(model, sd, checkpoint_name, skip=()):
    """Copy each of ``model``'s tensors (allocated on its device) from
    ``sd[checkpoint_name(name)]``, one tensor at a time."""
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        if name in skip or t is None:
            continue
        src = _take(sd, checkpoint_name(name))
        if tuple(src.shape) != tuple(t.shape):
            raise LoaderError(f"{checkpoint_name(name)}: shape {tuple(src.shape)}, the "
                              f"config's model wants {tuple(t.shape)}")
        t.copy_(src)


def _linears(model):
    """(name, has a bias) of each ``nn.Linear`` in ``model``."""
    return [(n, m.bias is not None) for n, m in model.named_modules()
            if isinstance(m, nn.Linear)]


def _check_biases(linears, sd):
    """A linear the config builds without a bias (``attention_bias`` /
    ``attention_out_bias``) must have none in the file either."""
    for name, has_bias in linears:
        bias = dit_checkpoint_name(f"{name}.bias")
        if not has_bias and bias in sd:
            raise LoaderError(f"{bias} is in the file, but the config builds "
                              f"{name} without a bias (attention_bias / attention_out_bias)")


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


@torch.no_grad()
def transformer_from_state_dict(sd, cfg: LtxTransformerConfig, device="cuda",
                                dtype=torch.bfloat16):
    """Diffusers-layout DiT state dict -> ``LtxTransformer3D`` on ``device``
    in ``dtype`` (JAX ``transformer_params_from_state_dict``).  Built on
    ``meta``, allocated on ``device`` and filled one tensor at a time;
    linears keep torch's ``[out, in]``."""
    device = loader_device(device)
    model = TF.empty_transformer(cfg, device, dtype)
    _check_biases(_linears(model), sd)
    _fill(model, sd, dit_checkpoint_name)
    return model.eval()


@torch.no_grad()
def _transformer_quant_from_state_dict(sd, cfg, device, dtype, quantize, make_linear):
    """The streaming loaders' shared body (JAX
    ``_transformer_params_quant_from_state_dict``): the dense part filled
    from the file on ``device``, then the block linears one layer at a time:
    each read off the file in its own precision as f32, quantized on the
    host by ``quantize(w [K, N] f32 numpy)`` (the layer's linears on a pool
    of threads: numpy releases the GIL), then built by ``make_linear(payload,
    bias f32 or None)`` and uploaded.  Neither the host nor the card ever
    holds the dense block tree."""
    device = loader_device(device)
    model, slots = TF.quantized_skeleton(cfg, device, dtype)
    _check_biases(_linears(model) + [(slot[2], slot[5]) for slot in slots], sd)
    _fill(model, sd, dit_checkpoint_name)

    def payload(slot):
        w = _take(sd, dit_checkpoint_name(f"{slot[2]}.weight")).float().numpy()
        return quantize(w.T)

    per_layer = len(TF.QUANTIZED_LINEARS)
    with ThreadPoolExecutor(max_workers=min(per_layer, os.cpu_count() or 1)) as pool:
        for i in range(0, len(slots), per_layer):
            layer = slots[i:i + per_layer]
            for (parent, attr, name, *_, has_bias), q in zip(layer, pool.map(payload, layer)):
                bias = _take(sd, dit_checkpoint_name(f"{name}.bias")).float() if has_bias \
                    else None
                setattr(parent, attr, make_linear(q, bias))
    return model.eval()


def transformer_w8_from_state_dict(sd, cfg: LtxTransformerConfig, device="cuda",
                                   dtype=torch.bfloat16, qblock: int = 128):
    """Diffusers-layout DiT state dict -> ``LtxTransformer3D`` with its block
    linears as weight-only int8 (W8A16, f32 scales per group of ``qblock``
    along K), quantized on the host layer by layer straight off the file
    (JAX ``transformer_params_w8_from_state_dict``).  At f32 the payloads
    equal ``quantize_transformer_w8``'s bit for bit; from a bf16 file they
    quantize the file's own values.  The bias is read as f32 and cast to
    ``dtype``."""
    def make(payload, bias):
        w_q, s = payload
        return Int8Linear(torch.from_numpy(w_q).to(dev), torch.from_numpy(s).to(dev),
                          bias=None if bias is None else bias.to(dev, dtype))

    dev = loader_device(device)
    return _transformer_quant_from_state_dict(
        sd, cfg, dev, dtype, lambda w: quantize_int8_blockwise(w, qblock), make)


def transformer_w4_from_state_dict(sd, cfg: LtxTransformerConfig, device="cuda",
                                   dtype=torch.bfloat16, qblock: int = 32,
                                   scale_dtype=torch.bfloat16):
    """As ``transformer_w8_from_state_dict``, the block linears as
    weight-only int4 (W4A16: packed nibbles, affine scale and min per group
    of ``qblock`` in ``scale_dtype``; JAX
    ``transformer_params_w4_from_state_dict``)."""
    def make(payload, bias):
        packed, s, m = payload
        return Int4Linear(packed.to(dev), s.to(dev), m.to(dev),
                          bias=None if bias is None else bias.to(dev, dtype),
                          compute_dtype=torch.bfloat16)

    dev = loader_device(device)
    return _transformer_quant_from_state_dict(
        sd, cfg, dev, dtype, lambda w: quantize_int4_blockwise(w, qblock, scale_dtype), make)


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def _count_resnets(sd, prefix: str) -> int:
    n = 0
    while f"{prefix}.resnets.{n}.conv1.conv.weight" in sd:
        n += 1
    return n


def _decoder_structure(sd) -> dict:
    """The decoder's block and resnet counts as the file's keys give them
    (the JAX loader's discovery)."""
    ups, i = [], 0
    while True:
        pre = f"decoder.up_blocks.{i}"
        has_ups = f"{pre}.upsamplers.0.conv.conv.weight" in sd
        if f"{pre}.resnets.0.conv1.conv.weight" not in sd and not has_ups:
            break
        ups.append((_count_resnets(sd, pre), has_ups))
        i += 1
    return dict(mid=_count_resnets(sd, "decoder.mid_block"), up_blocks=ups)


@torch.no_grad()
def vae_decoder_from_state_dict(sd, cfg: LtxVaeConfig, device="cuda", dtype=torch.bfloat16):
    """The decoder half of a diffusers-layout LTX VAE state dict (JAX
    ``vae_params_from_state_dict``) -> ``LtxVaeDecoder`` on ``device``:
    ``conv_in``, ``mid_block``, ``up_blocks`` (resnets, upsamplers, time
    embedders), ``conv_out``, ``time_embedder``, ``scale_shift_table``,
    ``timestep_scale_multiplier`` (f32) and ``latents_mean`` /
    ``latents_std`` (f32).  Encoder tensors are skipped.  A file without
    the multiplier or the statistics leaves them at 1, 0 and 1 (the JAX
    decoder then does not scale; the statistics are identity).
    ``per_channel_scale1/2`` (with or without ``.weight``) are read past:
    they scale the noise injection, which the port's decoder does not do,
    as JAX's does not without a noise key.  A decoder whose block or resnet
    counts differ from ``cfg``'s, or that holds other tensors, raises."""
    device = loader_device(device)
    model = V.empty_decoder(cfg, device, dtype)
    found = _decoder_structure(sd)
    want = dict(mid=len(model.mid_block.resnets),
                up_blocks=[(len(b.resnets), b.upsampler is not None) for b in model.up_blocks])
    if found != want:
        raise LoaderError(f"the file's decoder has {found}, the config's {want} "
                          "(mid-block resnets; (resnets, upsampler) per up block)")
    optional = {"timestep_scale_multiplier": 1.0, "latents_mean": 0.0, "latents_std": 1.0}
    absent = {n for n in optional if vae_checkpoint_name(n) not in sd}
    for name in absent:
        getattr(model, name).fill_(optional[name])
    _fill(model, sd, vae_checkpoint_name, skip=absent)
    read = {vae_checkpoint_name(k) for k in model.state_dict()}
    extra = sorted(k for k in sd if k.startswith("decoder.") and k not in read
                   and ".per_channel_scale" not in k)
    if extra:
        raise LoaderError(f"the file's decoder holds tensors the config's decoder has no "
                          f"place for: {extra[:5]}{' ...' if len(extra) > 5 else ''}")
    return model.eval()

