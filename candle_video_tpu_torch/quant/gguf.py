"""GGUF container reader (v2/v3) with mmap'd tensor access — the port's own
copy of ``candle_video_tpu/quant/gguf.py``.

Tensors dequantize through the numpy block decoders of ``dequant_np``
(the JAX package's native-library dispatch is not carried).  A minimal
writer is included for the tests to round-trip files.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, List

import numpy as np

from . import dequant_np as DQ

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

_SIMPLE_TYPES = {
    0: ("B", 1),  # uint8
    1: ("b", 1),  # int8
    2: ("H", 2),  # uint16
    3: ("h", 2),  # int16
    4: ("I", 4),  # uint32
    5: ("i", 4),  # int32
    6: ("f", 4),  # float32
    7: ("?", 1),  # bool
    10: ("Q", 8),  # uint64
    11: ("q", 8),  # int64
    12: ("d", 8),  # float64
}
_STRING = 8
_ARRAY = 9


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple  # logical shape, row-major (numpy order)
    ggml_type: int
    offset: int  # relative to data section start

    @property
    def n_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


class GGUFFile:
    """Parsed GGUF file: metadata dict + tensor table + mmap'd data."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, GGUFTensorInfo] = {}
        self._parse()

    # -- parsing ------------------------------------------------------------

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from("<" + fmt, self._mm, self._pos)
        self._pos += size
        return vals if len(vals) > 1 else vals[0]

    def _read_string(self) -> str:
        n = self._read("Q")
        s = self._mm[self._pos : self._pos + n].decode("utf-8")
        self._pos += n
        return s

    def _read_value(self, vtype: int):
        if vtype in _SIMPLE_TYPES:
            return self._read(_SIMPLE_TYPES[vtype][0])
        if vtype == _STRING:
            return self._read_string()
        if vtype == _ARRAY:
            etype = self._read("I")
            n = self._read("Q")
            return [self._read_value(etype) for _ in range(n)]
        raise ValueError(f"unknown GGUF value type {vtype}")

    def _parse(self):
        self._pos = 0
        magic = self._read("I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        version = self._read("I")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = self._read("Q")
        n_kv = self._read("Q")

        for _ in range(n_kv):
            key = self._read_string()
            vtype = self._read("I")
            self.metadata[key] = self._read_value(vtype)

        infos: List[GGUFTensorInfo] = []
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read("I")
            dims = [self._read("Q") for _ in range(n_dims)]
            ggml_type = self._read("I")
            offset = self._read("Q")
            # GGUF dims are innermost-first; numpy shape is the reverse
            shape = tuple(reversed(dims))
            infos.append(GGUFTensorInfo(name, shape, ggml_type, offset))

        alignment = int(self.metadata.get("general.alignment", 32))
        self._data_start = (self._pos + alignment - 1) // alignment * alignment
        for info in infos:
            self.tensors[info.name] = info

    # -- access ---------------------------------------------------------------

    def tensor_names(self):
        return list(self.tensors.keys())

    def raw_tensor(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        block_n, block_bytes = DQ.BLOCK_SIZES[info.ggml_type]
        nbytes = info.n_elements // block_n * block_bytes
        start = self._data_start + info.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=nbytes, offset=start)

    def tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Dequantize to a dense array of ``info.shape``."""
        info = self.tensors[name]
        out = DQ.dequantize_np(info.ggml_type, self.raw_tensor(name), info.n_elements)
        return out.reshape(info.shape).astype(dtype, copy=False)

    def close(self):
        self._mm.close()
        self._f.close()


# ---------------------------------------------------------------------------
# minimal writer (tests)
# ---------------------------------------------------------------------------


def write_gguf(path: str, tensors: Dict[str, tuple], metadata: Dict[str, Any] | None = None):
    """tensors: name -> (ggml_type, shape, raw_bytes np.uint8 array)."""
    metadata = dict(metadata or {})
    metadata.setdefault("general.alignment", 32)
    align = int(metadata["general.alignment"])

    def pstr(f: BinaryIO, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(tensors), len(metadata)))
        for k, v in metadata.items():
            pstr(f, k)
            if isinstance(v, str):
                f.write(struct.pack("<I", _STRING))
                pstr(f, v)
            elif isinstance(v, bool):
                f.write(struct.pack("<I?", 7, v))
            elif isinstance(v, int):
                f.write(struct.pack("<Iq", 11, v))
            elif isinstance(v, float):
                f.write(struct.pack("<Id", 12, v))
            else:
                raise ValueError(f"unsupported metadata type for {k}")

        offset = 0
        layouts = []
        for name, (ggml_type, shape, raw) in tensors.items():
            pstr(f, name)
            dims = list(reversed(shape))
            f.write(struct.pack("<I", len(dims)))
            for d in dims:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<IQ", ggml_type, offset))
            layouts.append((offset, raw))
            offset += (len(raw) + align - 1) // align * align

        pos = f.tell()
        pad = (pos + align - 1) // align * align - pos
        f.write(b"\x00" * pad)
        data_start = f.tell()
        for off, raw in layouts:
            f.seek(data_start + off)
            f.write(np.ascontiguousarray(raw).tobytes())
