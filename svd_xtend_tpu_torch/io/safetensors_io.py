"""The safetensors file format, read and written without the safetensors
package (the GPU machine may lack it).

A file is: an 8-byte little-endian header length N; N bytes of JSON, padded
with spaces to a multiple of 8, mapping each tensor's name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the data
that follows the header) and ``"__metadata__"`` to a str -> str dict; then
the tensors' raw little-endian bytes. Writing orders the tensors as the
package does (by dtype, in ``DTYPES``' order, then by name), so every
tensor starts aligned to its element size and the bytes equal the
package's.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

# in the order in which the package lays the tensors out
DTYPES = {"I64": torch.int64, "F64": torch.float64, "F32": torch.float32,
          "I32": torch.int32, "BF16": torch.bfloat16, "F16": torch.float16,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
_RANK = {v: i for i, v in enumerate(DTYPES.values())}
_MAX_HEADER = 100 * 2**20


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> str:
    """Write `tensors` (any device; copied to the host) to `path`."""
    bad = [k for k, t in tensors.items() if t.dtype not in _NAMES]
    if bad:
        raise ValueError(f"dtypes without a safetensors name: {bad[:5]}")
    order = sorted(tensors, key=lambda k: (_RANK[tensors[k].dtype], k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(t.view(torch.uint8).numpy())
    return path


def _header(f) -> Tuple[dict, int]:
    """(header dict, the data's start) of an open file; raises ValueError on
    a malformed header."""
    head = f.read(8)
    if len(head) != 8:
        raise ValueError("not a safetensors file: shorter than 8 bytes")
    (n,) = struct.unpack("<Q", head)
    if n > _MAX_HEADER:
        raise ValueError(f"safetensors header of {n} bytes")
    raw = f.read(n)
    if len(raw) != n:
        raise ValueError("safetensors header runs past the end of the file")
    header = json.loads(raw)
    if not isinstance(header, dict):
        raise ValueError("safetensors header is not a JSON object")
    return header, 8 + n


def load_metadata(path: str) -> Dict[str, str]:
    """The file's ``__metadata__`` ({} without one)."""
    with open(path, "rb") as f:
        return dict(_header(f)[0].get("__metadata__") or {})


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the host, in the file's dtypes."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        header, start = _header(f)
        data_len = os.fstat(f.fileno()).st_size - start
        for name, entry in header.items():
            if name == "__metadata__":
                continue
            dtype = DTYPES.get(entry.get("dtype"))
            if dtype is None:
                raise ValueError(f"{name}: unsupported dtype {entry.get('dtype')!r}")
            shape = tuple(int(d) for d in entry["shape"])
            begin, end = (int(o) for o in entry["data_offsets"])
            size = math.prod(shape) * dtype.itemsize
            if end - begin != size or begin < 0 or end > data_len:
                raise ValueError(f"{name}: data_offsets {entry['data_offsets']} do not hold "
                                 f"{entry['dtype']} {list(shape)} in {data_len} data bytes")
            buf = torch.empty(size, dtype=torch.uint8)
            f.seek(start + begin)
            if f.readinto(buf.numpy()) != size:
                raise ValueError(f"{name}: file ends inside its data")
            out[name] = buf.view(dtype).reshape(shape)
    return out
