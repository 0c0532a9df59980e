"""The safetensors file format, read with numpy alone (the port's stand-in
for `nerf3dtalker_tpu/data/ingest.py:load_safetensors_prefix`, which needs
the `safetensors` package).

A file is an 8-byte little-endian header length n, then n bytes of JSON
`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`, then the tensors' raw little-endian bytes, each at its offsets
from the end of the header. BF16 has no numpy type: it is read as the high
half of an f32.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
           "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file, as numpy arrays (BF16 as f32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw, shape = data[begin:end], tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif info["dtype"] in _DTYPES:
            dt = np.dtype(_DTYPES[info["dtype"]])
            out[name] = np.frombuffer(raw, dt.newbyteorder("<")).reshape(shape).astype(dt)
        else:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
    return out


def load_safetensors_prefix(path: str, prefix: str) -> Dict[str, np.ndarray]:
    """The tensors whose name starts with `prefix.`, the prefix stripped
    (SadTalker's safetensor_helper.load_x_from_safetensor)."""
    return {k[len(prefix) + 1:]: v for k, v in read_safetensors(path).items()
            if k.startswith(prefix + ".")}
