"""A reader of the safetensors format, in the standard library and torch.

The JAX package reads published ``.safetensors`` checkpoints with the
``safetensors`` package (``rapiddoc_tpu/tools/convert_weights.py:24-36``),
which the port does not depend on. The format: an 8-byte little-endian
header length, a UTF-8 JSON header (each tensor's ``dtype``, ``shape``
and ``data_offsets`` into the byte buffer that follows, and an optional
``__metadata__`` map of strings), then the raw little-endian bytes.

``load_file`` returns what ``safetensors.torch.load_file`` returns, and
refuses what it refuses, with ``ValueError``: a header too short, too
long or not a JSON object, a tensor entry of the wrong form or of an
unknown dtype, a byte count that does not match the shape, and offsets
that leave a gap, overlap, or run past the file (the tensors sorted by
offset must tile the buffer exactly, as the package checks).
"""
from __future__ import annotations

import json
import struct
from pathlib import Path

import torch

# the package caps the header at 100 MB
MAX_HEADER_SIZE = 100_000_000

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "U16": torch.uint16, "U32": torch.uint32, "U64": torch.uint64,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def _header(data: bytes | bytearray) -> tuple[dict, int]:
    """(JSON header, offset of the byte buffer)."""
    if len(data) < 8:
        raise ValueError("safetensors: file shorter than its 8-byte header length")
    (n,) = struct.unpack("<Q", data[:8])
    if n > MAX_HEADER_SIZE:
        raise ValueError(f"safetensors: header of {n} bytes is too large")
    if 8 + n > len(data):
        raise ValueError(f"safetensors: header of {n} bytes runs past the file")
    try:
        text = data[8:8 + n].decode("utf-8")
    except UnicodeDecodeError as exc:
        raise ValueError(f"safetensors: header is not UTF-8 ({exc})") from None
    try:
        header = json.loads(text)
    except json.JSONDecodeError as exc:
        raise ValueError(f"safetensors: header is not JSON ({exc})") from None
    if not isinstance(header, dict):
        raise ValueError("safetensors: header is not a JSON object")
    return header, 8 + n


def _entries(header: dict, size: int) -> list[tuple[str, torch.dtype, list[int], int, int]]:
    """Every tensor's (name, dtype, shape, begin, end), checked against
    a buffer of ``size`` bytes."""
    entries = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if not isinstance(info, dict) or not {"dtype", "shape", "data_offsets"} <= set(info):
            raise ValueError(f"safetensors: tensor {name!r} has a malformed entry")
        dtype, shape, offsets = info["dtype"], info["shape"], info["data_offsets"]
        if dtype not in DTYPES:
            raise ValueError(f"safetensors: tensor {name!r} has unsupported dtype {dtype!r}")
        if not (isinstance(shape, list) and all(
                type(d) is int and d >= 0 for d in shape)):
            raise ValueError(f"safetensors: tensor {name!r} has a malformed shape")
        if not (isinstance(offsets, list) and len(offsets) == 2 and all(
                type(o) is int and o >= 0 for o in offsets)):
            raise ValueError(f"safetensors: tensor {name!r} has malformed data_offsets")
        entries.append((name, DTYPES[dtype], shape, offsets[0], offsets[1]))
    end = 0
    for name, dtype, shape, begin, stop in sorted(entries, key=lambda e: (e[3], e[4])):
        if begin != end or stop < begin:
            raise ValueError(f"safetensors: tensor {name!r} offsets [{begin}, {stop}] "
                             f"leave a gap or overlap at byte {end}")
        count = 1
        for d in shape:
            count *= d
        if count * dtype.itemsize != stop - begin:
            raise ValueError(f"safetensors: tensor {name!r} holds {stop - begin} bytes, "
                             f"its shape {shape} needs {count * dtype.itemsize}")
        end = stop
    if end != size:
        raise ValueError(f"safetensors: the tensors cover {end} bytes of a "
                         f"{size}-byte buffer")
    return entries


def _metadata(header: dict) -> dict[str, str] | None:
    meta = header.get("__metadata__")
    if meta is not None and not (isinstance(meta, dict) and all(
            isinstance(v, str) for v in meta.values())):
        raise ValueError("safetensors: __metadata__ is not a map of strings")
    return meta


def metadata(path: str | Path) -> dict[str, str] | None:
    """The header's ``__metadata__`` (None where it has none)."""
    header, _ = _header(Path(path).read_bytes())
    return _metadata(header)


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """name -> CPU tensor, as ``safetensors.torch.load_file``."""
    data = bytearray(Path(path).read_bytes())
    header, start = _header(data)
    _metadata(header)
    out = {}
    for name, dtype, shape, begin, stop in _entries(header, len(data) - start):
        count = (stop - begin) // dtype.itemsize
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=start + begin)
        out[name] = flat.reshape(shape).clone()
    return out
