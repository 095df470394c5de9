"""Minimal ONNX protobuf writer.

Copy of ``rapiddoc_tpu/tools/onnx_writer.py``: the inverse of
onnx_reader, building .onnx bytes from a node list + initializers, so
graphs for the ONNX interpreter (engine/onnx_torch.py) can be made in
code without the onnx package. For the same graph its bytes equal the
JAX package's writer's. Field numbers per onnx.proto3 (see onnx_reader).
"""
from __future__ import annotations

import struct

import numpy as np

_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11, np.dtype(np.uint32): 12,
    np.dtype(np.uint64): 13,
}


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _varint_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    out = bytearray()
    for d in arr.shape:
        out += _varint_field(1, d)
    out += _varint_field(2, _NP_TO_ONNX[arr.dtype])
    out += _len_field(8, name.encode())
    out += _len_field(9, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


class SubGraph:
    """Marks an attribute value as a GraphProto (for If/Loop/Scan).

    `inputs` maps name -> shape for the subgraph's formal inputs (Loop
    body: iter_num, cond, carried...); If branches take no inputs."""

    def __init__(self, nodes, inputs=None, outputs=None, initializers=None,
                 input_dtypes=None):
        self.nodes = nodes
        self.inputs = inputs or {}
        self.outputs = outputs or {}
        self.initializers = initializers or {}
        self.input_dtypes = input_dtypes or {}

    def encode(self) -> bytes:
        graph = bytearray()
        for n in self.nodes:
            graph += _len_field(1, n)
        for k, v in self.initializers.items():
            graph += _len_field(5, encode_tensor(k, np.asarray(v)))
        graph += _len_field(2, b"sub")
        for name, shape in self.inputs.items():
            et = self.input_dtypes.get(name, 1)
            graph += _len_field(11, _value_info(name, shape, et))
        for name, shape in self.outputs.items():
            graph += _len_field(12, _value_info(name, shape))
        return bytes(graph)


def _encode_attribute(name: str, value) -> bytes:
    out = bytearray(_len_field(1, name.encode()))
    if isinstance(value, SubGraph):
        out += _len_field(6, value.encode()) + _varint_field(20, 5)  # GRAPH
        return bytes(out)
    if isinstance(value, bool):
        out += _varint_field(3, int(value)) + _varint_field(20, 2)  # INT
    elif isinstance(value, int):
        out += _varint_field(3, value) + _varint_field(20, 2)
    elif isinstance(value, float):
        out += _float_field(2, value) + _varint_field(20, 1)  # FLOAT
    elif isinstance(value, str):
        out += _len_field(4, value.encode()) + _varint_field(20, 3)  # STRING
    elif isinstance(value, np.ndarray):
        out += _len_field(5, encode_tensor("", value))
        out += _varint_field(20, 4)  # TENSOR
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            for v in value:
                out += _varint_field(8, int(v))
            out += _varint_field(20, 7)  # INTS
        elif all(isinstance(v, (float, np.floating)) for v in value):
            for v in value:
                out += _float_field(7, float(v))
            out += _varint_field(20, 6)  # FLOATS
        else:
            for v in value:
                out += _len_field(9, str(v).encode())
            out += _varint_field(20, 8)  # STRINGS
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return bytes(out)


def encode_node(op_type: str, inputs, outputs, attrs=None, name="") -> bytes:
    out = bytearray()
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    if name:
        out += _len_field(3, name.encode())
    out += _len_field(4, op_type.encode())
    for k, v in (attrs or {}).items():
        out += _len_field(5, _encode_attribute(k, v))
    return bytes(out)


def _value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = bytearray()
    for d in shape:
        dims += _len_field(1, _varint_field(1, d))
    tensor_type = _varint_field(1, elem_type) + _len_field(2, bytes(dims))
    type_proto = _len_field(1, tensor_type)
    return _len_field(1, name.encode()) + _len_field(2, type_proto)


def build_model(
    nodes: list[bytes],
    inputs: dict[str, tuple],
    outputs: dict[str, tuple],
    initializers: dict[str, np.ndarray] | None = None,
    opset: int = 17,
    input_dtypes: dict[str, int] | None = None,
) -> bytes:
    """-> serialized ModelProto bytes."""
    graph = bytearray()
    for n in nodes:
        graph += _len_field(1, n)
    for k, v in (initializers or {}).items():
        graph += _len_field(5, encode_tensor(k, np.asarray(v)))
    graph += _len_field(2, b"g")
    for name, shape in inputs.items():
        et = (input_dtypes or {}).get(name, 1)
        graph += _len_field(11, _value_info(name, shape, et))
    for name, shape in outputs.items():
        graph += _len_field(12, _value_info(name, shape))
    model = bytearray()
    model += _varint_field(1, 8)  # ir_version
    opset_proto = _len_field(1, b"") + _varint_field(2, opset)
    model += _len_field(8, opset_proto)
    model += _len_field(7, bytes(graph))
    return bytes(model)


def build_model_with_metadata(model_bytes: bytes, metadata: dict) -> bytes:
    """Append ModelProto.metadata_props (field 14) entries."""
    out = bytearray(model_bytes)
    for k, v in metadata.items():
        entry = _len_field(1, k.encode()) + _len_field(2, v.encode())
        out += _len_field(14, entry)
    return bytes(out)
