"""Minimal ONNX reader (the onnx package is not needed).

Copy of ``rapiddoc_tpu/tools/onnx_reader.py``: the port imports nothing
of the JAX package, and this module is numpy only.

The reference's layout/table checkpoints are published as .onnx graphs
(reference: rapid_doc/model/layout/rapid_layout_self/configs/
default_models.yaml); converting them to flax trees only needs the
*initializers* (named weight tensors), not graph execution. This module
parses the protobuf wire format directly for:

  ModelProto.graph (field 7) -> GraphProto.initializer (field 5,
  repeated TensorProto) with TensorProto fields dims(1), data_type(2),
  float_data(4), int64_data(7), name(8), raw_data(9).

Covers fp32/fp16/bf16/int32/int64/uint8/bool tensors — everything the
target checkpoints contain.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
    11: np.float64, 12: np.uint32, 13: np.uint64,
    16: np.uint16,  # bfloat16 stored as raw uint16; caller reinterprets
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over a protobuf message.
    value: int for varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw = None
    floats: list[float] = []
    int64s: list[int] = []
    int32s: list[int] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2 and wire == 0:
            dtype_code = val
        elif field == 4:  # float_data (packed or repeated)
            if wire == 2:
                floats.extend(
                    np.frombuffer(val, dtype="<f4").tolist()
                )
            else:
                floats.append(
                    np.frombuffer(
                        int(val).to_bytes(4, "little"), dtype="<f4"
                    )[0]
                )
        elif field == 5 and wire == 2:  # int32_data packed
            int32s.extend(np.frombuffer(val, dtype="<i4").tolist())
        elif field == 5 and wire == 0:
            int32s.append(val)
        elif field == 7 and wire == 2:  # int64_data packed
            int64s.extend(np.frombuffer(val, dtype="<i8").tolist())
        elif field == 7 and wire == 0:
            int64s.append(val)
        elif field == 8 and wire == 2:
            name = val.decode("utf-8", "replace")
        elif field == 9 and wire == 2:
            raw = val
    dtype = _DTYPES.get(dtype_code, np.float32)
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np.float32)
    elif int64s:
        arr = np.asarray(int64s, dtype=np.int64)
    elif int32s:
        arr = np.asarray(int32s, dtype=np.int32)
    else:
        arr = np.zeros(shape, dtype=dtype)
    # no dims + one element = a 0-d scalar tensor per the onnx spec
    return name, arr.reshape(shape)


def read_onnx_initializers(path: str | Path) -> dict[str, np.ndarray]:
    """-> {initializer name: ndarray} from an .onnx file."""
    buf = Path(path).read_bytes()
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _fields(buf):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:  # initializer
                    name, arr = _parse_tensor(gval)
                    if name:
                        out[name] = arr
                elif gfield == 15 and gwire == 2:
                    # sparse_initializer unsupported; ignore
                    pass
    return out


def read_onnx_io_names(path: str | Path) -> tuple[list[str], list[str]]:
    """-> (graph input names, output names) — useful to sanity-check a
    checkpoint before conversion."""
    buf = Path(path).read_bytes()
    inputs: list[str] = []
    outputs: list[str] = []
    for field, wire, val in _fields(buf):
        if field == 7 and wire == 2:
            for gfield, gwire, gval in _fields(val):
                if gfield in (11, 12) and gwire == 2:  # input/output ValueInfo
                    for vfield, vwire, vval in _fields(gval):
                        if vfield == 1 and vwire == 2:
                            (inputs if gfield == 11 else outputs).append(
                                vval.decode("utf-8", "replace")
                            )
    return inputs, outputs


# ---------------------------------------------------------------------------
# Full graph parsing (nodes + attributes + IO shapes) for the ONNX
# interpreter (engine/onnx_torch.py). Field numbers per onnx.proto3:
# GraphProto{node=1, initializer=5, input=11, output=12}, NodeProto{input=1,
# output=2, name=3, op_type=4, attribute=5}, AttributeProto{name=1, f=2,
# i=3, s=4, t=5, floats=7, ints=8, strings=9}.
# ---------------------------------------------------------------------------


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attribute(buf: bytes):
    import struct

    name = ""
    value = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    graphs: list = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = val.decode("utf-8", "replace")
        elif field == 2 and wire == 5:  # f
            value = struct.unpack("<f", int(val).to_bytes(4, "little"))[0]
        elif field == 3 and wire == 0:  # i
            value = _signed(val)
        elif field == 4 and wire == 2:  # s
            value = val.decode("utf-8", "replace")
        elif field == 5 and wire == 2:  # t (tensor)
            value = _parse_tensor(val)[1]
        elif field == 6 and wire == 2:  # g (subgraph, for If/Loop/Scan)
            value = _parse_graph(val)
        elif field == 11 and wire == 2:  # graphs
            graphs.append(_parse_graph(val))
        elif field == 7:  # floats
            if wire == 2:
                floats.extend(
                    np.frombuffer(val, dtype="<f4").tolist()
                )
            else:
                floats.append(
                    struct.unpack("<f", int(val).to_bytes(4, "little"))[0]
                )
        elif field == 8:  # ints
            if wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_signed(v))
            else:
                ints.append(_signed(val))
        elif field == 9 and wire == 2:  # strings
            strings.append(val)
    if value is None:
        if ints:
            value = ints
        elif floats:
            value = floats
        elif strings:
            value = [s.decode("utf-8", "replace") for s in strings]
        elif graphs:
            value = graphs
    return name, value


class OnnxNode:
    __slots__ = ("op_type", "inputs", "outputs", "attrs", "name")

    def __init__(self, op_type, inputs, outputs, attrs, name=""):
        self.op_type = op_type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs
        self.name = name

    def __repr__(self):
        return (
            f"OnnxNode({self.op_type}, in={self.inputs}, out={self.outputs})"
        )


class OnnxModel:
    def __init__(self):
        self.nodes: list[OnnxNode] = []
        self.initializers: dict[str, np.ndarray] = {}
        self.input_names: list[str] = []   # graph inputs minus initializers
        self.output_names: list[str] = []
        self.input_shapes: dict[str, tuple] = {}  # -1 for dynamic dims
        self.opset: int = 0


def _parse_value_info(buf: bytes):
    """ValueInfoProto -> (name, shape tuple with -1 for dynamic dims)."""
    name = ""
    shape: list[int] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = val.decode("utf-8", "replace")
        elif field == 2 and wire == 2:  # TypeProto
            for tf, tw, tv in _fields(val):
                if tf == 1 and tw == 2:  # tensor_type
                    for ttf, ttw, ttv in _fields(tv):
                        if ttf == 2 and ttw == 2:  # shape
                            for sf, sw, sv in _fields(ttv):
                                if sf == 1 and sw == 2:  # dim
                                    dim = -1
                                    for df, dw, dv in _fields(sv):
                                        if df == 1 and dw == 0:
                                            dim = dv
                                    shape.append(dim)
    return name, tuple(shape)


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: list[str] = []
    outputs: list[str] = []
    op_type = ""
    name = ""
    attrs: dict = {}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(val.decode("utf-8", "replace"))
        elif field == 2 and wire == 2:
            outputs.append(val.decode("utf-8", "replace"))
        elif field == 3 and wire == 2:
            name = val.decode("utf-8", "replace")
        elif field == 4 and wire == 2:
            op_type = val.decode("utf-8", "replace")
        elif field == 5 and wire == 2:
            aname, avalue = _parse_attribute(val)
            attrs[aname] = avalue
    return OnnxNode(op_type, inputs, outputs, attrs, name)


def _parse_graph(buf: bytes) -> OnnxModel:
    """GraphProto bytes -> OnnxModel (used for the main graph and for
    If/Loop/Scan subgraph attributes)."""
    model = OnnxModel()
    graph_inputs: list[tuple[str, tuple]] = []
    for gfield, gwire, gval in _fields(buf):
        if gfield == 1 and gwire == 2:
            model.nodes.append(_parse_node(gval))
        elif gfield == 5 and gwire == 2:
            tname, arr = _parse_tensor(gval)
            if tname:
                model.initializers[tname] = arr
        elif gfield == 11 and gwire == 2:
            graph_inputs.append(_parse_value_info(gval))
        elif gfield == 12 and gwire == 2:
            vname, _ = _parse_value_info(gval)
            model.output_names.append(vname)
    for vname, shape in graph_inputs:
        if vname not in model.initializers:
            model.input_names.append(vname)
            model.input_shapes[vname] = shape
    return model


def read_onnx_model(path: str | Path) -> OnnxModel:
    """Parse nodes + initializers + IO of an .onnx file."""
    buf = Path(path).read_bytes()
    model = OnnxModel()
    opset = 0
    for field, wire, val in _fields(buf):
        if field == 8 and wire == 2:  # opset_import
            for of, ow, ov in _fields(val):
                if of == 2 and ow == 0:
                    opset = max(opset, ov)
        if field == 7 and wire == 2:  # graph
            model = _parse_graph(val)
    model.opset = opset
    return model


def read_onnx_metadata(path: str | Path) -> dict[str, str]:
    """ModelProto.metadata_props (field 14) -> {key: value}. The published
    orientation checkpoint stores its label list here (reference:
    rapid_orientation.py:39 session.get_metadata()['character'])."""
    buf = Path(path).read_bytes()
    out: dict[str, str] = {}
    for field, wire, val in _fields(buf):
        if field == 14 and wire == 2:
            key = value = ""
            for kf, kw, kv in _fields(val):
                if kf == 1 and kw == 2:
                    key = kv.decode("utf-8", "replace")
                elif kf == 2 and kw == 2:
                    value = kv.decode("utf-8", "replace")
            if key:
                out[key] = value
    return out
