"""The port's ONNX interpreter against the JAX package's, on the CPU.

Every case writes one graph file with the JAX package's writer and runs
it through ``OnnxJaxFunction`` and the port's ``OnnxTorchFunction``
(device="cpu") on the same seeded feeds: discrete outputs and every
dtype equal, floats within atol 1e-5 and rtol 1e-4. The cases are those
of tests/test_onnx_jax.py and tests/test_onnx_family_graphs.py (with
their seeds), then one case per op handler those files do not reach
(Resize downsampling with antialias, integer Div/Mod with negative
operands, TopK ties, Loop's padded scan output on early exit, ...).
``test_every_handler_is_exercised`` holds the set of op types the cases
run to the JAX interpreter's handlers. Also here: the port's reader and
writer against the JAX package's, and Magika (the one published ONNX
model in the repository, at its full width) on the byte corpus of the
smoke's ``onnx`` phase, labels equal and scores within 1e-5.

    python tests/test_torch_onnx.py

rebuilds ``rapiddoc_tpu_torch/assets/onnx_smoke_golden.json``: the JAX
package's outputs for the smoke's Magika corpus and contract graphs.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]
from torch_threads import capped_threads  # noqa: E402

import chip_smoke  # noqa: E402
from rapiddoc_tpu.tools import onnx_writer as w  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
INT64, BOOL = 7, 9
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    yield from capped_threads(4)


def G(nodes, inputs, outputs, inits=None, feeds=(), input_dtypes=None):
    """One graph case: writer arguments and the feeds, in input order."""
    return {"nodes": nodes, "inputs": inputs, "outputs": {o: (1,) for o in outputs},
            "inits": inits or {}, "feeds": list(feeds), "input_dtypes": input_dtypes}


def write(case, path: Path) -> Path:
    path.write_bytes(w.build_model(case["nodes"], case["inputs"], case["outputs"],
                                   case["inits"], input_dtypes=case["input_dtypes"]))
    return path


def run_both(path: Path, feeds):
    from rapiddoc_tpu.engine.onnx_jax import OnnxJaxFunction
    from rapiddoc_tpu.tools.onnx_reader import read_onnx_model
    from rapiddoc_tpu_torch.engine.onnx_torch import OnnxTorchFunction

    want = OnnxJaxFunction(read_onnx_model(path))(*feeds)
    got = OnnxTorchFunction.from_file(path, device="cpu")(*feeds)
    return got, want


def assert_same(got, want, label=""):
    assert len(got) == len(want), label
    for i, (g, v) in enumerate(zip(got, want)):
        g, v = np.asarray(g), np.asarray(v)
        assert g.dtype == v.dtype, (label, i, g.dtype, v.dtype)
        assert g.shape == v.shape, (label, i, g.shape, v.shape)
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(g, v, atol=ATOL, rtol=RTOL, err_msg=f"{label} {i}")
        else:
            np.testing.assert_array_equal(g, v, err_msg=f"{label} {i}")


def rng_(seed):
    return np.random.default_rng(seed)


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------- tests/test_onnx_jax.py's cases

def c_conv():
    r = rng_(0)
    x, k, b = f32(r, 2, 3, 13, 17), f32(r, 8, 3, 3, 3), f32(r, 8)
    return G([w.encode_node("Conv", ["x", "w", "b"], ["y"],
                            {"strides": [2, 2], "pads": [1, 0, 1, 2], "dilations": [1, 1], "group": 1})],
             {"x": x.shape}, ["y"], {"w": k, "b": b}, [x])


def c_depthwise_conv():
    r = rng_(1)
    x, k = f32(r, 1, 6, 10, 10), f32(r, 6, 1, 3, 3)
    return G([w.encode_node("Conv", ["x", "w"], ["y"], {"pads": [1, 1, 1, 1], "group": 6})],
             {"x": x.shape}, ["y"], {"w": k}, [x])


def c_conv_transpose():
    r = rng_(2)
    x, k, b = f32(r, 1, 4, 7, 7), f32(r, 4, 6, 2, 2), f32(r, 6)
    return G([w.encode_node("ConvTranspose", ["x", "w", "b"], ["y"], {"strides": [2, 2]})],
             {"x": x.shape}, ["y"], {"w": k, "b": b}, [x])


def c_maxpool_ceil():
    x = f32(rng_(3), 1, 2, 11, 11)
    return G([w.encode_node("MaxPool", ["x"], ["y"],
                            {"kernel_shape": [3, 3], "strides": [2, 2], "ceil_mode": 1})],
             {"x": x.shape}, ["y"], None, [x])


def c_avgpool_pads():
    x = f32(rng_(3), 1, 2, 11, 11)
    return G([w.encode_node("AveragePool", ["x"], ["y"],
                            {"kernel_shape": [2, 2], "strides": [2, 2], "pads": [1, 1, 0, 0]})],
             {"x": x.shape}, ["y"], None, [x])


def c_batchnorm():
    r = rng_(4)
    x = f32(r, 2, 5, 4, 4)
    inits = {"s": f32(r, 5), "b": f32(r, 5), "m": f32(r, 5),
             "v": (r.random(5) + 0.5).astype(np.float32)}
    return G([w.encode_node("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"], {"epsilon": 1e-5})],
             {"x": x.shape}, ["y"], inits, [x])


def c_gemm_softmax():
    r = rng_(4)
    a = f32(r, 3, 7)
    return G([w.encode_node("Gemm", ["a", "b", "c"], ["y"], {"transB": 1, "alpha": 1.0, "beta": 1.0}),
              w.encode_node("Softmax", ["y"], ["z"], {"axis": -1})],
             {"a": a.shape}, ["z"], {"b": f32(r, 9, 7), "c": f32(r, 9)}, [a])


def c_resize_bilinear_up():
    x = f32(rng_(5), 1, 3, 8, 8)
    return G([w.encode_node("Resize", ["x", "", "", "sizes"], ["y"],
                            {"mode": "linear", "coordinate_transformation_mode": "half_pixel"})],
             {"x": x.shape}, ["y"], {"sizes": np.asarray([1, 3, 16, 16], np.int64)}, [x])


def c_grid_sample():
    r = rng_(6)
    x = f32(r, 2, 3, 9, 9)
    grid = (r.random((2, 5, 7, 2)).astype(np.float32) * 2.4) - 1.2
    return G([w.encode_node("GridSample", ["x", "g"], ["y"],
                            {"mode": "bilinear", "align_corners": 0, "padding_mode": "zeros"})],
             {"x": x.shape, "g": grid.shape}, ["y"], None, [x, grid])


def c_shape_chain():
    x = f32(rng_(7), 2, 6, 5)
    return G([w.encode_node("Shape", ["x"], ["shp"]),
              w.encode_node("Gather", ["shp", "i0"], ["b"], {"axis": 0}),
              w.encode_node("Unsqueeze", ["b", "ax0"], ["b1"]),
              w.encode_node("Concat", ["b1", "rest"], ["tgt"], {"axis": 0}),
              w.encode_node("Reshape", ["x", "tgt"], ["y"])],
             {"x": x.shape}, ["y"],
             {"i0": np.asarray(0, np.int64), "ax0": np.asarray([0], np.int64),
              "rest": np.asarray([3, 10], np.int64)}, [x])


def c_topk():
    x = f32(rng_(8), 2, 10)
    return G([w.encode_node("TopK", ["x", "k"], ["v", "i"], {"axis": -1})],
             {"x": x.shape}, ["v", "i"], {"k": np.asarray([3], np.int64)}, [x])


def c_layernorm():
    r = rng_(8)
    x = f32(r, 2, 4, 5)
    return G([w.encode_node("LayerNormalization", ["x", "s", "b"], ["y"], {"axis": -1, "epsilon": 1e-5})],
             {"x": x.shape}, ["y"], {"s": f32(r, 5), "b": f32(r, 5)}, [x])


def _if_branches():
    then_g = w.SubGraph([w.encode_node("Add", ["x", "x"], ["tb"])], outputs={"tb": (1,)})
    else_g = w.SubGraph([w.encode_node("Mul", ["x", "x"], ["eb"])], outputs={"eb": (1,)})
    return then_g, else_g


def c_if_static(flag):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    then_g, else_g = _if_branches()
    return G([w.encode_node("If", ["c"], ["y"], {"then_branch": then_g, "else_branch": else_g})],
             {"x": x.shape}, ["y"], {"c": np.asarray(flag)}, [x])


def c_if_traced(thresh):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    then_g, else_g = _if_branches()
    return G([w.encode_node("ReduceSum", ["x"], ["s"], {"keepdims": 0}),
              w.encode_node("Greater", ["s", "t"], ["c"]),
              w.encode_node("If", ["c"], ["y"], {"then_branch": then_g, "else_branch": else_g})],
             {"x": x.shape, "t": ()}, ["y"], None, [x, np.asarray(thresh, np.float32)])


def c_loop_carried():
    x = np.arange(4, dtype=np.float32)
    body = w.SubGraph([w.encode_node("Add", ["v", "v"], ["v2"]),
                       w.encode_node("Identity", ["cin"], ["cout"])],
                      inputs={"it": (), "cin": (), "v": (4,)}, outputs={"cout": (), "v2": (1,)},
                      input_dtypes={"it": INT64, "cin": BOOL})
    return G([w.encode_node("Loop", ["m", "c0", "x"], ["y"], {"body": body})],
             {"x": x.shape}, ["y"], {"m": np.asarray(5, np.int64), "c0": np.asarray(True)}, [x])


def _count_body(limit):
    return w.SubGraph([w.encode_node("Add", ["s", "one"], ["s2"]),
                       w.encode_node("Less", ["s2", "lim"], ["cout"]),
                       w.encode_node("Identity", ["s2"], ["scan"])],
                      inputs={"it": (), "cin": (), "s": ()},
                      outputs={"cout": (), "s2": (), "scan": ()},
                      initializers={"one": np.float32(1), "lim": np.float32(limit)},
                      input_dtypes={"it": INT64, "cin": BOOL})


def c_loop_early_exit():
    """s += 1 while s < 3, scanning s: 3 of 6 allowed steps, then the
    scan buffer's zero padding."""
    return G([w.encode_node("Loop", ["m", "c0", "s0"], ["sf", "hist"], {"body": _count_body(3)})],
             {"s0": ()}, ["sf", "hist"], {"m": np.asarray(6, np.int64), "c0": np.asarray(True)},
             [np.asarray(0.0, np.float32)])


# ------------------------------- tests/test_onnx_family_graphs.py's graphs

def family_case(name: str, seed: int | None = None, tmp=None):
    """The family graph ``name`` of tests/test_onnx_family_graphs.py and
    its feeds, built by that file's own code."""
    import test_onnx_family_graphs as fam

    captured = {}

    def build_fn(tmp_path, nodes, inputs, outputs, initializers=None, input_dtypes=None):
        captured.update(nodes=nodes, inputs=inputs, outputs=outputs,
                        inits=initializers or {}, input_dtypes=input_dtypes)
        raise _Captured

    class _Captured(Exception):
        pass

    saved = fam.build_fn
    fam.build_fn = build_fn
    try:
        fn = getattr(fam, f"test_{name}")
        try:
            fn(tmp, seed) if seed is not None else fn(tmp)
        except _Captured:
            pass
    finally:
        fam.build_fn = saved
    return captured


def family_feeds(name: str, seed: int | None):
    if name == "rtdetr_family_graph":
        r = rng_(0)
        img = r.standard_normal((1, 3, 32, 32)).astype(np.float32)
        return [[img, np.asarray([[32, 32]], np.float32), np.asarray([[0.5, 0.5]], np.float32),
                 np.asarray(flag)] for flag in (True, False)]
    if name == "formula_ar_loop_graph":
        return [[np.asarray(0, np.int64)]]
    if name == "unet_family_graph":
        return [[rng_(5).standard_normal((1, 3, 16, 16)).astype(np.float32)]]
    if name == "slanet_family_loop_graph":
        return [[np.zeros((1, 8), np.float32), np.asarray(0, np.int64)]]
    raise KeyError(name)


FAMILIES = [("rtdetr_family_graph", None), ("formula_ar_loop_graph", 3),
            ("formula_ar_loop_graph", 7), ("formula_ar_loop_graph", 11),
            ("unet_family_graph", None), ("slanet_family_loop_graph", 2),
            ("slanet_family_loop_graph", 9)]


# -------------------------------------------------- the handlers' gaps

def unary(op, x, attrs=None):
    return G([w.encode_node(op, ["x"], ["y"], attrs or {})], {"x": x.shape}, ["y"], None, [x])


def binary(op, a, b, static_b=False):
    if static_b:
        return G([w.encode_node(op, ["a", "b"], ["y"])], {"a": a.shape}, ["y"], {"b": b}, [a])
    return G([w.encode_node(op, ["a", "b"], ["y"])], {"a": a.shape, "b": b.shape}, ["y"], None, [a, b])


def c_constants():
    """Every Constant form, one output static (an int64 Constant comes
    back int32, as jit returns it) and the rest through device math."""
    x = f32(rng_(20), 3)
    nodes = [
        w.encode_node("Constant", [], ["ct"], {"value": np.asarray([1.5, 2.0, -1.0], np.float32)}),
        w.encode_node("Constant", [], ["cf"], {"value_float": 0.25}),
        w.encode_node("Constant", [], ["ci"], {"value_int": 7}),
        w.encode_node("Constant", [], ["cis"], {"value_ints": [1, 2, 3]}),
        w.encode_node("Constant", [], ["cfs"], {"value_floats": [0.5, 1.0, 2.0]}),
        w.encode_node("Add", ["x", "ct"], ["a"]),
        w.encode_node("Mul", ["a", "cf"], ["b"]),
        w.encode_node("Mul", ["b", "cfs"], ["c"]),
        w.encode_node("Add", ["cis", "ci"], ["static_int"]),
        w.encode_node("Cast", ["static_int"], ["sf"], {"to": 1}),
        w.encode_node("Add", ["c", "sf"], ["y"]),
    ]
    return G(nodes, {"x": x.shape}, ["y", "static_int"], None, [x])


def c_cast():
    x = (f32(rng_(21), 2, 5) * 4).astype(np.float32)
    nodes = [w.encode_node("Cast", ["x"], ["i64"], {"to": INT64}),
             w.encode_node("Cast", ["x"], ["h"], {"to": 10}),
             w.encode_node("Cast", ["x"], ["bo"], {"to": BOOL}),
             w.encode_node("Cast", ["x"], ["u8"], {"to": 2}),
             w.encode_node("Cast", ["i64"], ["d"], {"to": 11})]
    return G(nodes, {"x": x.shape}, ["i64", "h", "bo", "d"], None, [np.abs(x)])


def c_shape_ops():
    """Shape with start/end, Flatten, Expand, Tile, Range, ConstantOfShape,
    Squeeze without axes, Unsqueeze's attribute form, Transpose without
    perm."""
    x = f32(rng_(22), 2, 1, 3, 4)
    nodes = [
        w.encode_node("Shape", ["x"], ["s24"], {"start": 2, "end": 4}),
        w.encode_node("ConstantOfShape", ["s24"], ["z"], {"value": np.asarray([2.5], np.float32)}),
        w.encode_node("ConstantOfShape", ["s24"], ["z0"]),
        w.encode_node("Flatten", ["x"], ["fl"], {"axis": 2}),
        w.encode_node("Squeeze", ["x"], ["sq"]),
        w.encode_node("Unsqueeze", ["sq"], ["us"], {"axes": [0, 3]}),
        w.encode_node("Transpose", ["x"], ["tr"]),
        w.encode_node("Expand", ["row", "eshape"], ["ex"]),
        w.encode_node("Tile", ["sq", "reps"], ["ti"]),
        w.encode_node("Range", ["r0", "r1", "r2"], ["rg"]),
        w.encode_node("Cast", ["rg"], ["rgf"], {"to": 1}),
        w.encode_node("Add", ["z", "z0"], ["zz"]),
        w.encode_node("Mul", ["ex", "rgf"], ["exr"]),
    ]
    inits = {"row": f32(rng_(23), 1, 4), "eshape": np.asarray([3, 1], np.int64),
             "reps": np.asarray([1, 2, 1], np.int64), "r0": np.asarray(1, np.int64),
             "r1": np.asarray(9, np.int64), "r2": np.asarray(2, np.int64)}
    return G(nodes, {"x": x.shape}, ["zz", "fl", "us", "tr", "exr", "ti", "s24"], inits, [x])


def c_split():
    x = f32(rng_(24), 3, 10)
    nodes = [w.encode_node("Split", ["x", "sizes"], ["a", "b", "c"], {"axis": 1}),
             w.encode_node("Split", ["x"], ["d", "e"], {"axis": 1, "split": [4, 6]}),
             w.encode_node("Split", ["x"], ["f", "g"], {"axis": 1})]
    return G(nodes, {"x": x.shape}, ["a", "b", "c", "d", "e", "f", "g"],
             {"sizes": np.asarray([2, 3, 5], np.int64)}, [x])


def c_slice():
    x = f32(rng_(25), 4, 9, 6)
    nodes = [w.encode_node("Slice", ["x", "st", "en", "ax", "sp"], ["a"]),
             w.encode_node("Slice", ["x", "st2", "en2"], ["b"]),
             w.encode_node("Slice", ["x"], ["c"], {"starts": [1], "ends": [-1], "axes": [2]})]
    inits = {"st": np.asarray([-1, 7], np.int64), "en": np.asarray([-10**18, 1], np.int64),
             "ax": np.asarray([1, -1], np.int64), "sp": np.asarray([-2, -3], np.int64),
             "st2": np.asarray([1, 0, 2], np.int64),
             "en2": np.asarray([3, 2**62, 100], np.int64)}
    return G(nodes, {"x": x.shape}, ["a", "b", "c"], inits, [x])


def c_gathers():
    r = rng_(26)
    x = f32(r, 5, 4, 3)
    nodes = [w.encode_node("Gather", ["x", "gi"], ["a"], {"axis": 1}),
             w.encode_node("Gather", ["x", "idx"], ["b"], {"axis": -1}),
             w.encode_node("GatherElements", ["x", "ge"], ["c"], {"axis": 1}),
             w.encode_node("GatherND", ["x", "gnd"], ["d"])]
    inits = {"gi": np.asarray([[-1, 0], [2, 3]], np.int64),
             "ge": r.integers(-4, 4, (5, 2, 3)).astype(np.int64),
             "gnd": np.asarray([[0, 1], [4, -1], [2, 2]], np.int64)}
    idx = np.asarray([2, -1, 0], np.int64)
    return G(nodes, {"x": x.shape, "idx": idx.shape}, ["a", "b", "c", "d"], inits, [x, idx])


def c_onehot_where():
    idx = np.asarray([[0, 2, 5], [-1, 1, 3]], np.int64)
    x = f32(rng_(27), 2, 3)
    nodes = [w.encode_node("OneHot", ["idx", "depth", "vals"], ["oh"], {"axis": 1}),
             w.encode_node("OneHot", ["idx", "depth", "ivals"], ["ohi"]),
             w.encode_node("Greater", ["x", "zero"], ["pos"]),
             w.encode_node("Where", ["pos", "x", "idxf"], ["wh"]),
             w.encode_node("Where", ["sc", "sa", "sb"], ["ws"])]
    inits = {"depth": np.asarray(4, np.int64), "vals": np.asarray([-1.0, 3.0], np.float32),
             "ivals": np.asarray([0, 9], np.int64), "zero": np.asarray(0.0, np.float32),
             "idxf": np.asarray(-7.0, np.float32), "sc": np.asarray([True, False]),
             "sa": np.asarray([1, 2], np.int64), "sb": np.asarray([3, 4], np.int64)}
    return G(nodes, {"idx": idx.shape, "x": x.shape}, ["oh", "ohi", "wh", "ws"], inits, [idx, x])


def c_pads():
    x = f32(rng_(28), 1, 2, 4, 5)
    # a Constant node: a float initializer would be a device value, and the
    # pad value must be static
    nodes = [w.encode_node("Constant", [], ["cv"], {"value": np.asarray(1.25, np.float32)}),
             w.encode_node("Pad", ["x", "p", "cv"], ["a"], {"mode": "constant"}),
             w.encode_node("Pad", ["x", "p"], ["b"], {"mode": "reflect"}),
             w.encode_node("Pad", ["x", "p"], ["c"], {"mode": "edge"}),
             w.encode_node("Pad", ["x"], ["d"], {"pads": [0, 1, 0, 0, 0, 2, 1, 0], "value": 0.5})]
    inits = {"p": np.asarray([0, 0, 2, 1, 0, 0, 3, 4], np.int64)}
    return G(nodes, {"x": x.shape}, ["a", "b", "c", "d"], inits, [x])


def c_int_div_mod():
    a = np.asarray([-7, 7, -7, 7, -1, 0, 9], np.int64)
    b = np.asarray([2, -2, -2, 2, 3, 5, -4], np.int64)
    nodes = [w.encode_node("Div", ["a", "b"], ["q"]), w.encode_node("Mod", ["a", "b"], ["r"]),
             w.encode_node("Div", ["sa", "sb"], ["sq"]), w.encode_node("Mod", ["sa", "sb"], ["sr"]),
             w.encode_node("Mod", ["af", "bf"], ["rf"], {"fmod": 1})]
    inits = {"sa": a, "sb": b, "af": np.asarray([-7.5, 7.5, -0.5, 3.0], np.float32),
             "bf": np.asarray([2.0, -2.0, 3.0, -1.5], np.float32)}
    return G(nodes, {"a": a.shape, "b": b.shape}, ["q", "r", "sq", "sr", "rf"], inits, [a, b])


def c_float_div_mod_pow():
    r = rng_(29)
    a, b = f32(r, 3, 4), f32(r, 3, 4)
    p = np.abs(a) + 0.5
    nodes = [w.encode_node("Div", ["a", "b"], ["q"]), w.encode_node("Mod", ["a", "b"], ["r"]),
             w.encode_node("Pow", ["p", "b"], ["pw"]), w.encode_node("Pow", ["a", "two"], ["sq"]),
             w.encode_node("Pow", ["ia", "three"], ["ip"])]
    inits = {"two": np.asarray(2, np.int64), "three": np.asarray([3, 2], np.int64)}
    ia = np.asarray([-3, 4], np.int64)
    return G(nodes, {"a": a.shape, "b": b.shape, "p": p.shape, "ia": ia.shape},
             ["q", "r", "pw", "sq", "ip"], inits, [a, b, p, ia])


UNARY_OPS = ("Sqrt", "Reciprocal", "Exp", "Log", "Erf", "Tanh", "Abs", "Neg", "Floor", "Ceil",
             "Round", "Sign", "Relu", "Sigmoid", "HardSwish", "Softplus")


def c_unary(op):
    r = rng_(30)
    x = f32(r, 4, 6, scale=2.0)
    if op in ("Sqrt", "Log"):
        x = np.abs(x) + 0.1
    if op == "Round":
        x = np.asarray([[0.5, 1.5, 2.5, -0.5, -1.5, 3.49]], np.float32)
    return unary(op, x)


def c_variadic_clip():
    r = rng_(31)
    a, b, c = f32(r, 2, 5), f32(r, 2, 5), f32(r, 1, 5)
    nodes = [w.encode_node("Min", ["a", "b", "c"], ["mn"]), w.encode_node("Max", ["a", "b", "c"], ["mx"]),
             w.encode_node("Sum", ["a", "b", "c"], ["sm"]),
             w.encode_node("Clip", ["a", "lo", "hi"], ["cl"]),
             w.encode_node("Clip", ["b"], ["ca"], {"min": -0.25, "max": 0.5}),
             w.encode_node("Clip", ["c", "", "hi"], ["ch"])]
    inits = {"lo": np.asarray(-0.5, np.float32), "hi": np.asarray(0.75, np.float32)}
    return G(nodes, {"a": a.shape, "b": b.shape, "c": c.shape},
             ["mn", "mx", "sm", "cl", "ca", "ch"], inits, [a, b, c])


def c_compare_logic():
    a = np.asarray([[1, 2, 3, 4], [4, 3, 2, 1]], np.int64)
    b = np.asarray([2, 2, 2, 5], np.int64)
    nodes = [w.encode_node(op, ["a", "b"], [op.lower()])
             for op in ("Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual")]
    nodes += [w.encode_node("Not", ["equal"], ["not"]),
              w.encode_node("And", ["greater", "lessorequal"], ["and"]),
              w.encode_node("Or", ["less", "equal"], ["or"]),
              w.encode_node("Equal", ["sa", "sb"], ["sequal"])]
    inits = {"sa": np.asarray([1, 2], np.int64), "sb": np.asarray([1, 3], np.int64)}
    outs = ["equal", "greater", "greaterorequal", "less", "lessorequal", "not", "and", "or", "sequal"]
    return G(nodes, {"a": a.shape, "b": b.shape}, outs, inits, [a, b])


def c_activations():
    r = rng_(32)
    x = f32(r, 2, 3, 4, 4, scale=3.0)
    nodes = [w.encode_node("LeakyRelu", ["x"], ["lr"], {"alpha": 0.1}),
             w.encode_node("PRelu", ["x", "slope"], ["pr"]),
             w.encode_node("HardSigmoid", ["x"], ["hs"], {"alpha": 0.25, "beta": 0.4}),
             w.encode_node("Gelu", ["x"], ["ge"], {"approximate": "tanh"}),
             w.encode_node("LogSoftmax", ["x"], ["ls"], {"axis": 1}),
             w.encode_node("InstanceNormalization", ["x", "s", "b"], ["inn"], {"epsilon": 1e-4})]
    inits = {"slope": f32(r, 3), "s": f32(r, 3), "b": f32(r, 3)}
    return G(nodes, {"x": x.shape}, ["lr", "pr", "hs", "ge", "ls", "inn"], inits, [x])


def c_reductions():
    r = rng_(33)
    x = f32(r, 2, 3, 4)
    xi = r.integers(-3, 4, (2, 3, 4)).astype(np.int64)
    nodes = [w.encode_node("ReduceMean", ["x"], ["mean"], {"axes": [1, 2], "keepdims": 0}),
             w.encode_node("ReduceMin", ["x"], ["mn"], {"axes": [-1]}),
             w.encode_node("ReduceProd", ["x"], ["pr"], {"axes": [0, 2], "keepdims": 0}),
             w.encode_node("ReduceSum", ["x", "axes"], ["sm"], {"keepdims": 1}),
             w.encode_node("ReduceMax", ["x"], ["mx"], {"keepdims": 0}),
             w.encode_node("ReduceSum", ["xi"], ["si"], {"axes": [1], "keepdims": 0}),
             w.encode_node("Greater", ["xi", "zero"], ["pos"]),
             w.encode_node("Cast", ["pos"], ["pos8"], {"to": 3}),
             w.encode_node("ReduceSum", ["pos8"], ["s8"], {"axes": [2], "keepdims": 0}),
             w.encode_node("ReduceMean", ["xi"], ["mi"], {"axes": [0], "keepdims": 0}),
             w.encode_node("ReduceMax", ["sxi"], ["smx"], {"axes": [0]}),
             w.encode_node("ArgMax", ["x"], ["am"], {"axis": 1, "keepdims": 1}),
             w.encode_node("CumSum", ["x", "ax1"], ["cs"]),
             w.encode_node("CumSum", ["xi", "ax1"], ["csi"])]
    inits = {"axes": np.asarray([0, -1], np.int64), "zero": np.asarray(0, np.int64),
             "sxi": np.asarray([[1, 5], [4, 2]], np.int64), "ax1": np.asarray(1, np.int64)}
    outs = ["mean", "mn", "pr", "sm", "mx", "si", "s8", "mi", "smx", "am", "cs", "csi"]
    return G(nodes, {"x": x.shape, "xi": xi.shape}, outs, inits, [x, xi])


def c_topk_ties():
    """Saturated scores: equal values keep the lower index first, for
    largest and smallest, along a leading axis too."""
    x = np.asarray([[1.0, 0.5, 1.0, 1.0, 0.2, 0.5], [0.0, 0.0, 0.3, 0.0, 0.3, 1.0]], np.float32)
    nodes = [w.encode_node("Mul", ["x", "hundred"], ["x100"]),
             w.encode_node("Sigmoid", ["x100"], ["s"]),
             w.encode_node("TopK", ["s", "k"], ["v", "i"], {"axis": -1}),
             w.encode_node("TopK", ["x", "k"], ["v2", "i2"], {"axis": -1, "largest": 0}),
             w.encode_node("TopK", ["x", "k1"], ["v3", "i3"], {"axis": 0})]
    inits = {"k": np.asarray([4], np.int64), "k1": np.asarray([1], np.int64),
             "hundred": np.asarray(100.0, np.float32)}
    return G(nodes, {"x": x.shape}, ["v", "i", "v2", "i2", "v3", "i3"], inits, [x])


def c_linear_algebra():
    r = rng_(34)
    a, b = f32(r, 6, 3), f32(r, 6, 4)
    nodes = [w.encode_node("Gemm", ["a", "b", "c"], ["g"], {"transA": 1, "alpha": 0.5, "beta": 2.0}),
             w.encode_node("Einsum", ["a", "b"], ["e"], {"equation": "ij,ik->jk"}),
             w.encode_node("MatMul", ["b3", "m"], ["mm"])]
    inits = {"c": f32(r, 4), "b3": f32(r, 2, 5, 6), "m": f32(r, 6, 3)}
    return G(nodes, {"a": a.shape, "b": b.shape}, ["g", "e", "mm"], inits, [a, b])


def c_conv_same(auto):
    r = rng_(35)
    x = f32(r, 1, 3, 9, 10)
    nodes = [w.encode_node("Conv", ["x", "w"], ["y"],
                           {"auto_pad": auto, "strides": [2, 3], "dilations": [1, 2]}),
             w.encode_node("Conv", ["x1", "w1", "b1"], ["y1"],
                           {"pads": [2, 1], "strides": [2], "group": 2})]
    inits = {"w": f32(r, 4, 3, 3, 4), "w1": f32(r, 4, 2, 3), "b1": f32(r, 4)}
    x1 = f32(r, 2, 4, 11)
    return G(nodes, {"x": x.shape, "x1": x1.shape}, ["y", "y1"], inits, [x, x1])


def c_conv_transpose_pads():
    r = rng_(36)
    x = f32(r, 1, 3, 5, 6)
    nodes = [w.encode_node("ConvTranspose", ["x", "w", "b"], ["y"],
                           {"strides": [2, 3], "pads": [1, 0, 0, 2], "output_padding": [1, 2],
                            "dilations": [1, 2]}),
             w.encode_node("ConvTranspose", ["x1", "w1"], ["y1"], {"strides": [2]})]
    inits = {"w": f32(r, 3, 2, 3, 3), "b": f32(r, 2), "w1": f32(r, 2, 3, 4)}
    x1 = f32(r, 1, 2, 7)
    return G(nodes, {"x": x.shape, "x1": x1.shape}, ["y", "y1"], inits, [x, x1])


def c_pools_more():
    r = rng_(37)
    x = f32(r, 2, 3, 10, 9)
    nodes = [w.encode_node("AveragePool", ["x"], ["a"],
                           {"kernel_shape": [3, 2], "strides": [2, 2], "pads": [1, 0, 1, 1],
                            "count_include_pad": 1}),
             w.encode_node("AveragePool", ["x"], ["a2"],
                           {"kernel_shape": [3, 3], "strides": [2, 2], "auto_pad": "SAME_UPPER",
                            "ceil_mode": 1}),
             w.encode_node("MaxPool", ["x"], ["m"],
                           {"kernel_shape": [2, 3], "strides": [1, 2], "dilations": [2, 1],
                            "pads": [1, 1, 0, 1]}),
             w.encode_node("MaxPool", ["x1"], ["m1"], {"kernel_shape": [3], "strides": [2]}),
             w.encode_node("AveragePool", ["x1"], ["a1"], {"kernel_shape": [2], "pads": [1, 0]}),
             w.encode_node("GlobalAveragePool", ["x"], ["ga"]),
             w.encode_node("GlobalMaxPool", ["x"], ["gm"])]
    x1 = f32(r, 1, 2, 9)
    return G(nodes, {"x": x.shape, "x1": x1.shape}, ["a", "a2", "m", "m1", "a1", "ga", "gm"],
             None, [x, x1])


RESIZES = [("linear", (1, 3, 5, 7)), ("linear", (1, 3, 40, 9)), ("cubic", (1, 3, 5, 7)),
           ("cubic", (1, 3, 33, 41)), ("nearest", (1, 3, 7, 29)), ("nearest_asym", (1, 3, 31, 24)),
           ("linear_scales", None)]


def c_resize(mode, size):
    """Resize as jax.image.resize: linear and cubic down (antialias) and
    up, nearest at non-integer factors, asymmetric nearest, float scales
    from an initializer (kept static)."""
    x = f32(rng_(38), 1, 3, 16, 18)
    if mode == "linear_scales":
        return G([w.encode_node("Resize", ["x", "", "sc"], ["y"], {"mode": "linear"})],
                 {"x": x.shape}, ["y"], {"sc": np.asarray([1, 1, 0.4, 1.7], np.float32)}, [x])
    attrs = {"mode": mode.split("_")[0]}
    if mode == "nearest_asym":
        attrs["coordinate_transformation_mode"] = "asymmetric"
    return G([w.encode_node("Resize", ["x", "", "", "sizes"], ["y"], attrs)],
             {"x": x.shape}, ["y"], {"sizes": np.asarray(size, np.int64)}, [x])


def c_resize_int():
    """A uint8 input: nearest keeps the dtype, linear promotes to float32."""
    x = rng_(39).integers(0, 256, (1, 2, 6, 7)).astype(np.uint8)
    nodes = [w.encode_node("Resize", ["x", "", "", "s1"], ["n"], {"mode": "nearest"}),
             w.encode_node("Resize", ["x", "", "", "s2"], ["l"], {"mode": "linear"})]
    inits = {"s1": np.asarray([1, 2, 9, 4], np.int64), "s2": np.asarray([1, 2, 3, 11], np.int64)}
    return G(nodes, {"x": x.shape}, ["n", "l"], inits, [x])


def c_grid_sample_align():
    r = rng_(40)
    x = f32(r, 1, 2, 6, 8)
    grid = (r.random((1, 4, 5, 2)).astype(np.float32) * 2.4) - 1.2
    return G([w.encode_node("GridSample", ["x", "g"], ["y"], {"mode": "linear", "align_corners": 1})],
             {"x": x.shape, "g": grid.shape}, ["y"], None, [x, grid])


def c_loop_no_step():
    """The exit condition false from the start: no step runs, the carried
    value comes back as it went in and the scan buffer is all zeros."""
    return G([w.encode_node("Loop", ["m", "c0", "s0"], ["sf", "hist"], {"body": _count_body(3)})],
             {"s0": ()}, ["sf", "hist"], {"m": np.asarray(4, np.int64), "c0": np.asarray(False)},
             [np.asarray(0.0, np.float32)])


def c_loop_traced_exit():
    """A device exit condition fed in, an int64 carried counter (int32
    on the device), and a trip count that ends the loop first."""
    body = w.SubGraph([w.encode_node("Add", ["n", "one"], ["n2"]),
                       w.encode_node("Cast", ["n2"], ["nf"], {"to": 1}),
                       w.encode_node("Mul", ["nf", "v"], ["v2"]),
                       w.encode_node("Less", ["nf", "lim"], ["cout"]),
                       w.encode_node("Identity", ["v2"], ["scan"])],
                      inputs={"it": (), "cin": (), "n": (), "v": (3,)},
                      outputs={"cout": (), "n2": (), "v2": (1,), "scan": (1,)},
                      initializers={"one": np.asarray(1, np.int64)},
                      input_dtypes={"it": INT64, "cin": BOOL, "n": INT64})
    v0 = np.asarray([1.0, -2.0, 0.5], np.float32)
    return G([w.encode_node("Loop", ["m", "c0", "n0", "v0"], ["nf_", "vf", "hist"], {"body": body})],
             {"c0": (), "n0": (), "v0": (3,), "lim": ()}, ["nf_", "vf", "hist"],
             {"m": np.asarray(5, np.int64)},
             [np.asarray(True), np.asarray(0, np.int64), v0, np.asarray(3.0, np.float32)])


def c_static_outputs():
    """Outputs computed only from initializers and shapes: numpy on the
    host in both interpreters, returned in the x64-off dtypes."""
    x = f32(rng_(41), 2, 3)
    nodes = [w.encode_node("Shape", ["x"], ["shp"]),
             w.encode_node("Mul", ["shp", "d"], ["dbl"]),
             w.encode_node("Cast", ["dbl"], ["dblf"], {"to": 11})]
    return G(nodes, {"x": x.shape}, ["shp", "dblf"], {"d": np.asarray(3, np.int64)}, [x])


CASES = {
    "conv": c_conv, "depthwise_conv": c_depthwise_conv, "conv_transpose": c_conv_transpose,
    "maxpool_ceil": c_maxpool_ceil, "avgpool_pads": c_avgpool_pads, "batchnorm": c_batchnorm,
    "gemm_softmax": c_gemm_softmax, "resize_bilinear_up": c_resize_bilinear_up,
    "grid_sample": c_grid_sample, "shape_chain": c_shape_chain, "topk": c_topk,
    "layernorm": c_layernorm,
    "if_static_true": lambda: c_if_static(True), "if_static_false": lambda: c_if_static(False),
    "if_traced_then": lambda: c_if_traced(0.0), "if_traced_else": lambda: c_if_traced(100.0),
    "loop_carried": c_loop_carried, "loop_early_exit": c_loop_early_exit,
    # the handlers' gaps
    "constants": c_constants, "cast": c_cast, "shape_ops": c_shape_ops, "split": c_split,
    "slice": c_slice, "gathers": c_gathers, "onehot_where": c_onehot_where, "pads": c_pads,
    "int_div_mod": c_int_div_mod, "float_div_mod_pow": c_float_div_mod_pow,
    **{f"unary_{op}": (lambda op=op: c_unary(op)) for op in UNARY_OPS},
    "variadic_clip": c_variadic_clip, "compare_logic": c_compare_logic,
    "activations": c_activations, "reductions": c_reductions, "topk_ties": c_topk_ties,
    "linear_algebra": c_linear_algebra,
    "conv_same_upper": lambda: c_conv_same("SAME_UPPER"),
    "conv_same_lower": lambda: c_conv_same("SAME_LOWER"),
    "conv_transpose_pads": c_conv_transpose_pads, "pools_more": c_pools_more,
    **{f"resize_{m}_{'x'.join(map(str, s)) if s else 'scales'}": (lambda m=m, s=s: c_resize(m, s))
       for m, s in RESIZES},
    "resize_uint8": c_resize_int, "grid_sample_align": c_grid_sample_align,
    "loop_no_step": c_loop_no_step, "loop_traced_exit": c_loop_traced_exit,
    "static_outputs": c_static_outputs,
}


@pytest.mark.parametrize("name", list(CASES))
def test_graph_case(tmp_path, name):
    case = CASES[name]()
    got, want = run_both(write(case, tmp_path / "m.onnx"), case["feeds"])
    assert_same(got, want, name)


@pytest.mark.parametrize("name,seed", FAMILIES)
def test_family_graph(tmp_path, name, seed):
    case = family_case(name, seed, tmp_path)
    path = tmp_path / "fam.onnx"
    path.write_bytes(w.build_model(case["nodes"], case["inputs"], case["outputs"], case["inits"],
                                   input_dtypes=case["input_dtypes"]))
    for feeds in family_feeds(name, seed):
        got, want = run_both(path, feeds)
        assert_same(got, want, f"{name} {seed}")


def test_smoke_graphs_equal_the_family_graphs(tmp_path):
    """chip_smoke.py builds its contract graphs with the port's writer:
    the same bytes as tests/test_onnx_family_graphs.py's graphs written by
    the JAX writer, and its feeds the same; the port runs them within the
    family tests' tolerance of the committed golden."""
    from rapiddoc_tpu_torch.engine.onnx_torch import OnnxTorchFunction

    graphs = chip_smoke.onnx_contract_graphs()
    pairs = [("rtdetr_mask", "rtdetr_family_graph", None, 0),
             ("rtdetr_nomask", "rtdetr_family_graph", None, 1), ("unet", "unet_family_graph", None, 0)]
    pairs += [(f"formula_ar_{s}", "formula_ar_loop_graph", s, 0) for s in (3, 7, 11)]
    pairs += [(f"slanet_{s}", "slanet_family_loop_graph", s, 0) for s in (2, 9)]
    for smoke_name, fam, seed, run in pairs:
        case = family_case(fam, seed, tmp_path)
        want = w.build_model(case["nodes"], case["inputs"], case["outputs"], case["inits"],
                             input_dtypes=case["input_dtypes"])
        data, feeds = graphs[smoke_name]
        assert data == want, smoke_name
        for a, b in zip(feeds, family_feeds(fam, seed)[run]):
            assert a.dtype == b.dtype and np.array_equal(a, b), smoke_name
    golden = json.loads((REPO / "rapiddoc_tpu_torch/assets/onnx_smoke_golden.json").read_text())
    assert set(golden["graphs"]) == set(graphs)
    for name, (data, feeds) in graphs.items():
        if name == "wired_table_1024":
            continue  # a 1024 x 1024 input: the smoke runs it on the card
        path = tmp_path / f"{name}.onnx"
        path.write_bytes(data)
        chip_smoke.check_graph_outputs(
            name, OnnxTorchFunction.from_file(path, device="cpu")(*feeds), golden["graphs"][name])


def _op_types(nodes) -> set[str]:
    """Op types of encoded nodes, subgraphs included (parsed back)."""
    from rapiddoc_tpu_torch.tools.onnx_reader import _parse_node

    found = set()

    def visit(node):
        found.add(node.op_type)
        for v in node.attrs.values():
            if hasattr(v, "nodes"):
                for n in v.nodes:
                    visit(n)

    for raw in nodes:
        visit(_parse_node(raw))
    return found


def test_every_handler_is_exercised(tmp_path):
    """The port has a handler for every op_* of the JAX interpreter, and
    the cases above run every one of them."""
    from rapiddoc_tpu.engine.onnx_jax import _Executor as JaxExecutor
    from rapiddoc_tpu_torch.engine.onnx_torch import _Executor

    jax_ops = {n[3:] for n in dir(JaxExecutor) if n.startswith("op_")}
    torch_ops = {n[3:] for n in dir(_Executor) if n.startswith("op_")}
    assert len(jax_ops) == 86
    assert torch_ops == jax_ops
    used = set()
    for make in CASES.values():
        used |= _op_types(make()["nodes"])
    for name, seed in FAMILIES:
        used |= _op_types(family_case(name, seed, tmp_path)["nodes"])
    assert jax_ops - used == set()


# ------------------------------------------------------- reader and writer

def test_reader_matches_the_jax_reader(tmp_path):
    """test_onnx_reader.py's hand-built bytes (raw and packed tensors)
    read alike, and every graph of this file parses to the same model."""
    import test_onnx_reader as tr

    from rapiddoc_tpu.tools import onnx_reader as jr
    from rapiddoc_tpu_torch.tools import onnx_reader as pr

    rng = np.random.default_rng(0)
    weights = {
        "conv.weight": rng.standard_normal((8, 3, 3, 3)).astype(np.float32),
        "conv.bias": rng.standard_normal(8).astype(np.float32),
        "fc.weight": rng.standard_normal((4, 8)).astype(np.float32),
        "shape_const": np.array([1, -1], dtype=np.int64),
    }
    graph = b""
    for i, (name, arr) in enumerate(weights.items()):
        graph += tr._field(5, 2, tr._tensor(name, arr, raw=(i % 2 == 0)))
    graph += tr._field(11, 2, tr._value_info("image")) + tr._field(12, 2, tr._value_info("logits"))
    path = tmp_path / "net.onnx"
    path.write_bytes(tr._field(1, 0, 8) + tr._field(7, 2, graph))
    got, want = pr.read_onnx_initializers(path), jr.read_onnx_initializers(path)
    assert set(got) == set(want) == set(weights)
    for k in weights:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        assert np.allclose(got[k].astype(np.float64), weights[k].astype(np.float64))
    assert pr.read_onnx_io_names(path) == jr.read_onnx_io_names(path) == (["image"], ["logits"])

    def same_graph(a, b):
        assert (a.input_names, a.output_names, a.input_shapes) == (
            b.input_names, b.output_names, b.input_shapes)
        assert set(a.initializers) == set(b.initializers)
        for k in a.initializers:
            assert np.array_equal(a.initializers[k], b.initializers[k])
        assert [(n.op_type, n.inputs, n.outputs) for n in a.nodes] == [
            (n.op_type, n.inputs, n.outputs) for n in b.nodes]
        for na, nb in zip(a.nodes, b.nodes):
            assert set(na.attrs) == set(nb.attrs)
            for k in na.attrs:
                if hasattr(na.attrs[k], "nodes"):
                    same_graph(na.attrs[k], nb.attrs[k])
                elif isinstance(na.attrs[k], np.ndarray):
                    assert np.array_equal(na.attrs[k], nb.attrs[k])
                else:
                    assert na.attrs[k] == nb.attrs[k]

    for name in ("loop_traced_exit", "constants", "if_traced_then", "pads"):
        p = write(CASES[name](), tmp_path / f"{name}.onnx")
        same_graph(pr.read_onnx_model(p), jr.read_onnx_model(p))
        assert pr.read_onnx_model(p).opset == jr.read_onnx_model(p).opset == 17
    meta = w.build_model_with_metadata(path.read_bytes(), {"character": "0\n90", "k": "v"})
    (tmp_path / "meta.onnx").write_bytes(meta)
    assert (pr.read_onnx_metadata(tmp_path / "meta.onnx")
            == jr.read_onnx_metadata(tmp_path / "meta.onnx") == {"character": "0\n90", "k": "v"})


def test_writer_bytes_equal_the_jax_writer():
    """For the same graph, the port's writer writes the JAX writer's bytes:
    every case above, the family graphs, and metadata."""
    import rapiddoc_tpu.tools.onnx_writer as jw
    import rapiddoc_tpu_torch.tools.onnx_writer as pw

    assert pw._NP_TO_ONNX == jw._NP_TO_ONNX
    for name, make in CASES.items():
        case = make()
        # rebuild the nodes with the port's writer from the same arguments
        assert pw.build_model(case["nodes"], case["inputs"], case["outputs"], case["inits"],
                              input_dtypes=case["input_dtypes"]) == jw.build_model(
            case["nodes"], case["inputs"], case["outputs"], case["inits"],
            input_dtypes=case["input_dtypes"]), name
    body = pw.SubGraph([pw.encode_node("Add", ["v", "v"], ["v2"]),
                        pw.encode_node("Identity", ["cin"], ["cout"])],
                       inputs={"it": (), "cin": (), "v": (4,)}, outputs={"cout": (), "v2": (1,)},
                       initializers={"k": np.arange(3, dtype=np.int64)},
                       input_dtypes={"it": INT64, "cin": BOOL})
    jbody = jw.SubGraph([jw.encode_node("Add", ["v", "v"], ["v2"]),
                         jw.encode_node("Identity", ["cin"], ["cout"])],
                        inputs={"it": (), "cin": (), "v": (4,)}, outputs={"cout": (), "v2": (1,)},
                        initializers={"k": np.arange(3, dtype=np.int64)},
                        input_dtypes={"it": INT64, "cin": BOOL})
    attrs = {"f": 0.5, "i": 3, "b": True, "s": "x", "t": np.ones((2, 2), np.float16),
             "ints": [1, -2], "floats": [0.5, 1.5], "strs": ["a", "b"]}
    assert pw.encode_node("Loop", ["m"], ["y"], {"body": body, **attrs}, name="n") == \
        jw.encode_node("Loop", ["m"], ["y"], {"body": jbody, **attrs}, name="n")
    model = pw.build_model([], {"x": (1, -1)}, {"y": (2,)}, opset=13)
    assert model == jw.build_model([], {"x": (1, -1)}, {"y": (2,)}, opset=13)
    assert pw.build_model_with_metadata(model, {"a": "b"}) == jw.build_model_with_metadata(
        model, {"a": "b"})


# ----------------------------------------------------------------- Magika

def test_magika_features_equal():
    from rapiddoc_tpu.utils.sniff import magika_features as jax_features
    from rapiddoc_tpu_torch.utils.sniff import magika_features

    for name, data in chip_smoke.magika_corpus().items():
        got, want = magika_features(data), jax_features(data)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for data in (b"", b"   \n\t", b" a" * 3000, bytes(range(256)) * 20):
        assert np.array_equal(magika_features(data), jax_features(data))


def test_magika_on_the_corpus():
    """Magika through both interpreters at its published width on the CPU:
    the same label on every input, scores within 1e-5, the committed
    golden's labels."""
    from rapiddoc_tpu.utils.sniff import magika_classify as jax_classify
    from rapiddoc_tpu_torch.utils import sniff

    golden = json.loads((REPO / "rapiddoc_tpu_torch/assets/onnx_smoke_golden.json").read_text())
    sniff._load.cache_clear()
    corpus = chip_smoke.magika_corpus()
    assert len(corpus) >= 12 and set(corpus) == set(golden["magika"])
    for name, data in corpus.items():
        label, score = sniff.magika_classify(data, device="cpu")
        want_label, want_score = jax_classify(data)
        assert label == want_label == golden["magika"][name]["label"], name
        assert abs(score - want_score) <= 1e-5, (name, score, want_score)
        assert abs(score - golden["magika"][name]["score"]) <= 1e-5, name


# ---------------------------------------------------------------- golden

def build_golden(raw: bool = False) -> dict:
    """The JAX package's outputs for the smoke's onnx phase: Magika's label
    and score on each corpus input, each contract graph's outputs (as
    arrays with ``raw``, else encoded for the JSON file) and the
    wired-table contract's cells and grid."""
    import tempfile

    from rapiddoc_tpu.engine.onnx_jax import OnnxJaxFunction
    from rapiddoc_tpu.tools.onnx_reader import read_onnx_model
    from rapiddoc_tpu.utils.sniff import magika_classify

    out = {"magika": {}, "graphs": {}}
    for name, data in chip_smoke.magika_corpus().items():
        label, score = magika_classify(data)
        out["magika"][name] = {"label": label, "score": score}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (data, feeds) in chip_smoke.onnx_contract_graphs().items():
            p = Path(tmp) / f"{name}.onnx"
            p.write_bytes(data)
            outs = OnnxJaxFunction(read_onnx_model(p))(*feeds)
            out["graphs"][name] = [np.asarray(o) if raw else chip_smoke.encode_array(np.asarray(o))
                                   for o in outs]
        from rapiddoc_tpu.models.table.onnx_models import OnnxWiredTableStructure

        page = np.full((512, 512, 3), 255, np.uint8)
        cells, grid = OnnxWiredTableStructure(Path(tmp) / "wired_table_1024.onnx").batch([page])[0]
        out["wired_structure"] = json.loads(json.dumps([cells, grid]))
    return out


def test_golden_matches_the_jax_package():
    """The committed golden is what build_golden makes now (Magika's
    labels exactly, scores within 1e-5; the graphs' outputs as the
    smoke compares them)."""
    golden = json.loads((REPO / "rapiddoc_tpu_torch/assets/onnx_smoke_golden.json").read_text())
    fresh = build_golden(raw=True)
    assert {k: v["label"] for k, v in fresh["magika"].items()} == {
        k: v["label"] for k, v in golden["magika"].items()}
    assert set(fresh["graphs"]) == set(golden["graphs"])
    for name, outs in fresh["graphs"].items():
        chip_smoke.check_graph_outputs(name, outs, golden["graphs"][name])
    assert fresh["wired_structure"] == golden["wired_structure"]


if __name__ == "__main__":
    path = REPO / "rapiddoc_tpu_torch/assets/onnx_smoke_golden.json"
    path.write_text(json.dumps(build_golden(), indent=1) + "\n")
    print("wrote", path)
