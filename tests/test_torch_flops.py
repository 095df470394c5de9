"""The port's FLOP accounting (``rapiddoc_tpu_torch/engine/flops.py``)
against an independent count from layer shapes and against the JAX
package's ``engine/flops.py``, on the CPU in fp32.

- Each program's per-signature FLOPs (counted by FlopCounterMode on its
  first call, K1 analytic) equal, exactly, 2 x the multiply-adds of every
  convolution and dense layer, attention product and K1's head, computed
  here from the shapes the layers see (forward hooks on the same call).
- The same programs against the JAX package's XLA cost analysis of the
  same models (demo checkpoints) at the same input shapes: the ratio lies
  in RATIO_BAND. Measured on the CPU: ocr_det 0.909, ocr_rec 0.927,
  layout 1.010, table_cls 0.994, table_unet 1.0006, orientation 0.994 (at
  the full-size shapes; the test sizes read within 0.01 of these). XLA
  counts elementwise work (activations, norms, residual adds, softmax) the
  port leaves out, which lifts its count, and leaves out the taps a padded
  convolution spends on its border (a 3x3 SAME convolution on 32 x 32 x 16
  -> 32 counts 9 048 064 against 9 437 184 for 2 x MACs), which lowers
  it: small maps with many 3x3 and depthwise layers (the OCR models) sit
  lowest.
- The autoregressive decodes' extra steps (track_ar_extra) equal the JAX
  package's for the same decode and the decoder census counts equal.
- mfu_report has the JAX package's keys, and no MFU on the CPU.
- A program counts the same whichever head implementation runs.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from rapiddoc_tpu_torch.engine import flops
from rapiddoc_tpu_torch.engine.buckets import BucketSpec
from rapiddoc_tpu_torch.models.common.layers import MHSA, Deconv2x2BNAct
from rapiddoc_tpu_torch.models.layout.rtdetr import DenseGeneral, MSDeformAttn, MultiHeadAttention
from rapiddoc_tpu_torch.models.ocr.det import DBHeadV6
from rapiddoc_tpu_torch.models.ocr.rec import CTCHead

RATIO_BAND = (0.88, 1.04)
F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(4)


@pytest.fixture(autouse=True)
def fresh_costs():
    flops._COSTS.clear()
    flops.reset()
    yield
    flops._COSTS.clear()
    flops.reset()


def layer_flops(mod: nn.Module, inputs: tuple, out) -> int:
    """2 x multiply-adds of one layer call, from its shapes."""
    if isinstance(mod, nn.Conv2d):
        b, co, h, w = out.shape
        kh, kw = mod.kernel_size
        return 2 * b * co * h * w * (mod.in_channels // mod.groups) * kh * kw
    if isinstance(mod, nn.Linear):
        return 2 * (out.numel() // mod.out_features) * mod.in_features * mod.out_features
    if isinstance(mod, Deconv2x2BNAct):  # k2 s2: each output pixel takes Cin taps
        b, co, h, w = out.shape
        return 2 * b * co * h * w * mod.kernel.shape[0]
    if isinstance(mod, DBHeadV6):  # its final k2 s2 deconv, a function call
        b, co, h, w = out.shape
        return 2 * b * co * h * w * mod.final_kernel.shape[0]
    if isinstance(mod, DenseGeneral):
        return 2 * (out.numel() // mod.bias.numel()) * mod.kernel.numel()
    if isinstance(mod, MHSA):  # q k^T and attn v over (B, N, C)
        b, n, c = inputs[0].shape
        return 4 * b * n * n * c
    if isinstance(mod, MultiHeadAttention):
        b, q, c = inputs[0].shape
        return 4 * b * q * inputs[1].shape[1] * c
    if isinstance(mod, MSDeformAttn):  # output_proj, applied by a function call
        b, nq, c = inputs[0].shape
        return 2 * b * nq * c * c
    if isinstance(mod, CTCHead):  # K1: 2 N C V
        b, t, c = inputs[0].shape
        return 2 * b * t * c * mod.kernel.shape[1]
    return 0


class ShapeCount:
    """layer_flops summed over every module call of ``model`` while open,
    and the model's input shape."""

    def __init__(self, model: nn.Module):
        self.total, self.input_shape = 0, None
        self.handles = [m.register_forward_hook(self._hook) for m in model.modules()]
        self.handles.append(model.register_forward_hook(
            lambda m, i, o: setattr(self, "input_shape", tuple(i[0].shape))))

    def _hook(self, mod, inputs, out):
        self.total += layer_flops(mod, inputs, out)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def program_cost(name: str) -> float:
    """The one signature's FLOPs the port recorded for ``name``."""
    (cost,) = [v for k, v in flops._COSTS.items() if k[0] == name]
    return cost["flops"]


def jax_cost(name: str, apply, variables, shape) -> float:
    """The JAX package's flops.cost_report for ``apply(variables, x)``
    at ``shape`` (XLA's analysis of the lowered program)."""
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.engine import flops as jf

    jf._COSTS.clear()
    jf.reset()
    jf.track(name, jax.jit(apply), (variables, jnp.zeros(shape, jnp.float32)))
    return jf.cost_report()[name]["flops"]


def demo_variables(name: str):
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables

    return _load_variables(DEMO_ASSETS_DIR / f"{name}_demo.npz")


def nhwc(shape: tuple) -> tuple:
    return (shape[0], shape[2], shape[3], shape[1])


def _ocr_det(rng):
    from rapiddoc_tpu.models.ocr.det import DBNet
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    det = build_ocr_system(device="cpu", dtype=F32).detector
    with ShapeCount(det.session.module) as sc:
        det._detect([rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)])
    return sc, lambda v, x: DBNet().apply(v, x), demo_variables("ocr_det"), sc.input_shape


def _ocr_rec(rng):
    from rapiddoc_tpu.models.ocr.rec import SVTRRec
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    rec = build_ocr_system(device="cpu", dtype=F32).recognizer
    rec.session.bucket_spec = BucketSpec(heights=(48,), widths=(160,), batch_sizes=(2,))
    with ShapeCount(rec.session.module) as sc:
        rec([rng.integers(0, 256, (48, 150, 3), dtype=np.uint8)])
    return (sc, lambda v, x: SVTRRec(num_classes=96).apply(v, x), demo_variables("ocr_rec"),
            sc.input_shape)


def _layout(rng):
    import json

    from rapiddoc_tpu.models.layout.rtdetr import RTDETR
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR
    from rapiddoc_tpu_torch.models.layout.engine import LayoutConfig, LayoutDetector
    from rapiddoc_tpu_torch.models.weights import load_flax_into, load_npz

    arch = json.loads((DEMO_ASSETS_DIR / "layout_demo.json").read_text())
    assert not arch["with_masks"]
    cfg = LayoutConfig(model_size=arch["model_size"], input_size=320,
                       num_queries=arch["num_queries"], dec_layers=arch["dec_layers"],
                       with_masks=arch["with_masks"])
    model = load_flax_into(LayoutDetector.make_model(cfg),
                           load_npz(DEMO_ASSETS_DIR / "layout_demo.npz"))
    det = LayoutDetector(model, cfg, device="cpu", dtype=F32)
    with ShapeCount(det.session.module) as sc:
        det.batch_predict([rng.integers(0, 256, (400, 300, 3), dtype=np.uint8)])
    apply = lambda v, x: RTDETR(num_classes=25, backbone_size=cfg.model_size,  # noqa: E731
                                num_queries=cfg.num_queries, dec_layers=cfg.dec_layers).apply(v, x)
    return sc, apply, demo_variables("layout"), sc.input_shape


def _tables():
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer

    return TableRecognizer.build({}, device="cpu", dtype=F32)


def _table_cls(rng):
    from rapiddoc_tpu.models.table.cls import TableClsNet

    clf = _tables().classifier
    with ShapeCount(clf.model) as sc:
        clf([rng.integers(0, 256, (120, 200, 3), dtype=np.uint8)])
    return sc, lambda v, x: TableClsNet().apply(v, x), demo_variables("table_cls"), nhwc(
        sc.input_shape)


def _table_unet(rng):
    from rapiddoc_tpu.models.table.unet import UNet
    from rapiddoc_tpu_torch.models.ocr.pre_post import pack_nibbles, to_luma

    wired = _tables().wired
    assert wired.nibble_wire
    # the engine's dispatch at a test size (the program takes any size)
    small = pack_nibbles(to_luma(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)))[..., 0]
    with ShapeCount(wired.model) as sc:
        wired.finish([np.zeros((64, 64, 3), np.uint8)], wired.dispatch([small]))
    return sc, lambda v, x: UNet().apply(v, x), demo_variables("table_unet"), nhwc(
        sc.input_shape)


def _orientation(rng):
    from rapiddoc_tpu.models.orientation.engine import OrientationNet
    from rapiddoc_tpu_torch.models.orientation.engine import OrientationClassifier, OrientationNet as T
    from rapiddoc_tpu_torch.models.registry import DEMO_ASSETS_DIR
    from rapiddoc_tpu_torch.models.weights import load_flax_into, load_npz

    clf = OrientationClassifier(
        load_flax_into(T(), load_npz(DEMO_ASSETS_DIR / "orientation_demo.npz")),
        device="cpu", dtype=F32)
    with ShapeCount(clf.session.module) as sc:
        clf([rng.integers(0, 256, (120, 90, 3), dtype=np.uint8) for _ in range(3)])
    return sc, lambda v, x: OrientationNet().apply(v, x), demo_variables("orientation"), \
        sc.input_shape


PROGRAMS = {"ocr_det": _ocr_det, "ocr_rec": _ocr_rec, "layout": _layout,
            "table_cls": _table_cls, "table_unet": _table_unet, "orientation": _orientation}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_flops_equal_shape_count_and_track_xla(name):
    sc, apply, variables, shape = PROGRAMS[name](np.random.default_rng(0))
    got = program_cost(name)
    assert sc.total > 0 and got == sc.total
    rep = flops.cost_report()[name]
    assert rep["calls"] == 1 and rep["flops"] == got and rep["analyzed"] == 1
    ratio = got / jax_cost(name, apply, variables, shape)
    assert RATIO_BAND[0] <= ratio <= RATIO_BAND[1], ratio


def test_second_call_reuses_the_cost():
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    det = build_ocr_system(device="cpu", dtype=F32).detector
    img = np.random.default_rng(1).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    det._detect([img])
    first = flops.cost_report()["ocr_det"]
    det._detect([img])
    second = flops.cost_report()["ocr_det"]
    assert second["calls"] == 2 and second["flops"] == 2 * first["flops"]
    assert second["bytes"] == 2 * first["bytes"] > flops.nbytes(det.session.module)
    assert det.session.stats.compiles == 1


def _numpy_head(x, kernel, bias):
    """K1's function in numpy: invisible to the dispatcher, as the kernel is."""
    logits = x.float().numpy() @ kernel.float().numpy() + bias.float().numpy()
    ids = logits.argmax(-1)
    p = 1.0 / np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)
    return torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(p.astype(np.float32))


def test_rec_count_independent_of_the_head_implementation(monkeypatch):
    from rapiddoc_tpu_torch.models.registry import build_ocr_system
    from rapiddoc_tpu_torch.ops import ctc_head

    crop = np.random.default_rng(2).integers(0, 256, (48, 150, 3), dtype=np.uint8)
    counts = []
    for head in (None, _numpy_head):
        if head is not None:
            monkeypatch.setattr(ctc_head, "ctc_argmax_plain", head)
        flops._COSTS.clear()
        rec = build_ocr_system(device="cpu", dtype=F32).recognizer
        rec.session.bucket_spec = BucketSpec(heights=(48,), widths=(160,), batch_sizes=(2,))
        rec([crop])
        counts.append(program_cost("ocr_rec"))
    assert counts[0] == counts[1]
    n, c, v = 2 * 20, 120, 96  # 160 / 8 frames a row
    with flops.counting() as count:
        ctc_head.fused_ctc_argmax(torch.zeros(n, c), torch.zeros(c, v), torch.zeros(v))
    assert count.flops == 2 * n * c * v


def _formula_crops():
    from test_torch_formula_golden import load_crops

    return load_crops()[:2]


@pytest.fixture(scope="module")
def formula_rec():
    from rapiddoc_tpu_torch.models.registry import build_formula_recognizer

    return build_formula_recognizer(device="cpu", dtype=F32)


def test_formula_count_independent_of_the_head(monkeypatch, formula_rec):
    """The plain lm_head (seen by the dispatcher) and K2's wrapper over a
    numpy head the dispatcher cannot see (as it cannot see the kernel):
    one count. K2's plain torch version runs uncounted."""
    from rapiddoc_tpu_torch.ops import quant_head

    def numpy_int8(x, wq, scale, bias):
        logits = (x.float().numpy() @ wq.float().numpy()) * scale.numpy() + bias.numpy()
        return torch.from_numpy(logits.argmax(-1).astype(np.int32)), torch.ones(len(logits))

    counts = []
    for int8 in (False, True):
        if int8:
            monkeypatch.setattr(quant_head, "quant_argmax_plain", numpy_int8)
        flops._COSTS.clear()
        formula_rec.int8_head = int8
        formula_rec.batch_predict(_formula_crops()[:1], length_bucket=8)
        counts.append(program_cost("formula"))
    formula_rec.int8_head = None
    assert counts[0] == counts[1]
    monkeypatch.undo()
    n, k, v = 4, 512, 57
    with flops.counting() as count:
        quant_head.fused_argmax_int8(torch.zeros(n, k), torch.zeros(k, v, dtype=torch.int8),
                                     torch.ones(v), torch.zeros(v))
    assert count.flops == 2 * n * k * v


def _jax_ar(name: str, steps: float, batch: int, params: float, param_bytes: float) -> dict:
    """The JAX package's track_ar_extra total for one decode."""
    from rapiddoc_tpu.engine import flops as jf

    jf.reset()
    jf.track_ar_extra(name, steps=steps, batch=batch, dec_params=params,
                      dec_param_bytes=param_bytes)
    return dict(jf._AR_EXTRA[name])


@pytest.fixture
def fp32_params():
    from test_torch_formula_golden import _held_env

    with _held_env(RAPIDDOC_FP32_PARAMS="1"):
        yield


def test_formula_ar_extra_and_census_equal_jax(fp32_params, formula_rec):
    from rapiddoc_tpu.models.formula.engine import FormulaRecognizer as J

    rec = formula_rec
    steps0 = rec.stats.realized_steps
    rec.batch_predict(_formula_crops(), length_bucket=24)
    jrec = J.build({})
    assert (rec._dec_params, rec._dec_param_bytes) == (jrec._dec_params, jrec._dec_param_bytes)
    steps = rec.stats.realized_steps - steps0
    assert steps > 1
    want = _jax_ar("formula", float(steps), 4, jrec._dec_params, jrec._dec_param_bytes)
    assert flops._AR_EXTRA["formula"] == want
    assert flops.cost_report()["formula"]["ar_analytic"]


@pytest.mark.parametrize("strategy", ["unet_slanet_plus", "unet_unitable"])
def test_table_ar_extra_and_census_equal_jax(fp32_params, strategy):
    from rapiddoc_tpu.models.table.engine import TableRecognizer as J
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer

    wireless = TableRecognizer.build({"strategy": strategy}, device="cpu", dtype=F32).wireless
    jwire = J.build({"strategy": strategy}).wireless
    name = f"table_{wireless.name}"
    crop = np.full((60, 90, 3), 255, np.uint8)
    crop[::12] = 0
    crop[:, ::30] = 0
    lengths, run = [], wireless.run

    def spy(*args):  # the decode's realized length: its largest
        out = run(*args)
        lengths.append(int(out[-1].max()))
        return out

    wireless.run = spy
    wireless([crop], max_len=24) if strategy == "unet_unitable" else wireless([crop])
    attrs = ("_dec_params", "_dec_param_bytes") if strategy == "unet_unitable" else (
        "_step_params", "_step_param_bytes")
    census = [getattr(wireless, a) for a in attrs]
    assert census == [getattr(jwire, a) for a in attrs]
    assert len(lengths) == 1 and lengths[0] > 1
    assert flops._AR_EXTRA[name] == _jax_ar(name, float(lengths[0]), 4, *census)


def test_mfu_report_keys_equal_jax_and_no_mfu_on_the_cpu():
    from rapiddoc_tpu.engine import flops as jf

    jf._COSTS.clear()
    jf.reset()
    for mod in (jf, flops):
        mod._COSTS[("ocr_rec", ("s",))] = {"flops": 4e9, "bytes": 1e6}
        mod.count("ocr_rec", ("s",), 2.0)
    want = jf.mfu_report({"ocr_rec": 0.5}, {"ocr_rec": "ocr_rec"})
    got = flops.mfu_report({"ocr_rec": 0.5}, {"ocr_rec": "ocr_rec"}, device="cpu")
    assert set(got) == set(want)
    assert set(got["stages"]["ocr_rec"]) == set(want["stages"]["ocr_rec"])
    stage = got["stages"]["ocr_rec"]
    assert stage["gflops"] == 8.0 and stage["achieved_tflops"] == 8e9 / 0.5 / 1e12
    assert stage["mfu"] is None and stage["compute_bound_ms"] is None
    assert got["mfu_total"] is None and got["chip_peak_tflops_bf16"] is None
    assert "mfu is None" in got["note"]
    assert set(flops.cost_report()["ocr_rec"]) == set(jf.cost_report()["ocr_rec"])
    jf._COSTS.clear()
    jf.reset()


def test_peaks_name_no_tpu_figure():
    """Each peak is an H100's (NVIDIA's datasheet), keyed by the name
    torch.cuda.get_device_name() gives; none is the JAX package's v5e
    constant."""
    from rapiddoc_tpu.engine import flops as jf

    assert flops.PEAKS == {"NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12)}
    assert all(p != jf.CHIP_PEAK_FLOPS for p, _ in flops.PEAKS.values())
    assert flops.device_peaks("cpu") is None


def test_nested_programs_count_for_themselves():
    a, b = nn.Linear(8, 8), nn.Linear(8, 4)
    x = torch.zeros(3, 8)

    def outer(t):
        return b(flops.track("inner", a, (t,), sig=("i",)))

    flops.track("outer", outer, (x,), sig=("o",))
    assert program_cost("inner") == 2 * 3 * 8 * 8
    assert program_cost("outer") == 2 * 3 * 8 * 4
    with flops.counting() as c:
        with flops.uncounted():
            a(x)
        flops.add_flops(10)
    assert c.flops == 10


def test_maybe_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    """utils/trace.maybe_profile: nothing without RAPIDDOC_PROFILE[_DIR],
    a torch.profiler Chrome trace of the block in RAPIDDOC_PROFILE_DIR."""
    import json

    from rapiddoc_tpu_torch.utils.trace import maybe_profile

    monkeypatch.delenv("RAPIDDOC_PROFILE", raising=False)
    monkeypatch.delenv("RAPIDDOC_PROFILE_DIR", raising=False)
    with maybe_profile():
        torch.zeros(4, 4) @ torch.zeros(4, 4)
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("RAPIDDOC_PROFILE_DIR", str(tmp_path))
    with maybe_profile():
        torch.zeros(4, 4) @ torch.zeros(4, 4)
    (trace,) = tmp_path.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


GOLDEN = Path(__file__).resolve().parent.parent / "rapiddoc_tpu_torch" / "assets" / \
    "accounting_golden.json"


def test_accounting_golden_names_the_main_path_programs():
    """The committed golden of chip_smoke.py's accounting phase (the fp32
    parse of its 16 pages, counted by the port on the CPU) holds every
    program of the main path, each with whole calls."""
    import json

    golden = json.loads(GOLDEN.read_text())
    assert golden["pages"] == 16
    programs = golden["programs"]
    assert set(programs) == {"layout", "ocr_det", "ocr_rec", "formula", "table_cls",
                             "table_unet", "table_slanet"}
    for cost in programs.values():
        assert cost["flops"] > 0 and cost["calls"] >= 1 and cost["calls"] == int(cost["calls"])


def write_golden() -> None:
    """``python tests/test_torch_flops.py --golden``: the port's fp32
    parse of chip_smoke.py's accounting corpus on the CPU, its FLOPs and
    calls per program, into rapiddoc_tpu_torch/assets/accounting_golden.json
    (about 2 minutes)."""
    import json
    import sys

    sys.path.insert(0, str(GOLDEN.parents[2]))
    import chip_smoke

    programs = chip_smoke.accounting_fp32_costs("cpu")
    GOLDEN.write_text(json.dumps({
        "source": "rapiddoc_tpu_torch on the CPU in fp32: RapidDoc(device='cpu', "
                  "dtype=torch.float32) on chip_smoke.accounting_pdf() (the layout "
                  "fixture's four pages and twelve synth-text pages) with the demo layout, "
                  "formula and table stages, "
                  "engine/flops.cost_report(); rebuilt by python tests/test_torch_flops.py "
                  "--golden",
        "pages": chip_smoke.ACCOUNTING_PAGES, "programs": programs,
    }, indent=1) + "\n")


if __name__ == "__main__":
    import sys

    if "--golden" in sys.argv:
        write_golden()
