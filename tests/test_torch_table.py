"""The port's table stage (``rapiddoc_tpu_torch/models/table/``) against the
JAX package's, on the CPU.

Each module at a small depth and width with JAX random weights carried
over by the port's converter (``models/weights.py``), the same numpy
inputs from a seed: the UNet, the classifier, the SLANet backbone, neck
and decode step (the GRU gate mapping), the UniTable encoder and decoder,
and the ``sla_decode`` / ``unitable_decode`` token streams; the UNet's
8-bit wire on two of the layout fixture's table crops
(``rapiddoc_tpu_torch/assets/table_smoke_crops.npz``). The host pieces
(matcher, select, img2table, formula and image injection) on synthetic
grids. The demo checkpoints on all 15 crops are held against the JAX
package's stored outputs in ``test_torch_pipeline_table.py``, which
reuses the UNet's bits of its fp32 parse.

``python tests/test_torch_table.py`` rebuilds
``table_smoke_crops.npz`` and ``table_smoke_golden.json`` with the JAX
package (about 4 minutes on 8 cores): the crops are the fp32 layout's
table regions of ``layout_smoke_doc.pdf``; the golden holds the JAX
package's ``RapidDoc()(pdf, parse_method="ocr")`` with
``RAPIDDOC_DEMO_LAYOUT=1`` and the table stage on, in fp32 and in bf16
with the int8 formula head, and its per-stage outputs on the crops in
fp32 and bf16. ``--compare`` prints the port's bf16 readings on the CPU
against them (the source of ``chip_smoke.py``'s table bands).
"""
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
DOC_PDF = ASSETS / "layout_smoke_doc.pdf"
CROPS_NPZ = ASSETS / "table_smoke_crops.npz"
GOLDEN_JSON = ASSETS / "table_smoke_golden.json"
STAGE_MODES = ("fp32", "bf16")
PARSE_MODES = ("fp32", "bf16_int8")
UNITABLE_MAX_LEN = 256
# the UNet's fp32 line decision: a bit may differ from the JAX package's
# only where |l1 - l0| is below this (summation order of two frameworks)
UNET_TIE = 1e-3
# SLANet's fp32 boxes (sigmoid quads times 488 / ratio), px
SLANET_BOX_TOL = 0.01


def mask_uuids(obj, model_json: list[dict]):
    """``obj`` with the uuid of every in-table image placeholder of
    ``model_json`` (drawn from uuid4 in ``_run_tables``) replaced by a
    fixed word."""
    text = json.dumps(obj)
    for page in model_json:
        for det in page["layout_dets"]:
            for fill in det.get("fill_images", []):
                text = text.replace(fill["uuid"], "<uuid>")
    return json.loads(text)


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


# ----------------------------------------------------------------- golden


def _pipeline_helpers():
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_pipeline_layout as pl

    return pl


class table_env:
    """The demo layout on, the table stage on, every other RAPIDDOC_* /
    MINERU_* setting held off, plus ``extra``."""

    def __init__(self, **extra: str):
        self.extra = extra

    def __enter__(self):
        self.saved = {k: v for k, v in os.environ.items()
                      if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in self.saved:
            del os.environ[k]
        os.environ["RAPIDDOC_DEMO_LAYOUT"] = "1"
        os.environ.update(self.extra)
        return self

    def __exit__(self, *exc):
        for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
            del os.environ[k]
        os.environ.update(self.saved)


def tables_of(model_json: list[dict]) -> list[str]:
    """Every table det's HTML, in page and det order ("" where none)."""
    return [d.get("html", "") for page in model_json for d in page["layout_dets"]
            if d["category_id"] == 5]


def parse_summary(out) -> dict:
    pl = _pipeline_helpers()
    got = pl.summary(out)
    got["tables"] = tables_of(out.model_json)
    return mask_uuids(got, out.model_json)


def jax_parse(pdf: bytes, mode: str, window: int | None = None) -> tuple[dict, list]:
    """The JAX package's parse in ``mode`` with the table stage on, and
    its model_json (uuids masked)."""
    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    pl = _pipeline_helpers()
    extra = pl.mode_env(mode)
    if window is not None:
        extra["RAPIDDOC_PROCESSING_WINDOW_SIZE"] = str(window)
    with table_env(**extra):
        ModelStack._instances.clear()
        rapid = RapidDoc()
        analyzer = ModelStack.get("ch", True, True, {
            "layout": {}, "ocr": {}, "formula": {}, "table": {}, "checkbox": {}}).analyzer
        assert analyzer.table_model is not None and analyzer.table_model.ocr is None
        if mode.endswith("int8"):
            assert analyzer.formula_model._int8_head() is not None
        out = rapid(pdf, parse_method="ocr")
        ModelStack._instances.clear()
    return parse_summary(out), mask_uuids(pl.plain(out.model_json), out.model_json)


def golden_crops(pdf: bytes, model_json: list) -> tuple[list[np.ndarray], list]:
    """The table regions of ``model_json`` cut from the JAX package's
    rendered pages, as ``_run_tables`` cuts them."""
    pl = _pipeline_helpers()
    pages = pl.jax_pages(pdf)
    crops, where = [], []
    for i, page in enumerate(model_json):
        for d in page["layout_dets"]:
            if d["category_id"] != 5:
                continue
            x0, y0, _, _, x1, y1, _, _ = d["poly"]
            crops.append(np.ascontiguousarray(
                pages[i][max(int(y0), 0):int(y1) + 1, max(int(x0), 0):int(x1) + 1]))
            where.append([i, x0, y0, x1, y1])
    return crops, where


def jax_stages(crops: list[np.ndarray], mode: str) -> tuple[dict, dict]:
    """The JAX package's table models (demo checkpoints) on ``crops`` in
    ``mode``: (arrays, JSON-ready lists)."""
    import jax.numpy as jnp

    from rapiddoc_tpu.engine.buckets import batch_chunks, pad_rows
    from rapiddoc_tpu.models.table.engine import TableRecognizer

    env = {"RAPIDDOC_FP32_PARAMS": "1"} if mode == "fp32" else {}
    arrays, lists = {}, {}
    with table_env(**env):
        rec = TableRecognizer.build({})
        uni = TableRecognizer.build({"strategy": "unet_unitable"}).wireless
        clf, wired, sla = rec.classifier, rec.wired, rec.wireless
        import cv2

        batch = np.stack([cv2.resize(c, (224, 224)) for c in crops] + [
            np.zeros((224, 224, 3), np.uint8)])
        arrays["cls_probs"] = np.asarray(clf._fwd(clf.variables, jnp.asarray(batch)))[:len(crops)]
        lists["kinds"] = clf(crops)
        from rapiddoc_tpu.models.ocr.pre_post import pack_nibbles, to_luma

        prepped = [pack_nibbles(to_luma(cv2.resize(c, (1024, 1024))))[..., 0] for c in crops]
        bits = []
        for s, e, padded in batch_chunks(len(prepped), sizes=(1, 2, 4)):
            out = np.asarray(wired._fwd(wired.variables, jnp.asarray(
                pad_rows(np.stack(prepped[s:e]), padded))))
            bits.append(out[: e - s])
        arrays["unet_bits"] = np.concatenate(bits)
        structs = wired.batch(crops)
        lists["cells"] = [c for c, _ in structs]
        lists["grid"] = [g for _, g in structs]
        fn = sla._compiled()
        imgs = np.stack([sla._preprocess(c) for c in crops])
        t, loc, n = fn(sla.variables["backbone"], sla.variables["neck"],
                       sla.variables["fea_key"], sla.variables["step"],
                       jnp.asarray(pad_rows(imgs, 16)))
        arrays["slanet_tokens"] = np.asarray(t)[: len(crops)]
        arrays["slanet_locs"] = np.asarray(loc)[: len(crops)]
        arrays["slanet_lengths"] = np.asarray(n)[: len(crops)]
        lists["slanet"] = sla(crops)
        fn = uni._compiled(UNITABLE_MAX_LEN)
        imgs = np.stack([cv2.resize(c, (448, 448)) for c in crops])
        t, n = fn(uni.variables["encoder"], uni.variables["decoder"],
                  uni.variables["mem_proj"], jnp.asarray(pad_rows(imgs, 16)))
        arrays["unitable_tokens"] = np.asarray(t)[: len(crops)]
        arrays["unitable_lengths"] = np.asarray(n)[: len(crops)]
        lists["unitable"] = uni(crops, max_len=UNITABLE_MAX_LEN)
        lists["html"] = rec.batch_predict(crops)
    return arrays, _pipeline_helpers().plain(lists)


def make_assets(pdf: bytes) -> tuple[dict, dict]:
    """(npz arrays, golden JSON) rebuilt with the JAX package."""
    pl = _pipeline_helpers()
    golden = {
        "source": "rapiddoc_tpu RapidDoc()(pdf, parse_method='ocr') on the CPU with "
                  "RAPIDDOC_DEMO_LAYOUT=1 and the table stage on, on layout_smoke_doc.pdf, "
                  "and its table models on the fp32 layout's table crops; rebuilt by "
                  "tests/test_torch_table.py",
        "page_sha256": [sha256(p) for p in pl.jax_pages(pdf)],
    }
    for mode in PARSE_MODES:
        golden[mode], model_json = jax_parse(pdf, mode)
        if mode == "fp32":
            golden[mode]["model_info"] = model_json
            crops, where = golden_crops(pdf, model_json)
    one, _ = jax_parse(pdf, "fp32", window=1)
    golden["fp32_window1_equal"] = one == {k: v for k, v in golden["fp32"].items()
                                           if k != "model_info"}
    arrays = {f"crop_{i}": c for i, c in enumerate(crops)}
    golden["crops"] = {"regions": where, "sha256": [sha256(c) for c in crops]}
    golden["stages"] = {}
    for mode in STAGE_MODES:
        a, lists = jax_stages(crops, mode)
        arrays.update({f"{mode}/{k}": v for k, v in a.items()})
        golden["stages"][mode] = lists
    return arrays, golden


# ------------------------------------------------------------- fixtures


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs: the tier-1
    command runs six test processes on the machine's cores, and the
    1024x1024 UNet forwards here would oversubscribe them."""
    yield from capped_threads(4)


def capped_threads(n: int):
    """See ``tests/torch_threads.py``: at most ``n`` threads, and a share of
    the cores under xdist."""
    from torch_threads import capped_threads as capped

    yield from capped(n)


@pytest.fixture(scope="module")
def stored() -> dict:
    with np.load(CROPS_NPZ) as z:
        return dict(z)


def crops_of(stored: dict) -> list[np.ndarray]:
    n = sum(1 for k in stored if k.startswith("crop_"))
    return [stored[f"crop_{i}"] for i in range(n)]



# ------------------------------------------------ modules, random weights

TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 summation order only


def flatten(tree, prefix: str = "") -> dict:
    """A flax variables tree -> flat ``a/b/c`` float32 arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = v if hasattr(v, "shape") and not hasattr(v, "__array__") else (
                np.asarray(v, np.float32))
    return out


def numpy_init(module, rng, *args) -> dict:
    """Flat random variables for a flax ``module`` called on ``args``:
    the shapes from ``jax.eval_shape`` (no initializer is compiled), the
    values from ``rng`` (1/sqrt(fan_in) normals for kernels, 0.02 for
    embeddings and positions, 0.1 for biases, non-trivial BatchNorm and
    LayerNorm affines and statistics)."""
    import jax

    shapes = flatten(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args))
    out = {}
    for key, leaf in shapes.items():
        shape, name = tuple(leaf.shape), key.rsplit("/", 1)[-1]
        if name == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
        elif name in ("embedding", "pos_embed"):
            std = 0.02 if name == "pos_embed" else 1.0
        else:
            std = 0.1
        val = rng.standard_normal(shape).astype(np.float32) * np.float32(std)
        if name in ("scale", "var"):
            val = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        out[key] = val
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def nchw(x: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_unet_matches_jax_small():
    """UNet(base=4, depth=2) at 64x64: logits within 1e-4, including
    the raw 2x2 SAME upconv (pad 0 before, 1 after)."""
    import torch

    from rapiddoc_tpu.models.table.unet import UNet as JUNet
    from rapiddoc_tpu_torch.models.table.unet import UNet
    from rapiddoc_tpu_torch.models.weights import load_flax_into

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = JUNet(base=4, depth=2)
    flat = numpy_init(jm, rng, x)
    want = np.asarray(jm.apply(unflatten(flat), x))
    tm = load_flax_into(UNet(base=4, depth=2), flat).eval()
    with torch.no_grad():
        got = tm(nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_cls_net_matches_jax():
    import torch

    from rapiddoc_tpu.models.table.cls import TableClsNet as JNet
    from rapiddoc_tpu_torch.models.table.cls import TableClsNet
    from rapiddoc_tpu_torch.models.weights import load_flax_into

    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (3, 64, 96, 3)).astype(np.float32)
    jm = JNet()
    flat = numpy_init(jm, rng, x)
    want = np.asarray(jm.apply(unflatten(flat), x))
    tm = load_flax_into(TableClsNet(), flat).eval()
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_slanet_backbone_and_neck_match_jax():
    """SLANetBackbone(scale=0.25) + PANNeck(16) at 96x112: the neck's
    output level (its [:H, :W] crops after the upsample and the strided
    convs on odd sizes) within 1e-4."""
    import torch

    from rapiddoc_tpu.models.table import slanet as J
    from rapiddoc_tpu_torch.models.table import slanet as T
    from rapiddoc_tpu_torch.models.weights import load_flax_into

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 96, 112, 3)).astype(np.float32)
    jb, jn = J.SLANetBackbone(0.25), J.PANNeck(16)
    bb = numpy_init(jb, rng, x)
    feats = jb.apply(unflatten(bb), x)
    nk = numpy_init(jn, rng, feats)
    want = np.asarray(jn.apply(unflatten(nk), feats))
    tb = load_flax_into(T.SLANetBackbone(0.25), bb).eval()
    tn = load_flax_into(T.PANNeck(tb.channels, 16), nk).eval()
    with torch.no_grad():
        got = tn(tb(nchw(x))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _sla_step_pair(vocab=12, hidden=32, fea_ch=16, s=20, seed=4):
    from rapiddoc_tpu.models.table import slanet as J
    from rapiddoc_tpu_torch.models.table import slanet as T
    from rapiddoc_tpu_torch.models.weights import load_flax_into

    rng = np.random.default_rng(seed)
    fea = rng.standard_normal((3, s, fea_ch)).astype(np.float32)
    js, jk = J.SLAHeadStep(vocab, hidden), J.FeaKey(hidden)
    kflat = numpy_init(jk, rng, fea)
    sflat = numpy_init(js, rng, np.zeros((1, hidden), np.float32), np.zeros((1,), np.int32),
                       fea[:1], np.zeros((1, s, hidden), np.float32))
    kv, sv = unflatten(kflat), unflatten(sflat)
    ts = load_flax_into(T.SLAHeadStep(vocab, hidden, fea_ch), sflat).eval()
    tk = load_flax_into(T.FeaKey(fea_ch, hidden), kflat).eval()
    return (js, sv, jk, kv), (ts, tk), fea, rng


def test_sla_step_gru_gates_match_flax():
    """One decode step: the GRU's new hidden state, logits and loc
    within 1e-4 of flax's GRUCell (ir/iz/in biased, hr/hz not, hn
    biased) through the converter's gate mapping."""
    import torch

    (js, sv, jk, kv), (ts, tk), fea, rng = _sla_step_pair()
    h = rng.standard_normal((3, 32)).astype(np.float32)
    tok = np.array([0, 5, 11], np.int32)
    key = np.asarray(jk.apply(kv, fea))
    want = [np.asarray(a) for a in js.apply(sv, h, tok, fea, key)]
    with torch.no_grad():
        tkey = tk(torch.from_numpy(fea))
        np.testing.assert_allclose(tkey.numpy(), key, **TOL)
        got = [a.numpy() for a in ts(torch.from_numpy(h), torch.from_numpy(tok).long(),
                                      torch.from_numpy(fea), tkey)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_sla_decode_token_stream_matches_jax():
    """sla_decode on random weights: tokens and lengths equal, locs
    within 1e-4, with the done rows writing eos and a zero loc."""
    import torch

    from rapiddoc_tpu.models.table import slanet as J
    from rapiddoc_tpu_torch.models.table import slanet as T

    (js, sv, jk, kv), (ts, tk), fea, _ = _sla_step_pair(vocab=6, seed=7)
    want = [np.asarray(a) for a in J.sla_decode(js, sv, jk, kv, fea, 0, 5, 24)]
    tokens, locs, lengths, steps = T.sla_decode(ts, tk, torch.from_numpy(fea), 0, 5, 24)
    np.testing.assert_array_equal(tokens.numpy(), want[0])
    np.testing.assert_array_equal(lengths.numpy(), want[2])
    np.testing.assert_allclose(locs.numpy(), want[1], **TOL)
    assert steps == max(int(want[2].max()), 1) or steps == 24


def _unitable_pair(seed=5):
    from rapiddoc_tpu.models.formula.decoder import MemoryProjector as JMem
    from rapiddoc_tpu.models.table import unitable as J
    from rapiddoc_tpu_torch.models.table import unitable as T
    from rapiddoc_tpu_torch.models.weights import load_flax_into, nest_models

    dims = J.UniTableDims(enc_d=64, enc_layers=2, dec_d=128, dec_layers=2, dec_ffn=96)
    enc = J.UniTableEncoder(d_model=64, layers=2, heads=1)
    dec, mem = J.GPTFastDecoder(cfg=dims), JMem(dims)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (2, 64, 80, 3)).astype(np.float32)
    s = (64 // 16) * (80 // 16)
    hd = 64
    enc_v = unflatten(numpy_init(enc, rng, x))
    memory = np.asarray(enc.apply(enc_v, x))
    # the decoder reads d_model-wide memory
    mem_in = np.concatenate([memory, memory], axis=-1)
    mem_v = unflatten(numpy_init(mem, rng, mem_in))
    dec_v = unflatten(numpy_init(
        dec, rng, np.zeros((1, 1), np.int32),
        np.zeros((2, 1, 8, 2, hd), np.float32), np.zeros((2, 1, 8, 2, hd), np.float32),
        0, np.zeros((2, 1, s, 2, hd), np.float32), np.zeros((2, 1, s, 2, hd), np.float32),
        np.ones((1, s), bool)))
    flat = {}
    for name, v in (("encoder", enc_v), ("decoder", dec_v), ("mem_proj", mem_v)):
        flat.update({f"{name}/{k}": a for k, a in flatten(v).items()})
    tdims = T.dims_from_variables(flat)
    assert tdims == T.UniTableDims(enc_d=64, enc_layers=2, dec_d=128, dec_layers=2, dec_ffn=96)
    tm = load_flax_into(T.UniTableModel(tdims), nest_models(flat)).eval()
    return (enc, enc_v, dec, dec_v, mem, mem_v, dims), tm, x, mem_in


def test_unitable_encoder_matches_jax():
    """Patchify conv, learned positions, exact-GELU blocks, LayerNorm eps
    1e-5: the memory within 1e-4."""
    import torch

    (enc, enc_v, *_), tm, x, mem_in = _unitable_pair()
    want = np.asarray(enc.apply(enc_v, x))
    with torch.no_grad():
        got = tm.encoder(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_unitable_decode_token_stream_matches_jax():
    """unitable_decode on random weights (FusedCachedAttention, the
    formula decoder's CrossAttention and MemoryProjector): tokens and
    lengths equal, with the whitelist, the forced ]</td> after the fifth
    bbox token in a row, PAD after done, and the bf16 KV caches of the
    JAX package's default."""
    import torch

    from rapiddoc_tpu.models.table import unitable as J
    from rapiddoc_tpu_torch.models.table import unitable as T

    (_, _, dec, dec_v, mem, mem_v, dims), tm, _, mem_in = _unitable_pair()
    # steer the generator to bbox tokens so the grammar forcing runs
    gen = dec_v["params"]["generator"]
    bias = np.asarray(gen["bias"]).copy()
    bias[T.BBOX_BASE:T.BBOX_BASE + 40] += 3.0
    dec_v = {"params": {**dec_v["params"], "generator": {**gen, "bias": bias}}}
    with torch.no_grad():
        tm.decoder.generator.bias.copy_(torch.from_numpy(bias))
    import jax.numpy as jnp

    want_t, want_n = (np.asarray(a) for a in J.unitable_decode(
        dec, dec_v, mem, mem_v, jnp.asarray(mem_in), 20))
    got_t, got_n, _ = T.unitable_decode(tm.decoder, tm.mem_proj, torch.from_numpy(mem_in), 20)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    assert (want_t == T.BBOX_CLOSE_ID).any()


# ------------------------------------------------------------ host code


def _grid_image(rows=(20, 60, 100, 140), cols=(15, 90, 170, 250), size=(160, 270),
                thick=2, merge=None) -> np.ndarray:
    img = np.full((*size, 3), 255, np.uint8)
    for y in rows:
        img[y:y + thick, cols[0]:cols[-1] + thick] = 0
    for x in cols:
        img[rows[0]:rows[-1] + thick, x:x + thick] = 0
    if merge is not None:
        y0, y1, x0, x1 = merge
        img[y0:y1, x0:x1] = 255
    return img


@pytest.mark.parametrize("merge", [None, (62, 99, 92, 169)])
def test_img2table_and_cls_heuristic_match_jax(merge):
    """ruling_line_mask, opencv_table_extract (cells and grid, a merged
    cell included) and heuristic_table_kind equal the JAX package's on a
    drawn grid, and the kind on a blank crop."""
    from rapiddoc_tpu.models.table import cls as Jc
    from rapiddoc_tpu.models.table import img2table as Ji
    from rapiddoc_tpu_torch.models.table import cls as Tc
    from rapiddoc_tpu_torch.models.table import img2table as Ti

    img = _grid_image(merge=merge)
    np.testing.assert_array_equal(Ti.ruling_line_mask(img), Ji.ruling_line_mask(img))
    got, want = Ti.opencv_table_extract(img), Ji.opencv_table_extract(img)
    assert got == want and len(got[0]) >= 8
    blank = np.full((40, 90, 3), 250, np.uint8)
    for im in (img, blank, img[:, :40]):
        assert Tc.heuristic_table_kind(im) == Jc.heuristic_table_kind(im)


def test_matcher_and_select_match_jax():
    """match_ocr_to_cells (overlap, then nearest centre),
    build_html_from_grid, html_from_structure_tokens and
    select_best_table_html on synthetic grids and texts."""
    from rapiddoc_tpu.models.table import matcher as Jm
    from rapiddoc_tpu.models.table import select as Js
    from rapiddoc_tpu_torch.models.table import matcher as Tm
    from rapiddoc_tpu_torch.models.table import select as Ts
    from rapiddoc_tpu_torch.models.table.unet import cells_to_grid

    rng = np.random.default_rng(8)
    cells = [[c * 50.0 + rng.uniform(-2, 2), r * 30.0, c * 50.0 + 48, r * 30.0 + 28]
             for r in range(4) for c in range(3)]
    cells[0][2] = 148.0  # a header spanning three columns
    del cells[1:3]
    items = [{"bbox": [float(x), float(y), float(x) + 20, float(y) + 10], "text": f"t{i}"}
             for i, (x, y) in enumerate(rng.uniform(0, 150, (30, 2)))]
    assert Tm.match_ocr_to_cells(cells, items) == Jm.match_ocr_to_cells(cells, items)
    grid = cells_to_grid(cells)
    texts = [f"a<{i}>" for i in range(len(cells))]
    assert Tm.build_html_from_grid(grid, texts) == Jm.build_html_from_grid(grid, texts)
    struct = ["<thead>", "<tr>", "<td", ' colspan="2"', ">", "</td>", "<td></td>", "</tr>",
              "</thead>", "<tbody>", "<tr>", "<td></td>", "<td></td>", "</tr>", "</tbody>"]
    for t in (texts[:3], texts[:1], []):
        assert (Tm.html_from_structure_tokens(struct, t)
                == Jm.html_from_structure_tokens(struct, t))
    wired = Tm.build_html_from_grid(grid, texts)
    wireless = Tm.html_from_structure_tokens(struct, texts[:4])
    for ocr in ([], texts[:2], ["a<1>", "zz"], [f"a<{i}>" for i in range(12)]):
        for a, b in ((wired, wireless), (wireless, wired), ("", wired), (wired, "")):
            assert Ts.select_best_table_html(ocr, a, b) == Js.select_best_table_html(ocr, a, b)
    for s in ("表 格  文 字", "x y", "第 1 页 ， 共 2", ""):
        assert Ts.normalize_cell_text(s) == Js.normalize_cell_text(s)


def test_in_table_formula_and_image_injection():
    """Recognized formulas land in their cell as $latex$ and in-table
    images as their uuid (the region whited out first), as the JAX
    package's _cell_texts and batch_predict place them; the uuid
    resolves to an <img> tag at save time."""
    import torch

    from rapiddoc_tpu_torch.models.table.engine import TableConfig, TableRecognizer
    from rapiddoc_tpu_torch.types import ContentType
    from rapiddoc_tpu_torch.utils.images import cut_span_images

    rec = TableRecognizer(TableConfig(strategy="unet"), device="cpu", dtype=torch.float32)
    texts = rec._cell_texts(
        None, [[0, 0, 100, 50], [100, 0, 200, 50]],
        [([110.0, 10.0, 190.0, 40.0], "x^2+y^2")], [])
    assert texts == ["", "$x^2+y^2$"]
    img = _grid_image(rows=(20, 128, 236), cols=(20, 128, 236), size=(256, 256))
    img[150:220, 150:220] = 64  # a "photo" in the bottom-right cell
    # the structure comes from the ruling lines (random UNet weights find
    # no cells, so img2table runs), the texts from the injected items
    uid = "f" * 32
    html = rec.batch_predict([img], mfd_items=[[([30.0, 30.0, 100.0, 100.0], "a+b")]],
                             fill_items=[[([150, 150, 220, 220], uid)]])[0]
    assert "$a+b$" in html and uid in html
    span = {"type": ContentType.TABLE, "bbox": [0, 0, 256, 256], "html": html,
            "fill_images": [{"uuid": uid, "bbox": [150, 150, 220, 220]}]}
    written = {}

    class W:
        def write(self, name, data):
            written[name] = data

    cut_span_images({"preproc_blocks": [{"type": "table", "bbox": [0, 0, 256, 256],
                                         "lines": [{"spans": [span]}]}]}, img, 1.0, W())
    assert uid not in span["html"] and '<img src="images/' in span["html"] and written


# ----------------------------------------- demo checkpoints, golden crops


def port_table(strategy: str = "unet_slanet_plus", dtype=None, **env: str):
    import torch

    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer

    with table_env(**env):
        return TableRecognizer.build({"strategy": strategy}, device="cpu",
                                     dtype=dtype or torch.float32)


def unet_logit_gap(rec, crops: list[np.ndarray], rows: list[int]) -> np.ndarray:
    """l1 - l0 of the port's UNet on the crops ``rows``, (n, 1024, 1024)."""
    import torch

    wired = rec.wired
    x = torch.from_numpy(np.stack([wired.preprocess(crops[i]) for i in rows]))
    return wired.logit_gap(x).numpy()


def uni_resize(crop: np.ndarray) -> np.ndarray:
    from rapiddoc_tpu_torch.models.ocr.pre_post import resize_linear

    return resize_linear(crop, 448, 448)


def check_unet_bits(rec, crops, got_bits: np.ndarray, want_bits: np.ndarray) -> int:
    """Every bit where the port's line decision differs from the JAX
    package's is a near-tie: |l1 - l0| < UNET_TIE. Returns the count."""
    diff = np.unpackbits(got_bits ^ want_bits, axis=-1)
    rows = [i for i in range(len(crops)) if diff[i].any()]
    if rows:
        gap = unet_logit_gap(rec, crops, rows)
        for j, i in enumerate(rows):
            assert np.abs(gap[j][diff[i] > 0]).max() < UNET_TIE, i
    return int(diff.sum())


def test_unet_8bit_wire_matches_jax(stored):
    """RAPIDDOC_UNET_WIRE_BITS=8 (uint8 RGB in place of 4-bit luma) on
    two golden crops, fp32: the JAX package's cells and grid, and every
    differing line bit a near-tie."""
    import jax.numpy as jnp

    from rapiddoc_tpu.models.registry import _load_variables
    from rapiddoc_tpu.models.table.unet import WiredTableStructure as JWired

    crops = crops_of(stored)[1:3]
    rec = port_table("unet", RAPIDDOC_UNET_WIRE_BITS="8")
    assert not rec.wired.nibble_wire
    with table_env(RAPIDDOC_UNET_WIRE_BITS="8", RAPIDDOC_FP32_PARAMS="1"):
        jw = JWired(_load_variables(REPO / "rapiddoc_tpu" / "assets" / "table_unet_demo.npz"))
        assert not jw.nibble_wire
        import cv2

        want_bits = np.asarray(jw._fwd(jw.variables, jnp.asarray(
            np.stack([cv2.resize(c, (1024, 1024)) for c in crops]))))
        want = jw.batch(crops)
        handles = rec.wired.dispatch([rec.wired.preprocess(c) for c in crops])
        got_bits = np.concatenate([h[:n].numpy() for h, n in handles])
        check_unet_bits(rec, crops, got_bits, want_bits)
        assert rec.wired.finish(crops, handles) == want


def jax_stage_view(golden: dict, stored: dict, mode: str) -> dict:
    """The JAX package's stored per-stage outputs in ``mode``, in the form
    chip_smoke.table_stage_outputs gives."""
    g = golden["stages"][mode]
    return {"kinds": g["kinds"], "bits": stored[f"{mode}/unet_bits"], "cells": g["cells"],
            "grid": g["grid"], "slanet": g["slanet"], "unitable": g["unitable"]}


def compare() -> dict:
    """The port's bf16 on the CPU against the JAX package's bf16 (stages
    on the crops, and the parse with the int8 head), beside the JAX
    package's own fp32 against its bf16."""
    import torch

    import test_torch_pipeline_table as tp

    smoke = _pipeline_helpers()._chip_smoke()
    golden = json.loads(GOLDEN_JSON.read_text())
    with np.load(CROPS_NPZ) as z:
        stored = dict(z)
    crops = crops_of(stored)
    got = smoke.table_stage_outputs(port_table(dtype=torch.bfloat16),
                                    port_table("unet_unitable", torch.bfloat16).wireless, crops)
    want = jax_stage_view(golden, stored, "bf16")
    return {
        "port_stages_bf16_cpu": smoke.compare_table_stages(got, want, want["bits"]),
        "jax_stages_fp32_vs_bf16": smoke.compare_table_stages(
            jax_stage_view(golden, stored, "fp32"), want, want["bits"]),
        "port_parse_bf16_int8_cpu": smoke.compare_table_parse(
            parse_summary(tp.port_parse(DOC_PDF.read_bytes(), "bf16_int8")),
            golden["bf16_int8"]),
        "jax_parse_fp32_vs_bf16_int8": smoke.compare_table_parse(
            golden["fp32"], golden["bf16_int8"]),
    }


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" in sys.argv[1:]:
        sys.path.insert(0, str(REPO / "tests"))
        print(json.dumps(compare(), indent=1))
    else:
        arrays, golden_data = make_assets(DOC_PDF.read_bytes())
        np.savez_compressed(CROPS_NPZ, **arrays)
        GOLDEN_JSON.write_text(json.dumps(golden_data, indent=1) + "\n")
        print("wrote", CROPS_NPZ, GOLDEN_JSON)
