"""The port's compiled host loops (``rapiddoc_tpu_torch/utils/native.py``,
``csrc/hostops.cu``) against the JAX package's ``rapiddoc_tpu.utils.native``
on seeded inputs: the plain versions, and the C source built here with g++
(``tests/torch_host_builds.py``, as nvcc builds it on the card), equal the
JAX package's native results; the callers (Flate predictors, ``iou_matrix``
at 4096 pairs or more, ``teds``) equal the JAX package's; the wrappers take
the plain path where ``host_compiled()`` is false and raise, with no
fallback, where it is true and nvcc is missing."""
import contextlib
import zlib

import numpy as np
import pytest

from rapiddoc_tpu_torch.ops import build
from rapiddoc_tpu_torch.pdfio import filters
from rapiddoc_tpu_torch.utils import boxes, native, teds

import torch_host_builds


@pytest.fixture(scope="module")
def jax_native():
    from rapiddoc_tpu.utils import native as J

    if not J.available():
        pytest.skip("the JAX package's native library did not build")
    return J


@pytest.fixture
def compiled():
    """The wrappers on ``csrc/hostops.cu`` built with g++, as on a card."""
    if torch_host_builds.gxx() is None:
        pytest.skip("no g++")
    with torch_host_builds.compiled_host():
        yield


def png_rows(rng, row_len: int, nrows: int, kinds, partial: int = 0) -> bytes:
    """Random PNG-predicted rows with the given filter bytes in turn, and
    ``partial`` bytes of a row cut short."""
    out = bytearray()
    for r in range(nrows):
        out.append(kinds[r % len(kinds)])
        out += rng.integers(0, 256, row_len, dtype=np.uint8).tobytes()
    return bytes(out) + rng.integers(0, 256, partial, dtype=np.uint8).tobytes()


# (row_len, bpp, filter bytes, partial-row bytes): the five PNG types, an
# unknown filter byte (left as it is), a trailing partial row (dropped)
PNG_CASES = [
    (96, 3, (0, 1, 2, 3, 4), 0),
    (61, 1, (4, 3, 2, 1, 0), 17),
    (40, 4, (4, 7, 2, 255, 3), 0),
    (5100, 3, (4,), 100),
    (1, 2, (1, 2, 3, 4), 1),
]


@pytest.mark.parametrize("row_len,bpp,kinds,partial", PNG_CASES)
def test_png_defilter_equals_jax(jax_native, row_len, bpp, kinds, partial):
    rng = np.random.default_rng(row_len)
    data = png_rows(rng, row_len, 12, kinds, partial)
    want = jax_native.png_defilter(data, row_len, bpp)
    assert filters.png_defilter_plain(data, row_len, bpp) == want
    assert native.png_defilter(data, row_len, bpp) == want
    with torch_host_builds.compiled_host():
        assert native.png_defilter(data, row_len, bpp) == want


@pytest.mark.parametrize("row_len,bpp,extra", [(30, 3, 0), (17, 1, 5), (64, 4, 63)])
def test_tiff_defilter_equals_jax(jax_native, row_len, bpp, extra):
    rng = np.random.default_rng(row_len)
    data = rng.integers(0, 256, row_len * 9 + extra, dtype=np.uint8).tobytes()
    want = jax_native.tiff_defilter(data, row_len, bpp)
    assert filters.tiff_defilter_plain(data, row_len, bpp) == want
    assert native.tiff_defilter(data, row_len, bpp) == want
    with torch_host_builds.compiled_host():
        assert native.tiff_defilter(data, row_len, bpp) == want


@pytest.mark.parametrize("params", [
    {"Predictor": 15, "Colors": 3, "Columns": 32},
    {"Predictor": 12, "Colors": 1, "BitsPerComponent": 8, "Columns": 45},
    {"Predictor": 2, "Colors": 4, "Columns": 20},
    {"Predictor": 2, "Colors": 1, "BitsPerComponent": 4, "Columns": 20},
], ids=["png_rgb", "png_grey", "tiff_rgba", "tiff_4bit"])
def test_flate_predictors_equal_jax(params, compiled):
    from rapiddoc_tpu.pdfio import filters as J

    rng = np.random.default_rng(7)
    if params["Predictor"] >= 10:
        row_len = (params["Columns"] * params["Colors"] * params.get("BitsPerComponent", 8) + 7) // 8
        raw = png_rows(rng, row_len, 20, (0, 1, 2, 3, 4, 9))
    else:
        raw = rng.integers(0, 256, 20 * 80 + 3, dtype=np.uint8).tobytes()
    stream = zlib.compress(raw)
    want = J.flate_decode(stream, params)
    assert filters.flate_decode(stream, params) == want


def box_sets(n: int, m: int, seed: int):
    """Seeded xyxy boxes with degenerate ones: zero width, reversed
    corners, and zero-area pairs whose union is 0."""
    rng = np.random.default_rng(seed)

    def make(k):
        xy = rng.uniform(0, 500, (k, 2))
        wh = rng.uniform(-5, 120, (k, 2))
        out = np.concatenate([xy, xy + wh], axis=1)
        out[::7, 2] = out[::7, 0]  # zero width
        out[::11] = out[::11][:, [2, 3, 0, 1]]  # reversed corners
        return out

    a, b = make(n), make(m)
    b[: min(n, m) // 5] = a[: min(n, m) // 5]  # identical pairs
    return a, b


# The JAX package's library is built with -march=native (native/Makefile),
# so g++ fuses area_a + area_b * h into one FMA there: its IoUs differ
# from numpy's in the last bits. The port's build (nvcc, and g++ here)
# targets plain x86-64, which has no FMA, so its compiled IoUs equal the
# numpy plain version exactly; against the JAX library a few ulps.
IOU_RTOL = 1e-14


@pytest.mark.parametrize("n,m", [(64, 64), (100, 100), (80, 80), (3, 2048), (1, 5000)])
def test_iou_matrix_equals_jax(jax_native, n, m):
    from rapiddoc_tpu.utils import boxes as J

    a, b = box_sets(n, m, n * 1000 + m)
    want = jax_native.iou_matrix(a, b)
    plain = boxes.iou_matrix_plain(a, b)
    np.testing.assert_allclose(plain, want, rtol=IOU_RTOL, atol=0)
    assert np.array_equal(plain == 0, want == 0)
    np.testing.assert_allclose(boxes.iou_matrix(a, b), J.iou_matrix(a, b), rtol=IOU_RTOL, atol=0)
    assert np.array_equal(boxes.iou_matrix(a, b), plain)
    with torch_host_builds.compiled_host():
        assert np.array_equal(native.iou_matrix(a, b), plain)
        assert np.array_equal(boxes.iou_matrix(a, b), plain)


@pytest.mark.parametrize("n,threshold", [(50, 0.5), (300, 0.3), (120, 0.0), (40, 0.9)])
def test_nms_equals_jax(jax_native, n, threshold):
    rng = np.random.default_rng(n)
    b, _ = box_sets(n, 1, n)
    scores = rng.permutation(n) / n  # distinct: the JAX loop's sort is not stable
    want = jax_native.nms(b, scores, threshold)
    assert boxes.nms(b, scores, threshold) == want
    assert native.nms(b, scores, threshold) == want
    with torch_host_builds.compiled_host():
        assert native.nms(b, scores, threshold) == want


def test_nms_orders_ties_by_index(compiled):
    b = np.array([[0, 0, 10, 10], [50, 50, 60, 60], [1, 1, 10, 10], [50, 50, 61, 61]], float)
    scores = np.array([0.5, 0.9, 0.5, 0.9])
    assert native.nms(b, scores, 0.5) == [1, 0] == boxes.nms(b, scores, 0.5)


LEV_PAIRS = [
    ("kitten", "sitting"), ("", "abc"), ("same", "same"), ("abc", ""),
    ("表格识别结果", "表格识别的结果"), ("数学公式 E=mc²", "数学 公式 E=mc^2"),
    ("𝔸𝔹ℂ emoji 😀", "𝔸ℂ emoji 😃!"), ("Ünïcödé", "Unicode"),
]
# lone surrogates: code points the plain loop compares like any other
SURROGATE_PAIRS = [("a\ud800b", "ab"), ("\udc00\ud800", "\ud800\udc00"), ("x\udfff", "x\udffe")]


@pytest.mark.parametrize("a,b", LEV_PAIRS)
def test_levenshtein_equals_jax(jax_native, a, b):
    want = jax_native.levenshtein(a, b)
    assert teds.levenshtein(a, b) == want
    assert native.levenshtein(a, b) == want
    with torch_host_builds.compiled_host():
        assert native.levenshtein(a, b) == want


@pytest.mark.parametrize("a,b", SURROGATE_PAIRS)
def test_levenshtein_with_lone_surrogates_equals_plain(compiled, a, b):
    assert native.levenshtein(a, b) == teds.levenshtein(a, b) > 0


def test_teds_equals_jax(compiled):
    from rapiddoc_tpu.utils import teds as J

    gt = ("<table><tr><td>项目</td><td>金额（元）</td></tr>"
          "<tr><td colspan='2'>合计 1,234.50</td></tr></table>")
    pred = ("<table><tr><td>项 目</td><td>金额(元)</td></tr>"
            "<tr><td colspan='2'>合计 1234.5</td></tr></table>")
    for structure_only in (False, True):
        assert teds.teds(pred, gt, structure_only) == J.teds(pred, gt, structure_only)


def test_wrappers_take_the_plain_path_without_a_card(monkeypatch):
    def no_build(name):
        raise AssertionError(f"{name} loaded on the plain path")

    monkeypatch.setattr(build, "host_compiled", lambda: False)
    monkeypatch.setattr(build, "load", no_build)
    data = png_rows(np.random.default_rng(1), 30, 4, (4, 1))
    assert native.png_defilter(data, 30, 3) == filters.png_defilter_plain(data, 30, 3)
    assert native.tiff_defilter(data, 30, 3) == filters.tiff_defilter_plain(data, 30, 3)
    a, b = box_sets(70, 70, 1)
    assert np.array_equal(native.iou_matrix(a, b), boxes.iou_matrix_plain(a, b))
    assert native.nms(a, np.arange(70.0), 0.5) == boxes.nms(a, np.arange(70.0), 0.5)
    assert native.levenshtein("表格", "表") == 1


def test_wrappers_raise_without_nvcc_where_compiled(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "host_compiled", lambda: True)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
    a, b = box_sets(64, 64, 2)
    data = png_rows(np.random.default_rng(2), 30, 4, (4,))
    calls = [lambda: native.png_defilter(data, 30, 3), lambda: native.tiff_defilter(data, 30, 3),
             lambda: native.iou_matrix(a, b), lambda: boxes.iou_matrix(a, b),
             lambda: native.nms(a, np.arange(64.0), 0.5), lambda: native.levenshtein("a", "b"),
             lambda: filters.flate_decode(zlib.compress(data), {"Predictor": 15, "Colors": 3,
                                                                "Columns": 10})]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc"):
            call()


def test_malformed_predictor_rows_raise(compiled):
    with pytest.raises(ValueError, match="predictor rows"):
        native.tiff_defilter(b"\x01\x02", 0, 1)
    with pytest.raises(ValueError, match="predictor rows"):
        native.png_defilter(b"\x01\x02", -3, 1)
    with pytest.raises(ValueError, match="boxes but"):
        native.nms(np.zeros((3, 4)), np.zeros(2), 0.5)


# /Columns 1431655769 with /Colors 3 gives 4294967307 bytes a row, which a
# 32-bit int would read as 11; /Colors 2**31 gives a pixel of 2**31 bytes
OVERSIZED = [
    (filters.png_defilter_plain, native.png_defilter, {"Predictor": 15, "Colors": 3,
                                                       "Columns": 1431655769}),
    (filters.tiff_defilter_plain, native.tiff_defilter, {"Predictor": 2, "Colors": 2**31,
                                                         "Columns": 1}),
    (filters.png_defilter_plain, native.png_defilter, {"Predictor": 12, "Colors": 2**31,
                                                       "Columns": 1}),
]


@pytest.mark.parametrize("on_card", [False, True], ids=["plain", "compiled"])
@pytest.mark.parametrize("case", range(len(OVERSIZED)))
def test_oversized_predictor_rows_raise_on_both_paths(monkeypatch, on_card, case):
    plain, wrapper, params = OVERSIZED[case]
    data = png_rows(np.random.default_rng(case), 11, 12, (4, 1))

    def no_plain(*args):
        raise AssertionError("the plain loop ran")

    monkeypatch.setattr(filters, plain.__name__, no_plain)
    if on_card and torch_host_builds.gxx() is None:
        pytest.skip("no g++")
    with torch_host_builds.compiled_host() if on_card else contextlib.nullcontext():
        with pytest.raises(ValueError, match="predictor rows"):
            filters.flate_decode(zlib.compress(data), params)
        with pytest.raises(ValueError, match="predictor rows"):
            wrapper(data, 2**32 + 11, 3)


def test_library_is_typed_before_any_thread_uses_it(compiled, monkeypatch):
    """Threads that make their first calls together all see every entry
    point typed (nms's float threshold, levenshtein's 64-bit result)."""
    import threading

    import ctypes

    # a fresh handle on the library: its entry points not yet typed
    fresh = ctypes.CDLL(torch_host_builds.load("hostops")._name)
    monkeypatch.setitem(torch_host_builds._libs, "hostops", fresh)
    a, _ = box_sets(8, 1, 5)
    barrier = threading.Barrier(8)
    got: list = []

    def first_call(k):
        barrier.wait()
        got.append(native.nms(a, np.arange(8.0), 0.5) if k % 2 else
                   native.levenshtein("表格识别", "表格"))

    threads = [threading.Thread(target=first_call, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(map(str, got)) == sorted(map(str, [2] * 4 + [boxes.nms(a, np.arange(8.0), 0.5)] * 4))
