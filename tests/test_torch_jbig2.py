"""The port's JBIG2 decoder against the JAX package's.

Each case of ``tests/test_jbig2.py`` runs twice on the same streams of
the independent encoder (``tests/jbig2_encoder.py``): once as it is, on
the JAX package's decoder, and once with the port's module in its place
(its plain loops: Python, as on a machine without a card). Every bitmap
``decode`` returns must be equal bit for bit, and each case's own checks
must pass on the port too. The PDF case decodes through the port's
``xobject_to_array``. The compiled loops of ``csrc/bilevel.cu`` are held
to the plain ones on the same streams where a C++ compiler is at hand
(the file is host code, so g++ builds it as nvcc does on the card).
"""
import ctypes
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import jbig2_encoder as E  # noqa: E402
import test_jbig2 as T  # noqa: E402
from rapiddoc_tpu.pdfio import jbig2 as jax_jbig2  # noqa: E402
from rapiddoc_tpu_torch.pdfio import jbig2 as port_jbig2  # noqa: E402

CASES = [("test_generic_region_roundtrip", {"template": t}) for t in range(4)] + [
    (name, {}) for name in (
        "test_generic_region_tpgdon", "test_generic_region_python_fallback_matches",
        "test_integer_roundtrip", "test_symbol_dict_and_text_region", "test_composition_ops",
        "test_pdf_image_integration", "test_huffman_standard_tables",
        "test_huffman_symbol_dict_and_text_region", "test_halftone_region",
        "test_mmr_generic_region", "test_text_region_refinement_arith",
        "test_text_region_refinement_huffman", "test_symbol_dict_refagg_arith",
        "test_symbol_dict_refagg_huffman", "test_halftone_region_skip",
        "test_refinement_region_segment")]


class _Recorder(types.ModuleType):
    """A stand-in for ``test_jbig2``'s ``J``: the module's attributes, with
    every bitmap ``decode`` returns kept."""

    def __init__(self, module, decode):
        super().__init__(module.__name__)
        self.__dict__.update({k: v for k, v in vars(module).items() if not k.startswith("__")})
        self.outputs = []

        def recording(*args, **kw):
            out = decode(*args, **kw)
            self.outputs.append(np.array(out, copy=True))
            return out

        self.decode = recording


def _port_images_shim():
    """``rapiddoc_tpu.pdfio.images`` as the PDF case imports it, answered
    by the port: ``xobject_to_pil`` decodes with ``xobject_to_array``."""
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.images import xobject_to_array

    shim = types.ModuleType("rapiddoc_tpu.pdfio.images")
    shim.xobject_to_pil = lambda doc, stream: Image.fromarray(xobject_to_array(doc, stream))
    return shim


def _run(name, kw, monkeypatch, tmp_path, port: bool):
    if port:
        from rapiddoc_tpu_torch.pdfio import cos as port_cos

        rec = _Recorder(port_jbig2, lambda *a, **k: port_jbig2.decode(*a, compiled=False, **k))
        # the cases build decoders as the JAX package's take them
        # (``force_python``); the port's take the loops to run, here plain
        rec.ArithDecoder = lambda data, force_python=False: port_jbig2.ArithDecoder(data, False)
        monkeypatch.setitem(sys.modules, "rapiddoc_tpu.pdfio.jbig2", rec)
        monkeypatch.setitem(sys.modules, "rapiddoc_tpu.pdfio.images", _port_images_shim())
        monkeypatch.setitem(sys.modules, "rapiddoc_tpu.pdfio.cos", port_cos)
    else:
        rec = _Recorder(jax_jbig2, jax_jbig2.decode)
    monkeypatch.setattr(T, "J", rec)
    fn = getattr(T, name)
    if name == "test_pdf_image_integration":
        fn(tmp_path)
    else:
        fn(**kw)
    monkeypatch.undo()
    return rec.outputs


@pytest.mark.parametrize("name,kw", CASES, ids=[
    f"{n[5:]}{kw.get('template', '')}" for n, kw in CASES])
def test_case_equals_jax(name, kw, monkeypatch, tmp_path):
    want = _run(name, kw, monkeypatch, tmp_path, port=False)
    got = _run(name, kw, monkeypatch, tmp_path, port=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_port_imports_no_native_library():
    """The port's loops are its own: nothing of ``native/`` or
    ``utils.native``."""
    src = Path(port_jbig2.__file__).read_text()
    assert "utils import native" not in src and "hostops" not in src.replace(
        "native/hostops.cpp", "")


# ------------------------------------------------- compiled against plain

def _streams():
    """(stream, globals, width, height) covering every compiled loop:
    generic regions of each template (with TPGDON), a text region over a
    symbol dictionary in /JBIG2Globals, refinement, MMR, and a refinement
    region segment over part of the page."""
    rng = np.random.default_rng(17)
    out = []
    for template in range(4):
        bmp = T._random_bitmap(rng, 37, 71)
        bmp[10:20] = bmp[10]
        out.append((E.segment(1, 48, [], 1, E.page_info(71, 37))
                    + E.generic_region_segment(2, bmp, template=template,
                                               tpgdon=template % 2 == 0), None, 71, 37))
    glyphs = [(rng.random((9, 7)) < 0.5).astype(np.uint8) for _ in range(4)]
    sd, order = E.symbol_dict_segment(2, glyphs)
    export = [glyphs[i] for i in order]
    places = [(i % 4, 3 + 9 * i, 2 + 12 * (i // 6)) for i in range(12)]
    target = export[1].copy()
    target[2, 3] ^= 1
    places[5] = (1, 48, 2, target)
    tr = E.text_region_segment(3, 2, export, places, 64, 30)
    out.append((E.segment(1, 48, [], 1, E.page_info(64, 30)) + tr, sd, 64, 30))
    bmp = T._random_bitmap(rng, 23, 45, 0.2)
    out.append((E.segment(1, 48, [], 1, E.page_info(45, 23)) + E.mmr_generic_region_segment(2, bmp),
                None, 45, 23))
    bmp = T._random_bitmap(rng, 24, 40)
    target = bmp[4:16, 8:28].copy()
    target[3, 5] ^= 1
    out.append((E.segment(1, 48, [], 1, E.page_info(40, 24)) + E.generic_region_segment(2, bmp)
                + E.refinement_region_segment(3, target, bmp[4:16, 8:28], x=8, y=4),
                None, 40, 24))
    return out


@pytest.fixture(scope="module")
def gxx_bilevel(tmp_path_factory):
    """``csrc/bilevel.cu`` built with g++ (it holds no device code)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/bilevel.cu on the CPU")
    out = tmp_path_factory.mktemp("bilevel") / "libbilevel.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    str(REPO / "rapiddoc_tpu_torch" / "csrc" / "bilevel.cu"), "-o", str(out)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


@pytest.mark.parametrize("idx", range(7))
def test_compiled_loops_equal_plain(idx, gxx_bilevel, monkeypatch):
    from rapiddoc_tpu_torch.ops import build

    monkeypatch.setattr(build, "load", lambda name: gxx_bilevel)
    data, glob, w, h = _streams()[idx]
    plain = port_jbig2.decode(data, glob, w, h, compiled=False)
    compiled = port_jbig2.decode(data, glob, w, h, compiled=True)
    assert np.array_equal(plain, compiled)
    assert np.array_equal(plain, jax_jbig2.decode(data, glob, w, h))


@pytest.mark.parametrize("idx", range(7))
def test_band_equals_first_rows(idx, gxx_bilevel, monkeypatch):
    """``decode(..., max_rows=n)`` is the page's first n rows, on the plain
    and on the compiled loops (the card's smoke holds them on a band)."""
    from rapiddoc_tpu_torch.ops import build

    monkeypatch.setattr(build, "load", lambda name: gxx_bilevel)
    data, glob, w, h = _streams()[idx]
    page = port_jbig2.decode(data, glob, w, h, compiled=False)
    for rows in (1, h // 2, h + 5):
        for compiled in (False, True):
            band = port_jbig2.decode(data, glob, w, h, compiled=compiled, max_rows=rows)
            assert np.array_equal(band, page[:rows])


def test_threads_keep_their_own_loops(gxx_bilevel, monkeypatch):
    """Two threads decoding at once, one asking for the compiled loops and
    one for the plain ones: each runs only the loops it asked for."""
    import threading

    from rapiddoc_tpu_torch.ops import build
    from rapiddoc_tpu_torch.pdfio import ccitt

    monkeypatch.setattr(build, "load", lambda name: gxx_bilevel)
    streams = _streams()
    want = [port_jbig2.decode(d, g, w, h, compiled=False) for d, g, w, h in streams]
    used: dict[str, set] = {"compiled": set(), "plain": set()}
    init = port_jbig2.ArithDecoder.__init__

    def recording_init(self, data, compiled):
        init(self, data, compiled)
        used[threading.current_thread().name].add(self._native is not None)

    monkeypatch.setattr(port_jbig2.ArithDecoder, "__init__", recording_init)
    for fn, value in ((ccitt.decode_bits_compiled, True), (ccitt.decode_bits_plain, False)):
        def recording(*a, _fn=fn, _value=value):
            used[threading.current_thread().name].add(_value)
            return _fn(*a)

        monkeypatch.setattr(ccitt, fn.__name__, recording)
    start = threading.Barrier(2)
    outs: dict[str, list] = {"compiled": [], "plain": []}

    def work(compiled: bool):
        start.wait()
        for _ in range(8):
            for d, g, w, h in streams:
                outs[threading.current_thread().name].append(
                    port_jbig2.decode(d, g, w, h, compiled=compiled))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(name == "compiled",), name=name)
                   for name in ("compiled", "plain")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(switch)
    assert used == {"compiled": {True}, "plain": {False}}
    for name in outs:
        assert len(outs[name]) == 8 * len(streams)
        assert all(np.array_equal(o, want[i % len(streams)]) for i, o in enumerate(outs[name]))
