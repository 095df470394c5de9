"""The port's render pool (``rapiddoc_tpu_torch/pdfio/parallel_render.py``)
against the JAX package's and against the port's serial render, on the
CPU, with no models: the gate, the worker count and the shards equal the
JAX package's under the same environment; the pool's rasters, text dicts
and boxes equal the serial render's byte for byte on a 16-page document
at 72 dpi; a page whose render raises raises through the pool; a timeout
kills the pool, and ``RapidDoc`` then renders the window serially; a
script without the ``__main__`` guard runs its top level once (the
workers never import the program's main module)."""
import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path
from concurrent.futures import Future

import numpy as np
import pytest

from rapiddoc_tpu_torch.pdfio import open_pdf, parallel_render, render_page_full

# an arithmetic-coded JPEG's first markers: SOI, SOF9, EOI (the port raises)
ARITHMETIC_JPEG = bytes.fromhex("ffd8ffc9000b080006000801011100ffd9")


def vector_pdf(n_pages: int, seed: int = 0, bad_page: int | None = None) -> bytes:
    """n_pages Letter pages, each with four filled rectangles, a stroked
    line, a line of Helvetica text (drawn with the fallback font) and an
    8 x 6 Flate image placed at a page-dependent spot; ``bad_page`` holds
    an arithmetic-coded JPEG instead."""
    rng = np.random.default_rng(seed)
    objs: list[bytes] = []

    def add(body: bytes) -> int:
        objs.append(body)
        return len(objs)

    def stream(head: str, data: bytes) -> bytes:
        return f"<< {head} /Length {len(data)} >>\nstream\n".encode() + data + b"\nendstream"

    add(b"<< /Type /Catalog /Pages 2 0 R >>")
    add(b"")
    font = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
    image = "/Type /XObject /Subtype /Image /Width 8 /Height 6 /ColorSpace /DeviceRGB " \
            "/BitsPerComponent 8 /Filter "
    kids = []
    for i in range(n_pages):
        px = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
        if i == bad_page:
            img = add(stream(image + "/DCTDecode", ARITHMETIC_JPEG))
        else:
            img = add(stream(image + "/FlateDecode", zlib.compress(px.tobytes())))
        ops = []
        for _ in range(4):
            r, g, b = rng.random(3)
            x, y, w, h = rng.integers(20, 400, 4)
            ops.append(f"{r:.3f} {g:.3f} {b:.3f} rg {x} {y} {w // 2} {h // 3} re f")
        ops.append(f"0 0 0 RG 2 w 50 {700 - i * 10} m 500 {650 - i * 5} l S")
        ops.append(f"BT /F1 12 Tf 72 740 Td (Page {i + 1} of the pool test) Tj ET")
        ops.append(f"q 120 0 0 90 {300 + i} 500 cm /Im0 Do Q")
        content = add(stream("", "\n".join(ops).encode()))
        kids.append(add(f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Resources "
                        f"<< /Font << /F1 {font} 0 R >> /XObject << /Im0 {img} 0 R >> >> "
                        f"/Contents {content} 0 R >>".encode()))
    objs[1] = (f"<< /Type /Pages /Kids [{' '.join(f'{k} 0 R' for k in kids)}] "
               f"/Count {len(kids)} >>").encode()
    out = bytearray(b"%PDF-1.7\n")
    offsets = []
    for num, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += f"{num} 0 obj\n".encode() + body + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
    out += b"".join(f"{o:010d} 00000 n \n".encode() for o in offsets)
    out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
            f"startxref\n{xref}\n%%EOF\n").encode()
    return bytes(out)


@pytest.fixture(scope="module")
def pool():
    """The pool for this file's tests, killed at the end."""
    yield parallel_render
    parallel_render.kill_pool()


@pytest.fixture
def clean_env(monkeypatch):
    for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
        monkeypatch.delenv(k)
    return monkeypatch


class _FakePool:
    """Records the shards submitted to it; every page comes back None."""

    def __init__(self, port: bool):
        self.port, self.shards = port, []

    def submit(self, fn, pdf, shard, dpi, want_text):
        self.shards.append(list(shard))
        fut = Future()
        items = [None] * len(shard)
        fut.set_result((False, items) if self.port else items)
        return fut


ENVS = [{}, {"RAPIDDOC_PDF_RENDER_WORKERS": "3"}, {"MINERU_PDF_RENDER_WORKERS": "64"},
        {"RAPIDDOC_PDF_RENDER_WORKERS": "1"}, {"RAPIDDOC_PDF_CONCURRENCY_ENABLED": "0"},
        {"MINERU_PDF_CONCURRENCY_ENABLED": "false"}]


@pytest.mark.parametrize("cores", [1, 2, 8])
@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items())
                         or "default")
def test_gate_workers_and_shards_equal_jax(clean_env, env, cores):
    from rapiddoc_tpu.pdfio import parallel_render as J

    for k, v in env.items():
        clean_env.setenv(k, v)
    clean_env.setattr(os, "cpu_count", lambda: cores)
    for n in (1, 8, 15, 16, 17, 40):
        assert parallel_render.concurrency_enabled(n) == J.concurrency_enabled(n)
    assert parallel_render._n_workers() == J._n_workers()
    idxs = list(range(3, 3 + 17))
    fakes = {}
    for port, mod in ((True, parallel_render), (False, J)):
        fakes[port] = _FakePool(port)
        clean_env.setattr(mod, "_get_pool", lambda f=fakes[port]: f)
        mod.render_pages_parallel(b"", idxs, 72, False, timeout=5)
    assert fakes[True].shards == fakes[False].shards
    assert sorted(i for s in fakes[True].shards for i in s) == idxs


def test_pool_equals_the_serial_render(pool, clean_env):
    from rapiddoc_tpu_torch.ops import build

    pdf = vector_pdf(16)
    doc = open_pdf(pdf)
    serial = [(render_page_full(doc.get_page(i), dpi=72, with_text=True), doc.get_page(i).size)
              for i in range(16)]
    windows = pool.stats["windows"]
    got = pool.render_pages_parallel(pdf, list(range(16)), 72, True)
    assert pool.stats["windows"] == windows + 1
    assert pool.stats["worker_host_compiled"] == {build.host_compiled()}
    assert len(got) == 16
    for (img, size, tdict, boxes), ((want_img, want_text, want_boxes), want_size) in zip(
            got, serial):
        assert img.dtype == want_img.dtype and img.shape == want_img.shape
        assert img.tobytes() == want_img.tobytes()
        assert size == want_size and tdict == want_text and boxes == want_boxes
    assert any(t for (_, _, t, _) in got) and all(b for (_, _, _, b) in got)
    # a shard order other than the pages': every page in its place
    part = pool.render_pages_parallel(pdf, [9, 2, 14], 72, False)
    assert [p[0].tobytes() for p in part] == [serial[i][0][0].tobytes() for i in (9, 2, 14)]


def test_a_page_that_raises_raises_through_the_pool(pool, clean_env):
    pdf = vector_pdf(16, bad_page=3)
    with pytest.raises(NotImplementedError) as serial:
        render_page_full(open_pdf(pdf).get_page(3), dpi=72)
    with pytest.raises(NotImplementedError) as pooled:
        pool.render_pages_parallel(pdf, list(range(16)), 72, False)
    assert str(pooled.value) == str(serial.value)
    assert "arithmetic-coded" in str(pooled.value)
    assert pool._POOL is not None  # a page's error is no fault of the pool


def test_workers_import_no_torch_pil_or_jax(pool):
    reports = pool.probe_workers()
    assert reports and all(r["modules"] == [] for r in reports), reports


def test_timeout_kills_the_pool_and_the_window_renders_serially(pool, clean_env):
    from rapiddoc_tpu_torch import RapidDoc

    pdf = vector_pdf(16)
    pool.probe_workers()
    procs = list(pool._POOL.procs)
    with pytest.raises(pool.PoolFault, match="TimeoutError"):
        pool.render_pages_parallel(pdf, list(range(16)), 72, False, timeout=1e-4)
    assert pool._POOL is None
    assert procs and all(p.poll() is not None for p in procs)
    for k in ("LAYOUT", "FORMULA", "TABLE", "OCR"):
        clean_env.setenv(f"RAPIDDOC_DISABLE_{k}", "1")
    clean_env.setenv("RAPIDDOC_PDF_LOAD_IMAGES_TIMEOUT", "0.0001")
    fallbacks = pool.stats["fallbacks"]
    got = RapidDoc(device="cpu")(pdf, parse_method="txt")
    assert pool.stats["fallbacks"] == fallbacks + 1 and pool._POOL is None
    clean_env.setenv("RAPIDDOC_PDF_CONCURRENCY_ENABLED", "0")
    want = RapidDoc(device="cpu")(pdf, parse_method="txt")
    assert got.markdown == want.markdown and got.content_list_json == want.content_list_json


def test_a_script_without_the_main_guard_runs_its_top_level_once(tmp_path):
    """A user's script, unguarded, that parses a 16-page document through
    ``RapidDoc`` (one window, through the pool) and renders it through the
    pool alone: its top level writes the marker once (``spawn`` would
    re-run it in each of the four workers, whose start then fails), the
    pool's rasters, text dicts and boxes equal the serial render's, and
    no window falls back."""
    repo = Path(__file__).resolve().parent.parent
    marker = tmp_path / "marker.txt"
    (tmp_path / "doc.pdf").write_bytes(vector_pdf(16, seed=3))
    script = tmp_path / "unguarded.py"
    script.write_text(textwrap.dedent(f"""
        import hashlib, os, sys
        sys.path.insert(0, {str(repo)!r})
        with open({str(marker)!r}, "a") as f:
            f.write(str(os.getpid()) + chr(10))
        for k in ("LAYOUT", "FORMULA", "TABLE", "OCR"):
            os.environ["RAPIDDOC_DISABLE_" + k] = "1"
        from rapiddoc_tpu_torch import RapidDoc
        from rapiddoc_tpu_torch.pdfio import open_pdf, parallel_render, render_page_full
        pdf = open({str(tmp_path / "doc.pdf")!r}, "rb").read()
        pooled = RapidDoc(device="cpu")(pdf, parse_method="txt")
        stats = dict(parallel_render.stats)
        got = parallel_render.render_pages_parallel(pdf, list(range(16)), 72, True)
        parallel_render.kill_pool()
        doc = open_pdf(pdf)
        want = [render_page_full(doc.get_page(i), dpi=72, with_text=True) for i in range(16)]
        same = all(g[0].tobytes() == w[0].tobytes() and g[2] == w[1] and g[3] == w[2]
                   for g, w in zip(got, want))
        print("RESULT", stats["windows"], stats["fallbacks"], same, bool(pooled.markdown))
    """))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RAPIDDOC_", "MINERU_"))}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(marker.read_text().splitlines()) == 1
    assert proc.stdout.splitlines()[-1] == "RESULT 1 0 True True"
    assert "PoolFault" not in proc.stderr and "parallel render failed" not in proc.stderr
