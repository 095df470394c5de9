"""The port's command line (``rapiddoc_tpu_torch/cli/``) and its helpers
(``do_parse``, ``aio_do_parse``, ``utils/draw``, ``utils/markdown_convert``)
against the JAX package's CLI, run through click's ``CliRunner`` on the
same inputs.

- ``.md``, ``_middle.json``, ``_content_list.json``, ``_model.json``,
  ``.html`` and the span images: equal bytes; ``.docx``: equal members
  (a zip's headers carry the time of writing).
- ``_span.pdf``: equal bytes (no label is drawn on it).
- ``_layout.pdf`` and ``_line_sort.pdf``: the annotated pages equal the
  JAX package's outside the label boxes, and within ``LABEL_BAND`` inside
  them; in the PDFs' q92 JPEG pages, equal outside the 16 x 16 blocks
  (and one block around) that a label touches. FreeType hints DejaVu Sans
  Bold and the port draws it unhinted (ROADMAP item 12e): that is the
  band (``LABEL_BAND``).
- ``RAPIDDOC_PLATFORM=cpu`` maps the entry points to the CPU; without it
  and without CUDA the CLI, ``do_parse`` and the server raise before they
  parse anything.

Inputs: the committed checkbox page (``assets/checkbox_smoke_page.pdf``)
with ``--checkbox``, and the text fixture of ``test_torch_text.py``
(``assets/text_smoke_doc.pdf``, its "exact" fallback font) in "txt".
"""
from __future__ import annotations

import asyncio
import importlib
import io
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ASSETS = Path(__file__).resolve().parent.parent / "rapiddoc_tpu_torch" / "assets"
CHECKBOX_PDF = ASSETS / "checkbox_smoke_page.pdf"
TEXT_PDF = ASSETS / "text_smoke_doc.pdf"
# a page's labels against the JAX package's, over the pixels either
# inks inside the label boxes: the mean absolute difference of the
# darkest channel and the share more than 64 apart. test_torch_text.py's
# band for a face FreeType hints at a small size (RASTER_BAND["aileron"]);
# its DejaVu band (10.0, 0.05), measured on regular body text, does not
# hold for bold labels at 12 and 16 px, whose hinted heights snap a row or
# two: 11.6-18.8 and 0.043-0.104 measured on this file's pages.
LABEL_BAND = (32.0, 0.25)


def _test_module(name):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True)
def env(monkeypatch):
    """The port on the CPU; no OCR, layout, formula or table model (the
    text comes from the PDF's text layer, the boxes from the fallback
    layout), so both packages give the same bytes."""
    from torch_threads import thread_budget

    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(thread_budget(2), saved))
    monkeypatch.setenv("RAPIDDOC_PLATFORM", "cpu")
    for k in ("OCR", "LAYOUT", "FORMULA", "TABLE"):
        monkeypatch.setenv(f"RAPIDDOC_DISABLE_{k}", "1")
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def text_case():
    """The "exact" fallback font of the text fixture, for both packages."""
    tt = _test_module("test_torch_text")
    pdf = TEXT_PDF.read_bytes()
    with tt.fallback_case("exact", pdf):
        yield pdf


def jax_cli(args: list[str]) -> str:
    from click.testing import CliRunner

    from rapiddoc_tpu.cli.main import main

    result = CliRunner().invoke(main, args)
    assert result.exit_code == 0, (result.output, result.exception)
    return result.output


def port_cli(args: list[str]) -> None:
    from rapiddoc_tpu_torch.cli.main import main

    assert main(args) == 0


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def jpeg_pages(pdf: bytes) -> list[np.ndarray]:
    """The decoded JPEG page of each page of an overlay PDF."""
    from PIL import Image

    streams = re.findall(rb"stream\r?\n(\xff\xd8.*?\xff\xd9)\r?\nendstream", pdf, re.S)
    return [np.asarray(Image.open(io.BytesIO(s)).convert("RGB")) for s in streams]


def label_mask(shape, labels, grow: int = 0, block: int = 1) -> np.ndarray:
    """Pixels inside any label box, each box grown by ``grow`` and then
    out to the ``block`` grid."""
    mask = np.zeros(shape[:2], bool)
    for x0, y0, x1, y1 in labels:
        x0, y0 = max(x0 - grow, 0) // block * block, max(y0 - grow, 0) // block * block
        x1, y1 = -(-(x1 + grow) // block) * block, -(-(y1 + grow) // block) * block
        mask[y0:y1, x0:x1] = True
    return mask


def band(got: np.ndarray, want: np.ndarray, mask: np.ndarray) -> tuple[float, float]:
    a, b = got.min(axis=2).astype(np.int16), want.min(axis=2).astype(np.int16)
    ink = mask & ((a < 250) | (b < 250))
    d = np.abs(a - b)[ink]
    return (float(d.mean()), float((d > 64).mean())) if d.size else (0.0, 0.0)


def overlay_labels(pdf: bytes, middle: dict, mode: str, dpi: int = 96) -> list[list]:
    """Each page's label boxes on the port's overlay of ``mode``, and the
    annotated pages of both packages (the PDFs' pages before JPEG)."""
    from PIL import Image

    import rapiddoc_tpu.utils.draw as jax_draw
    from rapiddoc_tpu.pdfio import open_pdf as jax_open
    from rapiddoc_tpu.pdfio import render_page
    from rapiddoc_tpu_torch.pdfio import open_pdf
    from rapiddoc_tpu_torch.pdfio.render import PageRasterizer
    from rapiddoc_tpu_torch.utils import draw

    fn = {"layout": "draw_layout_on_page", "line_sort": "draw_line_sort_on_page"}[mode]
    scale = dpi / 72.0
    doc, jdoc = open_pdf(pdf), jax_open(pdf)
    out = []
    for i, info in enumerate(middle["pdf_info"]):
        page = PageRasterizer(doc.get_page(i), scale=scale).render()
        jpage = render_page(jdoc.get_page(i), dpi=dpi)
        assert np.array_equal(page, np.asarray(jpage))
        labels: list = []
        got = getattr(draw, fn)(page, info, scale, labels=labels)
        want = np.asarray(getattr(jax_draw, fn)(Image.fromarray(page), info, scale))
        assert labels
        inside = label_mask(got.shape, labels)
        assert (want != np.asarray(page)).any(axis=2)[~inside].sum() > 0
        assert np.array_equal(got[~inside], want[~inside]), (mode, i)
        mean_abs, share = band(got, want, inside)
        assert mean_abs <= LABEL_BAND[0] and share <= LABEL_BAND[1], (mode, i, mean_abs, share)
        out.append(labels)
    return out


def assert_overlay_pdf(got: bytes, want: bytes, labels: list[list]) -> None:
    pages, jpages = jpeg_pages(got), jpeg_pages(want)
    assert len(pages) == len(jpages) == len(labels)
    for page, jpage, page_labels in zip(pages, jpages, labels):
        outside = ~label_mask(page.shape, page_labels, grow=16, block=16)
        assert np.array_equal(page[outside], jpage[outside])


def zip_members(blob: bytes) -> list[tuple[str, bytes]]:
    """A zip's member names and contents (its headers carry the time of
    writing)."""
    import zipfile

    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def assert_same_outputs(got: Path, want: Path, name: str) -> None:
    g, w = _tree(got / name), _tree(want / name)
    overlays = {f"{name}_layout.pdf", f"{name}_line_sort.pdf"}
    assert set(g) == set(w)
    for rel in set(g) - overlays:
        if rel.endswith(".docx"):
            assert zip_members(g[rel]) == zip_members(w[rel]), rel
        else:
            assert g[rel] == w[rel], rel


# ------------------------------------------------------------------ CLI


def test_cli_checkbox_page_equals_jax_cli(tmp_path):
    args = [str(CHECKBOX_PDF), "-m", "ocr", "--checkbox", "--draw-layout", "--html", "--docx"]
    jax_cli(args + ["-o", str(tmp_path / "jax")])
    port_cli(args + ["-o", str(tmp_path / "port")])
    name = CHECKBOX_PDF.stem
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", name)
    produced = {p.name for p in (tmp_path / "port" / name).iterdir()}
    assert {f"{name}.md", f"{name}_middle.json", f"{name}_content_list.json", f"{name}.html",
            f"{name}.docx", f"{name}_layout.pdf", "images"} == produced
    middle = json.loads((tmp_path / "port" / name / f"{name}_middle.json").read_text())
    labels = overlay_labels(CHECKBOX_PDF.read_bytes(), middle, "layout")
    assert_overlay_pdf((tmp_path / "port" / name / f"{name}_layout.pdf").read_bytes(),
                       (tmp_path / "jax" / name / f"{name}_layout.pdf").read_bytes(), labels)


def test_cli_page_range_on_text_layer_equals_jax_cli(tmp_path, text_case):
    src = tmp_path / "doc.pdf"
    src.write_bytes(text_case)
    args = [str(src), "-m", "txt", "--start-page", "1", "--end-page", "2", "--html",
            "--md-mode", "nlp_markdown", "--no-formula"]
    out = jax_cli(args + ["-o", str(tmp_path / "jax")])
    port_cli(args + ["-o", str(tmp_path / "port")])
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", "doc")
    middle = json.loads((tmp_path / "port" / "doc" / "doc_middle.json").read_text())
    assert len(middle["pdf_info"]) == 2 and "parsing" in out


def test_cli_rejects_what_click_rejects(tmp_path, capsys):
    from rapiddoc_tpu_torch.cli.main import main

    for args in ([], [str(tmp_path / "missing.pdf")], [str(CHECKBOX_PDF), "-m", "vlm"]):
        with pytest.raises(SystemExit) as e:
            main(args)
        assert e.value.code == 2
    assert "does not exist" in capsys.readouterr().err


def test_python_dash_m_entry(tmp_path):
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    r = subprocess.run([sys.executable, "-m", "rapiddoc_tpu_torch.cli.main", "--help"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "--checkbox" in r.stdout and "--draw-layout" in r.stdout


# ------------------------------------------------------------- do_parse


def test_do_parse_overlays_and_model_json_equal_jax(tmp_path, text_case):
    from rapiddoc_tpu.cli.common import do_parse as jax_do_parse
    from rapiddoc_tpu_torch.cli.common import do_parse

    kw = dict(parse_method="txt", formula_enable=False, table_enable=False,
              f_draw_layout_bbox=True, f_draw_span_bbox=True, f_draw_line_sort_bbox=True,
              f_dump_model_output=True, start_page_id=0, end_page_id=1)
    want = jax_do_parse(tmp_path / "jax", ["t"], [text_case], **kw)
    got = do_parse(tmp_path / "port", ["t"], [text_case], **kw)
    assert json.loads(json.dumps(got, default=str)) == json.loads(json.dumps(want, default=str))
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", "t")
    assert (tmp_path / "port" / "t" / "t_span.pdf").exists()
    from rapiddoc_tpu_torch.cli.common import convert_pdf_bytes_to_bytes_by_pages

    sliced = convert_pdf_bytes_to_bytes_by_pages(text_case, 0, 1)
    middle = got[0]["middle_json"]
    for mode in ("layout", "line_sort"):
        labels = overlay_labels(sliced, middle, mode)
        assert_overlay_pdf((tmp_path / "port" / "t" / f"t_{mode}.pdf").read_bytes(),
                           (tmp_path / "jax" / "t" / f"t_{mode}.pdf").read_bytes(), labels)


def test_do_parse_batch_and_aio_equal_jax(tmp_path, text_case):
    from rapiddoc_tpu.cli.common import aio_do_parse as jax_aio
    from rapiddoc_tpu.cli.common import do_parse as jax_do_parse
    from rapiddoc_tpu_torch.cli.common import aio_do_parse, do_parse, prepare_env

    docs = [text_case, CHECKBOX_PDF.read_bytes()]
    kw = dict(parse_method="txt", formula_enable=False, table_enable=False,
              batch_inference=True, p_lang_list=["en", "en"])
    want = jax_do_parse(tmp_path / "jax", ["a", "b"], docs, **kw)
    got = do_parse(tmp_path / "port", ["a", "b"], docs, **kw)
    assert json.loads(json.dumps(got, default=str)) == json.loads(json.dumps(want, default=str))
    for name in ("a", "b"):
        assert_same_outputs(tmp_path / "port", tmp_path / "jax", name)
    one = dict(parse_method="txt", formula_enable=False, table_enable=False)
    want = asyncio.run(jax_aio(tmp_path / "ajax", ["x"], [docs[0]], **one))
    got = asyncio.run(aio_do_parse(tmp_path / "aport", ["x"], [docs[0]], **one))
    assert got[0]["markdown"] == want[0]["markdown"] and got[0]["markdown"]
    assert_same_outputs(tmp_path / "aport", tmp_path / "ajax", "x")
    assert prepare_env(tmp_path, "d", "ocr") == (str(tmp_path / "d" / "ocr" / "images"),
                                                 str(tmp_path / "d" / "ocr"))


# ------------------------------------------------------- markdown_convert


MARKDOWN = ("# Title\n\nSome *text* with **bold**, `code` and a [link](http://x).\n\n"
            "- one\n- two\n\n1. first\n2. second\n\n> quoted\n\n$$\nE=mc^2\n$$\n\n"
            "![fig](images/a.jpg)\n\n<table><tr><td>A</td><td>B &amp; C</td></tr></table>\n\n"
            "```\nraw <code>\n```\n\n## Sub\n\n| h | k |\n|---|---|\n| 1 | 2 |\n")


def test_markdown_to_html_and_docx_equal_jax(monkeypatch):
    import rapiddoc_tpu.utils.markdown_convert as jax_mc
    import rapiddoc_tpu_torch.utils.markdown_convert as port_mc

    assert port_mc.markdown_to_html(MARKDOWN) == jax_mc.markdown_to_html(MARKDOWN)
    assert zip_members(port_mc.markdown_to_docx(MARKDOWN)) == zip_members(
        jax_mc.markdown_to_docx(MARKDOWN))
    monkeypatch.setitem(sys.modules, "markdown_it", None)  # its fallback
    html = port_mc.markdown_to_html(MARKDOWN)
    assert html == jax_mc.markdown_to_html(MARKDOWN) and "<pre>" in html


# ------------------------------------------------------- device choice


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Neither RAPIDDOC_PLATFORM=cpu nor a card: the CLI, do_parse and the
    server raise before they parse or write anything."""
    import torch

    from rapiddoc_tpu_torch.cli.common import do_parse
    from rapiddoc_tpu_torch.cli.main import main
    from rapiddoc_tpu_torch.engine.session import resolve_device
    from rapiddoc_tpu_torch.serve.http import make_server

    assert resolve_device(None) == torch.device("cpu")
    monkeypatch.delenv("RAPIDDOC_PLATFORM")
    monkeypatch.setenv("MINERU_PLATFORM", "cpu")
    assert resolve_device(None) == torch.device("cpu")
    monkeypatch.delenv("MINERU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([str(CHECKBOX_PDF), "-o", str(tmp_path / "cli")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        do_parse(tmp_path / "dp", ["c"], [CHECKBOX_PDF.read_bytes()])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server("127.0.0.1", 0)
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------ per-model CLIs


@pytest.mark.parametrize("name", ["test_ocr_cli_smoke", "test_layout_cli_json_clean"])
def test_model_cli_case_on_the_port(name, tmp_path, capsys, monkeypatch):
    """tests/test_model_cli.py's cases with ``rapiddoc_tpu.models.cli``
    and ``.registry`` bound to the port's modules."""
    for mod in ("cli", "registry"):
        monkeypatch.setitem(sys.modules, f"rapiddoc_tpu.models.{mod}",
                            importlib.import_module(f"rapiddoc_tpu_torch.models.{mod}"))
    getattr(_test_module("test_model_cli"), name)(tmp_path, capsys, monkeypatch)


def test_model_cli_reads_images_as_pil(tmp_path):
    """``_load_rgb``: ``Image.open(path).convert("RGB")`` for the image
    files the port decodes."""
    from PIL import Image

    import rapiddoc_tpu_torch.models.cli as port_cli_mod

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    images = {
        "rgb.png": Image.fromarray(rgb), "rgba.png": Image.fromarray(
            np.dstack([rgb, rng.integers(0, 256, (23, 31), dtype=np.uint8)])),
        "grey.png": Image.fromarray(rgb[..., 0]), "pal.png": Image.fromarray(rgb).quantize(16),
        "page.jpg": Image.fromarray(rgb), "page.bmp": Image.fromarray(rgb),
        "page.gif": Image.fromarray(rgb).quantize(32), "page.tif": Image.fromarray(rgb),
        "grey16.png": Image.fromarray(rgb[..., 0].astype(np.uint16) * 257),
    }
    for name, img in images.items():
        path = tmp_path / name
        img.save(path)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        got = port_cli_mod._load_rgb(str(path))
        assert got.shape == want.shape and np.array_equal(got, want), name


def test_python_dash_m_model_entries():
    """``python -m rapiddoc_tpu_torch.models.<stage> --help`` for the four
    stages, run as ``-m`` runs them, in one process."""
    import subprocess

    code = ("import runpy, sys\n"
            "for stage in ('layout', 'ocr', 'formula', 'table'):\n"
            "    sys.argv = ['x', '--help']\n"
            "    try:\n"
            "        runpy.run_module(f'rapiddoc_tpu_torch.models.{stage}', run_name='__main__',"
            " alter_sys=True)\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (stage, e.code)\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    for stage in ("layout", "ocr", "formula", "table"):
        assert f"rapiddoc_tpu_torch.models.{stage}" in r.stdout
