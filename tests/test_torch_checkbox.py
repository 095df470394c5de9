"""Checkbox detection in the port (``rapiddoc_tpu_torch/utils/checkbox.py``)
against the JAX package's (``rapiddoc_tpu/utils/checkbox.py``, OpenCV).

- The two OpenCV replays the detector adds beside the port's existing
  contour functions, each equal to cv2 on seeded inputs:
  ``adaptiveThreshold(MEAN_C, THRESH_BINARY_INV, 15, 10)``
  (``utils/morph.adaptive_threshold_mean``: OpenCV's 8-bit box mean with
  a replicated, isolated border, the threshold ``src <= mean - 10``) and
  ``isContourConvex`` of integer points (``utils/contours``).
- ``detect_checkboxes`` equal to the JAX package's on seeded pages, on the
  JAX tests' pictures and on the committed checkbox page.
- The scheduler's step ②b: CheckBox dets with the tick glyph, score 0.9
  and the quad poly, equal to the JAX package's; and ``RapidDoc(
  checkbox_config=...)`` on the committed page, whose dets equal
  ``assets/checkbox_smoke_golden.json`` (the smoke's ``cli`` phase holds
  the card's run to it).

``python tests/test_torch_checkbox.py`` rebuilds the page
(``checkbox_smoke_page.pdf``: boxes, ticks and labels drawn from a seed
with the JAX tests' recipe, the page written by the JAX package's
``images_to_pdf`` at 200 dpi) and the golden (the JAX package's
``RapidDoc`` with the checkbox config the JAX CLI's ``--checkbox`` sets).
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest

from rapiddoc_tpu.utils.checkbox import detect_checkboxes as jax_detect
from rapiddoc_tpu_torch.utils.checkbox import detect_checkboxes
from rapiddoc_tpu_torch.utils.contours import is_contour_convex
from rapiddoc_tpu_torch.utils.morph import adaptive_threshold_mean

ASSETS = Path(__file__).resolve().parent.parent / "rapiddoc_tpu_torch" / "assets"
PAGE_PDF = ASSETS / "checkbox_smoke_page.pdf"
GOLDEN_JSON = ASSETS / "checkbox_smoke_golden.json"
PAGE_SEED = 0
# the parse the golden holds: the JAX CLI's --checkbox, no model stage
PARSE_ENV = {"RAPIDDOC_DISABLE_OCR": "1", "RAPIDDOC_DISABLE_LAYOUT": "1",
             "RAPIDDOC_DISABLE_FORMULA": "1", "RAPIDDOC_DISABLE_TABLE": "1"}
CHECKBOX_CONFIG = {"checkbox_enable": True}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(2)


def checkbox_page(seed: int = PAGE_SEED) -> np.ndarray:
    """A 900 x 640 form: eight labelled boxes (22-33 px, 2 px strokes),
    about half ticked with two 3 px strokes, as the JAX tests draw them."""
    from PIL import Image, ImageDraw, ImageFont

    rng = np.random.default_rng(seed)
    words = ["accept terms", "send copy", "urgent", "signed", "paid", "archive",
             "notify me", "approved"]
    rows = []
    for i, word in enumerate(words):
        x, y = 60 + 420 * (i % 2), 60 + 130 * (i // 2) + int(rng.integers(0, 20))
        rows.append((x, y, int(rng.integers(22, 34)), bool(rng.integers(0, 2)), word))
    img = np.full((640, 900, 3), 255, np.uint8)
    for x, y, s, ticked, _ in rows:
        cv2.rectangle(img, (x, y), (x + s, y + s), (0, 0, 0), 2)
        if ticked:
            cv2.line(img, (x + 4, y + 4), (x + s - 4, y + s - 4), (0, 0, 0), 3)
            cv2.line(img, (x + s - 4, y + 4), (x + 4, y + s - 4), (0, 0, 0), 3)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    font = ImageFont.load_default(size=28)
    for x, y, s, _, word in rows:
        draw.text((x + s + 16, y - 2), word, fill=(0, 0, 0), font=font)
    return np.asarray(pil)


def jax_tests_pictures() -> dict[str, np.ndarray]:
    """The pictures of tests/test_longtail.py::test_checkbox_detection and
    tests/test_scheduler_extras.py::test_checkbox_dets_in_scheduler."""
    a = np.full((100, 200, 3), 255, np.uint8)
    cv2.rectangle(a, (20, 20), (44, 44), (0, 0, 0), 2)
    cv2.rectangle(a, (80, 20), (104, 44), (0, 0, 0), 2)
    cv2.line(a, (84, 24), (100, 40), (0, 0, 0), 3)
    cv2.line(a, (100, 24), (84, 40), (0, 0, 0), 3)
    b = np.full((200, 300, 3), 255, np.uint8)
    cv2.rectangle(b, (50, 50), (80, 80), (0, 0, 0), 2)
    cv2.rectangle(b, (120, 50), (150, 80), (0, 0, 0), 2)
    cv2.line(b, (124, 54), (146, 76), (0, 0, 0), 3)
    cv2.line(b, (146, 54), (124, 76), (0, 0, 0), 3)
    return {"longtail": a, "scheduler": b}


def seeded_form(seed: int) -> np.ndarray:
    """Boxes of random size, stroke, tick and grey on a noisy page, with
    rectangles, circles and text that are no checkboxes."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(120, 260)), int(rng.integers(160, 320))
    img = rng.integers(225, 256, (h, w, 3), dtype=np.uint8)
    for _ in range(int(rng.integers(3, 9))):
        s = int(rng.integers(6, 70))
        x, y = int(rng.integers(0, max(w - s, 1))), int(rng.integers(0, max(h - s, 1)))
        ink = tuple(int(v) for v in rng.integers(0, 120, 3))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            cv2.circle(img, (x + s // 2, y + s // 2), s // 2, ink, 2)
        elif kind == 1:
            cv2.rectangle(img, (x, y), (x + s + int(rng.integers(10, 40)), y + s), ink, 2)
        elif kind == 2:
            cv2.putText(img, "Ok", (x, y + s), cv2.FONT_HERSHEY_SIMPLEX, s / 40, ink, 2)
        else:
            cv2.rectangle(img, (x, y), (x + s, y + s + int(rng.integers(-3, 4))), ink,
                          int(rng.integers(1, 4)))
            if kind == 4:
                cv2.line(img, (x + 3, y + s // 2), (x + s // 2, y + s - 3), ink, 3)
                cv2.line(img, (x + s // 2, y + s - 3), (x + s - 2, y + 2), ink, 3)
    return img


# ------------------------------------------------------------- the replays

@pytest.mark.parametrize("seed", range(6))
def test_adaptive_threshold_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for shape in [(int(rng.integers(1, 40)), int(rng.integers(1, 40))),
                  (int(rng.integers(40, 200)), int(rng.integers(40, 200)))]:
        gray = rng.integers(0, 256, shape, dtype=np.uint8)
        if seed % 2:
            gray = (gray // 64 * 80).astype(np.uint8)  # flat runs: means on exact values
        want = cv2.adaptiveThreshold(gray, 255, cv2.ADAPTIVE_THRESH_MEAN_C,
                                     cv2.THRESH_BINARY_INV, 15, 10)
        assert np.array_equal(adaptive_threshold_mean(gray, 255, 15, 10, inverse=True), want)


@pytest.mark.parametrize("seed", range(4))
def test_is_contour_convex_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(500):
        pts = rng.integers(-6, 7, (int(rng.integers(1, 8)), 1, 2)).astype(np.int32)
        assert is_contour_convex(pts) == cv2.isContourConvex(pts), pts.reshape(-1, 2).tolist()
    # the detector's shapes: approximated quads of real boxes
    for img in jax_tests_pictures().values():
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        binary = cv2.adaptiveThreshold(gray, 255, cv2.ADAPTIVE_THRESH_MEAN_C,
                                       cv2.THRESH_BINARY_INV, 15, 10)
        for c in cv2.findContours(binary, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)[0]:
            quad = cv2.approxPolyDP(c, 0.04 * cv2.arcLength(c, True), True)
            assert is_contour_convex(quad) == cv2.isContourConvex(quad)


# ---------------------------------------------------------- the detector

@pytest.mark.parametrize("name", ["longtail", "scheduler", "page"])
def test_detect_checkboxes_equals_jax_on_pictures(name):
    img = checkbox_page() if name == "page" else jax_tests_pictures()[name]
    got = detect_checkboxes(img)
    assert got == jax_detect(img)
    assert got and {r["checked"] for r in got} == {True, False}


@pytest.mark.parametrize("seed", range(8))
def test_detect_checkboxes_equals_jax_on_seeded_forms(seed):
    img = seeded_form(seed)
    assert detect_checkboxes(img) == jax_detect(img)
    grey = img[..., 0].copy()  # an (H, W) page skips the grey conversion
    assert detect_checkboxes(grey) == jax_detect(grey)


def test_scheduler_checkbox_dets_equal_jax():
    """Step ②b on test_scheduler_extras.py's picture: the dets (glyph,
    score, poly) and their place among the others equal the JAX
    package's."""
    from rapiddoc_tpu.pipeline.scheduler import DocumentAnalyzer as JaxAnalyzer
    from rapiddoc_tpu_torch.pipeline.scheduler import DocumentAnalyzer
    from rapiddoc_tpu_torch.types import CategoryId

    img = jax_tests_pictures()["scheduler"]
    got = DocumentAnalyzer(checkbox_enable=True).analyze_pages([img], ["txt"], [None])
    assert got == JaxAnalyzer(checkbox_enable=True).analyze_pages([img], ["txt"], [None])
    cb = [d for d in got[0]["layout_dets"] if d["category_id"] == CategoryId.CheckBox]
    assert {d["checkbox"] for d in cb} == {"☑", "☐"} and {d["score"] for d in cb} == {0.9}
    assert DocumentAnalyzer().analyze_pages([img], ["txt"], [None]) == [{"layout_dets": []}]


def checkbox_dets(model_json: list) -> list:
    from rapiddoc_tpu_torch.types import CategoryId

    return [[d for d in page["layout_dets"] if d["category_id"] == CategoryId.CheckBox]
            for page in model_json]


def test_committed_page_is_rebuilt_by_its_recipe():
    from PIL import Image
    from rapiddoc_tpu.pdfio import images_to_pdf

    assert images_to_pdf([Image.fromarray(checkbox_page())], dpi=200) == PAGE_PDF.read_bytes()
    assert PAGE_PDF.stat().st_size < 50_000


def test_rapiddoc_checkbox_dets_equal_golden(monkeypatch):
    """The port's facade with the JAX CLI's --checkbox config on the
    committed page: its checkbox dets, and the raster they come from,
    equal the golden."""
    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    for k, v in PARSE_ENV.items():
        monkeypatch.setenv(k, v)
    golden = json.loads(GOLDEN_JSON.read_text())
    pdf = PAGE_PDF.read_bytes()
    img = render_page_full(open_pdf(pdf).get_page(0), dpi=200, with_text=False)[0]
    assert hashlib.sha256(img.tobytes()).hexdigest() == golden["page_sha256"]
    out = RapidDoc(device="cpu", checkbox_config=CHECKBOX_CONFIG)(pdf, parse_method="ocr")
    assert checkbox_dets(out.model_json) == golden["dets"]
    assert len(golden["dets"][0]) == 8


def build_assets() -> None:
    """Rewrite the committed page and its golden with the JAX package."""
    from PIL import Image
    from rapiddoc_tpu import pdfio
    from rapiddoc_tpu.api import RapidDoc as JaxRapidDoc
    from rapiddoc_tpu.pdfio.render import render_page_full as jax_render

    os.environ.update(PARSE_ENV)
    pdf = pdfio.images_to_pdf([Image.fromarray(checkbox_page())], dpi=200)
    PAGE_PDF.write_bytes(pdf)
    img = np.asarray(jax_render(pdfio.open_pdf(pdf).get_page(0), dpi=200, with_text=False)[0])
    out = JaxRapidDoc(checkbox_config=CHECKBOX_CONFIG)(pdf, parse_method="ocr")
    golden = {"page_sha256": hashlib.sha256(img.tobytes()).hexdigest(),
              "dets": json.loads(json.dumps(checkbox_dets(out.model_json)))}
    GOLDEN_JSON.write_text(json.dumps(golden, indent=1, ensure_ascii=False) + "\n")
    print(f"wrote {PAGE_PDF.name} ({len(pdf)} bytes) and {GOLDEN_JSON.name}: "
          f"{len(golden['dets'][0])} boxes")


if __name__ == "__main__":
    build_assets()
