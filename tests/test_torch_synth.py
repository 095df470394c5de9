"""The port's synthetic data (``rapiddoc_tpu_torch/train/synth.py``) against
the JAX package's (``rapiddoc_tpu/train/synth.py``) and the PIL and cv2
calls it makes, on the CPU.

Equal wherever glyph outlines do not decide:
- ``random_text``, ``random_text_lang`` and ``encode_text`` for many seeds;
- ``db_prob_target`` on given boxes;
- ``scan_wash`` on given arrays and seeds, cv2's JPEG round trip included
  (cv2 reads the RGB array as BGR);
- the replays of ``ImageFilter.GaussianBlur`` and ``Image.rotate(expand=True,
  fillcolor=...)`` against PIL, and of ``ImageDraw.rectangle``/``line`` and
  ``Image.paste`` as ``render_page`` uses them;
- the face list (``FONTS``), and the error that names the folders searched
  where none is found.

Where glyphs decide (FreeType hints the faces PIL opens; the port draws
the unhinted outline, ROADMAP item 12e): ``render_line``'s canvas for a
given text, size and face within 1 px a side of PIL's, and its ink, with
the two pens at the same place, within ``tests/test_torch_text.py``'s
bands: DejaVu's (``RASTER_BAND["dejavu"]``) for the DejaVu faces, whose
``fpgm`` sends FreeType to its bytecode hinter, and the autohinted face's
(``RASTER_BAND["aileron"]``) for STIXGeneral, which has no ``fpgm`` and is
autohinted (its readings, 8.7 and 0.057 at worst, sit just outside
DejaVu's share).
"""
import random
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

from rapiddoc_tpu.train import synth as js  # noqa: E402
from rapiddoc_tpu_torch.train import synth as ts  # noqa: E402

# test_torch_text.RASTER_BAND: mean absolute difference over the inked
# pixels, and the share of them more than 64 apart; "dejavu" for a face
# FreeType's bytecode hinter runs, "aileron" for an autohinted one
RASTER_BAND = {"dejavu": (10.0, 0.05), "aileron": (32.0, 0.25)}


def test_fonts_are_the_jax_package_list():
    assert [p.name for p in ts.FONTS] == [p.name for p in js.FONTS]
    assert len(ts.FONTS) >= 6


def test_no_face_raises_naming_the_folders(monkeypatch):
    monkeypatch.setattr(ts, "FONTS", [])
    with pytest.raises(FileNotFoundError, match="dejavu"):
        ts.render_line("abc", random.Random(0))


@pytest.mark.parametrize("seed", range(6))
def test_random_text_and_labels_equal(seed):
    a, b = random.Random(seed), random.Random(seed)
    for max_words in (1, 3, 8, 10):
        ta, tb = ts.random_text(a, max_words), js.random_text(b, max_words)
        assert ta == tb
        assert ts.encode_text(ta, ts.DEMO_CHARSET) == js.encode_text(tb, js.DEMO_CHARSET)
    for lang in ("ru", "en"):
        ta, tb = ts.random_text_lang(a, lang), js.random_text_lang(b, lang)
        assert ta == tb
        cs = ts.LANG_CHARSETS.get(lang, ts.DEMO_CHARSET)
        assert ts.encode_text(ta, cs) == js.encode_text(tb, js.LANG_CHARSETS.get(lang, js.DEMO_CHARSET))
    assert a.random() == b.random()
    assert ts.CYRILLIC_CHARSET == js.CYRILLIC_CHARSET and ts.DEMO_CHARSET == js.DEMO_CHARSET


def test_db_prob_target_equal():
    rng = np.random.default_rng(3)
    boxes = [(10, 10, 200, 30), (5, 40, 8, 60), (300, 300, 301, 330), (600, 10, 700, 50),
             (-5, -5, 40, 20), (100, 100, 104, 104)]
    for _ in range(40):
        x0, y0 = rng.integers(0, 600, 2)
        boxes.append((int(x0), int(y0), int(x0 + rng.integers(1, 300)), int(y0 + rng.integers(1, 60))))
    np.testing.assert_array_equal(ts.db_prob_target(boxes, 640), js.db_prob_target(boxes, 640))


def test_scan_wash_equal_with_the_jpeg_round_trip():
    rng = np.random.default_rng(4)
    jpeg_runs = 0
    for seed in range(24):
        h, w = (int(v) for v in rng.integers(9, 90, 2))
        arr = np.full((h, w, 3), 240, np.uint8)
        arr[h // 4: h // 2, 2: w - 2] = rng.integers(0, 120, 3).astype(np.uint8)
        arr = np.clip(arr.astype(np.int32) + rng.integers(-20, 20, arr.shape), 0, 255).astype(np.uint8)
        a, b = random.Random(seed), random.Random(seed)
        got, want = ts.scan_wash(arr, a), js.scan_wash(arr, b)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert a.random() == b.random()
        probe = random.Random(seed)
        draws = [probe.random()]
        if draws[0] < 0.5:
            probe.uniform(0.45, 0.9)
        if probe.random() < 0.3:
            probe.uniform(0.65, 1.5)
        jpeg_runs += probe.random() < 0.35
    assert jpeg_runs >= 4


def test_jpeg_round_trip_is_cv2s():
    import cv2

    rng = np.random.default_rng(5)
    for q in (25, 47, 80):
        out = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
        out[:, :20] = (200, 30, 90)  # a colour cv2 sees with its channels swapped
        ok, enc = cv2.imencode(".jpg", out, [int(cv2.IMWRITE_JPEG_QUALITY), q])
        np.testing.assert_array_equal(ts._jpeg_round_trip(out, q), cv2.imdecode(enc, cv2.IMREAD_COLOR))


def test_gaussian_blur_is_pils():
    from PIL import Image, ImageFilter

    from rapiddoc_tpu_torch.pdfio.pil_filter import gaussian_blur

    rng = np.random.default_rng(6)
    for i in range(60):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        if i % 2:
            img = np.where(rng.random((h, w, 1)) < 0.3, 10, 245).astype(np.uint8).repeat(3, 2)
        radius = float(rng.random() * (0.8 if i % 3 else 5.0))
        want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius)))
        np.testing.assert_array_equal(gaussian_blur(img, radius), want, err_msg=f"{i} r={radius}")


def test_rotate_with_fillcolor_is_pils():
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.pil_resample import rotate_expand

    rng = np.random.default_rng(7)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(2, 90, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        angle, bg = float(rng.uniform(-2.0, 2.0)), int(rng.integers(235, 256))
        want = np.asarray(Image.fromarray(img).rotate(angle, expand=True, fillcolor=(bg, bg, bg)))
        np.testing.assert_array_equal(rotate_expand(img, angle, fillcolor=(bg, bg, bg)), want)


def test_page_graphics_are_pils():
    """The rectangles, rules, grid lines and pasted patches of
    ``render_page``, clipped at the page's edges, on one canvas."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(8)
    size = 160
    canvas = Image.new("RGB", (size, size), (250, 250, 250))
    draw = ImageDraw.Draw(canvas)
    got = np.full((size, size, 3), 250, np.uint8)
    for _ in range(30):
        gx, y = (int(v) for v in rng.integers(-10, size, 2))
        gw, gh = (int(v) for v in rng.integers(1, 120, 2))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            shade = int(rng.integers(120, 231))
            draw.rectangle([gx, y, gx + gw, y + gh], fill=(shade,) * 3, outline=(80, 80, 80))
            ts._rectangle(got, gx, y, gx + gw, y + gh, (shade,) * 3, (80, 80, 80))
        elif kind == 1:
            width = int(rng.integers(1, 4))
            draw.line([gx, y, gx + gw, y], fill=(60, 60, 60), width=width)
            ts._line(got, [(gx, y), (gx + gw, y)], (60, 60, 60), width)
        elif kind == 2:
            draw.line([gx, y, gx, y + gh], fill=(90, 90, 90))
            ts._line(got, [(gx, y), (gx, y + gh)], (90, 90, 90))
        else:
            gx, y = abs(gx), abs(y)
            patch = rng.integers(60, 220, (gh, gw, 3)).astype(np.uint8)
            canvas.paste(Image.fromarray(patch), (gx, y))
            cut = patch[: max(0, size - y), : max(0, size - gx)]
            got[y:y + cut.shape[0], gx:gx + cut.shape[1]] = cut
        np.testing.assert_array_equal(got, np.asarray(canvas))


def _pil_line_canvas(text, path, size, pad, bg, fg):
    """The JAX ``render_line``'s drawing before its degradations."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(str(path), size)
    bbox = font.getbbox(text)
    w = max(bbox[2] - bbox[0], 1) + 2 * pad
    h = max(bbox[3] - bbox[1], 1) + 2 * pad
    img = Image.new("RGB", (w, h), (bg, bg, bg))
    ImageDraw.Draw(img).text((pad - bbox[0], pad - bbox[1]), text, fill=(fg, fg, fg), font=font)
    return np.asarray(img)


LINE_CASES = [("DejaVuSans.ttf", 22, "Total area 1204 mm"), ("DejaVuSerif.ttf", 31, "the method (b) 0.5%"),
              ("STIXGeneral.ttf", 27, "Figure 3: results"), ("DejaVuSans-Bold.ttf", 40, "data,00 Input"),
              ("DejaVuSansMono.ttf", 25, "x7Qp-(k) 88213"), ("STIXGeneralItalic.ttf", 36, "Rate of water"),
              ("DejaVuSans-Oblique.ttf", 33, "mean, total"), ("STIXGeneralBol.ttf", 30, "Section 4.2"),
              ("DejaVuSerif-Bold.ttf", 38, "Water LEVEL")]


@pytest.mark.parametrize("face,size,text", LINE_CASES)
def test_render_line_canvas_within_band(face, size, text):
    from PIL import ImageFont

    path = next(p for p in ts.FONTS if p.name == face)
    want = _pil_line_canvas(text, path, size, 5, 248, 30)
    got = ts.line_canvas(text, ts._face(str(path), size), 5, 248, 30)
    gb, wb = ts._face(str(path), size).getbbox(text), ImageFont.truetype(str(path), size).getbbox(text)
    assert all(abs(g - w) <= 1 for g, w in zip(gb, wb)), (gb, wb)  # each side within 1 px
    assert (got.shape[0] - want.shape[0], got.shape[1] - want.shape[1]) == (
        (gb[3] - gb[1]) - (wb[3] - wb[1]), (gb[2] - gb[0]) - (wb[2] - wb[0]))
    # both pens at the same place: the port's canvas moved by the boxes' offset
    dx, dy = gb[0] - wb[0], gb[1] - wb[1]
    h, w = max(got.shape[0], want.shape[0]) + 4, max(got.shape[1], want.shape[1]) + 4
    a = np.full((h, w), 248, np.int16)
    b = a.copy()
    a[2 + dy:2 + dy + got.shape[0], 2 + dx:2 + dx + got.shape[1]] = got.min(axis=2)
    b[2:2 + want.shape[0], 2:2 + want.shape[1]] = want.min(axis=2)
    ink = (a < 250) | (b < 250)
    d = np.abs(a - b)[ink]
    assert ink.sum() > 100
    mean_max, share_max = RASTER_BAND["dejavu" if face.startswith("DejaVu") else "aileron"]
    assert d.mean() <= mean_max and (d > 64).mean() <= share_max, (float(d.mean()), float((d > 64).mean()))


def test_render_line_and_rec_sample_shapes():
    img = ts.render_line("a line of text", random.Random(2), height=48)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[0] == 48
    crop, text = ts.rec_sample(random.Random(3))
    assert crop.shape == (48, 320, 3) and text
    crop, text = ts.rec_sample_lang(random.Random(4), "ru")
    assert crop.shape == (48, 320, 3) and any("Ѐ" <= c <= "ӿ" or c.isdigit() for c in text)


def test_render_page_boxes_hold_ink():
    page, boxes, texts = ts.render_page(random.Random(5), 320, with_texts=True)
    assert page.shape == (320, 320, 3) and len(boxes) == len(texts) > 0
    for x0, y0, x1, y1 in boxes:
        assert page[y0:y1, x0:x1].min() < 200  # each line's box holds its glyphs
