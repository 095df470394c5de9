"""The port's FreeType replay (``pdfio/ft_raster.py`` and ``ft_face.py``)
against Pillow 12.1 with FreeType 2.14, on faces FreeType draws unhinted
(seeded random outlines in code-built fonts: TrueType with quadratic
curves, with and without the overlap flag, OpenType CFF and bare CFF with
cubic ones, Type1 with flex).

- ``getmask2(text, "L", anchor=...)`` byte-equal, with its offset, for
  single glyphs and runs of up to five (overlapping glyphs screen over
  each other), from 2 to 120 px;
- ``getbbox`` with and without ``anchor="ls"``;
- raqm's layout on DejaVu Sans (hinted, so only positions are held):
  pair kerning from GPOS and ligatures from GSUB give Pillow's advances.
"""
import io
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import ImageFont

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import torch_font_programs as fb  # noqa: E402
from rapiddoc_tpu_torch.pdfio import ft_raster  # noqa: E402
from rapiddoc_tpu_torch.pdfio.ft_face import Face  # noqa: E402

LETTERS = [chr(c) for c in range(65, 77)]
SIZES = (2, 3, 5, 8, 13, 21, 34, 55, 89, 120)


def _font(kind: str, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    cubic = not kind.startswith("ttf")
    ops = {c: fb.random_glyph(rng, cubic=cubic) for c in LETTERS}
    adv = {c: int(rng.integers(300, 900)) for c in LETTERS}
    if kind in ("ttf", "ttf_overlap"):
        data = fb.build_ttf({f"g{c}": o for c, o in ops.items()},
                            {ord(c): f"g{c}" for c in LETTERS},
                            advances={f"g{c}": a for c, a in adv.items()})
        if kind == "ttf":
            return data
        # OVERLAP_SIMPLE on every glyph: FreeType's 4x4 oversampled render
        t = fb.ttfont(data)
        for c in LETTERS:
            t["glyf"][f"g{c}"].flags[0] |= 0x40
        buf = io.BytesIO()
        t.save(buf)
        return buf.getvalue()
    if kind in ("otf", "cff"):
        return fb.build_otf(ops, {ord(c): c for c in LETTERS}, advances=adv, bare=kind == "cff")
    cs = {".notdef": fb.t1_program(fb.NOTDEF_BOX)}
    for c, o in ops.items():
        flex = next((k for k in range(len(o) - 1) if o[k][0] == "curve" and o[k + 1][0] == "curve"),
                    None)
        cs[c] = fb.t1_program(o, width=adv[c], flex_at=flex)
    return fb.build_type1(cs)


def _strings(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    runs = ["".join(rng.choice(LETTERS + ["Z"], int(rng.integers(2, 6)))) for _ in range(4)]
    return LETTERS[:6] + ["Z"] + runs


@pytest.mark.parametrize("kind", ["ttf", "ttf_overlap", "otf", "cff", "type1"])
@pytest.mark.parametrize("seed", [0, 1])
def test_masks_and_boxes_equal_pillow(kind, seed):
    data = _font(kind, seed)
    for px in SIZES:
        pil, face = ImageFont.truetype(io.BytesIO(data), px), Face(data, px)
        for text in _strings(seed * 100 + px):
            assert face.getbbox(text) == pil.getbbox(text), (px, text)
            assert face.getbbox(text, anchor="ls") == pil.getbbox(text, anchor="ls"), (px, text)
            im, offset = pil.getmask2(text, "L", anchor="ls")
            want = np.asarray(im, np.uint8).reshape(im.size[1], im.size[0])
            got, got_offset = face.getmask(text, anchor="ls")
            assert got_offset == tuple(offset), (px, text)
            assert np.array_equal(got, want), (kind, px, text)


def test_raster_square_exact_area():
    """A square from (0.5, 0.5) to (4.6875, 4.6875) pixels: exact area
    coverage at its edges and corners, 255 inside."""
    pts = np.array([[32, 32], [32, 300], [300, 300], [300, 32]])
    bm, left, top = ft_raster.render(pts, [1, 1, 1, 1], [3])
    assert (left, top) == (0, 5) and bm.shape == (5, 5)
    assert bm[0].tolist() == [88, 176, 176, 176, 121]
    assert bm[2].tolist() == [128, 255, 255, 255, 176]
    assert bm[4].tolist() == [64, 128, 128, 128, 88]


def _dejavu() -> Path:
    import matplotlib

    return Path(matplotlib.get_data_path()) / "fonts" / "ttf" / "DejaVuSans.ttf"


@pytest.mark.parametrize("px", [9, 12, 25, 33, 50, 77])
def test_raqm_positions_on_dejavu(px):
    """Pair kerning (GPOS, class and glyph pairs) and ligatures (GSUB
    liga: fi, ffl) give raqm's advances; boxes' x extents equal (DejaVu is
    hinted in y only, so only the width is held)."""
    path = _dejavu()
    pil, face = ImageFont.truetype(str(path), px), Face(path.read_bytes(), px)
    for text in ["AV", "To", "WAVE", "Type", "LT", "Yo", "office", "fi", "ffl", "P.", "y,", "Hello"]:
        run = face.layout(text)
        assert sum(a for _, a, _ in run) / 64 == pil.getlength(text), (px, text)
        got, want = face.getbbox(text), pil.getbbox(text)
        assert (got[0], got[2]) == (want[0], want[2]), (px, text)
    assert len(face.layout("fi")) == 1 and len(face.layout("ffl")) == 1
