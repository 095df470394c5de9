"""The port's mathtext replay (``rapiddoc_tpu_torch/utils/mathtext.py`` and
``utils/mathtext_raster.py``) against matplotlib 3.10 on the CPU.

- **Bytes**: ``math_to_image`` equal to ``matplotlib.mathtext.math_to_image``
  read back as RGBA under ``text.hinting: none``, for 200 expressions of
  ``random_latex`` (seeds 1234 and 77), each at one dpi of
  ``FormulaCache`` (90/110/130) and one of ``render_formula`` (60-140),
  and for a fixed list spanning the grammar.
- **Extents**: the ``'path'`` parse's width, height and depth equal.
- **The default renders** (``force_autohint``, which the replay does not
  do): shapes equal, each image's ink mass (the sum of ``255 - R``)
  matplotlib's over the port's within ``INK_MASS``, the inked rows' and
  columns' extents within ``INK_ROWS`` and ``INK_COLS`` px. Measured on
  this file's 60 formulas (seeds 1234 and 77, 30 each, at dpis drawn from
  both callers' lists): 0.929-1.165, rows within 3 (one formula; the
  next is 2), columns within 2 (one; the next is 1).
- **Glyphs**: the FreeType 2.6.1 rasterizer and the glyph loader equal to
  ``FT2Font.draw_glyph_to_bitmap`` on glyphs of the shipped faces at
  mathtext's sizes; overlapping glyphs OR-ed; the shipped fonts equal to
  matplotlib's.
- Constructs outside the grammar raise ``ValueError`` naming them.
"""
import io
import random
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"

INK_MASS = (0.90, 1.20)
INK_ROWS = 3
INK_COLS = 2
CACHE_DPIS = (90, 110, 130)
FORMULA_DPIS = (60, 80, 100, 120, 140)
# a hand list spanning the grammar: scripts on bare symbols, nested
# fractions and roots (STIX sizes one to three), limits, spaced and
# unspaced operators, punctuation
GRAMMAR = [
    r"x", r"x^2", r"x_i", r"a^{b}_{c}", r"\alpha_{\beta}^{\gamma}",
    r"-a + b", r"a = -b", r"(a - b)", r"f(x) = 3x", r"a, b; c.", r"1.5 + 2",
    r"\frac{1}{2}", r"\frac{\frac{a}{b}}{\frac{c}{d}}",
    r"\sqrt{x}", r"\sqrt{\frac{a}{b}}", r"\sqrt{\frac{\frac{a}{b}}{\frac{c}{d}}}",
    r"\sqrt{\frac{\frac{\frac{a}{b}}{c}}{\frac{d}{\frac{e}{f}}}}",
    r"\sum_{i=0}^{n} x_i", r"\sum_{k=1}^{N} k",
    r"\int_{0}^{1} f(x) dx", r"\int_{a}^{b} g(t) dt = G",
    r"x < y > z", r"[a, b] / 2", r"|x| * y : z",
    r"\phi \varphi \epsilon \xi \psi \chi \zeta \eta \kappa \nu \upsilon \iota",
]


def mpl_render(latex: str, dpi: int, hinting: str = "none") -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import mathtext, rc_context
    from PIL import Image

    buf = io.BytesIO()
    with rc_context({"text.hinting": hinting}):
        mathtext.math_to_image(f"${latex}$", buf, dpi=dpi, format="png")
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGBA"), np.uint8)


def sample(seed: int, n: int) -> list[str]:
    from rapiddoc_tpu.train.synth_layout import random_latex

    rng = random.Random(seed)
    return [random_latex(rng) for _ in range(n)]


def assert_same(latex: str, dpi: int) -> None:
    from rapiddoc_tpu_torch.utils.mathtext import math_to_image

    want, got = mpl_render(latex, dpi), math_to_image(latex, dpi)
    assert got.shape == want.shape, (latex, dpi, got.shape, want.shape)
    if not np.array_equal(got, want):
        d = np.abs(got.astype(int) - want).max(-1)
        ys, xs = np.nonzero(d)
        raise AssertionError(f"{latex!r} at {dpi} dpi: {len(ys)} px differ (max {d.max()}) "
                             f"in rows {ys.min()}-{ys.max()}, columns {xs.min()}-{xs.max()}")


@pytest.mark.parametrize("seed", [1234, 77])
def test_bytes_equal_matplotlib_unhinted(seed):
    rng = random.Random(seed + 1)
    for k, latex in enumerate(sample(seed, 100)):
        assert_same(latex, CACHE_DPIS[k % 3])
        assert_same(latex, FORMULA_DPIS[rng.randrange(5)])


@pytest.mark.parametrize("latex", GRAMMAR)
def test_grammar_bytes_equal_matplotlib_unhinted(latex):
    for dpi in (60, 110, 140):
        assert_same(latex, dpi)


def test_path_extents_equal_matplotlib():
    from matplotlib.mathtext import MathTextParser

    from rapiddoc_tpu_torch.utils.mathtext import path_extents

    parser = MathTextParser("path")
    for latex in GRAMMAR + sample(5, 60):
        w, h, d, _, _ = parser.parse(f"${latex}$", dpi=72)
        assert path_extents(latex) == (float(w), float(h), float(d)), latex


def ink_extents(img: np.ndarray):
    ink = 255 - img[..., 0].astype(np.int64)
    ys, xs = np.nonzero(ink)
    return ink.sum(), (ys.min(), ys.max()), (xs.min(), xs.max())


def test_default_renders_within_band():
    """Against matplotlib's default (autohinted) renders: the same shapes,
    ink and extents within the band measured on this sample."""
    from rapiddoc_tpu_torch.utils.mathtext import math_to_image

    dpis = CACHE_DPIS + FORMULA_DPIS
    ratios, rows, cols = [], [], []
    for seed in (1234, 77):
        rng = random.Random(seed + 2)
        for latex in sample(seed, 30):
            dpi = dpis[rng.randrange(len(dpis))]
            want, got = mpl_render(latex, dpi, "force_autohint"), math_to_image(latex, dpi)
            assert got.shape == want.shape, (latex, dpi)
            (mw, rw, cw), (mg, rg, cg) = ink_extents(want), ink_extents(got)
            ratios.append(mw / mg)
            rows.append(max(abs(rw[0] - rg[0]), abs(rw[1] - rg[1])))
            cols.append(max(abs(cw[0] - cg[0]), abs(cw[1] - cg[1])))
    assert INK_MASS[0] <= min(ratios) and max(ratios) <= INK_MASS[1], (min(ratios), max(ratios))
    assert max(rows) <= INK_ROWS and max(cols) <= INK_COLS, (max(rows), max(cols))
    # the hinter is the difference: a byte-equal band would mean no hinting
    assert min(ratios) < 0.95 and max(ratios) > 1.1


def test_glyphs_equal_freetype_261():
    """The glyph loader (scale, 1/8 transform, composites) and the 2.6.1
    rasterizer against ``FT2Font.draw_glyph_to_bitmap``, on glyphs of each
    shipped face at sizes mathtext reaches (shrunk scripts, scaled roots)."""
    import matplotlib.ft2font as ft

    from rapiddoc_tpu_torch.utils import mathtext as M, mathtext_raster

    rng = random.Random(3)
    warnings.filterwarnings("ignore", category=DeprecationWarning)
    for key, name in M._FILES.items():
        if not isinstance(key, str) and key != 1:
            continue
        font = M._Font(M._font_file(name))
        ref = ft.FT2Font(str(ASSETS / name), hinting_factor=8)
        codes = sorted(font.cmap)
        for pt, dpi in ((10, 90), (7.000000000000001, 110), (4.9, 130), (10, 60), (31.7, 140)):
            font.set_size(pt, dpi)
            ref.set_size(pt, dpi)
            for code in rng.sample(codes, min(12, len(codes))):
                g = font.load(code)
                want_g = ref.load_char(code, flags=ft.LoadFlags.NO_HINTING)
                assert g.bbox == tuple(want_g.bbox), (name, pt, dpi, hex(code))
                assert (g.width, g.height, g.iceberg, g.advance) == (
                    want_g.width, want_g.height, want_g.horiBearingY,
                    want_g.linearHoriAdvance), (name, pt, dpi, hex(code))
                bm, left, _ = mathtext_raster.render(*g.outline)
                im = ft.FT2Image(bm.shape[1] + 200, bm.shape[0] + 20)
                ref.draw_glyph_to_bitmap(im, 100, 10, want_g)
                want = np.asarray(im)
                got = np.zeros_like(want)
                got[10:10 + bm.shape[0], 100 + left:100 + left + bm.shape[1]] = bm
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {pt} {dpi} {hex(code)}")


def test_overlapping_glyphs_are_ored():
    import matplotlib.ft2font as ft

    from rapiddoc_tpu_torch.utils.mathtext import _draw_bitmap

    warnings.filterwarnings("ignore", category=DeprecationWarning)
    ref = ft.FT2Font(str(ASSETS / "mathtext_DejaVuSans.ttf"), hinting_factor=8)
    ref.set_size(20, 100)
    g1 = ref.load_char(ord("O"), flags=ft.LoadFlags.NO_HINTING)
    g2 = ref.load_char(ord("C"), flags=ft.LoadFlags.NO_HINTING)
    one, two, both = (ft.FT2Image(80, 60) for _ in range(3))
    ref.draw_glyph_to_bitmap(one, 5, 5, g1)
    ref.draw_glyph_to_bitmap(two, 12, 7, g2)
    ref.draw_glyph_to_bitmap(both, 5, 5, g1)
    ref.draw_glyph_to_bitmap(both, 12, 7, g2)
    a, b, want = np.asarray(one), np.asarray(two), np.asarray(both)
    assert ((a > 0) & (b > 0)).sum() > 10
    img = np.zeros((60, 80), np.uint8)
    _draw_bitmap(img, a, 0, 0)
    _draw_bitmap(img, b, 0, 0)
    np.testing.assert_array_equal(img, want)
    assert not np.array_equal(np.maximum(a, b), want)


def test_shipped_fonts_are_matplotlibs():
    import matplotlib

    mpl_fonts = Path(matplotlib.get_data_path()) / "fonts" / "ttf"
    shipped = sorted(ASSETS.glob("mathtext_*.ttf"))
    assert len(shipped) == 6
    for path in shipped:
        assert path.read_bytes() == (mpl_fonts / path.name[len("mathtext_"):]).read_bytes()
    for lic in ("DEJAVU", "STIX"):
        assert (ASSETS / f"mathtext_LICENSE_{lic}.txt").read_bytes() == (
            mpl_fonts / f"LICENSE_{lic}").read_bytes()


@pytest.mark.parametrize("latex, what", [
    (r"\hat{x}", r"\hat"), (r"x'", "apostrophe"), (r"\sqrt[3]{x}", r"\sqrt[...]"),
    (r"x^{2}^{3}", "Double superscript"), (r"\left( x \right)", r"\left"),
    (r"\mathrm{x}", r"\mathrm"), (r"a ? b", "'?'"), (r"\frac{a}", "missing '{'"),
    (r"{a + b", "unclosed group"), (r"x^ 2", "without an argument"), (r"", "empty"),
    (r"\Gamma", r"\Gamma"), (r"\infty", r"\infty"),
])
def test_outside_the_grammar_raises(latex, what):
    from rapiddoc_tpu_torch.utils.mathtext import math_to_image

    with pytest.raises(ValueError, match=re.escape(what)):
        math_to_image(latex, 100)
