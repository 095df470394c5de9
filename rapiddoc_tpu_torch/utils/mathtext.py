"""matplotlib's mathtext, replayed for the formulas the trainers draw.

``math_to_image(latex, dpi)`` gives what
``np.asarray(Image.open(png).convert("RGBA"))`` gives after
``matplotlib.mathtext.math_to_image(f"${latex}$", png, dpi=dpi,
format="png")`` under matplotlib 3.10's default rcParams
(``mathtext.fontset`` ``dejavusans``, ``mathtext.default`` ``it``,
``font.size`` 10, black antialiased text on a white figure), and
``path_extents(latex)`` the ``'path'`` parse's ``(width, height, depth)``
that sizes the figure.

The declared difference: the replay draws unhinted outlines. matplotlib
draws its pixels from a parse under ``text.hinting: force_autohint`` (the
default), FreeType's autohinter, which is not replayed (ROADMAP item 12e).
The replay is byte-equal to matplotlib under ``text.hinting: none``; against
the default it has the same shape (the figure is sized by the ``'path'``
parse, which loads glyphs with ``NO_HINTING`` in both) and lies in a band of
ink mass and extents that ``tests/test_torch_mathtext.py`` measures.

What is replayed, by the lines of matplotlib 3.10's ``_mathtext.py``:

- The grammar of ``train/synth_layout.random_latex``: Latin letters,
  digits, ``+ - = ( ) [ ] / < > : | * , . ;``, the lowercase Greek
  letters, ``^{}`` and ``_{}`` (also on a bare symbol), ``{}`` groups,
  ``\\frac``, ``\\sqrt`` (no index), ``\\sum`` (an over/under symbol, ``:1935``)
  and ``\\int`` (a drop-sub symbol, ``:1942``). Tokens are read by a
  recursive-descent parser in place of pyparsing's grammar (``:2000-2140``);
  anything else raises ``ValueError`` naming it.
- The handlers (``:2160-2680``): ``symbol`` with the spacing around binary
  operators and relations (a fifth of the italic ``m``'s advance either
  side), ``subsuper`` (over/under limits, drop-sub limits, ordinary
  scripts), ``_genfrac`` at text style and ``sqrt`` with its
  ``AutoHeightChar``.
- The box model (``:1004-1586``): ``Char``, ``Kern``, ``Glue``, ``Hlist``
  and ``Vlist`` packing with their kerning, ``Hrule``, ``HCentered``,
  ``AutoHeightChar`` and ``ship`` (``:1586``), including ``ship``'s habit
  of setting an ``Hlist``'s width to its ``Vlist``'s (so the second ship
  of ``to_raster`` sees the widths the first one left).
- The glyph choice of ``DejaVuSansFonts``/``DejaVuFonts``/``UnicodeFonts``
  (``:534-742``): DejaVu Sans Display first where it has the character,
  else the italic face for letters (lowercase Greek included) and the
  upright face for everything else; the square root's sizes are
  ``StixFonts.get_sized_alternatives_for_symbol`` (``:835``): DejaVu Sans,
  then STIX sizes one to three. The constants are
  ``DejaVuSansFontConstants`` (``:964``), the x-height is the italic
  ``x``'s top (the fonts have no ``PCLT`` table), the rule thickness
  ``0.75 / 12 * fontsize * dpi / 72``.
- Glyph metrics as ``TruetypeFonts._get_info`` takes them (``:362-427``)
  from FreeType 2.6.1 (matplotlib's bundled copy) after
  ``FT2Font.set_size(pt, dpi)``: ``FT_Set_Char_Size(pt * 64, 0, dpi * 8,
  dpi)`` (hinting factor 8), the ppem rounded to whole pixels as the
  fonts' ``head`` flags ask (``x_scale = FT_DivFix(x_ppem << 6, upem)``),
  then ``FT_Set_Transform`` by 1/8 in x, which ``FT_MulFix(x, 0x2000)``
  applies to every point. The advance is ``linearHoriAdvance / 8`` (C
  division), the width the untransformed control box's width ``/ 8``,
  the box the transformed control box, the iceberg its top. A composite's
  offsets with ``ROUND_XY_TO_GRID`` are rounded to whole pixels in x and y,
  and the outline moves by the scaled ``xMin - lsb`` (FreeType's pp1),
  unrounded. Kerning is the legacy ``kern`` table looked up with the two
  characters' codes (as matplotlib passes them), scaled by ``FT_MulFix``,
  shrunk by ``x_ppem / 25`` under 25 ppem, rounded to a pixel and divided
  by 8 in C.

The raster (``Output.to_raster``, ``:136-170``; ``backend_agg.py:173-183``):

- A glyph's bitmap is FreeType 2.6.1's smooth render of the transformed
  outline (``utils/mathtext_raster``), placed with its left column at
  ``int(ox) + bitmap_left`` and its top row at ``int(oy - iceberg)``.
- Where two glyphs overlap, their bytes are OR-ed (``*dst |= *src``), found
  by drawing overlapping glyphs with ``FT2Font.draw_glyph_to_bitmap``:
  neither the larger nor the sum matches, the OR does.
- A rule fills rows ``y .. y + h`` and columns ``int(x1) .. ceil(x2)``
  inclusive with 255, ``h = max(int(y2 - y1) - 1, 0)`` and ``y = int(y1)``
  (or the centre's ``int(c - 0.5)`` for a one-row rule).
- The figure is ``int(w / 72 * dpi)`` by ``int(h / 72 * dpi)`` pixels of
  white for the ``'path'`` parse's ``w`` and ``h``; the text image's last
  row sits on row ``round(H - H * depth / height + d)`` (Python's
  round-half-even of the float figure height ``H`` less the baseline,
  plus the raster parse's depth ``d``), its first column on column 0.
- Each covered pixel blends black over white as Agg's
  ``fixed_blender_rgba_plain`` does: cover 255 writes black, a cover
  ``c`` writes ``65025 * (256 - a) // (65280 + a)`` to R, G and B with
  ``a = ((255 * c + 128) >> 8) + 255 * c + 128 >> 8``, alpha stays 255.

These rules were found by experiment against matplotlib 3.10.8 with its
FreeType 2.6.1; ``tests/test_torch_mathtext.py`` holds them byte for byte.
The fonts are matplotlib's own files, shipped in ``assets/`` as
``mathtext_*.ttf`` with ``mathtext_LICENSE_DEJAVU.txt`` and
``mathtext_LICENSE_STIX.txt``.
"""
from __future__ import annotations

import functools
import math
import unicodedata
from pathlib import Path

import numpy as np

from ..pdfio.cff import divfix, mulfix
from ..pdfio.sfnt import ARGS_ARE_XY_VALUES, ROUND_XY_TO_GRID, SCALED_COMPONENT_OFFSET, Sfnt
from . import mathtext_raster

_ASSETS = Path(__file__).resolve().parent.parent / "assets"
_FILES = {
    "rm": "mathtext_DejaVuSans.ttf",
    "it": "mathtext_DejaVuSans-Oblique.ttf",
    "ex": "mathtext_DejaVuSansDisplay.ttf",
    0: "mathtext_DejaVuSans.ttf",
    1: "mathtext_STIXSizOneSymReg.ttf",
    2: "mathtext_STIXSizTwoSymReg.ttf",
    3: "mathtext_STIXSizThreeSymReg.ttf",
}
HINTING_FACTOR = 8
FONT_SIZE = 10.0

# _mathtext_data.tex2uni, the entries the grammar reaches
TEX2UNI = {
    "alpha": 945, "beta": 946, "gamma": 947, "delta": 948, "epsilon": 949,
    "varepsilon": 949, "zeta": 950, "eta": 951, "theta": 952, "vartheta": 977,
    "iota": 953, "kappa": 954, "lambda": 955, "mu": 956, "nu": 957, "xi": 958,
    "pi": 960, "varpi": 982, "rho": 961, "varrho": 1009, "sigma": 963,
    "varsigma": 962, "tau": 964, "upsilon": 965, "phi": 981, "varphi": 966,
    "chi": 967, "psi": 968, "omega": 969, "sum": 8721, "int": 8747,
    "__sqrt__": 8730,
}
_PLAIN = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+-=()[]/<>:|*,.;")
_BINARY = {"+", "*", "-", "\N{MINUS SIGN}"}
_RELATIONS = {"=", "<", ">", ":"}
_SPACED = _BINARY | _RELATIONS
_PUNCTUATION = {",", ";", "."}
_LEFT_DELIMS = {"(", "[", "<"}
_OVERUNDER = {"\\sum"}
_DROPSUB = {"\\int"}
_SLANTED = {"\\int"}
# StixFonts.get_sized_alternatives_for_symbol("\\__sqrt__"): the fonts of
# STIXGeneral and STIX sizes one to five holding U+221A are 0-4, the last
# dropped; font 0 is DejaVu Sans in the DejaVu fontset's map
_SQRT_ALTERNATIVES = (0, 1, 2, 3)

SHRINK_FACTOR = 0.7
NUM_SIZE_LEVELS = 6
# FontConstantsBase (DejaVuSansFontConstants adds nothing)
SCRIPT_SPACE, SUBDROP, SUP1, SUB1, SUB2 = 0.05, 0.4, 0.7, 0.3, 0.5
DELTA, DELTA_SLANTED, DELTA_INTEGRAL = 0.025, 0.2, 0.1


def _pix_round(v: int) -> int:
    return ((v + 32) // 64) * 64


def _muldiv(a: int, b: int, c: int) -> int:
    s = -1 if (a < 0) != (b < 0) else 1
    return s * ((abs(a) * abs(b) + (c >> 1)) // c)


# ------------------------------------------------------------------ fonts

class _Glyph:
    __slots__ = ("num", "advance", "width", "height", "bbox", "iceberg", "outline")

    def __init__(self, num, advance, width, height, bbox, iceberg, outline):
        self.num, self.advance, self.width, self.height = num, advance, width, height
        self.bbox, self.iceberg, self.outline = bbox, iceberg, outline


class _FontFile:
    """One TrueType file, parsed once a process: its tables and the glyphs
    loaded so far at each scale (shared by every parse)."""

    def __init__(self, path: Path) -> None:
        self.sfnt = Sfnt(path.read_bytes())
        self.cmap = self.sfnt.cmap
        self.upem = self.sfnt.units_per_em
        self.kern = self.sfnt.kern_pairs()
        self.glyphs: dict = {}


@functools.lru_cache(maxsize=None)
def _font_file(name: str) -> _FontFile:
    return _FontFile(_ASSETS / name)


class _Font:
    """One file as an ``FT2Font`` holds it within a parse: a current size,
    glyph loads at that size and kerning at that size."""

    def __init__(self, file: _FontFile) -> None:
        self.file = file
        self.cmap = file.cmap
        self.size = (0, 0, 0)  # (x_scale, y_scale, x_ppem)

    def char_index(self, code: int) -> int:
        return self.cmap.get(code, 0)

    def set_size(self, ptsize: float, dpi: float) -> None:
        """``FT_Set_Char_Size(ptsize * 64, 0, dpi * 8, dpi)``."""
        cw = max(int(ptsize * 64), 64)
        sw = (cw * int(dpi * HINTING_FACTOR) + 36) // 72
        sh = (cw * int(dpi) + 36) // 72
        x_ppem, y_ppem = (sw + 32) >> 6, (sh + 32) >> 6
        upem = self.file.upem
        self.size = (divfix(x_ppem << 6, upem), divfix(y_ppem << 6, upem), x_ppem)

    def _outline(self, gid: int, xs: int, ys: int, depth: int = 0):
        f = self.file.sfnt
        g = f.glyph(gid)
        if g.components is None:
            pts = np.array([[mulfix(int(x), xs), mulfix(int(y), ys)] for x, y in g.points],
                           np.int64).reshape(-1, 2)
            return pts, np.asarray(g.tags, np.int8), list(g.ends)
        if depth > 8:
            raise ValueError("mathtext glyph %d nests its components too deeply" % gid)
        pts = np.zeros((0, 2), np.int64)
        tags = np.zeros(0, np.int8)
        ends: list[int] = []
        for sub, flags, a1, a2, m in g.components:
            cp, ct, ce = self._outline(sub, xs, ys, depth + 1)
            cp = cp.copy()
            if m is not None:
                xx, xy, yx, yy = m
                cp = np.array([[mulfix(int(x), xx) + mulfix(int(y), xy),
                                mulfix(int(x), yx) + mulfix(int(y), yy)] for x, y in cp],
                              np.int64).reshape(-1, 2)
            if flags & ARGS_ARE_XY_VALUES:
                x, y = a1, a2
                if m is not None and flags & SCALED_COMPONENT_OFFSET:
                    x = mulfix(x, int(round(math.hypot(m[0], m[2]))))
                    y = mulfix(y, int(round(math.hypot(m[3], m[1]))))
                x, y = mulfix(x, xs), mulfix(y, ys)
                if flags & ROUND_XY_TO_GRID:
                    x, y = _pix_round(x), _pix_round(y)
            else:
                x = int(pts[a1][0] - cp[a2][0])
                y = int(pts[a1][1] - cp[a2][1])
            cp[:, 0] += x
            cp[:, 1] += y
            base = len(pts)
            pts = np.concatenate([pts, cp])
            tags = np.concatenate([tags, ct])
            ends += [e + base for e in ce]
        return pts, tags, ends

    def load(self, code: int) -> _Glyph:
        """``FT2Font.load_char(code, NO_HINTING)`` at the current size."""
        xs, ys, _ = self.size
        key = (code, xs, ys)
        g = self.file.glyphs.get(key)
        if g is not None:
            return g
        sfnt = self.file.sfnt
        gid = self.char_index(code)
        pts, tags, ends = self._outline(gid, xs, ys)
        shift = int(sfnt.glyph(gid).xmin) - int(sfnt.lsbs[gid])
        if shift and len(pts):
            pts = pts.copy()
            pts[:, 0] -= mulfix(shift, xs)
        if len(pts):
            x0, y0 = int(pts[:, 0].min()), int(pts[:, 1].min())
            x1, y1 = int(pts[:, 0].max()), int(pts[:, 1].max())
        else:
            x0 = y0 = x1 = y1 = 0
        tp = pts.copy()
        tp[:, 0] = [mulfix(int(x), 0x10000 // HINTING_FACTOR) for x in pts[:, 0]]
        bbox = (int(tp[:, 0].min()), y0, int(tp[:, 0].max()), y1) if len(tp) else (0, 0, 0, 0)
        linear = _muldiv(sfnt.advance(gid), xs, 64)
        g = _Glyph(code, int(linear / HINTING_FACTOR), int((x1 - x0) / HINTING_FACTOR),
                   y1 - y0, bbox, y1, (tp, tags, ends))
        self.file.glyphs[key] = g
        return g

    def kerning(self, left: int, right: int) -> int:
        """``FT2Font.get_kerning(left, right, Kerning.DEFAULT)`` at the
        current size, the codes taken as glyph ids."""
        v = self.file.kern.get((left, right), 0)
        if not v:
            return 0
        xs, _, x_ppem = self.size
        x = mulfix(v, xs)
        if x_ppem < 25:
            x = _muldiv(x, x_ppem, 25)
        return int(_pix_round(x) / HINTING_FACTOR)


class FontMetrics:
    __slots__ = ("advance", "height", "width", "xmin", "xmax", "ymin", "ymax", "iceberg", "slanted")

    def __init__(self, advance, height, width, xmin, xmax, ymin, ymax, iceberg, slanted):
        self.advance, self.height, self.width = advance, height, width
        self.xmin, self.xmax, self.ymin, self.ymax = xmin, xmax, ymin, ymax
        self.iceberg, self.slanted = iceberg, slanted


class _Info:
    __slots__ = ("font", "fontsize", "metrics", "num", "glyph")

    def __init__(self, font, fontsize, metrics, num, glyph):
        self.font, self.fontsize, self.metrics, self.num, self.glyph = font, fontsize, metrics, num, glyph


def unicode_index(sym: str) -> int:
    if len(sym) == 1:
        return ord(sym)
    try:
        return TEX2UNI[sym.strip("\\")]
    except KeyError:
        raise ValueError("mathtext symbol %r is not replayed" % sym) from None


class DejaVuSansFonts:
    """``DejaVuSansFonts`` for one parse: ``_get_info`` cached per
    instance, as ``TruetypeFonts.__init__`` caches it."""

    def __init__(self) -> None:
        self._info: dict = {}
        self._fonts: dict[str, _Font] = {}  # by file: 'rm' and 0 share one

    def _font(self, name) -> _Font:
        file = _FILES[name]
        font = self._fonts.get(file)
        if font is None:
            font = self._fonts[file] = _Font(_font_file(file))
        return font

    def _get_glyph(self, fontname, sym: str) -> tuple[_Font, int, bool]:
        # DejaVuFonts._get_glyph: the display face first
        uniindex = unicode_index(sym)
        if self._font("ex").char_index(uniindex):
            fontname = "ex"
        # UnicodeFonts._get_glyph
        new_fontname = fontname
        if fontname == "it" and uniindex < 0x10000:
            char = chr(uniindex)
            if (unicodedata.category(char)[0] != "L"
                    or unicodedata.name(char).startswith("GREEK CAPITAL")):
                new_fontname = "rm"
        slanted = (new_fontname == "it") or sym in _SLANTED
        font = self._font(new_fontname)
        if not font.char_index(uniindex):
            raise ValueError("mathtext symbol %r needs matplotlib's STIX fallback, not replayed" % sym)
        return font, uniindex, slanted

    def get_info(self, fontname, sym: str, fontsize: float, dpi: float) -> _Info:
        key = (fontname, sym, fontsize, dpi)
        info = self._info.get(key)
        if info is None:
            font, num, slanted = self._get_glyph(fontname, sym)
            font.set_size(fontsize, dpi)
            g = font.load(num)
            xmin, ymin, xmax, ymax = (v / 64 for v in g.bbox)
            metrics = FontMetrics(
                advance=g.advance / 65536, height=g.height / 64, width=g.width / 64,
                xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
                iceberg=g.iceberg / 64, slanted=slanted)
            info = _Info(font, fontsize, metrics, num, g)
            self._info[key] = info
        return info

    def get_xheight(self, fontname, fontsize: float, dpi: float) -> float:
        self._font(fontname).set_size(fontsize, dpi)
        return self.get_info(fontname, "x", fontsize, dpi).metrics.iceberg

    @staticmethod
    def get_underline_thickness(fontsize: float, dpi: float) -> float:
        return ((0.75 / 12.0) * fontsize * dpi) / 72.0

    def get_kern(self, c1: Char, c2: Char) -> float:
        if c1.font == c2.font and c1.fontsize == c2.fontsize:
            info1 = self.get_info(c1.font, c1.c, c1.fontsize, c1.dpi)
            info2 = self.get_info(c2.font, c2.c, c2.fontsize, c2.dpi)
            return info1.font.kerning(info1.num, info2.num) / 64
        return 0.0


class State:
    __slots__ = ("fontset", "font", "fontsize", "dpi")

    def __init__(self, fontset, font, fontsize, dpi):
        self.fontset, self.font, self.fontsize, self.dpi = fontset, font, fontsize, dpi

    def copy(self) -> State:
        return State(self.fontset, self.font, self.fontsize, self.dpi)

    def thickness(self) -> float:
        return self.fontset.get_underline_thickness(self.fontsize, self.dpi)


# ------------------------------------------------------------- box model

class Node:
    def __init__(self) -> None:
        self.size = 0

    def get_kerning(self, next) -> float:
        return 0.0

    def shrink(self) -> None:
        self.size += 1


class Box(Node):
    def __init__(self, width: float, height: float, depth: float) -> None:
        super().__init__()
        self.width, self.height, self.depth = width, height, depth

    def shrink(self) -> None:
        super().shrink()
        if self.size < NUM_SIZE_LEVELS:
            self.width *= SHRINK_FACTOR
            self.height *= SHRINK_FACTOR
            self.depth *= SHRINK_FACTOR

    def render(self, output: Output, x1: float, y1: float, x2: float, y2: float) -> None:
        pass


class Vbox(Box):
    def __init__(self, height: float, depth: float) -> None:
        super().__init__(0.0, height, depth)


class Hbox(Box):
    def __init__(self, width: float) -> None:
        super().__init__(width, 0.0, 0.0)


class Char(Node):
    def __init__(self, c: str, state: State) -> None:
        super().__init__()
        self.c = c
        self.fontset = state.fontset
        self.font = state.font
        self.fontsize = state.fontsize
        self.dpi = state.dpi
        m = self._metrics = self.fontset.get_info(self.font, c, self.fontsize, self.dpi).metrics
        self.width = m.advance if c == " " else m.width
        self.height = m.iceberg
        self.depth = -(m.iceberg - m.height)

    def get_kerning(self, next) -> float:
        advance = self._metrics.advance - self.width
        kern = 0.0
        if isinstance(next, Char):
            kern = self.fontset.get_kern(self, next)
        return advance + kern

    def render(self, output: Output, x: float, y: float) -> None:
        output.glyphs.append((x, y, self.fontset.get_info(self.font, self.c, self.fontsize, self.dpi)))

    def shrink(self) -> None:
        super().shrink()
        if self.size < NUM_SIZE_LEVELS:
            self.fontsize *= SHRINK_FACTOR
            self.width *= SHRINK_FACTOR
            self.height *= SHRINK_FACTOR
            self.depth *= SHRINK_FACTOR


class List(Box):
    def __init__(self, elements) -> None:
        super().__init__(0.0, 0.0, 0.0)
        self.shift_amount = 0.0
        self.children = [*elements]
        self.glue_set = 0.0
        self.glue_sign = 0
        self.glue_order = 0

    def _set_glue(self, x: float, sign: int, totals: list) -> None:
        self.glue_order = o = next((i for i in range(len(totals))[::-1] if totals[i] != 0), 0)
        self.glue_sign = sign
        if totals[o] != 0.0:
            self.glue_set = x / totals[o]
        else:
            self.glue_sign = 0

    def shrink(self) -> None:
        for child in self.children:
            child.shrink()
        super().shrink()
        if self.size < NUM_SIZE_LEVELS:
            self.shift_amount *= SHRINK_FACTOR
            self.glue_set *= SHRINK_FACTOR


class Hlist(List):
    def __init__(self, elements, w: float = 0.0, m: str = "additional", do_kern: bool = True) -> None:
        super().__init__(elements)
        if do_kern:
            self.kern()
        self.hpack(w=w, m=m)

    def kern(self) -> None:
        new_children = []
        n = len(self.children)
        for i in range(n):
            elem = self.children[i]
            nxt = self.children[i + 1] if i < n - 1 else None
            new_children.append(elem)
            d = elem.get_kerning(nxt)
            if d != 0.0:
                new_children.append(Kern(d))
        self.children = new_children

    def hpack(self, w: float = 0.0, m: str = "additional") -> None:
        h = d = x = 0.0
        total_stretch = [0.0] * 4
        total_shrink = [0.0] * 4
        for p in self.children:
            if isinstance(p, Char):
                x += p.width
                h = max(h, p.height)
                d = max(d, p.depth)
            elif isinstance(p, Box):
                x += p.width
                if not np.isinf(p.height) and not np.isinf(p.depth):
                    s = getattr(p, "shift_amount", 0.0)
                    h = max(h, p.height - s)
                    d = max(d, p.depth + s)
            elif isinstance(p, Glue):
                g = p.glue_spec
                x += g[0]
                total_stretch[g[2]] += g[1]
                total_shrink[g[4]] += g[3]
            elif isinstance(p, Kern):
                x += p.width
        self.height = h
        self.depth = d
        if m == "additional":
            w += x
        self.width = w
        x = w - x
        if x == 0.0:
            self.glue_sign = 0
            self.glue_order = 0
            return
        if x > 0.0:
            self._set_glue(x, 1, total_stretch)
        else:
            self._set_glue(x, -1, total_shrink)


class Vlist(List):
    def __init__(self, elements, h: float = 0.0, m: str = "additional") -> None:
        super().__init__(elements)
        self.vpack(h=h, m=m)

    def vpack(self, h: float = 0.0, m: str = "additional", l: float = np.inf) -> None:
        w = d = x = 0.0
        total_stretch = [0.0] * 4
        total_shrink = [0.0] * 4
        for p in self.children:
            if isinstance(p, Box):
                x += d + p.height
                d = p.depth
                if not np.isinf(p.width):
                    s = getattr(p, "shift_amount", 0.0)
                    w = max(w, p.width + s)
            elif isinstance(p, Glue):
                x += d
                d = 0.0
                g = p.glue_spec
                x += g[0]
                total_stretch[g[2]] += g[1]
                total_shrink[g[4]] += g[3]
            elif isinstance(p, Kern):
                x += d + p.width
                d = 0.0
        self.width = w
        if d > l:
            x += d - l
            self.depth = l
        else:
            self.depth = d
        if m == "additional":
            h += x
        self.height = h
        x = h - x
        if x == 0:
            self.glue_sign = 0
            self.glue_order = 0
            return
        if x > 0.0:
            self._set_glue(x, 1, total_stretch)
        else:
            self._set_glue(x, -1, total_shrink)


class Rule(Box):
    def render(self, output: Output, x: float, y: float, w: float, h: float) -> None:
        output.rects.append((x, y, x + w, y + h))


class Hrule(Rule):
    def __init__(self, state: State, thickness: float | None = None) -> None:
        if thickness is None:
            thickness = state.thickness()
        height = depth = thickness * 0.5
        super().__init__(np.inf, height, depth)


# (width, stretch, stretch_order, shrink, shrink_order), _GlueSpec._named
_GLUE = {"fill": (0.0, 1.0, 2, 0.0, 0), "ss": (0.0, 1.0, 1, -1.0, 1)}


class Glue(Node):
    def __init__(self, kind: str) -> None:
        super().__init__()
        self.glue_spec = _GLUE[kind]

    def shrink(self) -> None:
        super().shrink()
        if self.size < NUM_SIZE_LEVELS:
            g = self.glue_spec
            self.glue_spec = (g[0] * SHRINK_FACTOR,) + g[1:]


class HCentered(Hlist):
    def __init__(self, elements) -> None:
        super().__init__([Glue("ss"), *elements, Glue("ss")], do_kern=False)


class Kern(Node):
    height = 0
    depth = 0

    def __init__(self, width: float) -> None:
        super().__init__()
        self.width = width

    def shrink(self) -> None:
        super().shrink()
        if self.size < NUM_SIZE_LEVELS:
            self.width *= SHRINK_FACTOR


class AutoHeightChar(Hlist):
    def __init__(self, c: str, height: float, depth: float, state: State) -> None:
        alternatives = [(i, chr(TEX2UNI[c.strip("\\")])) for i in _SQRT_ALTERNATIVES]
        x_height = state.fontset.get_xheight(state.font, state.fontsize, state.dpi)
        state = state.copy()
        target_total = height + depth
        for fontname, sym in alternatives:
            state.font = fontname
            char = Char(sym, state)
            if char.height + char.depth >= target_total - 0.2 * x_height:
                break
        shift = 0.0
        if state.font != 0:
            factor = target_total / (char.height + char.depth)
            state.fontsize *= factor
            char = Char(sym, state)
            shift = depth - char.depth
        super().__init__([char])
        self.shift_amount = shift


class Output:
    def __init__(self, box: Box) -> None:
        self.box = box
        self.glyphs: list = []
        self.rects: list = []


def ship(box: Hlist, xy=(0, 0)) -> Output:
    """``_mathtext.ship``: the positioned glyphs and rules of a box."""
    ox, oy = xy
    st = {"v": 0.0, "h": 0.0}
    off_h = ox
    off_v = oy + box.height
    output = Output(box)

    def clamp(value: float) -> float:
        return -1e9 if value < -1e9 else +1e9 if value > +1e9 else value

    def hlist_out(box: Hlist) -> None:
        cur_g = 0
        cur_glue = 0.0
        glue_order, glue_sign = box.glue_order, box.glue_sign
        base_line = st["v"]
        for p in box.children:
            if isinstance(p, Char):
                p.render(output, st["h"] + off_h, st["v"] + off_v)
                st["h"] += p.width
            elif isinstance(p, Kern):
                st["h"] += p.width
            elif isinstance(p, List):
                if len(p.children) == 0:
                    st["h"] += p.width
                else:
                    edge = st["h"]
                    st["v"] = base_line + p.shift_amount
                    if isinstance(p, Hlist):
                        hlist_out(p)
                    else:
                        vlist_out(p)
                    st["h"] = edge + p.width
                    st["v"] = base_line
            elif isinstance(p, Box):
                rule_height, rule_depth, rule_width = p.height, p.depth, p.width
                if np.isinf(rule_height):
                    rule_height = box.height
                if np.isinf(rule_depth):
                    rule_depth = box.depth
                if rule_height > 0 and rule_width > 0:
                    st["v"] = base_line + rule_depth
                    p.render(output, st["h"] + off_h, st["v"] + off_v, rule_width, rule_height)
                    st["v"] = base_line
                st["h"] += rule_width
            elif isinstance(p, Glue):
                g = p.glue_spec
                rule_width = g[0] - cur_g
                if glue_sign != 0:
                    if glue_sign == 1:
                        if g[2] == glue_order:
                            cur_glue += g[1]
                            cur_g = round(clamp(box.glue_set * cur_glue))
                    elif g[4] == glue_order:
                        cur_glue += g[3]
                        cur_g = round(clamp(box.glue_set * cur_glue))
                rule_width += cur_g
                st["h"] += rule_width

    def vlist_out(box: Vlist) -> None:
        cur_g = 0
        cur_glue = 0.0
        glue_order, glue_sign = box.glue_order, box.glue_sign
        left_edge = st["h"]
        st["v"] -= box.height
        for p in box.children:
            if isinstance(p, Kern):
                st["v"] += p.width
            elif isinstance(p, List):
                if len(p.children) == 0:
                    st["v"] += p.height + p.depth
                else:
                    st["v"] += p.height
                    st["h"] = left_edge + p.shift_amount
                    save_v = st["v"]
                    p.width = box.width
                    if isinstance(p, Hlist):
                        hlist_out(p)
                    else:
                        vlist_out(p)
                    st["v"] = save_v + p.depth
                    st["h"] = left_edge
            elif isinstance(p, Box):
                rule_height, rule_depth, rule_width = p.height, p.depth, p.width
                if np.isinf(rule_width):
                    rule_width = box.width
                rule_height += rule_depth
                if rule_height > 0 and rule_depth > 0:
                    st["v"] += rule_height
                    p.render(output, st["h"] + off_h, st["v"] + off_v, rule_width, rule_height)
            elif isinstance(p, Glue):
                g = p.glue_spec
                rule_height = g[0] - cur_g
                if glue_sign != 0:
                    if glue_sign == 1:
                        if g[2] == glue_order:
                            cur_glue += g[1]
                            cur_g = round(clamp(box.glue_set * cur_glue))
                    elif g[4] == glue_order:
                        cur_glue += g[3]
                        cur_g = round(clamp(box.glue_set * cur_glue))
                rule_height += cur_g
                st["v"] += rule_height

    hlist_out(box)
    return output


# ------------------------------------------------------------------ parser

class Parser:
    """A recursive-descent reader of the grammar above that calls the
    handlers of matplotlib's ``Parser`` in the order pyparsing calls them."""

    def __init__(self, s: str, fontset: DejaVuSansFonts, fontsize: float, dpi: float) -> None:
        self.s = s
        self.state = State(fontset, "it", fontsize, dpi)
        self._em: dict = {}

    # ---- reading
    def _skip(self, pos: int) -> int:
        while pos < len(self.s) and self.s[pos] in " \t\n":
            pos += 1
        return pos

    def _fail(self, pos: int, what: str):
        raise ValueError("mathtext construct %s at %d of %r is not replayed" % (what, pos, self.s))

    def parse(self) -> Hlist:
        toks = []
        pos = self._skip(0)
        if pos == len(self.s):
            self._fail(pos, "(an empty expression)")
        while pos < len(self.s):
            node, pos = self._token(pos)
            toks.append(node)
            pos = self._skip(pos)
        math = Hlist(toks)
        return Hlist([Hlist([]), math, Hlist([])])

    def _group(self, pos: int) -> tuple[list, int]:
        """``{`` tokens ``}``: the nodes inside and the position after."""
        if pos >= len(self.s) or self.s[pos] != "{":
            self._fail(pos, "(a missing '{')")
        pos += 1
        toks = []
        while True:
            pos = self._skip(pos)
            if pos >= len(self.s):
                self._fail(pos, "(an unclosed group)")
            if self.s[pos] == "}":
                return toks, pos + 1
            node, pos = self._token(pos)
            toks.append(node)

    def _token(self, pos: int):
        nucleus = None
        if self.s[pos] not in "_^":
            nucleus, pos = self._placeable(pos)
        ops = []
        while True:
            p2 = self._skip(pos)
            if p2 < len(self.s) and self.s[p2] in "_^":
                p3 = p2 + 1
                if p3 >= len(self.s) or self.s[p3] in " \t\n":
                    self._fail(p3, "(a script without an argument)")
                arg, pos = self._placeable(p3)
                ops.append((self.s[p2], arg))
            else:
                break
        if pos < len(self.s) and self.s[pos] == "'":
            self._fail(pos, "(an apostrophe)")
        if not ops:
            return nucleus, pos
        return self._subsuper(nucleus if nucleus is not None else Hbox(0), ops), pos

    def _placeable(self, pos: int):
        s = self.s
        c = s[pos]
        if c == "{":
            toks, pos = self._group(pos)
            return Hlist(toks), pos
        if c == "\\":
            end = pos + 1
            while end < len(s) and s[end].isalpha():
                end += 1
            name = s[pos + 1:end]
            if name in TEX2UNI and name != "__sqrt__":
                return self._symbol(pos, "\\" + name), end
            if name == "frac":
                num, p = self._group(self._skip(end))
                den, p = self._group(self._skip(p))
                return self._frac(Hlist(num), Hlist(den)), p
            if name == "sqrt":
                p = self._skip(end)
                if p < len(s) and s[p] == "[":
                    self._fail(p, "\\sqrt[...]")
                body, p = self._group(p)
                return self._sqrt(Hlist(body)), p
            self._fail(pos, "\\" + (name or s[end:end + 1]))
        if c in _PLAIN:
            return self._symbol(pos, c), pos + 1
        self._fail(pos, repr(c))

    # ---- handlers
    def _make_space(self, percentage: float) -> Kern:
        st = self.state
        key = (st.font, st.fontsize, st.dpi)
        width = self._em.get(key)
        if width is None:
            width = st.fontset.get_info("it", "m", st.fontsize, st.dpi).metrics.advance
            self._em[key] = width
        return Kern(width * percentage)

    def _symbol(self, loc: int, c: str):
        s = self.s
        if c == "-":
            c = "\N{MINUS SIGN}"
        char = Char(c, self.state)
        if c in _SPACED:
            prev_char = next((ch for ch in s[:loc][::-1] if ch != " "), "")
            if c in _BINARY and (len(s[:loc].split()) == 0
                                 or prev_char in {"{", *_LEFT_DELIMS, *_RELATIONS}):
                return char
            return Hlist([self._make_space(0.2), char, self._make_space(0.2)], do_kern=True)
        if c in _PUNCTUATION:
            prev_char = next((ch for ch in s[:loc][::-1] if ch != " "), "")
            next_char = next((ch for ch in s[loc + 1:] if ch != " "), "")
            if c == "," and prev_char == "{" and next_char == "}":
                return char
            if c == "." and prev_char.isdigit() and next_char.isdigit():
                return char
            return Hlist([char, self._make_space(0.2)], do_kern=True)
        return char

    def _subsuper(self, nucleus, ops):
        sub = sup = None
        for op, arg in ops:
            if op == "_":
                if sub is not None:
                    raise ValueError("Double subscript in %r" % self.s)
                sub = arg
            else:
                if sup is not None:
                    raise ValueError("Double superscript in %r" % self.s)
                sup = arg
        st = self.state
        rule_thickness = st.thickness()
        x_height = st.fontset.get_xheight(st.font, st.fontsize, st.dpi)

        if isinstance(nucleus, Char) and nucleus.c in _OVERUNDER:
            vlist = []
            shift = 0.0
            width = nucleus.width
            if sup is not None:
                sup.shrink()
                width = max(width, sup.width)
            if sub is not None:
                sub.shrink()
                width = max(width, sub.width)
            vgap = rule_thickness * 3.0
            if sup is not None:
                hlist = HCentered([sup])
                hlist.hpack(width, "exactly")
                vlist.extend([hlist, Vbox(0, vgap)])
            hlist = HCentered([nucleus])
            hlist.hpack(width, "exactly")
            vlist.append(hlist)
            if sub is not None:
                hlist = HCentered([sub])
                hlist.hpack(width, "exactly")
                vlist.extend([Vbox(0, vgap), hlist])
                shift = hlist.height + vgap + nucleus.depth
            vlt = Vlist(vlist)
            vlt.shift_amount = shift
            return Hlist([vlt])

        last_char = nucleus
        if isinstance(nucleus, Hlist):
            new_children = nucleus.children
            if len(new_children):
                if isinstance(new_children[-1], Kern) and isinstance(new_children[-2], Char):
                    new_children = new_children[:-1]
                last_char = new_children[-1]
                if isinstance(last_char, Char):
                    last_char.width = last_char._metrics.advance
            nucleus = Hlist(new_children, do_kern=False)
        else:
            if isinstance(nucleus, Char):
                last_char.width = last_char._metrics.advance
            nucleus = Hlist([nucleus])

        dropsub = isinstance(last_char, Char) and last_char.c in _DROPSUB
        slanted = isinstance(last_char, Char) and last_char._metrics.slanted
        lc_height = last_char.height
        lc_baseline = last_char.depth if dropsub else 0

        superkern = DELTA * x_height
        subkern = DELTA * x_height
        if slanted:
            superkern += DELTA * x_height
            superkern += DELTA_SLANTED * (lc_height - x_height * 2.0 / 3.0)
            if dropsub:
                subkern = (3 * DELTA - DELTA_INTEGRAL) * lc_height
                superkern = (3 * DELTA + DELTA_INTEGRAL) * lc_height
            else:
                subkern = 0

        if sup is None:
            x = Hlist([Kern(subkern), sub])
            x.shrink()
            shift_down = lc_baseline + SUBDROP * x_height if dropsub else SUB1 * x_height
            x.shift_amount = shift_down
        else:
            x = Hlist([Kern(superkern), sup])
            x.shrink()
            shift_up = lc_height - SUBDROP * x_height if dropsub else SUP1 * x_height
            if sub is None:
                x.shift_amount = -shift_up
            else:
                y = Hlist([Kern(subkern), sub])
                y.shrink()
                shift_down = lc_baseline + SUBDROP * x_height if dropsub else SUB2 * x_height
                clr = 2.0 * rule_thickness - ((shift_up - x.depth) - (y.height - shift_down))
                if clr > 0.0:
                    shift_up += clr
                x = Vlist([x, Kern((shift_up - x.depth) - (y.height - shift_down)), y])
                x.shift_amount = shift_down
        if not dropsub:
            x.width += SCRIPT_SPACE * x_height
        return Hlist([nucleus, x])

    def _frac(self, num: Hlist, den: Hlist):
        st = self.state
        thickness = st.thickness()
        num.shrink()
        den.shrink()
        cnum = HCentered([num])
        cden = HCentered([den])
        width = max(num.width, den.width)
        cnum.hpack(width, "exactly")
        cden.hpack(width, "exactly")
        vlist = Vlist([cnum, Vbox(0, thickness * 2.0), Hrule(st, thickness),
                       Vbox(0, thickness * 2.0), cden])
        m = st.fontset.get_info(st.font, "=", st.fontsize, st.dpi).metrics
        shift = cden.height - ((m.ymax + m.ymin) / 2 - thickness * 3.0)
        vlist.shift_amount = shift
        return Hlist([vlist, Hbox(thickness * 2.0)])

    def _sqrt(self, body: Hlist):
        st = self.state
        thickness = st.thickness()
        height = body.height - body.shift_amount + thickness * 5.0
        depth = body.depth + body.shift_amount
        check = AutoHeightChar("\\__sqrt__", height, depth, st)
        height = check.height - check.shift_amount
        depth = check.depth + check.shift_amount
        padded_body = Hlist([Hbox(2 * thickness), body, Hbox(2 * thickness)])
        rightside = Vlist([Hrule(st), Glue("fill"), padded_body])
        rightside.vpack(height + (st.fontsize * st.dpi) / (100.0 * 12.0), "exactly", depth)
        root = Box(check.width * 0.5, 0.0, 0.0)
        root_vlist = Vlist([Hlist([root])])
        root_vlist.shift_amount = -height * 0.6
        return Hlist([root_vlist, Kern(-check.width * 0.5), check, rightside])


def parse(latex: str, dpi: float, fontsize: float = FONT_SIZE) -> Hlist:
    """The box of ``$latex$`` at ``dpi``, as ``Parser.parse`` builds it."""
    return Parser(latex, DejaVuSansFonts(), fontsize, dpi).parse()


def path_extents(latex: str) -> tuple[float, float, float]:
    """``MathTextParser('path').parse(f'${latex}$', dpi=72)``'s width,
    height and depth (``Output.to_vector``: the box's ceilings, height
    plus depth)."""
    box = parse(latex, 72)
    out = ship(box)
    w, h, d = (float(np.ceil(v)) for v in (out.box.width, out.box.height, out.box.depth))
    return w, h + d, d


def _draw_bitmap(image: np.ndarray, bm: np.ndarray, x: int, y: int) -> None:
    """``FT2Image::draw_bitmap``: OR the bitmap in, clipped to the image."""
    H, W = image.shape
    h, w = bm.shape
    x1, y1 = min(max(x, 0), W), min(max(y, 0), H)
    x2, y2 = min(max(x + w, 0), W), min(max(y + h, 0), H)
    if x2 > x1 and y2 > y1:
        sx, sy = max(0, -x), max(0, -y)
        image[y1:y2, x1:x2] |= bm[sy:sy + (y2 - y1), sx:sx + (x2 - x1)]


def to_raster(box: Hlist) -> tuple[np.ndarray, float, float, float]:
    """``Output.to_raster``: (8-bit coverage image, width, height, depth)."""
    out = ship(box)
    xmin = min([*[ox + info.metrics.xmin for ox, oy, info in out.glyphs],
                *[x1 for x1, y1, x2, y2 in out.rects], 0]) - 1
    ymin = min([*[oy - info.metrics.ymax for ox, oy, info in out.glyphs],
                *[y1 for x1, y1, x2, y2 in out.rects], 0]) - 1
    xmax = max([*[ox + info.metrics.xmax for ox, oy, info in out.glyphs],
                *[x2 for x1, y1, x2, y2 in out.rects], 0]) + 1
    ymax = max([*[oy - info.metrics.ymin for ox, oy, info in out.glyphs],
                *[y2 for x1, y1, x2, y2 in out.rects], 0]) + 1
    w = xmax - xmin
    h = ymax - ymin - box.depth
    d = ymax - ymin - box.height
    image = np.zeros((int(np.ceil(h + max(d, 0))), int(np.ceil(w))), np.uint8)
    shifted = ship(box, (-xmin, -ymin))
    for ox, oy, info in shifted.glyphs:
        pts, tags, ends = info.glyph.outline
        bm, left, _top = mathtext_raster.render(pts, tags, ends)
        _draw_bitmap(image, bm, int(ox) + left, int(oy - info.metrics.iceberg))
    H, W = image.shape
    for x1, y1, x2, y2 in shifted.rects:
        height = max(int(y2 - y1) - 1, 0)
        if height == 0:
            center = (y2 + y1) / 2
            y = int(center - (height + 1) / 2)
        else:
            y = int(y1)
        c0, r0 = min(int(x1), W), min(y, H)
        c1, r1 = min(int(np.ceil(x2)) + 1, W), min(y + height + 1, H)
        image[r0:r1, c0:c1] = 255
    return image, w, h + d, d


def _blend_black(cover: np.ndarray) -> np.ndarray:
    """Agg's ``blend_solid_hspan`` of opaque black over opaque white."""
    c = cover.astype(np.int64)
    t = 255 * c + 128
    alpha = ((t >> 8) + t) >> 8
    v = (65025 * (256 - alpha)) // (65280 + alpha)
    v = np.where(c == 255, 0, np.where(alpha == 0, 255, v))
    return v.astype(np.uint8)


def math_to_image(latex: str, dpi: float) -> np.ndarray:
    """``mathtext.math_to_image(f"${latex}$", png, dpi=dpi)`` read back as
    RGBA: (H, W, 4) uint8."""
    width, height, depth = path_extents(latex)
    fig_w, fig_h = width / 72.0 * dpi, height / 72.0 * dpi
    image, _w, _h, d = to_raster(parse(latex, dpi))
    H, W = int(fig_h), int(fig_w)
    canvas = np.full((H, W), 255, np.uint8)
    y = round(fig_h - fig_h * (depth / height) + d) + 1
    rows, cols = image.shape
    top = y - rows
    r0, r1 = max(top, 0), min(y, H)
    c0, c1 = 0, min(cols, W)
    if r1 > r0 and c1 > c0:
        canvas[r0:r1, c0:c1] = _blend_black(image[r0 - top:r1 - top, c0:c1])
    out = np.empty((H, W, 4), np.uint8)
    out[..., :3] = canvas[..., None]
    out[..., 3] = 255
    return out
