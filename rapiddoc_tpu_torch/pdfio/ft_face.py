"""The face object of the port's text path: what ``ImageFont.truetype``
gives the JAX renderer, replayed without FreeType.

``Face(program, px)`` opens a TrueType/OpenType font (``sfnt``), a bare
CFF (``cff``) or a Type1 program (``type1``) at ``px`` pixels per em, as
Pillow 12.1 sizes a FreeType face (``FT_Request_Size`` with a nominal
size of ``px * 64``: ``x_scale = FT_DivFix(px * 64, units_per_em)``).
Anything else raises ``ValueError``, as ``ImageFont.truetype`` raises.

Text is laid out as Pillow's raqm layout does it (``layout="basic"``, the
engine ``ImageFont.load_default`` asks for, maps characters and adds
advances only): each character goes
through the face's Unicode charmap (``sfnt``, ``cff``) to a glyph (glyph 0
when it is missing, whose outline PIL draws); GSUB ligatures and GPOS or
``kern`` pair kerning of the default features apply; each glyph advances
by its unhinted advance ``FT_MulFix(advance, x_scale)`` in 26.6 and is
drawn at the whole pixel ``(x + 32) >> 6``. ``getbbox`` and ``getmask``
give Pillow's box and mask: the box holds the pen's origin and its end
(x from ``min(0, glyph lefts)`` to ``max(advance, glyph rights)``, y from
the baseline to every glyph's top and bottom, each glyph's box its
control box grid-fitted outwards), placed by the anchor (``la`` by
default: the ascender; ``ls``: the baseline); the mask is that box with
each glyph's ``ft_raster`` bitmap in it, screened over what is there
(``a + b - MULDIV255(a, b)``) where two overlap.

Glyph outlines in 26.6 at the face's size are FreeType's:
- TrueType: ``FT_MulFix(font units, scale)`` per point; a composite's
  components are scaled, transformed by their 2x2 (16.16, from 2.14) and
  moved by their scaled offset (or by matched points), the y offset
  rounded to a whole pixel for ``ROUND_XY_TO_GRID`` where the bytecode
  hinter runs. Byte-equality is held where each glyph's ``hmtx`` left
  side bearing equals its ``xMin`` (as font tools write them); where they
  differ the outline moves by the scaled difference (the phantom point
  pp1, rounded where the bytecode hinter runs), which was measured one
  pixel off FreeType on a composite and is not held to it.
- CFF and Type1 (FreeType's ``cf2`` engine): the 16.16 font-unit point
  times ``(x_scale + 32) // 64`` with ``FT_MulFix``, then shifted right
  by 10.

Hinting is the one declared difference. FreeType hints every face that
PIL opens (``FT_LOAD_DEFAULT``); this module always draws the unhinted
outline. Measured against Pillow 12.1 / FreeType 2.14.1, the outline is
left unchanged (so the masks here are byte-equal) exactly when:
- a TrueType face has an ``fpgm`` table (FreeType then runs its own
  bytecode interpreter, v40, instead of the autohinter) and the glyph
  (with its components) has no instructions and no ``ROUND_XY_TO_GRID``
  x offset;
- a CFF or Type1 glyph has no stem hints (``hstem``/``vstem``, their
  ``hm`` forms, ``hintmask``, Type1 ``hstem3``/``vstem3``), so the Adobe
  engine's hint map is empty.
Every other face is hinted by FreeType: a TrueType face without ``fpgm``
goes to the autohinter (even with a ``prep``, and whatever its script:
instruction-less Latin and Private-Use glyphs alike had stems moved to the
pixel grid in x and y), glyph bytecode runs through the v40 interpreter,
and CFF/Type1 stem hints through the Adobe hinter. Those faces are held to
a band in the tests, not to bytes (ROADMAP Queue 1, item 12e). The port
never branches on this rule; the tests pick "exact" or "band" by it.

Not drawn here, raising ``not_ported(..., "glyphs")``: faces whose glyphs
are embedded bitmaps (EBDT/CBDT/sbix strikes) and text that needs complex
shaping (Arabic, Hebrew and other right-to-left scripts, Indic and other
South and Southeast Asian scripts).
"""
from __future__ import annotations

import math

import numpy as np

from ..utils.unported import not_ported
from . import ft_raster
from .cff import CFFFont, divfix, mulfix
from .sfnt import (
    ARGS_ARE_XY_VALUES, ROUND_XY_TO_GRID, SCALED_COMPONENT_OFFSET, USE_MY_METRICS, Sfnt,
    pair_value,
)

# scripts whose shaping HarfBuzz does with its complex shapers
_COMPLEX = (
    (0x0590, 0x08FF), (0x0900, 0x0DFF), (0x0E00, 0x0FFF), (0x1000, 0x109F),
    (0x1700, 0x18AF), (0x1900, 0x1AAF), (0x1B00, 0x1C4F), (0xA800, 0xA82F),
    (0xA840, 0xA8FF), (0xA980, 0xAAFF), (0xFB1D, 0xFDFF), (0xFE70, 0xFEFF),
    (0x10800, 0x10FFF), (0x11000, 0x11FFF), (0x1E800, 0x1EFFF),
)


def _needs_complex_shaping(text: str) -> bool:
    for ch in text:
        c = ord(ch)
        if c >= 0x0590:
            for lo, hi in _COMPLEX:
                if lo <= c <= hi:
                    return True
    return False


def _pix_ceil(v: int) -> int:
    return -((-v) // 64) * 64


def _pix_round(v: int) -> int:
    return ((v + 32) // 64) * 64


def open_program(data: bytes):
    """('sfnt' | 'cff' | 'type1', parsed program); ValueError for bytes no
    reader here takes."""
    b = bytes(data or b"")
    if len(b) < 4:
        raise ValueError("font program too short")
    try:
        if b[:4] in (b"\x00\x01\x00\x00", b"true", b"OTTO", b"ttcf", b"typ1"):
            return "sfnt", Sfnt(b)
        if b[0] == 1 and b[1] == 0 and 4 <= b[2] <= 16 and 1 <= b[3] <= 4:
            return "cff", CFFFont(b)
        if b[:2] == b"%!" or b[:2] == b"\x80\x01":
            from .type1 import Type1Font

            return "type1", Type1Font(b)
    except NotImplementedError:
        raise
    except Exception as exc:  # noqa: BLE001 - every parse failure is a broken face
        raise ValueError(f"broken font program: {exc}") from exc
    raise ValueError("unknown font program format")


class Face:
    """One font program at one pixel size."""

    def __init__(self, program, px: int, *, parsed=None, layout: str = "raqm") -> None:
        self.kind, self.font = parsed if parsed is not None else open_program(program)
        self.size = int(px)
        self.basic = layout == "basic"
        f = self.font
        if self.kind == "sfnt":
            self.upem = f.units_per_em
            asc, desc = f.ascender, f.descender
            self.charmap = f.cmap
            self.cff = f.cff
        else:
            fm = f.font_matrix
            if fm[1] or fm[2] or fm[0] <= 0 or abs(fm[0] - fm[3]) > 1e-9:
                raise not_ported("a font matrix that is not a plain scale", "glyphs")
            self.upem = int(round(1.0 / fm[3]))
            asc, desc = f.bbox[3], f.bbox[1]
            self.charmap = f.unicode_charmap()
            self.cff = f
        if self.kind == "sfnt" and f.has_bitmaps:
            raise not_ported("a face with embedded bitmap strikes", "glyphs")
        self.x_scale = divfix(self.size * 64, self.upem)
        self.y_scale = self.x_scale
        self.ascender = _pix_ceil(mulfix(int(asc), self.y_scale))
        self.descender = -_pix_ceil(-mulfix(int(desc), self.y_scale))
        self._outlines: dict[int, tuple] = {}
        self._bitmaps: dict[int, tuple] = {}

    # ------------------------------------------------------------ outlines

    def _cf2(self, v: int) -> int:
        return mulfix((self.x_scale + 32) // 64, v) >> 10

    def outline(self, gid: int):
        """(points (N, 2) int64 in 26.6, tags, contour ends, overlap flag)
        at this size."""
        o = self._outlines.get(gid)
        if o is None:
            if self.cff is not None:
                o = self._cff_outline(gid)
            else:
                pts, tags, ends, _ = self._tt_outline(gid, 0)
                o = (pts, tags, ends, self._overlap(gid, 0))
            self._outlines[gid] = o
        return o

    def _cff_outline(self, gid: int):
        ol = self.cff.outline(gid)
        pts, tags, ends = [], [], []
        for c in ol.contours:
            for x, y, t in c:
                pts.append((self._cf2(x), self._cf2(y)))
                tags.append(t)
            ends.append(len(pts) - 1)
        return np.array(pts, np.int64).reshape(-1, 2), np.array(tags, np.int8), ends, False

    def _tt_outline(self, gid: int, depth: int):
        """Scaled TrueType glyph: (points, tags, ends, advance font units)."""
        f = self.font
        g = f.glyph(gid)
        adv = f.advance(gid)
        if g.components is None:
            pts = np.array([[mulfix(int(x), self.x_scale), mulfix(int(y), self.y_scale)]
                            for x, y in g.points], np.int64).reshape(-1, 2)
            tags, ends = np.asarray(g.tags, np.int8), list(g.ends)
        else:
            if depth > 8:
                return np.zeros((0, 2), np.int64), np.zeros(0, np.int8), [], adv
            pts = np.zeros((0, 2), np.int64)
            tags = np.zeros(0, np.int8)
            ends: list[int] = []
            for sub, flags, a1, a2, m in g.components:
                cp, ct, ce, cadv = self._tt_outline(sub, depth + 1)
                cp = cp.copy()
                if flags & USE_MY_METRICS:
                    adv = cadv
                if m is not None:
                    xx, xy, yx, yy = m
                    cp = np.array([[mulfix(int(x), xx) + mulfix(int(y), xy),
                                    mulfix(int(x), yx) + mulfix(int(y), yy)] for x, y in cp],
                                  np.int64).reshape(-1, 2)
                if flags & ARGS_ARE_XY_VALUES:
                    x, y = a1, a2
                    if x or y:
                        if m is not None and flags & SCALED_COMPONENT_OFFSET:
                            x = mulfix(x, int(round(math.hypot(m[0], m[2]))))
                            y = mulfix(y, int(round(math.hypot(m[3], m[1]))))
                        x = mulfix(x, self.x_scale)
                        y = mulfix(y, self.y_scale)
                        if flags & ROUND_XY_TO_GRID and f.has_bytecode:
                            y = _pix_round(y)
                else:
                    if a1 >= len(pts) or a2 >= len(cp):
                        raise ValueError("composite glyph matches a missing point")
                    x = int(pts[a1][0] - cp[a2][0])
                    y = int(pts[a1][1] - cp[a2][1])
                cp[:, 0] += x
                cp[:, 1] += y
                base = len(pts)
                pts = np.concatenate([pts, cp])
                tags = np.concatenate([tags, ct])
                ends += [e + base for e in ce]
        # pp1: the outline moves by the scaled xMin - lsb
        if depth == 0 and 0 <= gid < len(f.lsbs):
            shift = int(g.xmin) - int(f.lsbs[gid])
            if shift:
                d = mulfix(shift, self.x_scale)
                if f.has_bytecode:
                    d = _pix_round(d)
                pts = pts.copy()
                pts[:, 0] -= d
        return pts, tags, ends, adv

    def _overlap(self, gid: int, depth: int) -> bool:
        """FreeType's FT_OUTLINE_OVERLAP: the glyph's own overlap flag, or
        any component's."""
        g = self.font.glyph(gid)
        if g.overlap:
            return True
        return depth < 8 and any(self._overlap(c[0], depth + 1) for c in g.components or ())

    def advance26(self, gid: int) -> int:
        if self.kind == "sfnt":
            return mulfix(self.font.advance(gid), self.x_scale)
        return mulfix(self.cff.outline(gid).width >> 16, self.x_scale)

    def bitmap(self, gid: int):
        """(bitmap, left, top) of the glyph, cached."""
        bm = self._bitmaps.get(gid)
        if bm is None:
            pts, tags, ends, overlap = self.outline(gid)
            bm = ft_raster.render(pts, tags, ends, overlap)
            self._bitmaps[gid] = bm
        return bm

    # -------------------------------------------------------------- layout

    def glyph_index(self, ch: str) -> int:
        return self.charmap.get(ord(ch), 0)

    def layout(self, text: str) -> list[tuple[int, int, int]]:
        """(glyph, x advance, x offset) per glyph in 26.6, raqm's run."""
        gids = [self.glyph_index(ch) for ch in text]
        if self.basic:
            # Pillow's BASIC layout: the charmap, the hinted advance (whole
            # pixels where FreeType hints; its hinting is the declared gap)
            # and FreeType's kern-table kerning added in whole pixels to a
            # 26.6 advance, as Pillow adds it
            adv = [_pix_round(self.advance26(g)) for g in gids]
            if self.kind == "sfnt":
                pairs = self.font.kern_pairs()
                for i in range(1, len(gids)):
                    k = pairs.get((gids[i - 1], gids[i]))
                    if k and gids[i - 1] and gids[i]:
                        adv[i - 1] += (_pix_round(mulfix(k, self.x_scale)) + 32) >> 6
            return [(g, a, 0) for g, a in zip(gids, adv)]
        if _needs_complex_shaping(text):
            raise not_ported("text that needs complex shaping", "glyphs")
        if self.kind == "sfnt" and len(gids) > 1:
            gids = self._ligate(gids)
        adv = [self.advance26(g) for g in gids]
        if self.kind == "sfnt" and len(gids) > 1:
            for i, k in self._kerning(gids):
                adv[i] += k
        return [(g, a, 0) for g, a in zip(gids, adv)]

    def _ligate(self, gids: list[int]) -> list[int]:
        for lookup in self.font.gsub_ligatures():
            out = []
            i = 0
            while i < len(gids):
                done = False
                for comps, lig in lookup.get(gids[i], ()):
                    n = len(comps)
                    if tuple(gids[i + 1:i + 1 + n]) == comps:
                        out.append(lig)
                        i += 1 + n
                        done = True
                        break
                if not done:
                    out.append(gids[i])
                    i += 1
            gids = out
        return gids

    def _em_scale(self, v: int) -> int:
        """HarfBuzz's em_scale: the font's 26.6 em size as a 16.16
        multiplier per font unit, rounded half up."""
        hb_scale = (self.x_scale * self.upem + (1 << 15)) >> 16
        mult = (hb_scale << 16) // self.upem
        return (v * mult + 32768) >> 16

    def _kerning(self, gids: list[int]):
        f = self.font
        gpos = f.gpos_pairs()
        out = []
        if gpos:
            for lookup in gpos:
                i = 0
                while i + 1 < len(gids):
                    hit = None
                    for sub in lookup:
                        hit = pair_value(sub, gids[i], gids[i + 1])
                        if hit is not None:
                            break
                    if hit is not None:
                        v, has2 = hit
                        if v:
                            out.append((i, self._em_scale(v)))
                        i += 2 if has2 else 1
                    else:
                        i += 1
            return out
        pairs = f.kern_pairs()
        for i in range(len(gids) - 1):
            v = pairs.get((gids[i], gids[i + 1]))
            if v:
                out.append((i, self._em_scale(v)))
        return out

    def _boxes(self, text: str):
        run = self.layout(text)
        x = 0
        placed = []
        x_min = x_max = y_min = y_max = 0
        for gid, adv, off in run:
            px = (x + off + 32) >> 6
            bx0, by0, bx1, by1 = ft_raster.cbox_pixels(self.outline(gid)[0])
            bx0 += px
            bx1 += px
            x_min, x_max = min(x_min, bx0), max(x_max, bx1)
            y_min, y_max = min(y_min, by0), max(y_max, by1)
            placed.append((gid, px))
            x += adv
        x_max = max(x_max, (x + 32) >> 6)
        return placed, x_min, x_max, y_min, y_max

    def _anchor_offset(self, anchor, x_min, y_max):
        anchor = anchor or "la"
        if len(anchor) != 2 or anchor[0] != "l" or anchor[1] not in "as":
            raise ValueError("anchor %r is not used by the renderer" % (anchor,))
        y_anchor = ((self.ascender + 32) >> 6) if anchor[1] == "a" else 0
        return x_min, y_anchor - y_max

    def getbbox(self, text: str, anchor: str | None = None) -> tuple[int, int, int, int]:
        _, x_min, x_max, y_min, y_max = self._boxes(text)
        x0, y0 = self._anchor_offset(anchor, x_min, y_max)
        return x0, y0, x0 + (x_max - x_min), y0 + (y_max - y_min)

    def getmask(self, text: str, anchor: str | None = None):
        """(L mask (h, w) uint8, (x offset, y offset)) as Pillow's
        ``getmask2`` gives them."""
        placed, x_min, x_max, y_min, y_max = self._boxes(text)
        w, h = x_max - x_min, y_max - y_min
        mask = np.zeros((max(h, 0), max(w, 0)), np.uint8)
        if w > 0 and h > 0:
            for gid, px in placed:
                bm, left, top = self.bitmap(gid)
                if bm.size == 0:
                    continue
                x0 = px + left - x_min
                y0 = y_max - top
                region = mask[y0:y0 + bm.shape[0], x0:x0 + bm.shape[1]]
                a = region.astype(np.int32)
                b = bm[:region.shape[0], :region.shape[1]].astype(np.int32)
                t = a * b + 128
                region[:] = a + b - (((t >> 8) + t) >> 8)
        return mask, self._anchor_offset(anchor, x_min, y_max)

    def getmetrics(self) -> tuple[int, int]:
        return (self.ascender + 32) >> 6, -((self.descender + 32) >> 6)
