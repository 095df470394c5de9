"""Page rasterization onto a numpy canvas (feeds the models).

Port of ``rapiddoc_tpu/pdfio/render.py`` ``render_page_full``. The page
size and its rounding, the placement arithmetic, the clip machinery and
the order of every drawing operation are the JAX package's; its PIL and
cv2 calls become numpy, each held byte-equal to Pillow 12.1 or OpenCV:

- vector paths (``on_paint_path``): fills and strokes through
  ``pil_draw`` (ImageDraw's polygon, line and RGBA blend, ``paste``
  through an ``L`` mask, ``ImageChops.multiply``), with the JAX package's
  fast path (each subpath blended onto the canvas) and slow path (an
  ``L`` layer clipped to the clip box, scaled by the clip mask and the
  alpha with ``// 255``, then pasted). As in the JAX package a stroke
  ignores a rectangular clip (``ADVICE.md``, ``render.py:209``). A clip
  that is not a rectangle is a mask of its subpaths (XOR for even-odd, AND
  across the clip stack);
- placed images (``on_draw_image``): flips and rotations by 90 degrees
  are array flips; other turns in 45-135 or 225-315 degrees are PIL's
  NEAREST ``rotate(expand=True)`` (``pil_resample``); ``cv2.resize``
  INTER_LINEAR (enlarging) and INTER_AREA (shrinking) are ``resize_linear``
  and ``resize_area`` of ``models/ocr/pre_post.py`` for RGB and grey
  placements of at least 16384 destination pixels; smaller ones and every
  RGBA placement go through PIL's BILINEAR ``resize``; image masks paint
  the fill colour through their BICUBIC-resized stencil, unflipped and
  unturned, as in the JAX package;
- Type3 glyphs run their CharProc content streams under FontMatrix x trm,
  as the JAX package does, with the text state saved and restored;
- text (``on_show_char``) is drawn as the JAX package draws it with PIL
  and FreeType: per character, a face from the font's embedded program
  (TrueType, OpenType, bare CFF or Type1, read by ``sfnt``, ``cff`` and
  ``type1``) at the rounded pixel size, or the fallback face when the
  program is missing, broken or draws no ink for the character (the
  first system font that opens: ``RAPIDDOC_FALLBACK_FONT``, DejaVu,
  Liberation, Noto or FreeSans, else ``ImageFont.load_default()``'s
  Aileron at 10 px, shipped in ``assets/``); the glyph tile is drawn
  (``ft_face`` and ``ft_raster``, FreeType's outline scaling and smooth
  rasterizer) and pasted through its alpha, upright or turned with PIL's
  BICUBIC ``rotate``, with the JAX package's run, face and tile caches at
  document scope. FreeType's hinting is not replayed (``ft_face``);
- shadings (``sh``) and pattern fills, as the JAX package paints them:
  the shading (``pdfio.shading``) over the clip box, the path's box and
  the shading's BBox, through its alpha, the fill alpha, the clip mask
  and the path's coverage, truncated to an ``L`` mask; a tiling
  pattern's cell drawn by a nested rasterizer on a transparent RGBA
  canvas (where ImageDraw writes the ink, alpha included, without
  blending), pasted through its own alpha across the path's box, and
  mid-grey for steps that are not axis-aligned.

The JAX package allocates a full-canvas layer for every clipped fill or
stroke; here every layer covers only the shape's rows and columns, and
consecutive fills and strokes of one ink are blended in one pass (blends
of one ink commute), which gives the same bytes.

What the JAX package would draw and this module does not draw yet raises
NotImplementedError naming its ROADMAP item, and is never left as
background: faces of bitmap strikes and text that needs complex shaping
(``ft_face``), the codings ``pdfio.images`` does not take (ROADMAP item
12f) and a 16-bit JPX image drawn at another size (PIL resamples
``I;16`` in its 16-bit path; at its own size it is clipped to 255 as
``convert("RGB")`` clips it). Where
the JAX package catches a failure and draws nothing (an image that does
not decode, a shading or pattern that raises) or mid-grey (a tiling cell
whose content raises), the page fails here. The content
interpreter skips an operator that raises, as the JAX package's does; so a
hook records what it cannot draw, inside a Type3 glyph too, and
``render_page_full`` raises it after the pass.
"""
from __future__ import annotations

import math
import logging
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..models.ocr.pre_post import resize_area, resize_linear
from ..utils.unported import not_ported
from . import pil_draw
from .ft_face import Face, open_program
from .content import ContentInterpreter, Matrix, mat_apply, mat_mul, mat_scale_of
from .cos import Stream
from .document import PdfPage
from .fonts import Font
from .images import xobject_to_array
from .shading import render_shading
from .pil_resample import resize, rotate_expand, rotate_expand_bicubic
from .text import page_base_ctm

# placements that the JAX package resizes with cv2 (at least this many
# destination pixels, RGB or grey); the rest go through PIL BILINEAR
CV2_MIN_PIXELS = 16384


_DEFAULT_FONT = Path(__file__).resolve().parent.parent / "assets" / "aileron_pil_default.ttf"


def _discover_fallback_fonts() -> list[str]:
    """Candidate system fonts for glyphs the embedded programs can't map,
    in the JAX package's order: ``RAPIDDOC_FALLBACK_FONT``, then DejaVu,
    Liberation, Noto or FreeSans under ``/usr/share/fonts``, Helvetica
    (mac) or Arial (Windows), and as a last resort any ``.ttf`` there."""
    import glob as _glob
    import os as _os

    cands: list[str] = []
    env = _os.environ.get("RAPIDDOC_FALLBACK_FONT")
    if env:
        cands.append(env)
    cands.append("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    patterns = [
        "/usr/share/fonts/**/DejaVuSans.ttf",
        "/usr/share/fonts/**/LiberationSans-Regular.ttf",
        "/usr/share/fonts/**/NotoSans-Regular.ttf",
        "/usr/share/fonts/**/FreeSans.ttf",
        "/System/Library/Fonts/Helvetica.ttc",
        "C:/Windows/Fonts/arial.ttf",
    ]
    for pat in patterns:
        if "*" in pat:
            cands.extend(sorted(_glob.glob(pat, recursive=True))[:1])
        elif _os.path.exists(pat):
            cands.append(pat)
    if not any(_os.path.exists(c) for c in cands):
        cands.extend(sorted(_glob.glob("/usr/share/fonts/**/*.ttf", recursive=True))[:1])
    return cands


_FALLBACK_FONTS_CACHE: list[str] | None = None
# glyph-tile cache lookups of the text path (upright and turned tiles),
# for the measurements; reset by whoever reads them
TILE_STATS = {"hits": 0, "misses": 0}
_SYSTEM_PROGRAMS: dict[str, tuple] = {}
_DEFAULT_FACE: list = []


def _fallback_fonts() -> list[str]:
    """The candidates, found once (the first time a fallback glyph is
    needed)."""
    global _FALLBACK_FONTS_CACHE
    if _FALLBACK_FONTS_CACHE is None:
        _FALLBACK_FONTS_CACHE = _discover_fallback_fonts()
    return _FALLBACK_FONTS_CACHE


def _system_face(path: str, px: int) -> Face:
    parsed = _SYSTEM_PROGRAMS.get(path)
    if parsed is None:
        with open(path, "rb") as f:
            parsed = open_program(f.read())
        _SYSTEM_PROGRAMS[path] = parsed
    return Face(None, px, parsed=parsed)


def default_face() -> Face:
    """``ImageFont.load_default()``: Pillow's embedded Aileron Regular
    subset at 10 px, laid out with the BASIC engine, whatever the text
    size."""
    if not _DEFAULT_FACE:
        _DEFAULT_FACE.append(Face(_DEFAULT_FONT.read_bytes(), 10, layout="basic"))
    return _DEFAULT_FACE[0]


class _FontBank:
    """Faces per (font, pixel size), as the JAX package caches FreeType
    faces; each program is parsed once."""

    def __init__(self) -> None:
        self._cache: dict[tuple[int, int], Face | None] = {}
        self._broken: set[int] = set()
        self._fallback_cache: dict[int, Face] = {}
        self._programs: dict[int, tuple] = {}

    def face(self, font: Font, px: int) -> Face | None:
        px = max(2, min(int(px), 512))
        key = (id(font), px)
        if key in self._cache:
            return self._cache[key]
        face = None
        if font.font_program and id(font) not in self._broken:
            try:
                parsed = self._programs.get(id(font))
                if parsed is None:
                    parsed = open_program(font.font_program)
                    self._programs[id(font)] = parsed
                face = Face(None, px, parsed=parsed)
            except NotImplementedError:
                raise
            except Exception:  # noqa: BLE001 - a program FreeType would refuse
                self._broken.add(id(font))
        self._cache[key] = face
        return face

    def fallback(self, px: int) -> Face:
        px = max(2, min(int(px), 512))
        if px not in self._fallback_cache:
            face = None
            for path in _fallback_fonts():
                try:
                    face = _system_face(path, px)
                    break
                except NotImplementedError:
                    raise
                except Exception:  # noqa: BLE001 - the next candidate, as in the JAX package
                    continue
            if face is None and not getattr(_FontBank, "_warned", False):
                _FontBank._warned = True
                logging.getLogger("rapiddoc_tpu_torch.pdfio").warning(
                    "no scalable system fallback font found (checked %d paths): unmapped "
                    "glyphs render with the default font; set RAPIDDOC_FALLBACK_FONT=<ttf>",
                    len(_fallback_fonts()))
            self._fallback_cache[px] = face or default_face()
        return self._fallback_cache[px]

    def covers(self, face: Face | None, text: str) -> bool:
        """Whether the face draws ink for ``text`` (subset fonts often
        can't)."""
        if face is None:
            return False
        try:
            bbox = face.getbbox(text)
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 - a glyph FreeType would fail to load
            return False
        return bbox[2] > bbox[0] and bbox[3] > bbox[1]


def _doc_cache(doc, name: str, factory=dict):
    """A cache kept on the document, as the JAX package keeps its font
    faces, glyph tiles and per-run values for all pages of a document."""
    c = getattr(doc, name, None)
    if c is None:
        c = factory()
        setattr(doc, name, c)
    return c


class PageRasterizer(ContentInterpreter):
    def __init__(self, page: PdfPage, scale: float = 1.0, background=(255, 255, 255)):
        super().__init__(page)
        self.scale = scale
        w, h = page.size
        self.width = max(1, int(round(w * scale)))
        self.height = max(1, int(round(h * scale)))
        self.canvas = np.empty((self.height, self.width, 3), np.uint8)
        self.canvas[:] = background
        self.failure: Exception | None = None
        self._clipmask_cache: dict = {}
        self._tile_cache: dict = {}
        # blends waiting to be drawn: one RGBA ink, its polygons and its
        # lines by width
        self._ink: tuple | None = None
        self._polys: list = []
        self._lines: dict[int, list] = {}
        doc = self.doc
        self.fontbank: _FontBank = _doc_cache(doc, "_render_fontbank", _FontBank)
        self._font_covers = _doc_cache(doc, "_render_font_covers")
        self._glyph_cache = _doc_cache(doc, "_render_glyph_cache")
        self._run_cache = _doc_cache(doc, "_render_run_cache")
        self._face_picks = _doc_cache(doc, "_render_face_picks")
        self._rot_cache = _doc_cache(doc, "_render_rot_cache")

    def _fail(self, exc: Exception) -> None:
        """Keep the first failure (render_page_full raises it) and raise
        it here too, so that the operator draws nothing."""
        if self.failure is None:
            self.failure = exc
        raise exc

    def render(self) -> np.ndarray:
        # pattern matrices map pattern space to the page's default space
        self._base_ctm = page_base_ctm(self.page, self.scale)
        self.run(self._base_ctm)
        self._flush()
        if self.failure is not None:
            raise self.failure
        return self.canvas

    # ------------------------------------------------------------- blending

    def _queue(self, rgba: tuple, polys=(), lines=(), width: int = 0) -> None:
        """Blend ``rgba`` through polygons and lines onto the canvas, as
        ``ImageDraw.Draw(canvas, "RGBA")`` would one call at a time."""
        if self._ink != rgba:
            self._flush()
            self._ink = rgba
        self._polys.extend(polys)
        if lines:
            self._lines.setdefault(width, []).extend(lines)

    def _flush(self) -> None:
        if self._ink is None:
            return
        # on the RGBA cell of a tiling pattern ImageDraw does not blend: it
        # writes the ink, alpha included, with its non-alpha polygon scan
        blend = self.canvas.shape[2] == 3
        spans = [pil_draw.polygon_spans(self._polys, self.height, blend)] if self._polys else []
        points = []
        for width, lines in self._lines.items():
            sp, pts = pil_draw.line_spans(lines, width, self.height, blend)
            spans.append(sp)
            if pts is not None:
                points.append(pts)
        if blend:
            pil_draw.blend_spans(self.canvas, spans, points, self._ink)
        else:
            pil_draw.write_spans(self.canvas, spans, points, self._ink)
        self._ink = None
        self._polys = []
        self._lines = {}

    # ----------------------------------------------------------------- hooks

    def on_paint_path(self, path, *, stroke: bool, fill: bool, even_odd: bool) -> None:
        gs = self.gs
        if fill:
            if gs.fill_pattern is not None:
                self._flush()
                self._guard(self._fill_with_pattern, path)
            else:
                self._paint_polys(path, pil_draw.ink(gs.fill_color, gs.fill_alpha))
        if stroke:
            color = pil_draw.ink(gs.stroke_color, gs.stroke_alpha)
            lw = max(1, int(round(gs.line_width * mat_scale_of(gs.ctm))))
            subs = [sub for sub in path if len(sub) >= 2]
            mask = self._clip_mask()
            if mask is None:
                self._queue(color, lines=subs, width=lw)
            elif subs:
                self._flush()
                cov = pil_draw.line_coverage(subs, lw, self.width, self.height)
                if cov is not None:
                    x0, y0, layer = cov
                    layer = layer * np.uint8(color[3])
                    h, w = layer.shape
                    layer = pil_draw.multiply(layer, mask[y0:y0 + h, x0:x0 + w])
                    self._paste_mask(color[:3], layer, x0, y0)

    def _guard(self, fn, *args) -> None:
        """Run a paint that the interpreter would skip on an error; here
        every error fails the page."""
        try:
            fn(*args)
        except Exception as exc:  # noqa: BLE001 - every failure is fatal here
            self._fail(exc)

    # -------------------------------------------------------------- shadings

    def on_shading(self, ops: list, res: dict) -> None:
        """``sh`` paints the shading across the current clip region."""
        if not ops or not isinstance(ops[0], str):
            return
        shs = self.doc.resolve(res.get("Shading"))
        sh = self.doc.resolve(shs.get(ops[0])) if isinstance(shs, dict) else None
        if sh is None:
            return
        self._flush()
        self._guard(self._paint_shading, sh, self.gs.ctm, None, None)

    def _paint_shading(self, sh, ctm, region, extra_mask) -> None:
        """The shading over the clip box, the region and the shading's own
        BBox, through its alpha, the fill alpha, the clip mask and
        ``extra_mask`` (sized to ``region``), in float64 as the JAX
        package multiplies them, then truncated to an ``L`` mask."""
        gs = self.gs
        r = self.doc.resolve
        x0, y0, x1, y1 = 0, 0, self.width, self.height
        if gs.clip_bbox is not None:
            cb = gs.clip_bbox
            x0 = max(x0, int(math.floor(cb[0])))
            y0 = max(y0, int(math.floor(cb[1])))
            x1 = min(x1, int(math.ceil(cb[2])))
            y1 = min(y1, int(math.ceil(cb[3])))
        if region is not None:
            x0, y0 = max(x0, region[0]), max(y0, region[1])
            x1, y1 = min(x1, region[2]), min(y1, region[3])
        sh_dict = sh.dict if hasattr(sh, "dict") else sh
        if isinstance(sh_dict, dict):
            bb = r(sh_dict.get("BBox"))
            if isinstance(bb, list) and len(bb) == 4:
                v = [float(r(b)) for b in bb]
                pts = [mat_apply(ctm, v[0], v[1]), mat_apply(ctm, v[2], v[1]),
                       mat_apply(ctm, v[2], v[3]), mat_apply(ctm, v[0], v[3])]
                x0 = max(x0, int(math.floor(min(p[0] for p in pts))))
                y0 = max(y0, int(math.floor(min(p[1] for p in pts))))
                x1 = min(x1, int(math.ceil(max(p[0] for p in pts))))
                y1 = min(y1, int(math.ceil(max(p[1] for p in pts))))
        if x1 <= x0 or y1 <= y0:
            return
        out = render_shading(self.doc, sh, ctm, (x0, y0, x1, y1))
        if out is None:
            return
        rgb, alpha = out
        a = alpha * gs.fill_alpha
        mask = self._clip_mask()
        if mask is not None:
            a = a * (mask[y0:y1, x0:x1].astype(np.float64) / 255.0)
        if extra_mask is not None:
            if region is not None and extra_mask.shape != a.shape:
                oy, ox = region[1], region[0]
                extra_mask = extra_mask[y0 - oy:y1 - oy, x0 - ox:x1 - ox]
            a = a * extra_mask
        self._paste_mask(rgb, (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8), x0, y0)

    def _fill_with_pattern(self, path) -> None:
        """Fill the subpaths' union with the active shading or tiling
        pattern, as the JAX package's ``_fill_with_pattern``: the pattern
        painted over the path's box (cut by the clip box), through the
        polygon coverage times the clip mask."""
        kind, payload, matrix = self.gs.fill_pattern
        xs = [p[0] for sub in path for p in sub]
        ys = [p[1] for sub in path for p in sub]
        if not xs:
            return
        rx0 = max(int(math.floor(min(xs))), 0)
        ry0 = max(int(math.floor(min(ys))), 0)
        rx1 = min(int(math.ceil(max(xs))), self.width)
        ry1 = min(int(math.ceil(max(ys))), self.height)
        cb = self.gs.clip_bbox
        if cb is not None:
            rx0 = max(rx0, int(math.floor(cb[0])))
            ry0 = max(ry0, int(math.floor(cb[1])))
            rx1 = min(rx1, int(math.ceil(cb[2])))
            ry1 = min(ry1, int(math.ceil(cb[3])))
        if rx1 <= rx0 or ry1 <= ry0:
            return
        poly = np.zeros((self.height, self.width), np.uint8)
        cov = pil_draw.fill_coverage([sub for sub in path if len(sub) >= 3],
                                     self.width, self.height)
        if cov is not None:
            cx, cy, inside = cov
            poly[cy:cy + inside.shape[0], cx:cx + inside.shape[1]][inside] = 255
        poly_np = poly[ry0:ry1, rx0:rx1].astype(np.float64) / 255.0
        mask0 = self._clip_mask()
        if mask0 is not None:
            poly_np = poly_np * (mask0[ry0:ry1, rx0:rx1].astype(np.float64) / 255.0)
        base = getattr(self, "_base_ctm", self.gs.ctm)
        pat_ctm = mat_mul(matrix, base)
        if kind == "shading":
            self._paint_shading(payload, pat_ctm, (rx0, ry0, rx1, ry1), poly_np)
            return
        tile = self._tiling_tile(payload, pat_ctm)
        if tile is None:  # a tiling whose steps are not axis-aligned: mid-grey
            self._paste_mask((128, 128, 128), (poly_np * 255).astype(np.uint8), rx0, ry0)
            return
        tile_img, tx0, ty0, stepx, stepy = tile
        th, tw = tile_img.shape[:2]
        if stepx <= 0 or stepy <= 0:
            return
        i0 = int(math.floor((rx0 - tx0) / stepx))
        j0 = int(math.floor((ry0 - ty0) / stepy))
        i1 = int(math.ceil((rx1 - tx0) / stepx))
        j1 = int(math.ceil((ry1 - ty0) / stepy))
        if (i1 - i0) * (j1 - j0) > 4096:
            return  # degenerate step, as the JAX package gives up
        layer = np.zeros((ry1 - ry0, rx1 - rx0, 4), np.uint8)
        for j in range(j0, j1 + 1):
            for i in range(i0, i1 + 1):
                px = int(round(tx0 + i * stepx)) - rx0
                py = int(round(ty0 + j * stepy)) - ry0
                if px > layer.shape[1] or py > layer.shape[0]:
                    continue
                if px + tw < 0 or py + th < 0:
                    continue
                pil_draw.paste_mask(layer, tile_img, tile_img[..., 3], px, py)
        la = (layer[..., 3].astype(np.float64) / 255.0) * poly_np
        self._paste_mask(layer[..., :3], (np.clip(la, 0, 1) * 255).astype(np.uint8), rx0, ry0)

    def _tiling_tile(self, pat_stream, pat_ctm):
        """One tiling-pattern cell drawn onto a transparent RGBA canvas by a
        nested rasterizer: (tile, origin x, origin y, x step, y step) in
        device pixels, or None where the JAX package gives up (steps that
        are not axis-aligned, a cell over 2048 pixels, a bad BBox, nesting
        past the form depth). A cell whose content fails fails the page."""
        doc = self.doc
        pd = pat_stream.dict if hasattr(pat_stream, "dict") else None
        if not isinstance(pd, dict):
            return None
        if self._form_depth >= self.MAX_FORM_DEPTH:
            return None
        cache = self._tile_cache
        key = (id(pat_stream), tuple(round(v, 3) for v in pat_ctm))
        if key in cache:
            return cache[key]
        try:
            bb = [float(doc.resolve(v)) for v in doc.resolve(pd.get("BBox"))]
            xstep = float(doc.resolve(pd.get("XStep", bb[2] - bb[0])) or (bb[2] - bb[0]))
            ystep = float(doc.resolve(pd.get("YStep", bb[3] - bb[1])) or (bb[3] - bb[1]))
        except (TypeError, ValueError, IndexError):
            cache[key] = None
            return None
        a, b, c, d_, _, _ = pat_ctm
        sx_dev = (xstep * a, xstep * b)
        sy_dev = (ystep * c, ystep * d_)
        if abs(sx_dev[1]) > 0.01 * abs(sx_dev[0] or 1) or abs(sy_dev[0]) > 0.01 * abs(sy_dev[1] or 1):
            cache[key] = None
            return None
        corners = [mat_apply(pat_ctm, bb[0], bb[1]), mat_apply(pat_ctm, bb[2], bb[1]),
                   mat_apply(pat_ctm, bb[2], bb[3]), mat_apply(pat_ctm, bb[0], bb[3])]
        tx0 = min(p[0] for p in corners)
        ty0 = min(p[1] for p in corners)
        tw = max(1, int(math.ceil(max(p[0] for p in corners) - tx0)))
        th = max(1, int(math.ceil(max(p[1] for p in corners) - ty0)))
        if tw > 2048 or th > 2048:
            cache[key] = None
            return None
        sub = PageRasterizer(self.page, scale=self.scale)
        sub._form_depth = self._form_depth + 1
        sub.canvas = np.zeros((th, tw, 4), np.uint8)
        sub.width, sub.height = tw, th
        sub.gs.ctm = mat_mul(pat_ctm, (1, 0, 0, 1, -tx0, -ty0))
        sub.execute(doc.stream_bytes(pat_stream), doc.resolve(pd.get("Resources")) or {})
        sub._flush()
        if sub.failure is not None:
            raise sub.failure
        out = (sub.canvas, tx0, ty0, abs(sx_dev[0]), abs(sy_dev[1]))
        cache[key] = out
        return out

    # ------------------------------------------------------- clip machinery

    def _clip_mask(self) -> np.ndarray | None:
        """The non-rectangular clips' mask, 255 inside (None when every
        active clip is a rectangle): each clip's subpaths filled as PIL
        mode-1 polygons, XORed for even-odd, the clips ANDed. Cached by the
        clip stack."""
        cp = self.gs.clip_paths
        if not cp:
            return None
        m = self._clipmask_cache.get(cp)
        if m is None:
            acc = None
            for polys, even_odd in cp:
                layer = np.zeros((self.height, self.width), bool)
                if even_odd:
                    for sub in polys:
                        cov = pil_draw.fill_coverage([sub], self.width, self.height)
                        if cov is not None:
                            x0, y0, inside = cov
                            layer[y0:y0 + inside.shape[0], x0:x0 + inside.shape[1]] ^= inside
                else:
                    cov = pil_draw.fill_coverage(list(polys), self.width, self.height)
                    if cov is not None:
                        x0, y0, inside = cov
                        layer[y0:y0 + inside.shape[0], x0:x0 + inside.shape[1]] |= inside
                acc = layer if acc is None else (acc & layer)
            m = acc.astype(np.uint8) * np.uint8(255)
            if len(self._clipmask_cache) > 64:
                self._clipmask_cache.clear()
            self._clipmask_cache[cp] = m
        return m

    def _paint_polys(self, path, rgba: tuple) -> None:
        """Polygon fill honouring the clip box and the clip mask (each
        subpath on its own, even-odd or not, as in the JAX package)."""
        gs = self.gs
        mask = self._clip_mask()
        cb = gs.clip_bbox
        needs_bbox = cb is not None and any(
            x < cb[0] - 0.5 or y < cb[1] - 0.5 or x > cb[2] + 0.5 or y > cb[3] + 0.5
            for sub in path for x, y in sub)
        subs = [sub for sub in path if len(sub) >= 3]
        if mask is None and not needs_bbox:
            self._queue(rgba, polys=subs)
            return
        self._flush()
        cov = pil_draw.fill_coverage(subs, self.width, self.height)
        if cov is None:
            return
        x0, y0, inside = cov
        h, w = inside.shape
        arr = inside.astype(np.uint8) * np.uint8(255)
        if needs_bbox:
            bx0 = max(int(math.floor(cb[0])), 0)
            by0 = max(int(math.floor(cb[1])), 0)
            bx1 = min(int(math.ceil(cb[2])), self.width)
            by1 = min(int(math.ceil(cb[3])), self.height)
            keep = np.zeros_like(arr)
            kx0, ky0 = max(bx0 - x0, 0), max(by0 - y0, 0)
            kx1, ky1 = min(bx1 - x0, w), min(by1 - y0, h)
            if kx1 > kx0 and ky1 > ky0 and bx1 > bx0 and by1 > by0:
                keep[ky0:ky1, kx0:kx1] = 1
            arr *= keep
        if mask is not None:
            arr = (arr.astype(np.uint16) * mask[y0:y0 + h, x0:x0 + w] // 255).astype(np.uint8)
        if rgba[3] < 255:
            arr = (arr.astype(np.uint16) * rgba[3] // 255).astype(np.uint8)
        self._paste_mask(rgba[:3], arr, x0, y0)

    def _with_clip_mask(self, origin, alpha: np.ndarray | None, size=None):
        """A paste alpha combined with the clip mask at ``origin`` (the
        mask is 0 outside the canvas); None for an unmasked paste."""
        mask = self._clip_mask()
        if mask is None:
            return alpha
        h, w = alpha.shape if alpha is not None else (size or (0, 0))
        if w <= 0 or h <= 0:
            return alpha
        ox, oy = origin
        crop = np.zeros((h, w), np.uint8)
        cx0, cy0 = max(ox, 0), max(oy, 0)
        cx1, cy1 = min(ox + w, self.width), min(oy + h, self.height)
        if cx1 > cx0 and cy1 > cy0:
            crop[cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox] = mask[cy0:cy1, cx0:cx1]
        if alpha is None:
            return crop
        return (alpha.astype(np.uint16) * crop // 255).astype(np.uint8)

    # ----------------------------------------------------------------- text

    def on_show_char(
        self, code: int, text: str, trm: Matrix, advance: float, font: Font
    ) -> None:
        gs = self.gs
        if gs.render_mode in (3, 7):  # invisible / clip-only
            return
        if getattr(font, "subtype", "") == "Type3" and self._draw_type3(code, font, trm):
            return
        if not text or text.isspace():
            return
        try:
            self._flush()
            self._draw_text(text, trm, font)
        except NotImplementedError as exc:
            self._fail(exc)

    def _draw_text(self, text: str, trm: Matrix, font: Font) -> None:
        gs = self.gs
        a, b, c, d, e, f = trm
        # (colour, rotation, pixel size) depend only on trm's linear part
        # and the fill state: one lookup per character, at document scope
        rkey = (a, b, c, d, gs.fill_color, gs.fill_alpha, id(font))
        run = self._run_cache.get(rkey)
        if run is None:
            px = math.hypot(c, d)
            if px < 1.0:
                run = (None, 0.0, None)
            else:
                color = tuple(int(v * 255) for v in gs.fill_color) + (int(255 * gs.fill_alpha),)
                rotation = math.degrees(math.atan2(b, a)) % 360.0
                upright = rotation < 0.5 or rotation > 359.5
                run = (color, rotation if not upright else 0.0, px)
            if len(self._run_cache) > 4096:
                self._run_cache.clear()
            self._run_cache[rkey] = run
        color, rotation, px = run
        if color is None:
            return
        face = self._pick_face(font, text, px)
        if face is None:
            return
        if rotation == 0.0:
            self._draw_cached(text, face, color, (e, f))
        else:
            self._draw_rotated(text, face, color, (e, f), rotation)

    def _pick_face(self, font: Font, text: str, px: float) -> Face | None:
        px_r = round(px)
        pick_key = (id(font), text[:1], px_r)
        face = self._face_picks.get(pick_key)
        if face is not None:
            return face
        face = self.fontbank.face(font, px_r)
        key = (id(font), text[:1])
        covered = self._font_covers.get(key)
        if covered is None:
            covered = self.fontbank.covers(face, text)
            self._font_covers[key] = covered
        if not covered:
            face = self.fontbank.fallback(px_r)
        self._face_picks[pick_key] = face
        return face

    def _draw_cached(self, text: str, face: Face, color: tuple, origin) -> None:
        """Glyph-tile cache: each (face, text, colour) is drawn once onto an
        RGBA tile (``ImageDraw.text`` with anchor ``ls``); repeats paste
        the tile through its own alpha."""
        key = (id(face), text, color)
        entry = self._glyph_cache.get(key)
        TILE_STATS["misses" if entry is None else "hits"] += 1
        if entry is None:
            try:
                bbox = face.getbbox(text, anchor="ls")
            except NotImplementedError:
                raise
            except Exception:  # noqa: BLE001 - the JAX package draws nothing then
                return
            w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
            if w <= 0 or h <= 0 or w > 2048 or h > 2048:
                return
            tile = np.zeros((h, w, 4), np.uint8)
            mask, (mx, my) = face.getmask(text, anchor="ls")
            pil_draw.draw_bitmap_rgba(tile, mask, -bbox[0] + mx, -bbox[1] + my, color)
            if len(self._glyph_cache) > 20000:
                self._glyph_cache.clear()
            entry = (tile, bbox[0], bbox[1])
            self._glyph_cache[key] = entry
        tile, dx, dy = entry
        x, y = origin
        self._paste_mask(tile, tile[..., 3], int(x + dx), int(y + dy))

    def _draw_rotated(self, text: str, face: Face, color: tuple, origin, rotation: float) -> None:
        """A tile drawn with the pad of 4, turned by ``-rotation`` with PIL's
        BICUBIC ``rotate(expand=True)`` and centred on the glyph origin, as
        the JAX package places it; cached per (face, text, colour,
        rotation)."""
        key = (id(face), text, color, round(rotation, 2))
        rotated = self._rot_cache.get(key)
        TILE_STATS["misses" if rotated is None else "hits"] += 1
        if rotated is None:
            try:
                bbox = face.getbbox(text)
            except NotImplementedError:
                raise
            except Exception:  # noqa: BLE001 - the JAX package draws nothing then
                return
            pad = 4
            w = bbox[2] - bbox[0] + 2 * pad
            h = bbox[3] - bbox[1] + 2 * pad
            if w <= 0 or h <= 0 or w > 4096 or h > 4096:
                return
            tile = np.zeros((h, w, 4), np.uint8)
            mask, (mx, my) = face.getmask(text)
            pil_draw.draw_bitmap_rgba(tile, mask, pad - bbox[0] + mx, pad - bbox[1] + my, color)
            rotated = rotate_expand_bicubic(tile, -rotation)
            if len(self._rot_cache) > 8192:
                self._rot_cache.clear()
            self._rot_cache[key] = rotated
        ox, oy = origin
        rh, rw = rotated.shape[:2]
        self._paste_mask(rotated, rotated[..., 3], int(ox - rw / 2), int(oy - rh / 2))

    def _draw_type3(self, code: int, font: Font, trm: Matrix) -> bool:
        """Run a Type3 glyph's CharProc under FontMatrix x trm; False when
        the glyph program cannot be resolved (the JAX package then draws
        the text with a system font)."""
        procs = getattr(font, "t3_charprocs", None)
        if not procs:
            return False
        name = font._differences.get(code)
        if name is None:
            return False
        stream = self.doc.resolve(procs.get(name))
        if stream is None or not hasattr(stream, "dict"):
            return False
        if self._form_depth >= self.MAX_FORM_DEPTH:
            return True  # depth-guarded, as in the JAX package
        self._form_depth += 1
        saved_gs = replace(self.gs)
        saved_len = len(self.gs_stack)
        # CharProcs may contain BT/ET: the text state restores too
        saved_tm = self.text_matrix
        saved_tlm = self.text_line_matrix
        try:
            self.gs.ctm = mat_mul(getattr(font, "t3_matrix", (0.001, 0, 0, 0.001, 0, 0)), trm)
            res = getattr(font, "t3_resources", None) or self.page.resources
            cache = getattr(self.doc, "_form_tokens_cache", None)
            if cache is None:
                cache = {}
                self.doc._form_tokens_cache = cache
            toks = cache.get(id(stream))
            if toks is None:
                from .content import tokenize_content

                toks = list(tokenize_content(self.doc.stream_bytes(stream)))
                if len(cache) > 512:
                    cache.clear()
                cache[id(stream)] = toks
            self.execute(b"", res, tokens=toks)
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 - the JAX package draws the glyph as far as it got
            pass
        finally:
            self.gs = saved_gs
            del self.gs_stack[saved_len:]
            self.text_matrix = saved_tm
            self.text_line_matrix = saved_tlm
            self._form_depth -= 1
        return True

    # --------------------------------------------------------------- images

    def on_draw_image(self, stream: Stream, name: str) -> None:
        try:
            self._flush()
            self._draw_image(stream)
        except Exception as exc:  # noqa: BLE001 - every failure is fatal here
            self._fail(exc)

    def _draw_image(self, stream: Stream) -> None:
        img = xobject_to_array(self.doc, stream)
        ctm = self.gs.ctm
        # unit square corners under CTM
        corners = [
            mat_apply(ctm, 0, 0), mat_apply(ctm, 1, 0),
            mat_apply(ctm, 1, 1), mat_apply(ctm, 0, 1),
        ]
        xs = [p[0] for p in corners]
        ys = [p[1] for p in corners]
        x0, y0, x1, y1 = min(xs), min(ys), max(xs), max(ys)
        if self.gs.clip_bbox:
            cb = self.gs.clip_bbox
            x0, y0 = max(x0, cb[0]), max(y0, cb[1])
            x1, y1 = min(x1, cb[2]), min(y1, cb[3])
        dst_w, dst_h = int(round(x1 - x0)), int(round(y1 - y0))
        if dst_w <= 0 or dst_h <= 0 or img is None:
            return
        origin = (int(x0), int(y0))
        if img.ndim == 3 and img.shape[2] == 2:
            # stencil mask: the fill colour through the mask, unflipped
            color = tuple(int(v * 255) for v in self.gs.fill_color)
            mask = self._with_clip_mask(origin, resize(img[..., 0], dst_w, dst_h, "bicubic"))
            self._paste_mask(color, mask, *origin)
            return
        a, b, c, d, _, _ = ctm
        if a < 0:  # FLIP_LEFT_RIGHT
            img = img[:, ::-1]
        if d > 0:  # FLIP_TOP_BOTTOM: images are top-down after the y-flip base ctm
            img = img[::-1]
        rot = math.degrees(math.atan2(b, a)) % 360.0
        if 45 <= rot < 135 or 225 <= rot < 315:
            img = rotate_expand(np.ascontiguousarray(img), -rot)
        h, w = img.shape[:2]
        if img.dtype == np.uint16:
            if (dst_w, dst_h) != (w, h):
                raise not_ported("16-bit JPX images drawn at another size", "pdfio")
            img = np.minimum(img, 255).astype(np.uint8)
        rgba = img.ndim == 3 and img.shape[2] == 4
        if (dst_w, dst_h) != (w, h):
            img = np.ascontiguousarray(img)
            if not rgba and dst_w * dst_h >= CV2_MIN_PIXELS:
                if dst_w * dst_h < w * h:
                    img = resize_area(img, dst_w, dst_h)
                else:
                    img = resize_linear(img, dst_w, dst_h)
            else:
                img = resize(img, dst_w, dst_h, "bilinear")
        if rgba:
            pmask = self._with_clip_mask(origin, img[..., 3])
            self._paste_mask(img, pmask, *origin)
            return
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, 2)
        pmask = self._with_clip_mask(origin, None, img.shape[:2])
        if pmask is None:
            self._paste(img, *origin)
        else:
            self._paste_mask(img, pmask, *origin)

    def _paste(self, img: np.ndarray, ox: int, oy: int) -> None:
        """PIL ``Image.paste`` at (ox, oy), clipped to the canvas."""
        h, w = img.shape[:2]
        cx0, cy0 = max(ox, 0), max(oy, 0)
        cx1, cy1 = min(ox + w, self.width), min(oy + h, self.height)
        if cx1 <= cx0 or cy1 <= cy0:
            return
        self.canvas[cy0:cy1, cx0:cx1] = self._source(img)[cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox]

    def _source(self, src):
        """A paste's source in the canvas's bands: on the RGB page the
        colour bands; on a tiling pattern's RGBA cell an RGB source gains
        alpha 255 (PIL converts it to RGBA) and an RGBA one keeps its own."""
        rgba = self.canvas.shape[2] == 4
        if not isinstance(src, np.ndarray):
            src = tuple(src)
            return (src[:3] + (255,)) if rgba and len(src) == 3 else src[:4 if rgba else 3]
        if not rgba:
            return src[..., :3]
        if src.shape[2] == 4:
            return src
        return np.concatenate([src, np.full(src.shape[:2] + (1,), 255, np.uint8)], axis=2)

    def _paste_mask(self, src, mask: np.ndarray, ox: int, oy: int) -> None:
        """``canvas.paste(src, (ox, oy), mask)`` with an ``L`` mask (every
        band of the canvas blended)."""
        pil_draw.paste_mask(self.canvas, self._source(src), mask, ox, oy)


class _RenderAndExtract(PageRasterizer):
    """One content-stream pass producing the raster, the char records,
    and the image placements."""

    def __init__(self, page: PdfPage, scale: float, with_text: bool = True):
        super().__init__(page, scale)
        self.chars: list[dict] = []
        self.image_boxes: list[list[float]] = []
        self._rec_cache: dict = {}
        self._record_char = None
        if with_text:
            from .text import record_char

            self._record_char = record_char

    def on_show_char(self, code, text, trm, advance, font) -> None:
        if self._record_char is not None:
            self._record_char(
                self.chars, self.gs, code, text, trm, advance, font,
                self._rec_cache,
            )
        super().on_show_char(code, text, trm, advance, font)

    def on_draw_image(self, stream: Stream, name: str) -> None:
        # placement record (raster pixels; rescaled to page points by
        # render_page_full) — same unit-square math as
        # placements.PlacementCollector
        ctm = self.gs.ctm
        pts = [
            mat_apply(ctm, x, y) for x, y in ((0, 0), (1, 0), (1, 1), (0, 1))
        ]
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        self.image_boxes.append([min(xs), min(ys), max(xs), max(ys)])
        super().on_draw_image(stream, name)


def render_page_full(
    page: PdfPage, dpi: int = 200, with_text: bool = True
) -> tuple[np.ndarray, dict | None, list[list[float]]]:
    """(raster (H, W, 3) uint8, native-text page dict, image placement
    boxes) from ONE interpreter pass, as the JAX package's function
    returns them (the raster as an array). with_text=False returns None
    for the page dict."""
    scale = dpi / 72.0
    r = _RenderAndExtract(page, scale, with_text=with_text)
    img = r.render()
    # char/box geometry was recorded at raster scale; back to page points
    inv = 1.0 / scale
    for ch in r.chars:
        ch["bbox"] = [v * inv for v in ch["bbox"]]
        ch["origin"] = [v * inv for v in ch["origin"]]
        ch["size"] *= inv
    boxes = []
    for b in r.image_boxes:
        pb = [v * inv for v in b]
        if pb[2] - pb[0] >= 1 and pb[3] - pb[1] >= 1:
            boxes.append(pb)
    if not with_text:
        return img, None, boxes
    from .text import build_page_dict

    return img, build_page_dict(page, r.chars), boxes
