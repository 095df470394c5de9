"""Page rasterization onto a numpy canvas (feeds the OCR models).

Port of ``rapiddoc_tpu/pdfio/render.py`` ``render_page_full`` for pages
whose content is images placed by ``q ... cm ... Do ... Q``, as scanned
pages and ``images_to_pdf`` write them. The page size and its rounding
(``PageRasterizer.__init__``) and the placement arithmetic
(``on_draw_image``: the unit square under the CTM, the rectangular clip,
the flips, rotations by 90 degrees, the resize and the paste) are the JAX
package's; its PIL and cv2 calls become numpy:

- PIL's ``transpose`` and ``rotate(expand=True)`` by 90 or 270 degrees
  are array flips and ``np.rot90``;
- ``cv2.resize`` INTER_LINEAR (enlarging) is ``resize_linear`` and
  INTER_AREA (shrinking) is ``resize_area`` of ``models/ocr/pre_post.py``,
  both bit-equal, for placements of at least 16384 destination pixels;
- the paste onto the white canvas is a clipped slice assignment.

What the JAX package would draw and this module does not draw yet raises
NotImplementedError naming its ROADMAP item, and is never left as
background: text that shows ink, path painting, shadings, a clip that is
not a rectangle, an image resized to under 16384 pixels (PIL BILINEAR in
the JAX package), a rotation other than a multiple of 90 degrees, and the
codecs ``pdfio.images`` does not take. The content interpreter skips an
operator that raises, as the JAX package's does; so a hook records what
it cannot draw, and ``render_page_full`` raises it after the pass.
"""
from __future__ import annotations

import math

import numpy as np

from ..models.ocr.pre_post import resize_area, resize_linear
from ..utils.unported import not_ported
from .content import ContentInterpreter, Matrix, mat_apply
from .cos import Stream
from .document import PdfPage
from .fonts import Font
from .images import xobject_to_array
from .text import page_base_ctm

# placements that the JAX package resizes with cv2 (at least this many
# destination pixels); smaller ones go through PIL BILINEAR
CV2_MIN_PIXELS = 16384


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

    def _fail(self, exc: Exception) -> None:
        """Keep the first failure (render_page_full raises it) and raise
        it here too, so that the operator draws nothing."""
        if self.failure is None:
            self.failure = exc
        raise exc

    def render(self) -> np.ndarray:
        self.run(page_base_ctm(self.page, self.scale))
        if self.failure is not None:
            raise self.failure
        return self.canvas

    # ----------------------------------------------------------------- hooks

    def on_paint_path(self, path, *, stroke: bool, fill: bool, even_odd: bool) -> None:
        self._fail(not_ported("path painting", "pdfio"))

    def on_shading(self, ops: list, res: dict) -> None:
        self._fail(not_ported("shadings", "pdfio"))

    def on_show_char(
        self, code: int, text: str, trm: Matrix, advance: float, font: Font
    ) -> None:
        # the JAX package draws nothing for invisible or clip-only text,
        # blank characters and glyphs under one pixel; Type3 glyphs are
        # content streams it runs
        if self.gs.render_mode in (3, 7):
            return
        if getattr(font, "subtype", "") != "Type3":
            if not text or text.isspace() or math.hypot(trm[2], trm[3]) < 1.0:
                return
        self._fail(not_ported("text rendering", "pdfio"))

    def on_draw_image(self, stream: Stream, name: str) -> None:
        try:
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
        if self.gs.clip_paths:
            raise not_ported("a clip that is not a rectangle", "pdfio")
        a, b, c, d, _, _ = ctm
        if a < 0:  # FLIP_LEFT_RIGHT
            img = img[:, ::-1]
        if d > 0:  # FLIP_TOP_BOTTOM: images are top-down after the y-flip base ctm
            img = img[::-1]
        rot = math.degrees(math.atan2(b, a)) % 360.0
        if 45 <= rot < 135 or 225 <= rot < 315:
            # PIL rotate(-rot, expand=True) is a transpose only at 90 and 270
            if rot == 90.0:
                img = np.rot90(img, -1)
            elif rot == 270.0:
                img = np.rot90(img, 1)
            else:
                raise not_ported(f"an image placed at {rot:.6g} degrees", "pdfio")
        h, w = img.shape[:2]
        if (dst_w, dst_h) != (w, h):
            if dst_w * dst_h < CV2_MIN_PIXELS:
                raise not_ported(f"a {w}x{h} image resized to {dst_w}x{dst_h}",
                                 "small_resize")
            img = np.ascontiguousarray(img)
            if dst_w * dst_h < w * h:
                img = resize_area(img, dst_w, dst_h)
            else:
                img = resize_linear(img, dst_w, dst_h)
        self._paste(img, int(x0), int(y0))

    def _paste(self, img: np.ndarray, ox: int, oy: int) -> None:
        """PIL ``Image.paste`` at (ox, oy), clipped to the canvas; a grey
        image is pasted as RGB."""
        h, w = img.shape[:2]
        cx0, cy0 = max(ox, 0), max(oy, 0)
        cx1, cy1 = min(ox + w, self.width), min(oy + h, self.height)
        if cx1 <= cx0 or cy1 <= cy0:
            return
        part = img[cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox]
        self.canvas[cy0:cy1, cx0:cx1] = part[..., None] if part.ndim == 2 else part


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
