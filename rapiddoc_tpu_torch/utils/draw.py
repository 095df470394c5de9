"""Visual QA overlays: layout / span boxes drawn onto rendered pages.

Port of ``rapiddoc_tpu/utils/draw.py`` (reference:
rapid_doc/utils/draw_bbox.py — *_layout.pdf / *_span.pdf debug
artifacts): the same boxes, colours, labels and PDFs, drawn on numpy
pages with Pillow's rules replayed:

- ``ImageDraw.rectangle(outline=, width=)``: corners truncated toward
  zero, ``width`` horizontal rows at the top and the bottom over the full
  span, and the sides as Pillow's vertical lines (without their last
  point) between them;
- ``ImageDraw.polygon(outline=)``: vertices truncated toward zero, each
  edge a Bresenham line without its last point (``pdfio/pil_draw``);
- ``ImageDraw.text``: the label's mask from ``pdfio/ft_face`` (DejaVu
  Sans Bold where its system file exists, else the Aileron face that
  ``ImageFont.load_default`` gives, at 10 px), drawn from the position's
  fraction (``getmask2``'s ``start``) and pasted in the ink at the
  truncated position plus the mask's offset. FreeType hints both faces
  and the port draws them unhinted (ROADMAP item 12e), so label pixels
  differ from the JAX package's within a band, and nowhere else.

Pages are rendered by the port's ``PageRasterizer`` and written by
``pdfio/writer.images_to_pdf`` (JPEG at quality 92), as the JAX package
writes them.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np

from ..pdfio.pil_draw import _bresenham, paste_mask
from ..types import BlockType

_TYPE_COLORS = {
    BlockType.TEXT: (30, 120, 255),
    BlockType.TITLE: (220, 40, 40),
    BlockType.IMAGE: (40, 170, 90),
    BlockType.IMAGE_BODY: (40, 170, 90),
    BlockType.IMAGE_CAPTION: (120, 200, 120),
    BlockType.TABLE: (200, 120, 30),
    BlockType.TABLE_BODY: (200, 120, 30),
    BlockType.TABLE_CAPTION: (230, 170, 90),
    BlockType.INTERLINE_EQUATION: (160, 60, 200),
    BlockType.LIST: (60, 60, 220),
    BlockType.INDEX: (90, 90, 180),
    BlockType.DISCARDED: (150, 150, 150),
}
_DEFAULT_COLOR = (90, 90, 90)

# the label font the JAX package asks for, and Pillow's default face
_LABEL_FONT = Path("/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf")
_DEFAULT_FONT = Path(__file__).resolve().parent.parent / "assets" / "aileron_pil_default.ttf"


@functools.lru_cache(maxsize=None)
def label_face(px: int):
    """``ImageFont.truetype(DejaVuSans-Bold.ttf, px)``, or
    ``ImageFont.load_default()`` (Aileron at 10 px, basic layout) where
    that file does not open."""
    from ..pdfio.ft_face import Face

    try:
        return Face(_LABEL_FONT.read_bytes(), px)
    except OSError:
        return Face(_DEFAULT_FONT.read_bytes(), 10, layout="basic")


def _rgb(page_img: np.ndarray) -> np.ndarray:
    """``page_img.convert("RGB").copy()`` of an (H, W) or (H, W, 3) page."""
    img = np.asarray(page_img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return np.array(img[..., :3], copy=True)


def _points(img: np.ndarray, pts, color) -> None:
    h, w = img.shape[:2]
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def draw_rectangle(img: np.ndarray, xy, color, width: int = 1) -> None:
    """``ImageDraw.rectangle(xy, outline=color, width=width)``."""
    if xy[2] < xy[0]:
        raise ValueError("x1 must be greater than or equal to x0")
    if xy[3] < xy[1]:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = (int(v) for v in xy)
    h, w = img.shape[:2]
    width = max(width, 1)
    for i in range(width):
        for y in (y0 + i, y1 - i):
            if 0 <= y < h and x1 >= 0 and x0 < w:
                img[y, max(x0, 0):min(x1, w - 1) + 1] = color
        _points(img, _bresenham(x1 - i, y0 + width, x1 - i, y1 - width + 1), color)
        _points(img, _bresenham(x0 + i, y0 + width, x0 + i, y1 - width + 1), color)


def draw_polygon(img: np.ndarray, pts, color) -> None:
    """``ImageDraw.polygon(pts, outline=color)`` (width 1, no fill)."""
    ip = [(int(x), int(y)) for x, y in pts]
    for i in range(len(ip)):
        _points(img, _bresenham(*ip[i - 1], *ip[i]), color)


def draw_text(img: np.ndarray, xy, text: str, color, face) -> tuple[int, int, int, int]:
    """``ImageDraw.text(xy, text, fill=color, font=face)``; returns the
    label's box (x0, y0, x1, y1) on the page."""
    start = (math.modf(xy[0])[0], math.modf(xy[1])[0])
    mask, (ox, oy) = face.getmask(text, start=start)
    x, y = int(xy[0]) + ox, int(xy[1]) + oy
    if mask.size:
        paste_mask(img, color, mask, x, y)
    return x, y, x + mask.shape[1], y + mask.shape[0]


def draw_layout_on_page(
    page_img: np.ndarray, page_info: dict, scale: float, labels: list | None = None
) -> np.ndarray:
    """Draw block boxes + reading-order indices on a rendered page
    (``labels``, where given, collects each label's box)."""
    img = _rgb(page_img)
    face = label_face(16)

    def draw_block(block: dict, order: int | None) -> None:
        color = _TYPE_COLORS.get(block["type"], _DEFAULT_COLOR)
        x0, y0, x1, y1 = (v * scale for v in block["bbox"])
        draw_rectangle(img, [x0, y0, x1, y1], color, width=2)
        label = block["type"] + (f" #{order}" if order is not None else "")
        box = draw_text(img, (x0 + 2, max(y0 - 18, 0)), label, color, face)
        if labels is not None:
            labels.append(box)

    blocks = page_info.get("para_blocks") or page_info.get("preproc_blocks") or []
    for i, block in enumerate(blocks):
        draw_block(block, i)
        for sub in block.get("blocks", []):
            draw_block(sub, None)
    for block in page_info.get("discarded_blocks", []):
        draw_block(block, None)
    return img


# span colors keyed by span type (reference: draw_span_bbox
# draw_bbox_without_number color table, draw_bbox.py:510-520)
_SPAN_COLORS = {
    "text": (255, 0, 0),
    "inline_equation": (0, 200, 0),
    "interline_equation": (0, 0, 255),
    "checkbox": (0, 200, 0),
    "image": (255, 204, 0),
    "table": (204, 0, 255),
}
_DROPPED_COLOR = (158, 158, 158)


def _draw_box_or_polygon(img: np.ndarray, span: dict, scale: float, color, width=1):
    """Rotated content carries polygon_points alongside bbox (reference:
    cal_canvas_polygon/draw_polygon, draw_bbox.py:64-131)."""
    poly = span.get("polygon_points")
    if poly and len(poly) >= 3:
        draw_polygon(img, [(px * scale, py * scale) for px, py in poly], color)
        return
    x0, y0, x1, y1 = (v * scale for v in span["bbox"])
    draw_rectangle(img, [x0, y0, x1, y1], color, width=width)


def draw_spans_on_page(page_img: np.ndarray, page_info: dict, scale: float) -> np.ndarray:
    img = _rgb(page_img)

    def walk(blocks, dropped=False):
        for block in blocks:
            if "blocks" in block:
                walk(block["blocks"], dropped)
            for line in block.get("lines", []):
                for span in line.get("spans", []):
                    color = (
                        _DROPPED_COLOR
                        if dropped
                        else _SPAN_COLORS.get(span.get("type", "text"), (255, 80, 80))
                    )
                    _draw_box_or_polygon(img, span, scale, color)

    walk(page_info.get("para_blocks") or page_info.get("preproc_blocks") or [])
    walk(page_info.get("discarded_blocks") or [], dropped=True)
    return img


def draw_line_sort_on_page(
    page_img: np.ndarray, page_info: dict, scale: float, labels: list | None = None
) -> np.ndarray:
    """Line-level reading order overlay: every text line gets its global
    order index (reference: draw_line_sort_bbox, draw_bbox.py:552)."""
    img = _rgb(page_img)
    face = label_face(12)
    blocks = page_info.get("preproc_blocks") or page_info.get("para_blocks") or []

    def lines_of(block):
        if "blocks" in block and block["blocks"]:
            for sub in block["blocks"]:
                yield from sub.get("lines", [])
        else:
            yield from block.get("lines", [])

    # walk blocks in computed reading order (block['index'] from the sort
    # stage); lines carry their own 'index' when the pipeline stored one,
    # else they are numbered sequentially along that order
    order = 0
    for block in sorted(range(len(blocks)), key=lambda i: blocks[i].get("index", i)):
        for line in lines_of(blocks[block]):
            bbox = line.get("bbox")
            if not bbox:
                continue
            idx = line.get("index")
            if idx is None:
                idx = order
            x0, y0, x1, y1 = (v * scale for v in bbox)
            draw_rectangle(img, [x0, y0, x1, y1], (255, 0, 0), width=1)
            box = draw_text(img, (x0 + 1, y0), str(idx), (255, 0, 0), face)
            if labels is not None:
                labels.append(box)
            order += 1
    return img


def debug_pdfs_from_output(
    pdf_bytes: bytes,
    middle_json: dict,
    *,
    layout: bool = True,
    spans: bool = False,
    line_sort: bool = False,
    dpi: int = 96,
) -> dict[str, bytes]:
    """Re-render the source pages and emit annotated debug PDFs
    (reference: cli/common.py:188-194 — *_layout.pdf / *_span.pdf /
    *_line_sort.pdf visual QA artifacts). Returns a dict with any of
    "layout" / "span" / "line_sort" keys."""
    from ..pdfio import open_pdf
    from ..pdfio.render import PageRasterizer

    pdf_info = (middle_json or {}).get("pdf_info") or []
    if not pdf_info or not (layout or spans or line_sort):
        return {}
    doc = open_pdf(pdf_bytes)
    n = min(len(doc), len(pdf_info))
    scale = dpi / 72.0
    imgs = [PageRasterizer(doc.get_page(i), scale=scale).render() for i in range(n)]
    out: dict[str, bytes] = {}
    if layout:
        out["layout"] = render_debug_pdf(imgs, pdf_info[:n], scale, "layout")
    if spans:
        out["span"] = render_debug_pdf(imgs, pdf_info[:n], scale, "span")
    if line_sort:
        out["line_sort"] = render_debug_pdf(imgs, pdf_info[:n], scale, "line_sort")
    return out


def render_debug_pdf(
    page_imgs: list[np.ndarray],
    pdf_info: list[dict],
    scale: float,
    mode: str = "layout",
) -> bytes:
    """Annotated pages -> a PDF for visual QA."""
    from ..pdfio.writer import images_to_pdf

    fn = {
        "layout": draw_layout_on_page,
        "span": draw_spans_on_page,
        "line_sort": draw_line_sort_on_page,
    }[mode]
    annotated = [fn(img, info, scale) for img, info in zip(page_imgs, pdf_info)]
    return images_to_pdf(annotated, dpi=int(72 * scale))
