"""Collect image/vector placements on a page (page coordinates, y-down).

Feeds the structural-layout fallback and original-image extraction
(reference role: rapid_doc/utils/pdf_image_tools.py get_ori_image).
"""
from __future__ import annotations

from .content import ContentInterpreter, mat_apply
from .cos import Stream
from .document import PdfPage
from .text import page_base_ctm


class PlacementCollector(ContentInterpreter):
    def __init__(self, page: PdfPage):
        super().__init__(page)
        self.image_boxes: list[list[float]] = []
        self.image_streams: list[Stream] = []

    def on_draw_image(self, stream: Stream, name: str) -> None:
        pts = [
            mat_apply(self.gs.ctm, x, y)
            for x, y in ((0, 0), (1, 0), (1, 1), (0, 1))
        ]
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        box = [min(xs), min(ys), max(xs), max(ys)]
        if box[2] - box[0] < 1 or box[3] - box[1] < 1:
            return
        self.image_boxes.append(box)
        self.image_streams.append(stream)


def image_placements(page: PdfPage) -> list[list[float]]:
    """Bounding boxes of drawn images, in page coordinates (top-left origin)."""
    collector = PlacementCollector(page)
    try:
        collector.run(page_base_ctm(page))
    except Exception:
        pass
    return collector.image_boxes


def original_image_streams(page: PdfPage) -> list[tuple[list[float], Stream]]:
    """(bbox, raw stream) pairs for extracting original embedded images."""
    collector = PlacementCollector(page)
    try:
        collector.run(page_base_ctm(page))
    except Exception:
        pass
    return list(zip(collector.image_boxes, collector.image_streams))
