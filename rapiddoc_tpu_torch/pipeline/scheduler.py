"""Batch inference scheduler: pages -> layout dets (+OCR/formula/table fills).

Port of ``rapiddoc_tpu/pipeline/scheduler.py``: ⓪ the orientation
classifier (pages that pass its landscape gate are turned upright before
the other stages, and ⑥ ``_rotate_dets_back`` maps their dets back onto
the page as given); ① the layout model
(``demo_txt_fallback`` routes txt-mode pages of a demo-trained detector
to the structural fallback) or, for pages without one, the structural
fallback layout (native text blocks and image placements become dets);
② full-page OCR (``_run_page_ocr``: det on the whole page with formula
regions whitened, crop, rec with the fused CTC head); ③ the formula
recognizer on the layout's formula regions; ④ the table recognizer on
the layout's table regions, with the recognized formulas inside each
table and uuid placeholders for the images inside it; ⑤
``_recover_missed_text``, a focused rec pass over layout text regions
the page-level det missed; ⑥ ``_run_seals``, seal OCR
(``models/ocr/seal.py``) on the layout's seal regions. Formula and table regions can instead be
collected into a ``DeferredAR`` that the facade flushes in full decode
buckets across page windows (formulas first, so that tables get the
LaTeX of the formulas inside them). The helpers are the JAX package's
code, unchanged.

②b checkbox detection (``utils/checkbox.py``) adds a CheckBox det with
its tick glyph for every box found on a page when ``checkbox_enable``.

Three differences of policy, each for the port's own models only (a
custom model of ``models/custom.py`` keeps the JAX package's fallback).
Seal OCR with the port's own OCR system raises where it fails; the JAX
package logs "seal OCR failed" and leaves the seals without text. The
port's rec runs as one call, without the JAX package's
``_rec_with_fallback`` (a failed batch retried crop by crop, each failed
crop an empty low-score text), in ``_run_page_ocr`` and in
``_recover_missed_text``. The port's table model is called with its
formula and image items, without the JAX package's retry without them on
a TypeError. What fails there is the card or a compiled piece (a kernel
that does not build, load or launch), and that is an error, never an
empty text.
"""
from __future__ import annotations

import re as _re
import threading
import uuid
from typing import Sequence

import numpy as np

from ..types import CategoryId
from ..utils import boxes as B
from ..utils.logging import get_logger
from ..utils.trace import stage_timer

logger = get_logger("rapiddoc_tpu_torch.scheduler")


def _quad_poly(x0: float, y0: float, x1: float, y1: float) -> list[float]:
    return [x0, y0, x1, y0, x1, y1, x0, y1]


def _merge_touching_boxes(
    boxes: list[list[float]], tol: float
) -> list[list[float]]:
    """Union of boxes whose rects intersect within `tol` (connected
    components); scan strips and sliced figures collapse to one box."""
    n = len(boxes)
    if n <= 1:
        return [list(b) for b in boxes]
    parent = list(range(n))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        x0, y0, x1, y1 = boxes[i]
        for j in range(i + 1, n):
            u0, v0, u1, v1 = boxes[j]
            if (
                x0 - tol <= u1 and u0 - tol <= x1
                and y0 - tol <= v1 and v0 - tol <= y1
            ):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri
    groups: dict[int, list[float]] = {}
    for i, box in enumerate(boxes):
        r = find(i)
        g = groups.get(r)
        if g is None:
            groups[r] = list(box)
        else:
            g[0] = min(g[0], box[0])
            g[1] = min(g[1], box[1])
            g[2] = max(g[2], box[2])
            g[3] = max(g[3], box[3])
    return list(groups.values())


def _drop_scan_substrate_images(
    model_info: dict, page_hw: tuple[int, int], cover_thresh: float = 0.8,
    min_texts: int = 8,
) -> None:
    """Remove fallback ImageBody dets that are the scan substrate.

    A scanned page arrives as one (merged) image placement covering the
    whole page; once OCR finds >= `min_texts` text dets inside it, the
    image is the page background, not a figure, and emitting it would
    wrap the page's entire text in a picture block. The threshold is
    high enough that a photo with incidental text (e.g. a seal image,
    a storefront) keeps its picture — scanned text pages carry dozens
    of det lines."""
    ph, pw = page_hw
    page_area = max(float(pw) * float(ph), 1.0)
    dets = model_info["layout_dets"]
    text_centers = [
        (
            (d["poly"][0] + d["poly"][4]) / 2.0,
            (d["poly"][1] + d["poly"][5]) / 2.0,
        )
        for d in dets
        if d["category_id"] in (CategoryId.Text, CategoryId.OcrText)
    ]
    kept = []
    for d in dets:
        if d["category_id"] == CategoryId.ImageBody:
            x0, y0 = d["poly"][0], d["poly"][1]
            x1, y1 = d["poly"][4], d["poly"][5]
            if (x1 - x0) * (y1 - y0) / page_area > cover_thresh:
                inside = sum(
                    1 for cx, cy in text_centers
                    if x0 <= cx <= x1 and y0 <= cy <= y1
                )
                if inside >= min_texts:
                    continue
        kept.append(d)
    model_info["layout_dets"] = kept


_PAGE_NO_RE = _re.compile(
    r"^[\s\-–—·.]*(第?\s*\d{1,4}\s*(页|頁)?|[ivxlcIVXLC]{1,6})"
    r"[\s\-–—·./]*(共?\s*\d{1,4}\s*(页|頁)?)?$"
)
_DIGITS_RE = _re.compile(r"\d+")


def _block_edge_pos(block: dict, page_h: float) -> str | None:
    """'top' / 'bottom' when a text block hugs the page margin."""
    y0, y1 = block["bbox"][1], block["bbox"][3]
    if y1 < page_h * 0.08:
        return "top"
    if y0 > page_h * 0.92:
        return "bottom"
    return None


def _block_text(block: dict) -> str:
    return " ".join(ln.get("text", "") for ln in block.get("lines", [])).strip()


def decoration_texts(text_dicts) -> set[str]:
    """Digit-normalized texts of edge blocks repeating on >= 3 pages (or
    half the batch) — running headers/footers. The model-free stand-in
    for the layout model's header/footer labels."""
    from collections import Counter

    counts: Counter = Counter()
    pages = 0
    for td in text_dicts:
        if not td:
            continue
        pages += 1
        h = float(td.get("height") or 0)
        if not h:
            continue
        for block in td.get("blocks", []):
            if _block_edge_pos(block, h) is None:
                continue
            text = _block_text(block)
            if text and len(text) <= 80:
                counts[_DIGITS_RE.sub("#", text)] += 1
    need = min(3, max(2, pages // 2)) if pages >= 2 else 2
    return {t for t, c in counts.items() if c >= need}


def _looks_like_page_decoration(
    block: dict, page_h: float, repeated: set[str]
) -> bool:
    """Page numbers (regex) or cross-page-repeating edge blocks."""
    if _block_edge_pos(block, page_h) is None:
        return False
    text = _block_text(block)
    if not text:
        return False
    if len(text) <= 16 and _PAGE_NO_RE.match(text):
        return True
    return _DIGITS_RE.sub("#", text) in repeated


_MATH_CHARS = set("·±×÷√∞′″¯∂∇≈≠≤≥≪≫∝∈∉⊂⊃∩∪∧∨¬∀∃∅−")
_EQ_NUMBER_RE = _re.compile(r"^\(\d{1,3}\)$")


def _math_char_count(text: str) -> int:
    n = 0
    for c in text:
        o = ord(c)
        if (
            c in _MATH_CHARS
            or 0x0370 <= o <= 0x03FF  # Greek
            or 0x2070 <= o <= 0x209F  # super/subscripts
            or 0x2190 <= o <= 0x21FF  # arrows
            or 0x2200 <= o <= 0x22FF  # math operators
            or 0x27C0 <= o <= 0x27EF
            or 0x2980 <= o <= 0x2AFF
        ):
            n += 1
    return n


def _split_math_bands(block: dict) -> list[tuple[str, list[dict]]]:
    """Partition a native-text block's lines into ('text'|'math', lines)
    runs. The real layout model emits displayed equations as their own
    interline_equation regions (reference: PP-DocLayout label set); the
    no-model txt fallback approximates that by math-glyph density so a
    display equation embedded in a column does not glue to the paragraph
    below it (which would then misclassify as a list in para_split).
    Standalone "(N)" equation-number lines attach to an adjacent math run.
    """
    lines = block.get("lines", [])
    kinds: list[str] = []
    for ln in lines:
        text = "".join(ln.get("text") or "")
        stripped = text.replace(" ", "")
        mc = _math_char_count(stripped)
        ratio = mc / max(len(stripped), 1)
        if (mc >= 3 and ratio > 0.1) or (mc >= 2 and ratio > 0.2):
            kinds.append("math")
        elif _EQ_NUMBER_RE.match(stripped):
            kinds.append("eqnum")
        else:
            kinds.append("text")
    for i, k in enumerate(kinds):  # attach (N) to neighboring math
        if k == "eqnum":
            prev_k = kinds[i - 1] if i else None
            next_k = kinds[i + 1] if i + 1 < len(kinds) else None
            kinds[i] = "math" if "math" in (prev_k, next_k) else "text"
    runs: list[tuple[str, list[dict]]] = []
    for ln, k in zip(lines, kinds):
        if runs and runs[-1][0] == k:
            runs[-1][1].append(ln)
        else:
            runs.append((k, [ln]))
    return runs


def _rotate_dets_back(dets: list[dict], angle: int, rot_w: int, rot_h: int) -> None:
    """Map det polys from rotated-image coords back to the original page.

    The page was rotated by `angle` (CCW via np.rot90 semantics) before
    inference; rot_w/rot_h are the rotated image dims.
    """
    for det in dets:
        poly = det.get("poly")
        if not poly:
            continue
        pts = [(poly[i], poly[i + 1]) for i in range(0, 8, 2)]
        if angle == 90:
            mapped = [(rot_h - 1 - y, x) for x, y in pts]
        elif angle == 180:
            mapped = [(rot_w - 1 - x, rot_h - 1 - y) for x, y in pts]
        elif angle == 270:
            mapped = [(y, rot_w - 1 - x) for x, y in pts]
        else:
            continue
        xs = [p[0] for p in mapped]
        ys = [p[1] for p in mapped]
        det["poly"] = _quad_poly(min(xs), min(ys), max(xs), max(ys))


class DeferredAR:
    """Doc-scope accumulator for autoregressive work (formula LaTeX,
    table structure) collected across page windows (the JAX package's,
    ``scheduler.py:283-318``).

    AR decode throughput is set by batch occupancy: a 16-slot decode
    bucket running 2 regions wastes 7/8 of every step. Windows usually
    contribute 0-4 regions each, so regions are pooled here and decoded
    when full buckets accumulate (or at the end of the document)."""

    # full decode bucket sizes (models/formula/engine.py batch_chunks
    # sizes=(4, 16); table engines bucket similarly)
    FORMULA_FLUSH = 16
    TABLE_FLUSH = 8

    def __init__(self) -> None:
        # (crop, owner_det)
        self.formula: list[tuple[np.ndarray, dict]] = []
        # (crop, owner_det, [(coords, formula_det)], [(coords, uuid)])
        self.table: list[tuple] = []
        self._mark = (0, 0)

    def window_added(self) -> int:
        """Items contributed since the previous call (lets the caller
        fast-path windows with no AR work)."""
        added = (len(self.formula) - self._mark[0]) + (
            len(self.table) - self._mark[1]
        )
        self._mark = (len(self.formula), len(self.table))
        return added

    def should_flush(self) -> bool:
        return (
            len(self.formula) >= self.FORMULA_FLUSH
            or len(self.table) >= self.TABLE_FLUSH
        )


class DocumentAnalyzer:
    """Runs the model stack over rendered page images."""

    def __init__(
        self,
        layout_model=None,
        ocr_system=None,
        formula_model=None,
        table_model=None,
        orientation_model=None,
        formula_enable: bool = True,
        table_enable: bool = True,
        checkbox_enable: bool = False,
    ):
        self.layout_model = layout_model
        self.ocr = ocr_system
        self.formula_model = formula_model
        self.table_model = table_model
        self.orientation_model = orientation_model
        self.formula_enable = formula_enable
        self.table_enable = table_enable
        self.checkbox_enable = checkbox_enable
        # device stages serialize per analyzer (concurrent requests must
        # not interleave inside one analyze call)
        self._lock = threading.RLock()

    # ------------------------------------------------------------ main

    def analyze_pages(
        self,
        page_images: Sequence[np.ndarray],
        parse_modes: Sequence[str],
        text_dicts: Sequence[dict | None],
        image_boxes_per_page: Sequence[list[list[float]] | None] | None = None,
        scales: Sequence[float] | None = None,
        deferred: DeferredAR | None = None,
    ) -> list[dict]:
        with self._lock:
            return self._analyze_pages_impl(
                page_images, parse_modes, text_dicts,
                image_boxes_per_page, scales, deferred,
            )

    def _analyze_pages_impl(
        self,
        page_images: Sequence[np.ndarray],
        parse_modes: Sequence[str],
        text_dicts: Sequence[dict | None],
        image_boxes_per_page: Sequence[list[list[float]] | None] | None = None,
        scales: Sequence[float] | None = None,
        deferred: DeferredAR | None = None,
    ) -> list[dict]:
        """Returns one model_info = {"layout_dets": [...]} per page, in the
        JAX package's order of stages. With ``deferred``, the formula
        decode only collects its regions, and the caller runs
        flush_deferred() when a full bucket accumulates."""
        n = len(page_images)
        scales = scales or [1.0] * n
        image_boxes_per_page = image_boxes_per_page or [None] * n
        model_infos: list[dict] = [{"layout_dets": []} for _ in range(n)]

        # ⓪ orientation: pre-rotate sideways pages, restore coords after
        rotations = [0] * n
        if self.orientation_model is not None:
            from ..models.orientation.engine import rotate_image, should_check_orientation

            check = [i for i in range(n) if should_check_orientation(page_images[i])]
            if check:
                angles = self.orientation_model([page_images[i] for i in check])
                page_images = list(page_images)
                for i, angle in zip(check, angles):
                    if angle:
                        page_images[i] = rotate_image(page_images[i], angle)
                        rotations[i] = angle

        # ① layout detection. A demo-trained layout checkpoint opts out
        # of txt-mode pages (demo_txt_fallback): native-text structural
        # layout is stronger there, while ocr-mode (scanned) pages gain
        # real region structure from the detector.
        layout_pages: list[int] = []
        if self.layout_model is not None:
            txt_fallback = getattr(self.layout_model, "demo_txt_fallback", False)
            layout_pages = [
                i for i in range(n) if not (txt_fallback and parse_modes[i] == "txt")
            ]
            if layout_pages:
                with stage_timer("layout", len(layout_pages)):
                    layout_results = self.layout_model.batch_predict(
                        [page_images[i] for i in layout_pages]
                    )
                for i, dets in zip(layout_pages, layout_results):
                    model_infos[i]["layout_dets"].extend(dets)
        fallback_pages = sorted(set(range(n)) - set(layout_pages))
        if fallback_pages:
            repeated = decoration_texts(text_dicts)
            for i in fallback_pages:
                self._fallback_layout(
                    model_infos[i],
                    parse_modes[i],
                    text_dicts[i],
                    image_boxes_per_page[i],
                    scales[i],
                    repeated,
                )

        # ② OCR for ocr-mode pages
        ocr_pages = [
            i for i in range(n) if parse_modes[i] == "ocr" and self.ocr is not None
        ]
        if ocr_pages:
            with stage_timer("ocr", len(ocr_pages)):
                self._run_page_ocr(ocr_pages, page_images, model_infos)
            # a near-full-page fallback ImageBody on a page where OCR
            # found real text is the scan substrate, not a figure — a
            # picture-only page (no text found) keeps its image
            for i in sorted(set(ocr_pages) & set(fallback_pages)):
                _drop_scan_substrate_images(
                    model_infos[i], page_images[i].shape[:2]
                )

        # ②b checkbox detection: dets carry the tick glyph
        if self.checkbox_enable:
            from ..utils.checkbox import detect_checkboxes

            for i in range(n):
                for res in detect_checkboxes(page_images[i]):
                    x0, y0, x1, y1 = res["bbox"]
                    model_infos[i]["layout_dets"].append(
                        {
                            "category_id": CategoryId.CheckBox,
                            "poly": _quad_poly(x0, y0, x1, y1),
                            "score": 0.9,
                            "checkbox": "☑" if res["checked"] else "☐",
                        }
                    )

        # ③ formulas
        if self.formula_enable and self.formula_model is not None:
            self._run_formulas(page_images, model_infos, deferred)

        # ④ tables
        if self.table_enable and self.table_model is not None:
            self._run_tables(page_images, model_infos, deferred)

        # ⑤ leftover text recovery: layout Text regions the page-level
        # det missed entirely get a focused rec pass
        if self.ocr is not None and self.layout_model is not None:
            self._recover_missed_text(page_images, model_infos)

        # ⑥ seal OCR inside seal-labeled regions
        if self.ocr is not None:
            self._run_seals(page_images, model_infos)

        # ⑥ restore coordinates for pre-rotated pages
        for i, angle in enumerate(rotations):
            if angle:
                h, w = page_images[i].shape[:2]
                _rotate_dets_back(model_infos[i]["layout_dets"], angle, w, h)
        return model_infos

    def _recognize(self, crops):
        """Rec over ``crops``: the port's recognizer in one call, a custom
        OCR object's with the JAX package's ``_rec_with_fallback``."""
        from ..models.ocr.engine import RecResult, TextSystem

        if isinstance(self.ocr, TextSystem):
            return self.ocr.recognizer(crops)
        try:
            return self.ocr.recognizer(crops)
        except Exception:
            logger.exception("rec batch failed; retrying per crop")
        out = []
        for crop in crops:
            try:
                out.extend(self.ocr.recognizer([crop]))
            except Exception:
                logger.exception("rec failed for a single crop; marking low-score")
                out.append(RecResult("", 0.0))
        return out

    def _predict_tables(self, regions, mfd_items, fill_items):
        """The table model over ``regions`` with the formulas and images
        inside each; a custom model that takes neither gets the regions
        alone, as in the JAX package."""
        from ..models.table.engine import TableRecognizer

        if isinstance(self.table_model, TableRecognizer):
            return self.table_model.batch_predict(
                regions, mfd_items=mfd_items, fill_items=fill_items)
        try:
            return self.table_model.batch_predict(
                regions, mfd_items=mfd_items, fill_items=fill_items)
        except TypeError:  # custom table model without mfd/fill support
            return self.table_model.batch_predict(regions)

    def _run_seals(self, page_images, model_infos) -> None:
        from ..models.ocr.engine import TextSystem
        from ..models.ocr.seal import SealOCR

        crops, owners = [], []
        for page_i, info in enumerate(model_infos):
            for det in info["layout_dets"]:
                if det.get("original_label") != "seal" or det.get("text"):
                    continue
                x0, y0, _, _, x1, y1, _, _ = det["poly"]
                crop = page_images[page_i][
                    max(int(y0), 0) : int(y1) + 1, max(int(x0), 0) : int(x1) + 1
                ]
                if crop.size:
                    crops.append(crop)
                    owners.append(det)
        if not crops:
            return
        if isinstance(self.ocr, TextSystem):
            texts = SealOCR(self.ocr).batch(crops)
        else:
            try:  # a custom OCR object: the JAX package's fallback
                texts = SealOCR(self.ocr).batch(crops)
            except Exception:
                logger.exception("seal OCR failed")
                return
        for det, text in zip(owners, texts):
            if text:
                det["text"] = text

    def _recover_missed_text(self, page_images, model_infos) -> None:
        from ..models.ocr.engine import crop_quad

        crops, owners = [], []
        for page_i, info in enumerate(model_infos):
            dets = info["layout_dets"]
            ocr_boxes = [
                d["poly"] for d in dets
                if d["category_id"] in (CategoryId.OcrText, CategoryId.LowScoreText)
            ]
            for det in dets:
                if det["category_id"] != CategoryId.Text or det.get("text"):
                    continue
                poly = det["poly"]
                box = [min(poly[0::2]), min(poly[1::2]),
                       max(poly[0::2]), max(poly[1::2])]
                covered = any(
                    B.overlap_ratio(
                        [min(p[0::2]), min(p[1::2]), max(p[0::2]), max(p[1::2])], box
                    ) > 0.05
                    for p in ocr_boxes
                )
                if covered:
                    continue
                if box[2] - box[0] < 8 or box[3] - box[1] < 6:
                    continue
                quad = np.array(
                    [[box[0], box[1]], [box[2], box[1]],
                     [box[2], box[3]], [box[0], box[3]]], np.float32,
                )
                crop = crop_quad(page_images[page_i], quad)
                if crop.size:
                    crops.append(crop)
                    owners.append((page_i, det))
        if not crops:
            return
        results = self._recognize(crops)
        for (page_i, det), rec in zip(owners, results):
            if not rec.text:
                continue
            model_infos[page_i]["layout_dets"].append(
                {
                    "category_id": CategoryId.OcrText,
                    "poly": list(det["poly"]),
                    "score": rec.score,
                    "text": rec.text,
                }
            )

    # ------------------------------------------------------- fallbacks

    def _fallback_layout(
        self,
        model_info: dict,
        parse_mode: str,
        text_dict: dict | None,
        image_boxes: list[list[float]] | None,
        scale: float,
        repeated_decorations: set[str] | None = None,
    ) -> None:
        dets = model_info["layout_dets"]
        math_dets: list[dict] = []
        if parse_mode == "txt" and text_dict is not None:
            page_h = float(text_dict.get("height") or 0)
            for block in text_dict.get("blocks", []):
                if page_h and _looks_like_page_decoration(
                    block, page_h, repeated_decorations or set()
                ):
                    # page numbers / running headers become discarded
                    # blocks (the layout model would label header/footer)
                    x0, y0, x1, y1 = (v * scale for v in block["bbox"])
                    dets.append(
                        {
                            "category_id": CategoryId.Abandon,
                            "poly": _quad_poly(x0, y0, x1, y1),
                            "score": 1.0,
                        }
                    )
                    continue
                # math bands split from the surrounding text; they become
                # real equation regions when the formula recognizer can
                # produce LaTeX for them, otherwise standalone Text dets
                # (the split alone keeps para_split's list classifier off
                # display equations glued to a paragraph)
                math_cat = (
                    CategoryId.InterlineEquation_Layout
                    if self.formula_enable and self.formula_model is not None
                    else CategoryId.Text
                )
                for kind, lines in _split_math_bands(block):
                    x0 = min(ln["bbox"][0] for ln in lines) * scale
                    y0 = min(ln["bbox"][1] for ln in lines) * scale
                    x1 = max(ln["bbox"][2] for ln in lines) * scale
                    y1 = max(ln["bbox"][3] for ln in lines) * scale
                    det = {
                        "category_id": (
                            math_cat if kind == "math" else CategoryId.Text
                        ),
                        "poly": _quad_poly(x0, y0, x1, y1),
                        "score": 1.0,
                    }
                    dets.append(det)
                    if kind == "math":
                        math_dets.append(det)
            # a display equation often splits into several native blocks
            # (lhs, stacked fraction, "(N)"); y-overlapping math dets are
            # one equation — fuse them so the region matches what the
            # layout model would emit
            for a in math_dets:
                if a not in dets:
                    continue
                for b in math_dets:
                    if b is a or b not in dets:
                        continue
                    ay0, ay1 = a["poly"][1], a["poly"][5]
                    by0, by1 = b["poly"][1], b["poly"][5]
                    if min(ay1, by1) - max(ay0, by0) > 0.5 * min(
                        ay1 - ay0, by1 - by0
                    ):
                        a["poly"] = _quad_poly(
                            min(a["poly"][0], b["poly"][0]),
                            min(ay0, by0),
                            max(a["poly"][4], b["poly"][4]),
                            max(ay1, by1),
                        )
                        dets.remove(b)
        if image_boxes:
            # scanned/tiled pages place one xobject per strip; touching
            # placements are one picture, so merge connected components
            # first (a layout model would emit one figure region)
            scaled = [
                [v * scale for v in box]
                for box in image_boxes
                if (box[2] - box[0]) >= 8 and (box[3] - box[1]) >= 8
            ]
            for x0, y0, x1, y1 in _merge_touching_boxes(scaled, 3.0 * scale):
                dets.append(
                    {
                        "category_id": CategoryId.ImageBody,
                        "poly": _quad_poly(x0, y0, x1, y1),
                        "score": 1.0,
                    }
                )

    # ------------------------------------------------------------- ocr

    def _run_page_ocr(
        self,
        page_idxs: list[int],
        page_images: Sequence[np.ndarray],
        model_infos: list[dict],
    ) -> None:
        """Full-page OCR: det boxes become Text dets + OcrText spans.

        Formula regions are painted white before text detection so the
        detector does not fragment equations into spurious text lines
        (reference: analyze_utils.py:82-103 _apply_mask_boxes_to_image).
        """
        formula_cats = (
            CategoryId.InterlineEquation_Layout,
            CategoryId.InterlineEquation_YOLO,
            CategoryId.InlineEquation,
        )
        images = []
        for i in page_idxs:
            img = page_images[i]
            boxes = [
                det["poly"]
                for det in model_infos[i]["layout_dets"]
                if det["category_id"] in formula_cats
            ]
            if boxes:
                img = img.copy()
                h, w = img.shape[:2]
                for poly in boxes:
                    x0 = max(int(min(poly[0::2])), 0)
                    y0 = max(int(min(poly[1::2])), 0)
                    x1 = min(int(max(poly[0::2])) + 1, w)
                    y1 = min(int(max(poly[1::2])) + 1, h)
                    img[y0:y1, x0:x1] = 255
            images.append(img)
        with stage_timer("ocr_det", len(images)):
            det_results = self.ocr.detector(images)
        crops: list[np.ndarray] = []
        owners: list[tuple[int, np.ndarray, float]] = []
        from ..models.ocr.engine import crop_quad

        with stage_timer("ocr_crop", len(images)):
            for page_i, det in zip(page_idxs, det_results):
                for quad, score in zip(det.boxes, det.scores):
                    crops.append(crop_quad(page_images[page_i], quad))
                    owners.append((page_i, quad, float(score)))
        with stage_timer("ocr_rec", len(images)):
            logger.debug("rec over %d crops", len(crops))
            rec_results = self._recognize(crops)
        for (page_i, quad, det_score), rec in zip(owners, rec_results):
            x0, y0 = float(quad[:, 0].min()), float(quad[:, 1].min())
            x1, y1 = float(quad[:, 0].max()), float(quad[:, 1].max())
            if not rec.text:
                continue
            dets = model_infos[page_i]["layout_dets"]
            cat = (
                CategoryId.OcrText
                if rec.score >= self.ocr.drop_score
                else CategoryId.LowScoreText
            )
            dets.append(
                {
                    "category_id": CategoryId.Text,
                    "poly": _quad_poly(x0, y0, x1, y1),
                    "score": det_score,
                }
            )
            dets.append(
                {
                    "category_id": cat,
                    "poly": _quad_poly(x0, y0, x1, y1),
                    "score": rec.score,
                    "text": rec.text,
                }
            )


    # ---------------------------------------------------------- formula

    def _run_formulas(
        self, page_images, model_infos, deferred: DeferredAR | None = None
    ) -> None:
        regions = []
        owners = []
        for page_i, info in enumerate(model_infos):
            for det in info["layout_dets"]:
                if det["category_id"] in (
                    CategoryId.InterlineEquation_Layout,
                    CategoryId.InterlineEquation_YOLO,
                    CategoryId.InlineEquation,
                ) and not det.get("latex"):
                    x0, y0, _, _, x1, y1, _, _ = det["poly"]
                    crop = page_images[page_i][
                        max(int(y0), 0) : int(y1) + 1, max(int(x0), 0) : int(x1) + 1
                    ]
                    if crop.size:
                        regions.append(crop)
                        owners.append(det)
        if not regions:
            return
        if deferred is not None:
            # copy the crops: region views would pin whole page arrays
            # in memory until the flush
            deferred.formula.extend(
                (np.array(r, copy=True), o) for r, o in zip(regions, owners)
            )
            return
        with stage_timer("formula", len(regions)):
            latexes = self.formula_model.batch_predict(regions)
        for det, latex in zip(owners, latexes):
            det["latex"] = latex

    def flush_deferred(self, deferred: DeferredAR) -> None:
        with self._lock:
            self._flush_deferred_impl(deferred)

    def _flush_deferred_impl(self, deferred: DeferredAR) -> None:
        """Decode every accumulated AR region in packed buckets.

        Formulas first (tables inject recognized in-table formulas via
        mfd items), then tables."""
        if deferred.formula:
            regions = [r for r, _ in deferred.formula]
            owners = [o for _, o in deferred.formula]
            with stage_timer("formula", len(regions)):
                latexes = self.formula_model.batch_predict(regions)
            for det, latex in zip(owners, latexes):
                det["latex"] = latex
            deferred.formula.clear()
        if deferred.table:
            regions = [t[0] for t in deferred.table]
            owners = [t[1] for t in deferred.table]
            mfd_items = [
                [(coords, f_det["latex"])
                 for coords, f_det in t[2] if f_det.get("latex")]
                for t in deferred.table
            ]
            fill_items = [t[3] for t in deferred.table]
            with stage_timer("table", len(regions)):
                htmls = self._predict_tables(regions, mfd_items, fill_items)
            for det, html in zip(owners, htmls):
                if html:
                    det["html"] = html
            deferred.table.clear()
        deferred.window_added()  # reset the mark

    # ----------------------------------------------------------- table

    def _run_tables(
        self, page_images, model_infos, deferred: DeferredAR | None = None
    ) -> None:
        formula_cats = (
            CategoryId.InterlineEquation_Layout,
            CategoryId.InterlineEquation_YOLO,
            CategoryId.InlineEquation,
        )
        regions = []
        owners = []
        # (coords, formula_det) pairs per table — resolved to (coords,
        # latex) at predict time, so deferred formulas (decoded later,
        # flush_deferred) still inject correctly
        mfd_refs: list[list[tuple[list[float], dict]]] = []
        fill_items: list[list[tuple[list[float], str]]] = []
        for page_i, info in enumerate(model_infos):
            formulas = [
                d for d in info["layout_dets"]
                if d["category_id"] in formula_cats
                and (d.get("latex") or deferred is not None)
            ]
            images = [
                d for d in info["layout_dets"]
                if d["category_id"] == CategoryId.ImageBody
            ]
            for det in info["layout_dets"]:
                if det["category_id"] == CategoryId.TableBody and not det.get("html"):
                    x0, y0, _, _, x1, y1, _, _ = det["poly"]
                    crop = page_images[page_i][
                        max(int(y0), 0) : int(y1) + 1, max(int(x0), 0) : int(x1) + 1
                    ]
                    if not crop.size:
                        continue
                    regions.append(crop)
                    owners.append(det)
                    # recognized formulas inside this table, in crop coords
                    # (reference: rapid_table.py:180-213 in-table formula
                    # injection via mfd_res)
                    inside = []
                    for f in formulas:
                        fx0 = min(f["poly"][0::2])
                        fy0 = min(f["poly"][1::2])
                        fx1 = max(f["poly"][0::2])
                        fy1 = max(f["poly"][1::2])
                        if fx0 >= x0 and fy0 >= y0 and fx1 <= x1 and fy1 <= y1:
                            inside.append(
                                ([fx0 - x0, fy0 - y0, fx1 - x0, fy1 - y0], f)
                            )
                    mfd_refs.append(inside)
                    # in-table images become uuid placeholders resolved to
                    # <img> at save time (reference: rapid_table.py
                    # fill_image_res + pdf_image_tools.save_table_fill_image)
                    fills = []
                    det_fills = []
                    for im in images:
                        ix0 = min(im["poly"][0::2])
                        iy0 = min(im["poly"][1::2])
                        ix1 = max(im["poly"][0::2])
                        iy1 = max(im["poly"][1::2])
                        if ix0 >= x0 and iy0 >= y0 and ix1 <= x1 and iy1 <= y1:
                            uid = uuid.uuid4().hex
                            fills.append(
                                ([ix0 - x0, iy0 - y0, ix1 - x0, iy1 - y0],
                                 uid)
                            )
                            det_fills.append(
                                {"uuid": uid, "bbox": [ix0, iy0, ix1, iy1]}
                            )
                            im["in_table"] = True
                    fill_items.append(fills)
                    if det_fills:
                        det["fill_images"] = det_fills
        if not regions:
            return
        if deferred is not None:
            # copy the crops: region views would pin whole page arrays
            # in memory until the flush
            deferred.table.extend(
                (np.array(r, copy=True), o, m, fl)
                for r, o, m, fl in zip(regions, owners, mfd_refs, fill_items)
            )
            return
        mfd_items = [
            [(coords, f["latex"]) for coords, f in refs if f.get("latex")]
            for refs in mfd_refs
        ]
        with stage_timer("table", len(regions)):
            htmls = self._predict_tables(regions, mfd_items, fill_items)
        for det, html in zip(owners, htmls):
            if html:
                det["html"] = html
