"""PageModel: cleans raw layout detections and exposes typed views.

Behavioral counterpart of the reference MagicModel
(reference: rapid_doc/backend/pipeline/pipeline_magic_model.py and
utils/magic_model_utils.py): scale normalization, confidence/IoU dedup,
footnote re-typing, body-overlap merging, and greedy nearest-distance
caption/footnote attachment. Re-implemented with vectorized geometry.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from ..types import CategoryId, ContentType
from ..utils import boxes as B

LOW_CONF = 0.05
HIGH_IOU = 0.9


def _directional_distance(a: list[float], b: list[float]) -> float:
    """Distance between boxes, infinite unless b is cleanly beside/above/below
    a (exactly one relative direction), with a size-compat check."""
    left = b[2] < a[0]
    right = b[0] > a[2]
    above = b[3] < a[1]
    below = b[1] > a[3]
    count = sum((left, right, above, below))
    if count > 1:
        return float("inf")
    if left or right:
        l1, l2 = a[3] - a[1], b[3] - b[1]
    else:
        l1, l2 = a[2] - a[0], b[2] - b[0]
    if l1 > 0 and l2 > l1 and (l2 - l1) / l1 > 0.3:
        return float("inf")
    return B.edge_distance(a, b)


def _reduct_overlap(items: list[dict]) -> list[dict]:
    """Drop boxes fully contained in another box of the same list."""
    out = []
    for i, it in enumerate(items):
        contained = any(
            j != i and B.contains(items[j]["bbox"], it["bbox"])
            for j in range(len(items))
        )
        if not contained:
            out.append(it)
    return out


def attach_objects(subjects: list[dict], objects: list[dict]) -> list[dict]:
    """Greedy nearest-pair attachment of objects (captions/footnotes) to
    subjects (bodies). Every subject appears in the result; every object is
    attached to its nearest subject."""
    subjects = _reduct_overlap(subjects)
    objects = _reduct_overlap(objects)
    result = [
        {"sub_bbox": s, "obj_bboxes": [], "sub_idx": i}
        for i, s in enumerate(subjects)
    ]
    if not objects:
        return result
    if not subjects:
        return result
    for obj in objects:
        dists = [
            _directional_distance(s["bbox"], obj["bbox"]) for s in subjects
        ]
        finite = [(d, i) for i, d in enumerate(dists) if math.isfinite(d)]
        if finite:
            _, best = min(finite)
        else:
            best = min(
                range(len(subjects)),
                key=lambda i: B.center_distance(subjects[i]["bbox"], obj["bbox"]),
            )
        result[best]["obj_bboxes"].append(obj)
    return result


class PageModel:
    """Typed views over one page's cleaned layout detections.

    `page_model_info` = {"layout_dets": [{category_id, poly, score, ...}]}
    with poly in render pixels; `scale` converts to page coordinates.
    """

    def __init__(self, page_model_info: dict, scale: float):
        self.dets: list[dict] = [dict(d) for d in page_model_info.get("layout_dets", [])]
        self._normalize(scale)
        self._drop_low_confidence()
        self._dedup_high_iou()
        self._retype_image_footnotes()
        self._merge_overlapping_bodies()

    # ------------------------------------------------------------- cleanup

    def _normalize(self, scale: float) -> None:
        kept = []
        for det in self.dets:
            poly = det.get("poly")
            if poly is not None and len(poly) >= 8:
                x0, y0, x1, y1 = poly[0], poly[1], poly[4], poly[5]
                det["bbox"] = [
                    math.floor(x0 / scale * 100) / 100,
                    math.floor(y0 / scale * 100) / 100,
                    math.floor(x1 / scale * 100) / 100,
                    math.floor(y1 / scale * 100) / 100,
                ]
            if "bbox" not in det:
                continue
            pts = det.get("polygon_points")
            if pts is not None and len(pts) >= 3:
                det["polygon_points"] = [
                    [round(x / scale, 2), round(y / scale, 2)] for x, y in pts
                ]
            for fill in det.get("fill_images", []):
                fill["bbox"] = [round(v / scale, 2) for v in fill["bbox"]]
            if B.is_valid(det["bbox"]):
                kept.append(det)
        self.dets = kept

    def _drop_low_confidence(self) -> None:
        self.dets = [d for d in self.dets if d.get("score", 1.0) > LOW_CONF]

    def _dedup_high_iou(self) -> None:
        relevant = {
            CategoryId.Title, CategoryId.Text, CategoryId.ImageBody,
            CategoryId.ImageCaption, CategoryId.TableBody,
            CategoryId.TableCaption, CategoryId.TableFootnote,
            CategoryId.InterlineEquation_Layout,
            CategoryId.InterlineEquationNumber_Layout,
        }
        cand = [d for d in self.dets if d["category_id"] in relevant]
        drop: set[int] = set()
        if len(cand) > 1:
            arr = np.array([d["bbox"] for d in cand])
            ious = B.iou_matrix(arr, arr)
            for i in range(len(cand)):
                for j in range(i + 1, len(cand)):
                    if ious[i, j] > HIGH_IOU:
                        loser = (
                            cand[i]
                            if cand[i].get("score", 0) < cand[j].get("score", 0)
                            else cand[j]
                        )
                        drop.add(id(loser))
        self.dets = [d for d in self.dets if id(d) not in drop]

    def _retype_image_footnotes(self) -> None:
        """TableFootnote dets nearer to a figure than any table become
        image footnotes."""
        footnotes = [d for d in self.dets if d["category_id"] == CategoryId.TableFootnote]
        figures = [d for d in self.dets if d["category_id"] == CategoryId.ImageBody]
        tables = [d for d in self.dets if d["category_id"] == CategoryId.TableBody]
        if not footnotes or not figures:
            return
        for fn in footnotes:
            d_fig = min(
                (_directional_distance(fn["bbox"], f["bbox"]) for f in figures),
                default=float("inf"),
            )
            d_tab = min(
                (_directional_distance(fn["bbox"], t["bbox"]) for t in tables),
                default=float("inf"),
            )
            if math.isfinite(d_fig) and d_tab > d_fig:
                fn["category_id"] = CategoryId.ImageFootnote

    def _merge_overlapping_bodies(self) -> None:
        """Merge image/table bodies overlapping >80%: keep the big one grown
        to the union, drop the small one."""
        drop: set[int] = set()
        for cat in (CategoryId.ImageBody, CategoryId.TableBody):
            blocks = [d for d in self.dets if d["category_id"] == cat]
            for i in range(len(blocks)):
                for j in range(i + 1, len(blocks)):
                    b1, b2 = blocks[i], blocks[j]
                    if id(b1) in drop or id(b2) in drop:
                        continue
                    ratio = max(
                        B.overlap_ratio(b1["bbox"], b2["bbox"]),
                        B.overlap_ratio(b2["bbox"], b1["bbox"]),
                    )
                    if ratio > 0.8:
                        small, big = (
                            (b1, b2)
                            if B.area(b1["bbox"]) <= B.area(b2["bbox"])
                            else (b2, b1)
                        )
                        big["bbox"] = B.merge(big["bbox"], small["bbox"])
                        drop.add(id(small))
        self.dets = [d for d in self.dets if id(d) not in drop]

    # --------------------------------------------------------------- views

    def _by_category(self, cat: int, extra: tuple[str, ...] = ()) -> list[dict]:
        out = []
        for d in self.dets:
            if d["category_id"] != cat:
                continue
            if d.get("in_table"):
                # lives inside a table cell as a uuid placeholder
                # (reference: rapid_table.py fill_image_res)
                continue
            block = {
                "bbox": d["bbox"],
                "score": d.get("score"),
                "original_label": d.get("original_label"),
                "original_order": d.get("original_order"),
                "polygon_points": d.get("polygon_points"),
            }
            for col in extra:
                block[col] = d.get(col)
            out.append(block)
        return out

    def images(self) -> list[dict]:
        with_captions = attach_objects(
            self._by_category(CategoryId.ImageBody),
            self._by_category(CategoryId.ImageCaption),
        )
        with_footnotes = attach_objects(
            self._by_category(CategoryId.ImageBody),
            self._by_category(CategoryId.ImageFootnote),
        )
        fn_by_idx = {v["sub_idx"]: v["obj_bboxes"] for v in with_footnotes}
        return [
            {
                "image_body": v["sub_bbox"],
                "image_caption_list": v["obj_bboxes"],
                "image_footnote_list": fn_by_idx.get(v["sub_idx"], []),
            }
            for v in with_captions
        ]

    def tables(self) -> list[dict]:
        with_captions = attach_objects(
            self._by_category(CategoryId.TableBody),
            self._by_category(CategoryId.TableCaption),
        )
        with_footnotes = attach_objects(
            self._by_category(CategoryId.TableBody),
            self._by_category(CategoryId.TableFootnote),
        )
        fn_by_idx = {v["sub_idx"]: v["obj_bboxes"] for v in with_footnotes}
        return [
            {
                "table_body": v["sub_bbox"],
                "table_caption_list": v["obj_bboxes"],
                "table_footnote_list": fn_by_idx.get(v["sub_idx"], []),
            }
            for v in with_captions
        ]

    def equations(self) -> tuple[list, list, list]:
        return (
            self._by_category(CategoryId.InlineEquation, ("latex",)),
            self._by_category(CategoryId.InterlineEquation_YOLO, ("latex",)),
            self._by_category(CategoryId.InterlineEquation_Layout),
        )

    def formula_numbers(self) -> list[dict]:
        return self._by_category(CategoryId.InterlineEquationNumber_Layout)

    def discarded(self) -> list[dict]:
        return self._by_category(CategoryId.Abandon)

    def text_blocks(self) -> list[dict]:
        return self._by_category(CategoryId.Text)

    def title_blocks(self) -> list[dict]:
        return self._by_category(CategoryId.Title)

    def all_spans(self) -> list[dict]:
        """Content spans (image/table/equation/ocr-text/checkbox)."""
        spans = []
        allow = {
            CategoryId.ImageBody, CategoryId.TableBody,
            CategoryId.InlineEquation, CategoryId.InterlineEquation_YOLO,
            CategoryId.OcrText, CategoryId.CheckBox,
        }
        for det in self.dets:
            cat = det["category_id"]
            if cat not in allow or det.get("vl_ocr"):
                continue
            span: dict[str, Any] = {
                "bbox": det["bbox"],
                "score": det.get("score"),
                "original_label": det.get("original_label"),
                "original_order": det.get("original_order"),
                "polygon_points": det.get("polygon_points"),
            }
            if cat == CategoryId.ImageBody:
                span["type"] = ContentType.IMAGE
                if det.get("original_label") == "seal":
                    span["content"] = det.get("text")
            elif cat == CategoryId.TableBody:
                span["type"] = ContentType.TABLE
                if det.get("latex"):
                    span["latex"] = det["latex"]
                elif det.get("html"):
                    span["html"] = det["html"]
                    for key in ("latex_boxes", "img_boxes"):
                        if det.get(key):
                            span[key] = det[key]
                            break
                    if det.get("fill_images"):
                        span["fill_images"] = det["fill_images"]
            elif cat == CategoryId.InlineEquation:
                span["type"] = ContentType.INLINE_EQUATION
                span["content"] = det.get("latex") or ""
            elif cat == CategoryId.InterlineEquation_YOLO:
                span["type"] = ContentType.INTERLINE_EQUATION
                span["content"] = det.get("latex") or ""
            elif cat == CategoryId.CheckBox:
                span["type"] = ContentType.CHECKBOX
                span["content"] = det.get("checkbox") or ""
            elif cat == CategoryId.OcrText:
                span["type"] = ContentType.TEXT
                span["content"] = det.get("text", "")
            spans.append(span)
        # dedup identical spans
        seen: list[dict] = []
        unique = []
        for s in spans:
            if s not in seen:
                seen.append(s)
                unique.append(s)
        return unique

    def vl_ocr_spans(self) -> list[dict]:
        out = []
        for det in self.dets:
            if not det.get("vl_ocr") or not det.get("text"):
                continue
            out.append(
                {
                    "bbox": det["bbox"],
                    "score": det.get("score", 0.95),
                    "content": det["text"],
                    "type": ContentType.TEXT,
                    "vl_ocr": True,
                    "original_label": det.get("original_label"),
                    "original_order": det.get("original_order"),
                    "polygon_points": det.get("polygon_points"),
                }
            )
        return out
