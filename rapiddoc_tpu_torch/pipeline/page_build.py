"""Build a page_info dict from PageModel views + content spans.

Behavioral counterpart of the reference chain
(reference: rapid_doc/utils/block_pre_proc.py prepare_block_bboxes,
utils/span_pre_proc.py remove_outside_spans, utils/span_block_fix.py
fill_spans_in_blocks/fix_block_spans/merge_spans_to_line,
utils/block_sort.py sort_blocks_by_bbox,
backend/pipeline/model_json_to_middle_json.py make_page_info_dict).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..reading_order.xycut import sort_boxes_reading_order
from ..reading_order.xycut_v3 import sort_blocks_v3
from ..types import BlockType, ContentType
from ..utils import boxes as B

TEXTY_BLOCKS = (
    BlockType.TEXT, BlockType.TITLE,
    BlockType.IMAGE_CAPTION, BlockType.IMAGE_FOOTNOTE,
    BlockType.TABLE_CAPTION, BlockType.TABLE_FOOTNOTE,
    BlockType.FORMULA_NUMBER, BlockType.DISCARDED,
)


def _mk_block(det: dict, btype: str, group_id: int | None = None) -> dict:
    return {
        "type": btype,
        "bbox": list(det["bbox"]),
        "score": det.get("score"),
        "original_label": det.get("original_label"),
        "original_order": det.get("original_order"),
        "polygon_points": det.get("polygon_points"),
        **({"group_id": group_id} if group_id is not None else {}),
    }


def collect_blocks(
    page_model, page_w: float, page_h: float
) -> tuple[list[dict], list[dict], list[list[float]]]:
    """All body blocks with conflicts resolved + discarded blocks + footnote
    boxes. Groups (image/table bodies with captions) get a shared group_id."""
    all_blocks: list[dict] = []
    group_id = 0
    for img in page_model.images():
        all_blocks.append(_mk_block(img["image_body"], BlockType.IMAGE_BODY, group_id))
        for cap in img["image_caption_list"]:
            all_blocks.append(_mk_block(cap, BlockType.IMAGE_CAPTION, group_id))
        for fn in img["image_footnote_list"]:
            all_blocks.append(_mk_block(fn, BlockType.IMAGE_FOOTNOTE, group_id))
        group_id += 1
    for tbl in page_model.tables():
        all_blocks.append(_mk_block(tbl["table_body"], BlockType.TABLE_BODY, group_id))
        for cap in tbl["table_caption_list"]:
            all_blocks.append(_mk_block(cap, BlockType.TABLE_CAPTION, group_id))
        for fn in tbl["table_footnote_list"]:
            all_blocks.append(_mk_block(fn, BlockType.TABLE_FOOTNOTE, group_id))
        group_id += 1
    for det in page_model.text_blocks():
        all_blocks.append(_mk_block(det, BlockType.TEXT))
    for det in page_model.title_blocks():
        all_blocks.append(_mk_block(det, BlockType.TITLE))
    _, _, interline_blocks = page_model.equations()
    for det in interline_blocks:
        all_blocks.append(_mk_block(det, BlockType.INTERLINE_EQUATION))
    for det in page_model.formula_numbers():
        all_blocks.append(_mk_block(det, BlockType.FORMULA_NUMBER))

    discarded = [_mk_block(d, BlockType.DISCARDED) for d in page_model.discarded()]

    all_blocks = _resolve_block_conflicts(all_blocks, discarded)

    # footnote heuristic: wide, low-on-page discarded regions
    footnote_boxes = [
        list(d["bbox"])
        for d in discarded
        if (d["bbox"][2] - d["bbox"][0]) > page_w / 3
        and (d["bbox"][3] - d["bbox"][1]) > 10
        and d["bbox"][1] > page_h * 0.7
    ]
    return all_blocks, discarded, footnote_boxes


def _resolve_block_conflicts(blocks: list[dict], discarded: list[dict]) -> list[dict]:
    drop: set[int] = set()
    # text wins over overlapping title
    for t in (b for b in blocks if b["type"] == BlockType.TEXT):
        for ti in (b for b in blocks if b["type"] == BlockType.TITLE):
            if B.overlap_ratio(ti["bbox"], t["bbox"]) > 0.8:
                drop.add(id(ti))
    # discarded wins over anything mostly inside it
    for b in blocks:
        for d in discarded:
            if B.overlap_ratio(b["bbox"], d["bbox"]) > 0.8:
                drop.add(id(b))
    # interline equation with near-1 IoU vs text: equation wins
    for eq in (b for b in blocks if b["type"] == BlockType.INTERLINE_EQUATION):
        for t in (b for b in blocks if b["type"] in (BlockType.TEXT, BlockType.TITLE)):
            if B.iou(eq["bbox"], t["bbox"]) > 0.8:
                drop.add(id(t))
    # small box fully inside bigger box of texty types: keep the big one
    blocks2 = [b for b in blocks if id(b) not in drop]
    for i, small in enumerate(blocks2):
        if small["type"] not in (BlockType.TEXT, BlockType.TITLE, BlockType.INTERLINE_EQUATION):
            continue
        for j, big in enumerate(blocks2):
            if i == j or id(big) in drop:
                continue
            if big["type"] in (BlockType.TEXT, BlockType.TITLE) and B.contains(
                big["bbox"], small["bbox"]
            ) and B.area(small["bbox"]) < 0.5 * B.area(big["bbox"]):
                drop.add(id(small))
    return [b for b in blocks if id(b) not in drop]


# ------------------------------------------------------------------- spans

def remove_outside_spans(
    spans: list[dict], blocks: list[dict], discarded: list[dict]
) -> list[dict]:
    """Keep spans overlapping any block; image/table spans only count
    against their own body blocks."""
    if not spans:
        return []
    body_boxes = [b["bbox"] for b in blocks] + [d["bbox"] for d in discarded]
    img_boxes = [b["bbox"] for b in blocks if b["type"] == BlockType.IMAGE_BODY]
    tbl_boxes = [b["bbox"] for b in blocks if b["type"] == BlockType.TABLE_BODY]
    out = []
    for span in spans:
        stype = span.get("type")
        if stype == ContentType.IMAGE:
            targets = img_boxes
        elif stype == ContentType.TABLE:
            targets = tbl_boxes
        else:
            targets = body_boxes
        if any(B.overlap_ratio(span["bbox"], t) > 0.4 for t in targets):
            out.append(span)
    return out


def _span_block_compatible(span_type: str, block_type: str) -> bool:
    if span_type in (ContentType.TEXT, ContentType.INLINE_EQUATION, ContentType.CHECKBOX):
        return block_type in TEXTY_BLOCKS
    if span_type == ContentType.INTERLINE_EQUATION:
        return block_type in (BlockType.INTERLINE_EQUATION, BlockType.TEXT)
    if span_type == ContentType.IMAGE:
        return block_type == BlockType.IMAGE_BODY
    if span_type == ContentType.TABLE:
        return block_type == BlockType.TABLE_BODY
    return False


def fill_spans_into_blocks(
    blocks: list[dict], spans: list[dict], ratio: float = 0.4
) -> tuple[list[dict], list[dict]]:
    """Assign each span to blocks it overlaps; returns (blocks, leftover)."""
    remaining = list(spans)
    for block in blocks:
        mine = []
        for span in remaining:
            r = 0.9 if span["type"] in (ContentType.IMAGE, ContentType.TABLE) else ratio
            if _span_block_compatible(span["type"], block["type"]) and (
                B.overlap_ratio(span["bbox"], block["bbox"]) > r
            ):
                mine.append(span)
        block["spans"] = mine
        for span in mine:
            remaining.remove(span)
    return blocks, remaining


def merge_spans_to_lines(spans: list[dict], y_thresh: float = 0.6) -> list[dict]:
    """Group spans into lines by y-overlap; sort lines top-down, spans LTR."""
    if not spans:
        return []
    spans = sorted(spans, key=lambda s: (s["bbox"][1], s["bbox"][0]))
    lines: list[list[dict]] = [[spans[0]]]
    for span in spans[1:]:
        cur = lines[-1]
        bb = cur[-1]["bbox"]
        if span["type"] in (ContentType.INTERLINE_EQUATION, ContentType.IMAGE, ContentType.TABLE) or any(
            s["type"] in (ContentType.INTERLINE_EQUATION, ContentType.IMAGE, ContentType.TABLE)
            for s in cur
        ):
            lines.append([span])
            continue
        if B.y_overlap_ratio(span["bbox"], bb) > y_thresh:
            cur.append(span)
        else:
            lines.append([span])
    out = []
    for line_spans in lines:
        line_spans.sort(key=lambda s: s["bbox"][0])
        out.append(
            {
                "bbox": B.merge_all([s["bbox"] for s in line_spans]),
                "spans": line_spans,
            }
        )
    out.sort(key=lambda ln: ln["bbox"][1])
    return out


def finalize_block_lines(blocks: list[dict]) -> list[dict]:
    """Convert each block's spans to lines (reference fix_block_spans)."""
    out = []
    for block in blocks:
        spans = block.pop("spans", [])
        block["lines"] = merge_spans_to_lines(spans)
        if not block["lines"] and block["type"] not in (
            BlockType.IMAGE_BODY, BlockType.TABLE_BODY,
        ):
            # keep empty texty blocks, they may receive OCR later
            pass
        out.append(block)
    return out


# ----------------------------------------------------------------- sorting

_GROUPABLE = {
    BlockType.IMAGE_BODY: BlockType.IMAGE,
    BlockType.IMAGE_CAPTION: BlockType.IMAGE,
    BlockType.IMAGE_FOOTNOTE: BlockType.IMAGE,
    BlockType.TABLE_BODY: BlockType.TABLE,
    BlockType.TABLE_CAPTION: BlockType.TABLE,
    BlockType.TABLE_FOOTNOTE: BlockType.TABLE,
}


def sort_and_group_blocks(
    blocks: list[dict], page_w: float = 0.0, page_h: float = 0.0
) -> list[dict]:
    """Reading order + nest image/table groups into composite blocks.

    Prefers the layout model's built-in order (original_order) when present
    (reference: utils/block_sort.py:154-170); else the v3 enhanced sorter
    (virtual lines + separator bands), falling back to plain XY-cut on any
    failure (reference try/except chain, block_sort.py:215-224).
    """
    if not blocks:
        return []
    if page_w <= 0:
        page_w = max(b["bbox"][2] for b in blocks)
    if page_h <= 0:
        page_h = max(b["bbox"][3] for b in blocks)
    has_model_order = all(
        b.get("original_order") is not None and b.get("original_order", -1) >= 0
        for b in blocks
    )
    if has_model_order:
        for b in blocks:
            b["index"] = b["original_order"]
    else:
        try:
            order = sort_blocks_v3(blocks, page_w, page_h)
        except Exception:
            order = sort_boxes_reading_order([b["bbox"] for b in blocks])
        for rank, idx in enumerate(order):
            blocks[idx]["index"] = rank

    # nest grouped blocks
    groups: dict[int, list[dict]] = {}
    singles: list[dict] = []
    for b in blocks:
        gid = b.get("group_id")
        if b["type"] in _GROUPABLE and gid is not None:
            groups.setdefault(gid, []).append(b)
        else:
            singles.append(b)
    composites = []
    for gid, members in groups.items():
        members.sort(key=lambda b: b.get("index", 0))
        outer_type = _GROUPABLE[members[0]["type"]]
        body = next(
            (m for m in members if m["type"] in (BlockType.IMAGE_BODY, BlockType.TABLE_BODY)),
            members[0],
        )
        composites.append(
            {
                "type": outer_type,
                "bbox": B.merge_all([m["bbox"] for m in members]),
                "blocks": members,
                "index": body.get("index", members[0].get("index", 0)),
            }
        )
    merged = singles + composites
    merged.sort(key=lambda b: b.get("index", 0))
    return merged


def make_page_info(
    blocks: list[dict], page_idx: int, page_w: float, page_h: float,
    discarded: list[dict],
) -> dict[str, Any]:
    return {
        "preproc_blocks": blocks,
        "page_idx": page_idx,
        "page_size": [page_w, page_h],
        "discarded_blocks": discarded,
    }
