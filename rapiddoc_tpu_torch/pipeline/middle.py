"""Model outputs -> middle_json.

Behavioral counterpart of the reference result_to_middle_json
(reference: rapid_doc/backend/pipeline/model_json_to_middle_json.py:295):
per-page PageModel cleanup, span assembly (model spans + native pdf text in
'txt' mode), block filling, reading order, image cutting, paragraph merge.

Copy of the JAX package's module with the page images as numpy arrays
(H, W, 3): ``utils/images.cut_span_images`` raises NotImplementedError
for a span that needs a JPEG payload.
"""
from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np

from ..types import BlockType, ContentType
from ..utils import boxes as B
from ..utils.images import cut_span_images
from ..version import __version__
from .page_build import (
    collect_blocks,
    fill_spans_into_blocks,
    finalize_block_lines,
    make_page_info,
    remove_outside_spans,
    sort_and_group_blocks,
)
from .page_model import PageModel
from .para import para_split
from .table_merge import cross_page_table_merge


def native_text_spans(page_text_dict: dict) -> list[dict]:
    """Convert pdfio native text structure to content spans."""
    spans = []
    for block in page_text_dict.get("blocks", []):
        for line in block.get("lines", []):
            for span in line.get("spans", []):
                text = span.get("text", "")
                if not text.strip():
                    continue
                spans.append(
                    {
                        "bbox": [round(v, 2) for v in span["bbox"]],
                        "content": text,
                        "type": ContentType.TEXT,
                        "score": 1.0,
                    }
                )
    return spans


def page_to_page_info(
    page_model_info: dict,
    page_idx: int,
    page_w: float,
    page_h: float,
    scale: float,
    *,
    page_img: np.ndarray | None = None,
    page_text_dict: dict | None = None,
    parse_mode: str = "ocr",
    image_writer=None,
    originals=None,
    original_iou_thresh: float = 0.9,
) -> dict | None:
    model = PageModel(page_model_info, scale)
    all_blocks, discarded, footnotes = collect_blocks(model, page_w, page_h)

    spans = model.all_spans()
    if parse_mode == "txt" and page_text_dict is not None:
        # native text replaces OCR text spans
        ocr_text_spans = [s for s in spans if s["type"] == ContentType.TEXT]
        spans = [s for s in spans if s["type"] != ContentType.TEXT]
        spans.extend(native_text_spans(page_text_dict))
        del ocr_text_spans

    spans = remove_outside_spans(spans, all_blocks, discarded)

    blocks, leftover = fill_spans_into_blocks(all_blocks, spans, 0.4)
    discarded_filled, _ = fill_spans_into_blocks(discarded, leftover, 0.4)
    blocks = finalize_block_lines(blocks)
    discarded_filled = finalize_block_lines(discarded_filled)

    if not blocks and not discarded_filled:
        return None

    sorted_blocks = sort_and_group_blocks(blocks, page_w, page_h)
    page_info = make_page_info(
        sorted_blocks, page_idx, page_w, page_h, discarded_filled
    )
    if page_img is not None:
        cut_span_images(
            page_info, page_img, scale, image_writer,
            originals=originals, original_iou_thresh=original_iou_thresh,
        )
    return page_info


def build_page_infos(
    model_infos: Sequence[dict],
    page_dims: Sequence[tuple[float, float]],
    scales: Sequence[float],
    *,
    page_imgs: Sequence[np.ndarray] | None = None,
    page_text_dicts: Sequence[dict | None] | None = None,
    parse_mode: str = "ocr",
    image_writer=None,
    page_idx_offset: int = 0,
    originals_per_page=None,
    image_config: dict | None = None,
) -> list[dict]:
    """The per-page half of result_to_middle_json: model output ->
    page_info (span fill, image cutting, xycut sort). Window-local, so
    the api window loop can run it on an assembly worker thread UNDER
    the next window's device compute; the cross-page passes live in
    finalize_middle_json."""
    infos: list[dict] = []
    for i, model_info in enumerate(model_infos):
        w, h = page_dims[i]
        info = page_to_page_info(
            model_info,
            page_idx_offset + i,
            w,
            h,
            scales[i],
            page_img=page_imgs[i] if page_imgs else None,
            page_text_dict=page_text_dicts[i] if page_text_dicts else None,
            parse_mode=parse_mode,
            image_writer=image_writer,
            originals=originals_per_page[i] if originals_per_page else None,
            original_iou_thresh=(image_config or {}).get(
                "extract_original_image_iou_thresh", 0.9
            ),
        )
        if info is None:
            info = make_page_info([], page_idx_offset + i, w, h, [])
        infos.append(info)
    return infos


def finalize_middle_json(
    page_infos: list[dict], parse_mode: str = "ocr"
) -> dict[str, Any]:
    """Cross-page passes (need every page): running-decoration demotion,
    formula-number \\tag merge, paragraph split, cross-page table merge."""
    middle: dict[str, Any] = {
        "pdf_info": page_infos,
        "_backend": "pipeline",
        "_version_name": __version__,
        "_parse_type": parse_mode,
    }
    _drop_running_decorations(middle["pdf_info"])
    _merge_formula_numbers(middle["pdf_info"])
    para_split(middle["pdf_info"])
    cross_page_table_merge(middle["pdf_info"])
    return middle


_DECOR_DIGITS_RE = re.compile(r"\d+")


def _drop_running_decorations(pdf_info: list[dict]) -> None:
    """Demote running headers/footers: digit-normalized texts of
    edge-hugging blocks that repeat on >= 3 pages (or half the doc).

    The analyze pass runs the same heuristic (scheduler.decoration_texts)
    but only sees ONE WINDOW of pages — a footer that repeats across
    windows is invisible to it, so page outputs would depend on the
    window size. This document-level pass makes the final result
    window-invariant. (Reference analogue: the layout model's
    header/footer labels, rapid_layout.py:131 label maps.)"""
    from collections import Counter

    def norm(block: dict) -> str | None:
        text = _block_text(block)
        if not text or len(text) > 80:
            return None
        return _DECOR_DIGITS_RE.sub("#", text)

    def edge(block: dict, page_h: float) -> bool:
        bbox = block.get("bbox")
        if not bbox or not page_h:
            return False
        return bbox[3] < page_h * 0.08 or bbox[1] > page_h * 0.92

    counts: Counter = Counter()
    pages = 0
    for page in pdf_info:
        pages += 1
        page_h = float((page.get("page_size") or [0, 0])[1])
        seen: set[str] = set()
        for block in page.get("preproc_blocks", []):
            if block.get("type") not in (BlockType.TEXT, BlockType.TITLE):
                continue
            if not edge(block, page_h):
                continue
            key = norm(block)
            if key and key not in seen:
                seen.add(key)
                counts[key] += 1
        # blocks the per-window pass already demoted still count toward
        # the repeat threshold, so window sizes converge on one answer
        for block in page.get("discarded_blocks", []):
            if edge(block, page_h):
                key = norm(block)
                if key and key not in seen:
                    seen.add(key)
                    counts[key] += 1
    if pages < 2:
        return
    need = min(3, max(2, pages // 2))
    repeated = {t for t, c in counts.items() if c >= need}
    if not repeated:
        return
    for page in pdf_info:
        page_h = float((page.get("page_size") or [0, 0])[1])
        kept, dropped = [], []
        for block in page.get("preproc_blocks", []):
            if (
                block.get("type") in (BlockType.TEXT, BlockType.TITLE)
                and edge(block, page_h)
                and norm(block) in repeated
            ):
                block["type"] = BlockType.DISCARDED
                dropped.append(block)
            else:
                kept.append(block)
        if dropped:
            page["preproc_blocks"] = kept
            page.setdefault("discarded_blocks", []).extend(dropped)


def result_to_middle_json(
    model_infos: Sequence[dict],
    page_dims: Sequence[tuple[float, float]],
    scales: Sequence[float],
    *,
    page_imgs: Sequence[np.ndarray] | None = None,
    page_text_dicts: Sequence[dict | None] | None = None,
    parse_mode: str = "ocr",
    image_writer=None,
    page_idx_offset: int = 0,
    originals_per_page=None,
    image_config: dict | None = None,
) -> dict[str, Any]:
    infos = build_page_infos(
        model_infos, page_dims, scales,
        page_imgs=page_imgs, page_text_dicts=page_text_dicts,
        parse_mode=parse_mode, image_writer=image_writer,
        page_idx_offset=page_idx_offset,
        originals_per_page=originals_per_page, image_config=image_config,
    )
    return finalize_middle_json(infos, parse_mode)


def _block_text(block: dict) -> str:
    return " ".join(
        span.get("content", "")
        for line in block.get("lines", [])
        for span in line.get("spans", [])
    ).strip()


def _merge_formula_numbers(pdf_info: list[dict]) -> None:
    """Fold formula_number blocks into the adjacent interline equation as
    a LaTeX \\tag{...}; orphans demote to text (reference:
    model_json_to_middle_json.py:240-292 _optimize_formula_number_blocks)."""
    for page in pdf_info:
        blocks = page.get("preproc_blocks", [])
        out = []
        for idx, block in enumerate(blocks):
            if block.get("type") != BlockType.FORMULA_NUMBER:
                out.append(block)
                continue
            tag = _block_text(block).strip("()（）[] ")
            neighbors = []
            if idx > 0:
                neighbors.append(blocks[idx - 1])
            if idx + 1 < len(blocks) and (
                idx + 2 >= len(blocks)
                or blocks[idx + 2].get("type") != BlockType.FORMULA_NUMBER
            ):
                neighbors.append(blocks[idx + 1])
            merged = False
            if tag:
                for nb in neighbors:
                    if nb.get("type") != BlockType.INTERLINE_EQUATION:
                        continue
                    span = next(
                        (
                            s
                            for ln in nb.get("lines", [])
                            for s in ln.get("spans", [])
                            if s.get("type") == ContentType.INTERLINE_EQUATION
                            and s.get("content")
                        ),
                        None,
                    )
                    if span is not None:
                        span["content"] = f"{span['content']}\\tag{{{tag}}}"
                        merged = True
                        break
            if merged:
                continue
            if tag:  # orphan number with text: keep it as a text block
                block["type"] = BlockType.TEXT
                out.append(block)
        page["preproc_blocks"] = out
