"""Paragraph splitting/merging across pages + geometric list detection.

Behavioral counterpart of the reference para_split (reference:
rapid_doc/backend/pipeline/para_split.py): blocks flatten across pages in
reading order, consecutive text blocks form groups (split before titles /
interline equations), each text block classifies geometrically as
TEXT/LIST/INDEX with per-line ListLineTag marks (left/right/center
alignment counts, digit/end-flag ratios, dog-tooth right edges), and
adjacent blocks in a group merge backward — text->text with indentation /
width / capital / digit gating (:274-316), list->list and index->index
unconditionally (:319-327) — setting SplitFlag.CROSS_PAGE on spans that
moved across a page boundary.
"""
from __future__ import annotations

import re

from ..types import BlockType, SplitFlag

LINE_STOP_FLAG = (
    ".", "!", "?", "。", "！", "？", ")", "）", '"', "”", ":", "：", ";", "；",
)
LIST_END_FLAG = (".", "。", ";", "；")

LIST_START_RE = re.compile(
    r"^\s*(?:[-•▪◦●○·*]|\(?\d{1,3}[.)]|\(?[a-zA-Z][.)]|\[\d{1,3}\]|"
    r"[ivxlcIVXLC]{1,6}[.)]|第[一二三四五六七八九十百]+[章节条款]|[一二三四五六七八九十]+[、.])"
)


class ListLineTag:
    IS_LIST_START_LINE = "is_list_start_line"
    IS_LIST_END_LINE = "is_list_end_line"


def _line_text(line: dict) -> str:
    return "".join(
        (s.get("content") or "").strip()
        for s in line.get("spans", [])
        if s.get("content")
    )


def _block_text(block: dict) -> str:
    return "\n".join(_line_text(ln) for ln in block.get("lines", []))


def _is_cjk_block(text: str) -> bool:
    if not text:
        return False
    cjk = sum(1 for c in text if 0x2E80 <= ord(c) <= 0x9FFF)
    return cjk / len(text) > 0.5


def _bbox_fs(block: dict) -> list[float]:
    lines = block.get("lines", [])
    if lines and all(ln.get("bbox") for ln in lines):
        return [
            min(ln["bbox"][0] for ln in lines),
            min(ln["bbox"][1] for ln in lines),
            max(ln["bbox"][2] for ln in lines),
            max(ln["bbox"][3] for ln in lines),
        ]
    return list(block["bbox"])


def classify_text_block(block: dict, page_size) -> str:
    """Geometric TEXT/LIST/INDEX classification with line tagging
    (reference: __is_list_or_index_block, para_split.py:73-270)."""
    lines = block.get("lines", [])
    if len(lines) < 2:
        return BlockType.TEXT
    bbox = block["bbox_fs"]
    first_line, last_line = lines[0], lines[-1]
    line_height = max(first_line["bbox"][3] - first_line["bbox"][1], 1e-6)
    block_w = max(bbox[2] - bbox[0], 1e-6)
    block_h = bbox[3] - bbox[1]
    page_w = page_size[0] if page_size else 0
    wr = block_w / page_w if page_w else 0.0

    texts = [_line_text(ln) for ln in lines]
    lang_cjk = _is_cjk_block("".join(texts))

    left_close = left_not_close = 0
    right_close = right_not_close = 0
    center_close = external_not_close = 0
    for ln in lines:
        lb = ln["bbox"]
        if (
            lb[0] - bbox[0] > 0.7 * line_height
            and bbox[2] - lb[2] > 0.7 * line_height
        ):
            external_not_close += 1
        if abs((lb[0] + lb[2]) / 2 - (bbox[0] + bbox[2]) / 2) < line_height / 2:
            center_close += 1
        if abs(bbox[0] - lb[0]) < line_height / 2:
            left_close += 1
        elif lb[0] - bbox[0] > line_height:
            left_not_close += 1
        if abs(bbox[2] - lb[2]) < line_height:
            right_close += 1
        else:
            if lang_cjk or wr >= 0.5:
                closed_area = 0.26 * block_w
            else:
                closed_area = 0.36 * block_w
            if bbox[2] - lb[2] > closed_area:
                right_not_close += 1

    # first line indented + last line flush-left with a short last line ->
    # probably two paragraphs in one block, not a list
    multiple_para = (
        first_line["bbox"][0] - bbox[0] > line_height / 2
        and abs(last_line["bbox"][0] - bbox[0]) < line_height / 2
        and bbox[2] - last_line["bbox"][2] > line_height
    )

    num_start = sum(1 for t in texts if t and t[0].isdigit())
    num_end = sum(1 for t in texts if t and t[-1].isdigit())
    flag_end = sum(1 for t in texts if t and t[-1] in LIST_END_FLAG)
    n = len(lines)
    line_num_flag = num_start / n >= 0.8 or num_end / n >= 0.8
    line_end_flag = flag_end / n >= 0.8

    if (left_close / n >= 0.8 or right_close / n >= 0.8) and line_num_flag:
        for ln in lines:
            ln[ListLineTag.IS_LIST_START_LINE] = True
        return BlockType.INDEX

    if (
        external_not_close >= 2
        and center_close == n
        and external_not_close / n >= 0.5
        and block_h / block_w > 0.4
    ):
        for ln in lines:
            ln[ListLineTag.IS_LIST_START_LINE] = True
        return BlockType.LIST

    if (
        left_close >= 2
        and (right_not_close >= 2 or line_end_flag or left_not_close >= 2)
        and not multiple_para
    ):
        if left_close / n > 0.8:
            if flag_end == 0 and right_close / n < 0.5:
                for ln in lines:
                    if abs(bbox[0] - ln["bbox"][0]) < line_height / 2:
                        ln[ListLineTag.IS_LIST_START_LINE] = True
            elif line_end_flag:
                for i, ln in enumerate(lines):
                    if texts[i] and texts[i][-1] in LIST_END_FLAG:
                        ln[ListLineTag.IS_LIST_END_LINE] = True
                        if i + 1 < n:
                            lines[i + 1][ListLineTag.IS_LIST_START_LINE] = True
            else:
                start_next = False
                for ln in lines:
                    if start_next:
                        ln[ListLineTag.IS_LIST_START_LINE] = True
                        start_next = False
                    if abs(bbox[2] - ln["bbox"][2]) > 0.1 * block_w:
                        ln[ListLineTag.IS_LIST_END_LINE] = True
                        start_next = True
        elif num_start >= 2 and num_start == flag_end:
            for i, ln in enumerate(lines):
                if texts[i]:
                    if texts[i][0].isdigit():
                        ln[ListLineTag.IS_LIST_START_LINE] = True
                    if texts[i][-1] in LIST_END_FLAG:
                        ln[ListLineTag.IS_LIST_END_LINE] = True
        else:
            for ln in lines:
                if abs(bbox[0] - ln["bbox"][0]) < line_height / 2:
                    ln[ListLineTag.IS_LIST_START_LINE] = True
                if abs(bbox[2] - ln["bbox"][2]) > line_height:
                    ln[ListLineTag.IS_LIST_END_LINE] = True
        return BlockType.LIST

    return BlockType.TEXT


def _merge_text_blocks(cur: dict, prev: dict) -> None:
    """Merge cur into prev when cur continues prev's paragraph
    (reference: __merge_2_text_blocks — indentation/width/capital gating)."""
    if not cur.get("lines") or not prev.get("lines"):
        return
    first_line = cur["lines"][0]
    line_height = max(first_line["bbox"][3] - first_line["bbox"][1], 1e-6)
    w1 = cur["bbox"][2] - cur["bbox"][0]
    w2 = prev["bbox"][2] - prev["bbox"][0]
    if abs(cur["bbox_fs"][0] - first_line["bbox"][0]) >= line_height / 2:
        return  # continuation must start flush-left
    last_line = prev["lines"][-1]
    lh2 = max(last_line["bbox"][3] - last_line["bbox"][1], 1e-6)
    last_text = _line_text(last_line)
    first_text = _line_text(first_line)
    if not first_text:
        return
    starts_digit = first_text[0].isdigit()
    starts_upper = first_text[0].isupper()
    if (
        abs(prev["bbox_fs"][2] - last_line["bbox"][2]) < lh2
        and not last_text.endswith(LINE_STOP_FLAG)
        and abs(w1 - w2) < min(w1, w2)
        and not starts_digit
        and not starts_upper
        and cur["bbox"][1] < prev["bbox"][3]
        and (len(cur["lines"]) > 1 or len(prev["lines"]) > 1)
    ):
        if cur.get("page_num") != prev.get("page_num"):
            for line in cur["lines"]:
                for span in line.get("spans", []):
                    span[SplitFlag.CROSS_PAGE] = True
        prev["lines"].extend(cur["lines"])
        cur["lines"] = []
        cur[SplitFlag.LINES_DELETED] = True


def _merge_list_blocks(cur: dict, prev: dict) -> None:
    if cur.get("page_num") != prev.get("page_num"):
        for line in cur.get("lines", []):
            for span in line.get("spans", []):
                span[SplitFlag.CROSS_PAGE] = True
    prev.setdefault("lines", []).extend(cur.get("lines", []))
    cur["lines"] = []
    cur[SplitFlag.LINES_DELETED] = True


def _group_blocks(blocks: list[dict]) -> list[dict]:
    """Consecutive text blocks group together; any other block is its own
    group; titles/interline equations also cut the running text group
    (reference: __process_blocks)."""
    groups: list[dict] = []
    current: list[dict] = []

    def flush():
        nonlocal current
        if current:
            groups.append({"group_type": "text", "blocks": current})
            current = []

    for i, block in enumerate(blocks):
        if block["type"] == BlockType.TEXT:
            block["bbox_fs"] = _bbox_fs(block)
            current.append(block)
        else:
            flush()
            groups.append({"group_type": block["type"], "blocks": [block]})
        if i + 1 < len(blocks) and blocks[i + 1]["type"] in (
            BlockType.TITLE, BlockType.INTERLINE_EQUATION
        ):
            flush()
    flush()
    return groups


def para_split(page_info_list: list[dict]) -> None:
    """Populate para_blocks per page, merging paragraphs within and across
    pages (reference: para_split :374-392 + __para_merge_page :330)."""
    all_blocks: list[dict] = []
    for page_info in page_info_list:
        for block in page_info.get("preproc_blocks", []):
            block["page_num"] = page_info.get("page_idx")
            block["page_size"] = page_info.get("page_size") or [0, 0]
            all_blocks.append(block)

    for group in _group_blocks(all_blocks):
        members = group["blocks"]
        if group["group_type"] == "text":
            for block in members:
                block["type"] = classify_text_block(
                    block, block.get("page_size")
                )
                # bullet-marker regex backs up the geometric signal
                if block["type"] == BlockType.TEXT:
                    starts = sum(
                        1
                        for ln in block.get("lines", [])
                        if LIST_START_RE.match(_line_text(ln))
                    )
                    if starts >= 2 and starts >= len(block["lines"]) * 0.4:
                        block["type"] = BlockType.LIST
                        for ln in block["lines"]:
                            if LIST_START_RE.match(_line_text(ln)):
                                ln[ListLineTag.IS_LIST_START_LINE] = True
        if len(members) > 1 and group["group_type"] == "text":
            is_list_group = all(
                len(b.get("lines", [])) <= 3 for b in members
            )
            for i in range(len(members) - 1, 0, -1):
                cur, prev = members[i], members[i - 1]
                if (
                    cur["type"] == BlockType.TEXT
                    and prev["type"] == BlockType.TEXT
                    and not is_list_group
                ):
                    _merge_text_blocks(cur, prev)
                elif cur["type"] == prev["type"] and cur["type"] in (
                    BlockType.LIST, BlockType.INDEX
                ):
                    _merge_list_blocks(cur, prev)

    for page_info in page_info_list:
        page_info["para_blocks"] = []
        for block in page_info.get("preproc_blocks", []):
            if block.get(SplitFlag.LINES_DELETED):
                block.pop("page_num", None)
                block.pop("page_size", None)
                continue
            if block.get("page_num") == page_info.get("page_idx"):
                page_info["para_blocks"].append(block)
            block.pop("page_num", None)
            block.pop("page_size", None)
