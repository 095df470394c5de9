"""middle_json -> Markdown / content_list emitters.

Behavioral counterpart of the reference union_make
(reference: rapid_doc/backend/pipeline/pipeline_middle_json_mkcontent.py:
MM_MD / NLP_MD / CONTENT_LIST modes, hyphen joining, configurable LaTeX
delimiters, title levels, caption/body/footnote ordering).
"""
from __future__ import annotations

import re
from typing import Any

from ..config import get_latex_delimiter_config
from ..types import BlockType, ContentType, MakeMode

_CJK_RE = re.compile(r"[⺀-鿿豈-﫿＀-￯]")


def _full_to_half(text: str) -> str:
    out = []
    for ch in text:
        code = ord(ch)
        if 0xFF01 <= code <= 0xFF5E and ch not in "：；，。！？":
            out.append(chr(code - 0xFEE0))
        elif code == 0x3000:
            out.append(" ")
        else:
            out.append(ch)
    return "".join(out)


def _span_markdown(span: dict, delims: dict) -> str:
    stype = span.get("type")
    content = span.get("content", "") or ""
    if stype in (ContentType.TEXT, ContentType.CHECKBOX, ContentType.SEAL):
        return _full_to_half(content)
    if stype == ContentType.INLINE_EQUATION:
        d = delims["inline"]
        return f"{d['left']}{content.strip()}{d['right']}" if content.strip() else ""
    if stype == ContentType.INTERLINE_EQUATION:
        d = delims["display"]
        return f"\n{d['left']}\n{content.strip()}\n{d['right']}\n" if content.strip() else ""
    return content


def _ends_with_cjk(text: str) -> bool:
    return bool(text) and bool(_CJK_RE.match(text[-1]))


def merge_para_with_text(block: dict) -> str:
    """Join a block's lines into one paragraph string."""
    delims = get_latex_delimiter_config()
    para = ""
    for line in block.get("lines", []):
        line_text = "".join(_span_markdown(s, delims) for s in line.get("spans", []))
        line_text = line_text.strip("\n") if line_text.strip("\n") else line_text
        if not line_text.strip():
            continue
        if line.get("is_list_start_line") and para:
            para = para.rstrip() + "  \n"  # markdown hard break between items
        if para and not para.endswith("\n"):
            if re.search(r"[A-Za-z]-$", para.rstrip()):
                para = para.rstrip()[:-1]  # drop trailing hyphen, join word
            elif _ends_with_cjk(para.rstrip()) and line_text and _CJK_RE.match(line_text[0]):
                pass  # CJK: no space joint
            else:
                para = para.rstrip() + " "
        para += line_text.strip() if not para.endswith("\n") else line_text.strip()
    return para.strip()


def get_title_level(block: dict) -> int:
    level = block.get("level", 1)
    try:
        level = int(level)
    except (TypeError, ValueError):
        level = 1
    return min(max(level, 1), 4)


def _image_block_md(block: dict, img_prefix: str) -> str:
    parts_caption, parts_body, parts_footnote = [], [], []
    for sub in block.get("blocks", []):
        if sub["type"] == BlockType.IMAGE_CAPTION:
            parts_caption.append(merge_para_with_text(sub))
        elif sub["type"] == BlockType.IMAGE_BODY:
            for line in sub.get("lines", []):
                for span in line.get("spans", []):
                    if span.get("type") == ContentType.IMAGE:
                        if span.get("image_path"):
                            parts_body.append(f"![]({img_prefix}/{span['image_path']})")
                        if span.get("original_label") == "seal" and span.get("content"):
                            parts_body.append(span["content"])
        elif sub["type"] == BlockType.IMAGE_FOOTNOTE:
            parts_footnote.append(merge_para_with_text(sub))
    pieces = parts_body + parts_caption + parts_footnote
    return "  \n".join(x for x in pieces if x)


def _table_block_md(block: dict, img_prefix: str) -> str:
    caption, body, footnote = [], [], []
    for sub in block.get("blocks", []):
        if sub["type"] == BlockType.TABLE_CAPTION:
            caption.append(merge_para_with_text(sub))
        elif sub["type"] == BlockType.TABLE_BODY:
            for line in sub.get("lines", []):
                for span in line.get("spans", []):
                    if span.get("type") == ContentType.TABLE:
                        if span.get("html"):
                            body.append(f"\n{span['html']}\n")
                        elif span.get("latex"):
                            body.append(f"\n{span['latex']}\n")
                        elif span.get("image_path"):
                            body.append(f"![]({img_prefix}/{span['image_path']})")
        elif sub["type"] == BlockType.TABLE_FOOTNOTE:
            footnote.append(merge_para_with_text(sub))
    out = ""
    if caption:
        out += "  \n".join(caption) + "  \n"
    out += "".join(body)
    if footnote:
        out += "\n" + "  \n".join(footnote)
    return out.strip()


def blocks_to_markdown(
    para_blocks: list[dict], mode: str, img_prefix: str = ""
) -> list[str]:
    delims = get_latex_delimiter_config()
    page_md: list[str] = []
    for block in para_blocks:
        btype = block["type"]
        text = ""
        if btype in (BlockType.TEXT, BlockType.LIST, BlockType.INDEX):
            text = merge_para_with_text(block)
        elif btype == BlockType.TITLE:
            text = f"{'#' * get_title_level(block)} {merge_para_with_text(block)}"
            text = text.replace("-\n", "").replace("\n", " ")
        elif btype == BlockType.INTERLINE_EQUATION:
            lines = block.get("lines", [])
            if not lines or not lines[0].get("spans"):
                continue
            span = lines[0]["spans"][0]
            if span.get("content"):
                text = merge_para_with_text(block)
            elif span.get("image_path") and mode == MakeMode.MM_MD:
                text = f"![]({img_prefix}/{span['image_path']})"
        elif btype == BlockType.IMAGE:
            if mode == MakeMode.MM_MD:
                text = _image_block_md(block, img_prefix)
        elif btype == BlockType.TABLE:
            if mode == MakeMode.MM_MD:
                text = _table_block_md(block, img_prefix)
        if text and text.strip():
            page_md.append(text.strip())
    return page_md


def _norm_bbox(bbox, page_size) -> list | None:
    """bbox -> per-mille page coordinates (reference:
    pipeline_middle_json_mkcontent.py:304-313)."""
    if not bbox or not page_size or not page_size[0] or not page_size[1]:
        return list(bbox) if bbox else None
    w, h = page_size
    x0, y0, x1, y1 = bbox
    return [
        int(x0 * 1000 / w), int(y0 * 1000 / h),
        int(x1 * 1000 / w), int(y1 * 1000 / h),
    ]


def _block_content_item(block: dict, page_idx: int, img_prefix: str,
                        page_size=None) -> dict | None:
    btype = block["type"]
    item: dict[str, Any] = {
        "page_idx": page_idx,
        "bbox": _norm_bbox(block.get("bbox"), page_size),
    }
    if btype in (BlockType.TEXT, BlockType.LIST, BlockType.INDEX):
        item.update({"type": ContentType.TEXT, "text": merge_para_with_text(block)})
    elif btype in (BlockType.DISCARDED, BlockType.HEADER, BlockType.FOOTER):
        # discarded page furniture rides along typed (reference:
        # make_blocks_to_content_list BlockType.DISCARDED branch :248)
        item.update({"type": btype, "text": merge_para_with_text(block)})
    elif btype == BlockType.TITLE:
        item.update(
            {
                "type": ContentType.TEXT,
                "text": merge_para_with_text(block),
                "text_level": get_title_level(block),
            }
        )
    elif btype == BlockType.INTERLINE_EQUATION:
        text = merge_para_with_text(block)
        item.update({"type": ContentType.EQUATION, "text": text, "text_format": "latex"})
    elif btype == BlockType.IMAGE:
        item.update({"type": ContentType.IMAGE})
        captions, footnotes = [], []
        for sub in block.get("blocks", []):
            if sub["type"] == BlockType.IMAGE_BODY:
                for line in sub.get("lines", []):
                    for span in line.get("spans", []):
                        if span.get("image_path"):
                            item["img_path"] = f"{img_prefix}/{span['image_path']}"
                        # recognized seal text rides on the image item
                        # (reference: _get_seal_text :363-369, :277-278)
                        if span.get("original_label") == "seal" and span.get(
                            "content"
                        ):
                            content = span["content"]
                            item["text"] = (
                                " ".join(
                                    str(x) for x in content if str(x).strip()
                                )
                                if isinstance(content, list)
                                else str(content).strip()
                            )
            elif sub["type"] == BlockType.IMAGE_CAPTION:
                captions.append(merge_para_with_text(sub))
            elif sub["type"] == BlockType.IMAGE_FOOTNOTE:
                footnotes.append(merge_para_with_text(sub))
        item["img_caption"] = captions
        item["img_footnote"] = footnotes
    elif btype == BlockType.TABLE:
        item.update({"type": ContentType.TABLE})
        captions, footnotes = [], []
        for sub in block.get("blocks", []):
            if sub["type"] == BlockType.TABLE_BODY:
                for line in sub.get("lines", []):
                    for span in line.get("spans", []):
                        if span.get("html"):
                            item["table_body"] = span["html"]
                        if span.get("image_path"):
                            item["img_path"] = f"{img_prefix}/{span['image_path']}"
            elif sub["type"] == BlockType.TABLE_CAPTION:
                captions.append(merge_para_with_text(sub))
            elif sub["type"] == BlockType.TABLE_FOOTNOTE:
                footnotes.append(merge_para_with_text(sub))
        item["table_caption"] = captions
        item["table_footnote"] = footnotes
    else:
        return None
    if item.get("type") == ContentType.TEXT and not item.get("text", "").strip():
        return None
    return item


def union_make(
    pdf_info: list[dict],
    make_mode: str = MakeMode.MM_MD,
    img_prefix: str = "",
) -> str | list[dict]:
    """Emit markdown (str) or content list (list of dicts) from pdf_info."""
    if make_mode in (MakeMode.MM_MD, MakeMode.NLP_MD):
        output: list[str] = []
        for page_info in pdf_info:
            blocks = page_info.get("para_blocks") or page_info.get("preproc_blocks") or []
            output.extend(blocks_to_markdown(blocks, make_mode, img_prefix))
        return "\n\n".join(output)
    if make_mode in (MakeMode.CONTENT_LIST, MakeMode.CONTENT_LIST_V2):
        builder = (
            _block_content_item_v2
            if make_mode == MakeMode.CONTENT_LIST_V2
            else _block_content_item
        )
        items: list[dict] = []
        for page_info in pdf_info:
            page_idx = page_info.get("page_idx", 0)
            page_size = page_info.get("page_size")
            blocks = page_info.get("para_blocks") or page_info.get("preproc_blocks") or []
            # discarded blocks ride along after the layout blocks
            # (reference: union_make :338 paras_of_layout + paras_of_discarded)
            blocks = list(blocks) + list(page_info.get("discarded_blocks") or [])
            for block in blocks:
                item = builder(block, page_idx, img_prefix, page_size)
                if item is not None:
                    items.append(item)
        return items
    raise ValueError(f"unknown make mode {make_mode!r}")


def _block_content_item_v2(block: dict, page_idx: int, img_prefix: str,
                           page_size=None) -> dict | None:
    """Structured content-list-v2 item (reference:
    output_builders.py make_blocks_to_content_list_v2:541-679): every
    item is {"type", "content": {...typed payload...}}."""
    from ..types import ContentTypeV2 as V2

    btype = block["type"]
    text = merge_para_with_text(block)
    spans = [{"type": V2.SPAN_TEXT, "content": text}] if text else []
    item: dict[str, Any] | None = None
    if btype == BlockType.TITLE:
        item = {
            "type": V2.TITLE,
            "content": {"title_content": spans,
                        "level": get_title_level(block)},
        }
    elif btype in (BlockType.TEXT,):
        item = {"type": V2.PARAGRAPH, "content": {"paragraph_content": spans}}
    elif btype in (BlockType.HEADER, BlockType.FOOTER, BlockType.DISCARDED):
        kind = (
            V2.PAGE_FOOTER if btype == BlockType.FOOTER else V2.PAGE_HEADER
        )
        item = {"type": kind, "content": {f"{kind}_content": spans}}
    elif btype == BlockType.INTERLINE_EQUATION:
        item = {
            "type": V2.EQUATION_INTERLINE,
            "content": {"math_content": text, "math_type": "latex"},
        }
    elif btype in (BlockType.LIST, BlockType.INDEX):
        lines = [
            span.get("content", "")
            for line in block.get("lines", [])
            for span in line.get("spans", [])
            if span.get("content")
        ] or ([text] if text else [])
        item = {
            "type": V2.INDEX if btype == BlockType.INDEX else V2.LIST,
            "content": {
                "list_type": V2.LIST_TEXT,
                "attribute": block.get("attribute", "unordered"),
                "list_items": lines,
            },
        }
    elif btype == BlockType.IMAGE:
        path, captions = "", []
        for sub in block.get("blocks", []):
            if sub["type"] == BlockType.IMAGE_BODY:
                for line in sub.get("lines", []):
                    for span in line.get("spans", []):
                        if span.get("image_path"):
                            path = f"{img_prefix}/{span['image_path']}"
            elif sub["type"] == BlockType.IMAGE_CAPTION:
                captions.append(merge_para_with_text(sub))
        item = {
            "type": V2.IMAGE,
            "content": {"image_source": {"path": path},
                        "image_caption": captions},
        }
    elif btype == BlockType.TABLE:
        html, captions = "", []
        for sub in block.get("blocks", []):
            if sub["type"] == BlockType.TABLE_BODY:
                for line in sub.get("lines", []):
                    for span in line.get("spans", []):
                        if span.get("html"):
                            html = span["html"]
            elif sub["type"] == BlockType.TABLE_CAPTION:
                captions.append(merge_para_with_text(sub))
        nest = 2 if html.count("<table") > 1 else 1
        complex_ = "colspan" in html or "rowspan" in html or nest > 1
        item = {
            "type": V2.TABLE,
            "content": {
                "table_caption": captions,
                "html": html,
                "table_type": V2.TABLE_COMPLEX if complex_
                else V2.TABLE_SIMPLE,
                "table_nest_level": nest,
            },
        }
    if item is None:
        return None
    anchor = block.get("anchor")
    if isinstance(anchor, str) and anchor.strip():
        item["anchor"] = anchor.strip()
    item["page_idx"] = page_idx
    bbox = _norm_bbox(block.get("bbox"), page_size)
    if bbox:
        item["bbox"] = bbox
    return item
