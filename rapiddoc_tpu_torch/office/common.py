"""Shared office-conversion infrastructure.

A copy of ``rapiddoc_tpu/office/common.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.
"""
from __future__ import annotations

import html as html_mod
from dataclasses import dataclass, field

from ..types import BlockType, ContentType, MakeMode
from ..version import __version__

NS = {
    "w": "http://schemas.openxmlformats.org/wordprocessingml/2006/main",
    "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships",
    "a": "http://schemas.openxmlformats.org/drawingml/2006/main",
    "p": "http://schemas.openxmlformats.org/presentationml/2006/main",
    "m": "http://schemas.openxmlformats.org/officeDocument/2006/math",
    "rel": "http://schemas.openxmlformats.org/package/2006/relationships",
    "wp": "http://schemas.openxmlformats.org/drawingml/2006/wordprocessingDrawing",
    "pic": "http://schemas.openxmlformats.org/drawingml/2006/picture",
    "s": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
    "a14": "http://schemas.microsoft.com/office/drawing/2010/main",
}


def q(tag: str) -> str:
    """'w:p' -> '{ns}p'."""
    prefix, local = tag.split(":")
    return f"{{{NS[prefix]}}}{local}"


@dataclass
class OfficeBlock:
    type: str  # text | title | table | image | equation | code
    #           | header | footer | index
    text: str = ""
    html: str = ""
    image_name: str = ""
    level: int = 1
    page_idx: int = 0
    items: list = field(default_factory=list)  # index (TOC) lines
    anchor: str = ""  # bookmark id a TOC entry can link to (titles)


@dataclass
class OfficeResult:
    blocks: list[OfficeBlock] = field(default_factory=list)
    images: dict[str, bytes] = field(default_factory=dict)
    n_pages: int = 1

    def add_text(self, text: str, page: int = 0) -> None:
        if text and text.strip():
            self.blocks.append(OfficeBlock("text", text=text.strip(), page_idx=page))

    def add_title(self, text: str, level: int = 1, page: int = 0,
                  anchor: str = "") -> None:
        if text and text.strip():
            self.blocks.append(
                OfficeBlock("title", text=text.strip(), level=level,
                            page_idx=page, anchor=anchor)
            )

    def add_table(self, html: str, page: int = 0) -> None:
        if html:
            self.blocks.append(OfficeBlock("table", html=html, page_idx=page))

    def add_image(self, name: str, data: bytes, page: int = 0) -> None:
        from .images import normalize_office_image

        # WMF/EMF vector media -> labeled placeholder raster (reference:
        # backend/utils/office_image.py:34-181)
        name, data = normalize_office_image(name, data)
        self.images[f"images/{name}"] = data
        self.blocks.append(OfficeBlock("image", image_name=f"images/{name}", page_idx=page))

    def add_equation(self, latex: str, page: int = 0) -> None:
        if latex and latex.strip():
            self.blocks.append(OfficeBlock("equation", text=latex.strip(), page_idx=page))

    def add_caption(self, text: str, page: int = 0) -> None:
        """A caption-flagged paragraph (docx SEQ field, reference:
        docx_converter._is_caption:3446 -> BlockType.CAPTION). It ties to
        the adjacent image/table even without a Figure/Table text prefix;
        unconsumed captions degrade to plain text."""
        if text and text.strip():
            self.blocks.append(OfficeBlock("caption", text=text.strip(), page_idx=page))

    def add_header(self, text: str, page: int = 0) -> None:
        """Page header text — discarded from markdown, carried in the
        content list / middle json as a discarded block (reference:
        office_magic_model.py:144 routes HEADER/FOOTER to
        discarded_blocks; output_builders.py:449 keeps them in the
        content list)."""
        if text and text.strip():
            self.blocks.append(OfficeBlock("header", text=text.strip(), page_idx=page))

    def add_footer(self, text: str, page: int = 0) -> None:
        if text and text.strip():
            self.blocks.append(OfficeBlock("footer", text=text.strip(), page_idx=page))

    def add_index(self, items: list[str], page: int = 0) -> None:
        """A table-of-contents block: pre-rendered lines (indentation and
        anchors applied by the converter). Rendered like the reference's
        INDEX block (output_builders.py merge_index_to_markdown)."""
        items = [it for it in items if it and it.strip()]
        if items:
            self.blocks.append(OfficeBlock("index", items=list(items), page_idx=page))

    def add_list(self, items: list[str], page: int = 0) -> None:
        """A list block: pre-rendered markdown lines ("- x" / "1. y").
        Kept as a typed block so the content list carries list_items
        (reference: output_builders.py make_blocks_to_content_list
        BlockType.LIST -> {'type': 'list', 'list_items': ...})."""
        items = [it for it in items if it and it.strip()]
        if items:
            self.blocks.append(OfficeBlock("list", items=list(items), page_idx=page))

    # ------------------------------------------------------------- outputs

    def to_markdown(self) -> str:
        out = []
        for b in self.blocks:
            if b.type == "title":
                head = f"{'#' * min(b.level, 4)} {b.text}"
                # bookmark anchor so intra-document TOC links resolve
                # (reference: mk_blocks_to_markdown anchor handling)
                out.append(
                    f'<a id="{b.anchor}"></a>\n{head}' if b.anchor else head
                )
            elif b.type in ("text", "caption"):
                out.append(b.text)
            elif b.type == "table":
                out.append(b.html)
            elif b.type == "image":
                out.append(f"![]({b.image_name})")
            elif b.type == "equation":
                out.append(f"$$\n{b.text}\n$$")
            elif b.type in ("index", "list"):
                out.append("\n".join(b.items))
            # header/footer: discarded from markdown (reference parity)
        return "\n\n".join(out)

    def _classify_captions(self) -> dict[int, str]:
        """idx -> 'img_caption'|'table_caption' (reference:
        backend/office/office_magic_model.py classify_caption_blocks —
        caption type follows the adjacent body, looking backward first,
        with runs of captions between body and caption treated as
        adjacent; the first text right after a body with a matching
        Table/Figure prefix is a caption even without a number)."""
        blocks = self.blocks
        n = len(blocks)
        kinds: dict[int, str] = {}
        for i, b in enumerate(blocks):
            if b.type in ("image", "table") and i + 1 < n:
                nxt = blocks[i + 1]
                if nxt.type in ("text", "caption") and nxt.page_idx == b.page_idx:
                    content = nxt.text.strip().lower()
                    prefixes = (
                        ("表", "table")
                        if b.type == "table"
                        else ("图", "圖", "fig", "chart", "diagram")
                    )
                    if nxt.type == "caption" or any(
                        content.startswith(p) for p in prefixes
                    ):
                        kinds[i + 1] = (
                            "table_caption"
                            if b.type == "table"
                            else "img_caption"
                        )

        def neighbor_body(i: int, step: int) -> str | None:
            j = i + step
            while 0 <= j < n and blocks[j].page_idx == blocks[i].page_idx:
                t = blocks[j]
                if t.type in ("image", "table"):
                    return t.type
                if t.type in ("text", "caption") and (
                    j in kinds
                    or t.type == "caption"
                    or _CAPTION_RE.match(t.text.strip())
                ):
                    j += step  # caption runs between body and caption
                    continue
                return None
            return None

        for i, b in enumerate(blocks):
            if i in kinds or b.type not in ("text", "caption"):
                continue
            # SEQ-flagged captions qualify without a Figure/Table prefix
            if b.type != "caption" and not _CAPTION_RE.match(b.text.strip()):
                continue
            btype = neighbor_body(i, -1) or neighbor_body(i, +1)
            if btype:
                kinds[i] = (
                    "table_caption" if btype == "table" else "img_caption"
                )
        return kinds

    def _tie_up_captions(
        self, kinds: dict[int, str]
    ) -> dict[int, list[tuple[str, str]]]:
        """Caption idx -> owning body via minimal effective index distance
        (reference: utils/magic_model_utils.py tie_up_category_by_index
        with include_bbox=False — index gaps made only of other captions
        don't count; ties go to the earlier body)."""
        blocks = self.blocks
        pending: dict[int, list[tuple[str, str]]] = {}
        for body_type, key in (("image", "img_caption"),
                               ("table", "table_caption")):
            subjects = [
                i for i, b in enumerate(blocks) if b.type == body_type
            ]
            objects = [i for i, k in kinds.items() if k == key]
            obj_set = set(objects)

            def eff_diff(oi: int, si: int) -> int:
                lo, hi = min(oi, si), max(oi, si)
                gap_objs = sum(
                    1 for k in range(lo + 1, hi) if k in obj_set
                )
                return (hi - lo) - gap_objs

            for oi in sorted(objects):
                cands = [
                    si for si in subjects
                    if blocks[si].page_idx == blocks[oi].page_idx
                ]
                if not cands:
                    continue
                best = min(cands, key=lambda si: (eff_diff(oi, si), si))
                pending.setdefault(best, []).append(
                    (key, blocks[oi].text)
                )
        return pending

    def to_content_list(self) -> list[dict]:
        items = []
        caption_for = self._classify_captions()
        pending = self._tie_up_captions(caption_for)
        for i, b in enumerate(self.blocks):
            if i in caption_for:
                continue
            if b.type == "title":
                items.append(
                    {"type": ContentType.TEXT, "text": b.text, "text_level": b.level,
                     "page_idx": b.page_idx}
                )
            elif b.type in ("text", "caption"):
                items.append({"type": ContentType.TEXT, "text": b.text,
                              "page_idx": b.page_idx})
            elif b.type == "table":
                item = {"type": ContentType.TABLE, "table_body": b.html,
                        "page_idx": b.page_idx}
                for key, text in pending.get(i, []):
                    item.setdefault(key, []).append(text)
                items.append(item)
            elif b.type == "image":
                item = {"type": ContentType.IMAGE, "img_path": b.image_name,
                        "page_idx": b.page_idx}
                for key, text in pending.get(i, []):
                    item.setdefault(key, []).append(text)
                items.append(item)
            elif b.type == "equation":
                items.append({"type": ContentType.EQUATION, "text": b.text,
                              "text_format": "latex", "page_idx": b.page_idx})
            elif b.type in ("header", "footer"):
                items.append({"type": b.type, "text": b.text,
                              "page_idx": b.page_idx})
            elif b.type in ("index", "list"):
                items.append({"type": b.type, "list_items": list(b.items),
                              "page_idx": b.page_idx})
        return items

    def to_middle_json(self) -> dict:
        pages: dict[int, list] = {}
        for b in self.blocks:
            pages.setdefault(b.page_idx, []).append(b)
        pdf_info = []
        for page_idx in sorted(pages) if pages else [0]:
            blocks_json = []
            discarded = []
            y = 0.0
            for b in pages.get(page_idx, []):
                bbox = [0.0, y, 600.0, y + 20.0]
                y += 24.0
                if b.type in ("header", "footer"):
                    discarded.append(
                        {
                            "type": BlockType.HEADER if b.type == "header"
                            else BlockType.FOOTER,
                            "bbox": bbox,
                            "lines": [
                                {
                                    "bbox": bbox,
                                    "spans": [
                                        {"bbox": bbox, "type": ContentType.TEXT,
                                         "content": b.text}
                                    ],
                                }
                            ],
                        }
                    )
                elif b.type in ("index", "list"):
                    blocks_json.append(
                        {
                            "type": BlockType.INDEX if b.type == "index"
                            else BlockType.LIST,
                            "bbox": bbox,
                            "lines": [
                                {
                                    "bbox": bbox,
                                    "spans": [
                                        {"bbox": bbox, "type": ContentType.TEXT,
                                         "content": it}
                                    ],
                                }
                                for it in b.items
                            ],
                        }
                    )
                elif b.type in ("text", "title", "caption"):
                    blocks_json.append(
                        {
                            "type": BlockType.TITLE if b.type == "title" else BlockType.TEXT,
                            "bbox": bbox,
                            **({"level": b.level} if b.type == "title" else {}),
                            "lines": [
                                {
                                    "bbox": bbox,
                                    "spans": [
                                        {"bbox": bbox, "type": ContentType.TEXT,
                                         "content": b.text}
                                    ],
                                }
                            ],
                        }
                    )
                elif b.type == "table":
                    blocks_json.append(
                        {
                            "type": BlockType.TABLE,
                            "bbox": bbox,
                            "blocks": [
                                {
                                    "type": BlockType.TABLE_BODY,
                                    "bbox": bbox,
                                    "lines": [
                                        {
                                            "bbox": bbox,
                                            "spans": [
                                                {"bbox": bbox,
                                                 "type": ContentType.TABLE,
                                                 "html": b.html}
                                            ],
                                        }
                                    ],
                                }
                            ],
                        }
                    )
                elif b.type == "image":
                    blocks_json.append(
                        {
                            "type": BlockType.IMAGE,
                            "bbox": bbox,
                            "blocks": [
                                {
                                    "type": BlockType.IMAGE_BODY,
                                    "bbox": bbox,
                                    "lines": [
                                        {
                                            "bbox": bbox,
                                            "spans": [
                                                {"bbox": bbox,
                                                 "type": ContentType.IMAGE,
                                                 "image_path": b.image_name.split("/")[-1]}
                                            ],
                                        }
                                    ],
                                }
                            ],
                        }
                    )
                elif b.type == "equation":
                    blocks_json.append(
                        {
                            "type": BlockType.INTERLINE_EQUATION,
                            "bbox": bbox,
                            "lines": [
                                {
                                    "bbox": bbox,
                                    "spans": [
                                        {"bbox": bbox,
                                         "type": ContentType.INTERLINE_EQUATION,
                                         "content": b.text}
                                    ],
                                }
                            ],
                        }
                    )
            pdf_info.append(
                {
                    "preproc_blocks": blocks_json,
                    "para_blocks": blocks_json,
                    "page_idx": page_idx,
                    "page_size": [600.0, max(y, 800.0)],
                    "discarded_blocks": discarded,
                }
            )
        return {
            "pdf_info": pdf_info,
            "_backend": "office",
            "_version_name": __version__,
        }


_CAPTION_RE = __import__("re").compile(
    r"^(图|表|圖|Figure|Fig\.?|Table|Chart|Diagram)\s*\d", __import__("re").I
)


def esc(text: str) -> str:
    return html_mod.escape(text, quote=False)


def wrap_inline_style(text: str, styles, syntax: str = "markdown") -> str:
    """Render one styled inline segment (reference: office_rich_text.py
    + mkcontent/inline_renderer.py _apply_markdown_style/_apply_html_style).

    styles: iterable of {bold, italic, underline, strikethrough,
    superscript, subscript}. syntax="markdown" uses **/*/~~ plus HTML
    tags for what markdown lacks; syntax="html" uses tags only (for
    segments that land inside HTML blocks; caller escapes `text` first).

    Whitespace-only text keeps only the visible styles
    (underline/strikethrough) and wraps the whitespace as-is; markdown
    delimiters hug the stripped core so they stay valid.
    """
    if not text:
        return text
    styles = set(styles)
    if not styles:
        return text
    html = syntax == "html"
    if not text.strip():
        if not (styles & {"underline", "strikethrough"}):
            return text
        core = text
        if "underline" in styles:
            core = f"<u>{core}</u>"
        if "strikethrough" in styles:
            core = f"<s>{core}</s>" if html else f"~~{core}~~"
        return core
    lead = text[: len(text) - len(text.lstrip())]
    trail = text[len(text.rstrip()):]
    core = text.strip()
    if "superscript" in styles:
        core = f"<sup>{core}</sup>"
    elif "subscript" in styles:
        core = f"<sub>{core}</sub>"
    if "underline" in styles:
        core = f"<u>{core}</u>"
    if "strikethrough" in styles:
        core = f"<s>{core}</s>" if html else f"~~{core}~~"
    bold, italic = "bold" in styles, "italic" in styles
    if html:
        if bold:
            core = f"<strong>{core}</strong>"
        if italic:
            core = f"<em>{core}</em>"
    elif bold and italic:
        core = f"***{core}***"
    elif bold:
        core = f"**{core}**"
    elif italic:
        core = f"*{core}*"
    return f"{lead}{core}{trail}"
