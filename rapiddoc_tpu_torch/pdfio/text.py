"""Native text extraction: chars -> spans -> lines -> blocks.

Produces the page dict shape the pipeline consumes (capability parity with
reference rapid_doc/utils/pdf_text_tool.py get_page(), which wraps
pdfium/pdftext). Coordinates are top-left-origin page points.
"""
from __future__ import annotations

import math
from typing import Any

from .content import ContentInterpreter, Matrix, mat_apply, mat_mul
from .document import PdfPage
from .fonts import Font


def page_base_ctm(page: PdfPage, scale: float = 1.0) -> Matrix:
    """PDF user space -> top-left-origin device space at `scale`, honoring /Rotate."""
    x0, y0, x1, y1 = page.cropbox
    w, h = x1 - x0, y1 - y0
    rot = page.rotation
    # translate cropbox origin to 0, flip y, then rotate
    base: Matrix = (1, 0, 0, -1, -x0, y1)  # now y down, origin top-left
    if rot == 90:
        # rotate page 90° clockwise for display: (x,y)->(h-y, x) in y-down coords
        base = mat_mul(base, (0, 1, -1, 0, h, 0))
    elif rot == 180:
        base = mat_mul(base, (-1, 0, 0, -1, w, h))
    elif rot == 270:
        base = mat_mul(base, (0, -1, 1, 0, 0, w))
    if scale != 1.0:
        base = mat_mul(base, (scale, 0, 0, scale, 0, 0))
    return base


class TextExtractor(ContentInterpreter):
    def __init__(self, page: PdfPage):
        super().__init__(page)
        self.chars: list[dict] = []
        self._run_cache: dict = {}

    def on_show_char(
        self, code: int, text: str, trm: Matrix, advance: float, font: Font
    ) -> None:
        record_char(
            self.chars, self.gs, code, text, trm, advance, font,
            self._run_cache,
        )


def record_char(
    chars: list[dict], gs, code: int, text: str, trm: Matrix,
    advance: float, font: Font, cache: dict | None = None,
) -> None:
    """Append one char record (shared by the text-only extractor and the
    fused render+text pass).

    The advance box is (0,descent)-(adv_text,ascent) in text space mapped
    through trm. Everything except trm's translation and the per-char
    advance is constant across a text run, so with a `cache` dict the
    rotation / size / vertical-extent terms are computed once per
    (linear-trm, font, font-state) key instead of per char.
    """
    if gs.render_mode == 3 and not text:
        return
    a, b, c, d, e, f = trm
    fs = gs.font_size
    run = None
    if cache is not None:
        rkey = (a, b, c, d, id(font), fs, gs.h_scale)
        run = cache.get(rkey)
    if run is None:
        asc, desc = font.ascent, font.descent
        fsh = fs * (gs.h_scale or 1.0) if fs else 0.0
        run = (
            math.degrees(math.atan2(b, a)) % 360.0,  # rotation
            math.hypot(c, d),  # size: vertical extent scale
            c * desc, c * asc,  # x components of the asc/desc corners
            d * desc, d * asc,  # y components
            fsh,
            font.base_font,
            font.is_cid,
            # CID font lacking a ToUnicode CMap: its text is unmappable
            # (classifier signal, reference pdf_classify.py CID usage)
            font.is_cid and not getattr(font, "has_to_unicode", True),
        )
        if cache is not None:
            if len(cache) > 4096:
                cache.clear()
            cache[rkey] = run
    (rotation, size, cdx, cax, ddy, day, fsh,
     base_font, is_cid, no_tu) = run
    adv_text = advance / fsh if fsh else 0.0
    adva, advb = a * adv_text, b * adv_text
    # the four advance-box corners, same float-op order as mat_apply
    x0, x1 = cdx + e, cax + e
    x2, x3 = (adva + cdx) + e, (adva + cax) + e
    y0, y1 = ddy + f, day + f
    y2, y3 = (advb + ddy) + f, (advb + day) + f
    chars.append(
        {
            "char": text,
            "code": code,
            "bbox": [min(x0, x1, x2, x3), min(y0, y1, y2, y3),
                     max(x0, x1, x2, x3), max(y0, y1, y2, y3)],
            "origin": [e, f],
            "rotation": rotation,
            "size": size,
            "font": base_font,
            "cid": is_cid,
            "no_tounicode_cid": no_tu,
        }
    )


def _dedup_chars(chars: list[dict]) -> list[dict]:
    """Drop identical chars drawn at (nearly) the same position (fake bold)."""
    seen: set = set()
    out = []
    for ch in chars:
        key = (ch["char"], round(ch["origin"][0], 1), round(ch["origin"][1], 1))
        if key in seen:
            continue
        seen.add(key)
        out.append(ch)
    return out


def _group_spans(chars: list[dict], line_gap_ratio: float = 0.5) -> list[dict]:
    """Consecutive chars (content order) with same font/size/rotation and
    contiguous baseline form a span."""
    spans: list[dict] = []
    cur: list[dict] = []

    def flush() -> None:
        if not cur:
            return
        # Synthesize word spaces from kerning gaps (many PDFs encode spaces
        # as TJ adjustments, not space glyphs)
        pieces = []
        for k, c in enumerate(cur):
            if k > 0:
                prev = cur[k - 1]
                gap = c["bbox"][0] - prev["bbox"][2]
                sz = max(prev["size"], 1e-3)
                if gap > 0.22 * sz and prev["char"] != " " and c["char"] != " ":
                    pieces.append(" ")
            pieces.append(c["char"])
        text = "".join(pieces)
        xs0 = [c["bbox"][0] for c in cur]
        ys0 = [c["bbox"][1] for c in cur]
        xs1 = [c["bbox"][2] for c in cur]
        ys1 = [c["bbox"][3] for c in cur]
        spans.append(
            {
                "text": text,
                "bbox": [min(xs0), min(ys0), max(xs1), max(ys1)],
                "font": cur[0]["font"],
                "size": cur[0]["size"],
                "rotation": cur[0]["rotation"],
                "chars": list(cur),
            }
        )
        cur.clear()

    for ch in chars:
        if not ch["char"] and ch["bbox"][2] - ch["bbox"][0] <= 0:
            continue
        if cur:
            prev = cur[-1]
            same_style = (
                prev["font"] == ch["font"]
                and abs(prev["size"] - ch["size"]) < 0.1 + 0.1 * prev["size"]
                and abs(prev["rotation"] - ch["rotation"]) < 1.0
            )
            sz = max(prev["size"], 1e-3)
            dy = abs(ch["origin"][1] - prev["origin"][1])
            dx = ch["bbox"][0] - prev["bbox"][2]
            horizontal = prev["rotation"] % 180 < 1 or prev["rotation"] % 180 > 179
            if horizontal:
                baseline_ok = dy < 0.25 * sz
                gap_ok = -2.0 * sz < dx < 1.2 * sz
            else:
                baseline_ok = abs(ch["origin"][0] - prev["origin"][0]) < 0.25 * sz
                gap_ok = True
            if not (same_style and baseline_ok and gap_ok):
                flush()
        cur.append(ch)
    flush()
    return spans


def _group_lines(spans: list[dict]) -> list[dict]:
    """Spans sharing a baseline-ish y band form a line."""
    lines: list[dict] = []
    used = [False] * len(spans)
    order = sorted(
        range(len(spans)), key=lambda i: (spans[i]["bbox"][1], spans[i]["bbox"][0])
    )
    for i in order:
        if used[i]:
            continue
        base = spans[i]
        group = [i]
        used[i] = True
        bb = list(base["bbox"])
        h = max(bb[3] - bb[1], 1e-3)
        for j in order:
            if used[j]:
                continue
            sb = spans[j]["bbox"]
            if abs(spans[j]["rotation"] - base["rotation"]) > 1.0:
                continue
            overlap = min(bb[3], sb[3]) - max(bb[1], sb[1])
            if overlap > 0.5 * min(h, sb[3] - sb[1]):
                group.append(j)
                used[j] = True
                bb = [
                    min(bb[0], sb[0]), min(bb[1], sb[1]),
                    max(bb[2], sb[2]), max(bb[3], sb[3]),
                ]
        group_spans = sorted((spans[j] for j in group), key=lambda s: s["bbox"][0])
        lines.append(
            {
                "bbox": bb,
                "spans": group_spans,
                "rotation": base["rotation"],
                "text": " ".join(s["text"] for s in group_spans),
            }
        )
    lines.sort(key=lambda ln: (ln["bbox"][1], ln["bbox"][0]))
    return lines


def _group_blocks(lines: list[dict]) -> list[dict]:
    """Vertically-adjacent lines with x-overlap form a block."""
    blocks: list[dict] = []
    for line in lines:
        h = max(line["bbox"][3] - line["bbox"][1], 1e-3)
        attached = None
        for block in blocks:
            bb = block["bbox"]
            gap = line["bbox"][1] - bb[3]
            x_ov = min(bb[2], line["bbox"][2]) - max(bb[0], line["bbox"][0])
            if -h * 0.5 <= gap < h * 0.8 and x_ov > 0:
                attached = block
                break
        if attached is None:
            blocks.append({"bbox": list(line["bbox"]), "lines": [line]})
        else:
            attached["lines"].append(line)
            bb = attached["bbox"]
            attached["bbox"] = [
                min(bb[0], line["bbox"][0]), min(bb[1], line["bbox"][1]),
                max(bb[2], line["bbox"][2]), max(bb[3], line["bbox"][3]),
            ]
    return blocks


def get_page(page: PdfPage) -> dict[str, Any]:
    """Extract the native-text structure of one page (top-left origin, points)."""
    extractor = TextExtractor(page)
    try:
        extractor.run(page_base_ctm(page))
    except Exception:
        pass
    return build_page_dict(page, extractor.chars)


def build_page_dict(page: PdfPage, raw_chars: list[dict]) -> dict[str, Any]:
    """Char records (page points) -> the page text-structure dict."""
    chars = _dedup_chars(raw_chars)
    spans = _group_spans(chars)
    lines = _group_lines(spans)
    blocks = _group_blocks(lines)
    w, h = page.size
    return {
        "size": (w, h),
        "bbox": page.cropbox,
        "width": math.ceil(w),
        "height": math.ceil(h),
        "rotation": page.rotation,
        "blocks": blocks,
        "char_count": len(chars),
    }


def page_text(page: PdfPage) -> str:
    info = get_page(page)
    out = []
    for block in info["blocks"]:
        for line in block["lines"]:
            out.append(line["text"])
    return "\n".join(out)
