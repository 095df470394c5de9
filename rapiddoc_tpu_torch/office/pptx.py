"""PPTX -> blocks converter.

A copy of ``rapiddoc_tpu/office/pptx.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.

Behavioral counterpart of the reference pptx converter
(reference: rapid_doc/model/pptx/pptx_converter.py + xycut_pp_sorter.py):
slides in order; shapes sorted top-left-ish (XY-cut-lite on shape offsets);
titles, body text, tables, images.
"""
from __future__ import annotations

import io
import os
import re
import zipfile
from xml.etree import ElementTree as ET

from .common import NS, OfficeResult, esc, q
from .docx import _load_rels

A = NS["a"]
P = NS["p"]
_M_NS = NS["m"]
# the three node kinds that carry inline OMML in a pptx paragraph
_MATH_TAGS = frozenset({
    f"{{{NS['a14']}}}m",
    f"{{{_M_NS}}}oMath",
    f"{{{_M_NS}}}oMathPara",
})
_MC_NS = "http://schemas.openxmlformats.org/markup-compatibility/2006"


def _shape_xy(sp) -> tuple[int, int]:
    xfrm = sp.find(f".//{{{A}}}xfrm")
    if xfrm is not None:
        off = xfrm.find(f"{{{A}}}off")
        if off is not None:
            try:
                return int(off.get("y", "0")), int(off.get("x", "0"))
            except ValueError:
                pass
    return (1 << 60), (1 << 60)


def _run_style_key(rpr) -> tuple | None:
    """Hashable style signature of a run (None = unstyled)."""
    if rpr is None:
        return None
    key = (
        rpr.get("b") == "1",
        rpr.get("i") == "1",
        (rpr.get("u") or "none") != "none",
        (rpr.get("strike") or "noStrike") != "noStrike",
        rpr.get("baseline", "0"),
    )
    return key if any(key[:4]) or key[4] not in ("0", "") else None


def _wrap_run_style(text: str, rpr) -> str:
    """DrawingML run styling -> inline wrappers via the shared office
    renderer (reference: office_rich_text.py formatting; a:rPr
    b/i/u/strike/baseline attributes)."""
    if not text:
        return text
    styles = set()
    if rpr.get("b") == "1":
        styles.add("bold")
    if rpr.get("i") == "1":
        styles.add("italic")
    if (rpr.get("u") or "none") != "none":
        styles.add("underline")
    if (rpr.get("strike") or "noStrike") != "noStrike":
        styles.add("strikethrough")
    try:
        baseline = int(rpr.get("baseline", "0"))
    except ValueError:
        baseline = 0
    if baseline > 0:
        styles.add("superscript")
    elif baseline < 0:
        styles.add("subscript")
    from .common import wrap_inline_style

    return wrap_inline_style(text, styles)


def _sz_pt(rpr) -> float | None:
    """a:rPr/@sz is in hundredths of a point."""
    if rpr is None:
        return None
    sz = rpr.get("sz")
    if not sz:
        return None
    try:
        return int(sz) / 100.0
    except ValueError:
        return None


def _bold_of(rpr) -> bool | None:
    if rpr is None:
        return None
    b = rpr.get("b")
    if b is None:
        return None
    return b in ("1", "true")


def _para_font_sources(para, txbody) -> list:
    """rPr-like elements consulted after the run's own rPr: paragraph
    defRPr, then the txBody lstStyle level defRPr (reference:
    pptx_converter.py:1296-1368 _get_font_sources_from_* — the
    layout/master chain is approximated by the in-shape sources)."""
    sources = []
    ppr = para.find(f"{{{A}}}pPr")
    lvl = int(ppr.get("lvl", "0")) if ppr is not None else 0
    if ppr is not None:
        dpr = ppr.find(f"{{{A}}}defRPr")
        if dpr is not None:
            sources.append(dpr)
    lst = txbody.find(f"{{{A}}}lstStyle") if txbody is not None else None
    if lst is not None:
        lvl_ppr = lst.find(f"{{{A}}}lvl{lvl + 1}pPr")
        if lvl_ppr is not None:
            dpr = lvl_ppr.find(f"{{{A}}}defRPr")
            if dpr is not None:
                sources.append(dpr)
    end = para.find(f"{{{A}}}endParaRPr")
    if end is not None:
        sources.append(end)
    return sources


def _shape_style_profile(sp) -> dict:
    """(max effective font size, all-runs-bold) over the shape's
    non-whitespace runs (reference: _build_paragraph_style_profile
    pptx_converter.py:1454-1489), used for bold-size title promotion."""
    txbody = sp.find(f"{{{P}}}txBody")
    if txbody is None:
        txbody = sp.find(f"{{{A}}}txBody")
    size: float | None = None
    all_bold = True
    has_text = False
    if txbody is not None:
        for para in txbody.findall(f"{{{A}}}p"):
            sources = _para_font_sources(para, txbody)
            for r in para.findall(f"{{{A}}}r"):
                t = r.find(f"{{{A}}}t")
                if t is None or not (t.text or "").strip():
                    continue
                has_text = True
                rpr = r.find(f"{{{A}}}rPr")
                for src in (rpr, *sources):
                    s = _sz_pt(src)
                    if s is not None:
                        size = s if size is None else max(size, s)
                        break
                bold = None
                for src in (rpr, *sources):
                    bold = _bold_of(src)
                    if bold is not None:
                        break
                if bold is not True:
                    all_bold = False
    return {"font_size_pt": size, "all_bold": has_text and all_bold}


def _lststyle_bullet(txbody, lvl: int):
    """Fallback bullet definition from the shape's own lstStyle level
    (a deck whose bullets live in the text-body list style, not on each
    paragraph)."""
    lst = txbody.find(f"{{{A}}}lstStyle") if txbody is not None else None
    if lst is None:
        return None, None, None
    lvl_ppr = lst.find(f"{{{A}}}lvl{lvl + 1}pPr")
    if lvl_ppr is None:
        return None, None, None
    return (
        lvl_ppr.find(f"{{{A}}}buChar"),
        lvl_ppr.find(f"{{{A}}}buAutoNum"),
        lvl_ppr.find(f"{{{A}}}buNone"),
    )


def _shape_text(sp, rels: dict | None = None) -> list[str]:
    """Paragraph texts of a shape: runs joined (hyperlinks become
    markdown links via `rels`), `a:br` as newline, bullet paragraphs
    (`a:buChar`/`a:buAutoNum`, reference pptx_converter.py:1508-1560)
    prefixed as markdown list items with `a:pPr lvl` indentation; when a
    paragraph has no explicit bullet, the txBody lstStyle level bullet
    applies (reference: _parse_bullet_from_text_body_list_style:2143)."""
    out = []
    txbody = sp.find(f"{{{P}}}txBody")
    if txbody is None:
        txbody = sp.find(f"{{{A}}}txBody")
    if txbody is None:
        return out
    auto_counters: dict[int, int] = {}
    for para in txbody.findall(f"{{{A}}}p"):
        # (text, rpr-or-None, link-target) segments; adjacent runs with
        # identical styling+link merge before wrapping so split runs
        # don't emit "**bo****ld**"
        segs: list[list] = []
        for el in para:
            if el.tag == f"{{{A}}}r":
                t = el.find(f"{{{A}}}t")
                if t is None or not t.text:
                    continue
                rpr = el.find(f"{{{A}}}rPr")
                link = None
                if rpr is not None and rels:
                    hl = rpr.find(f"{{{A}}}hlinkClick")
                    if hl is not None:
                        target = rels.get(hl.get(q("r:id")))
                        if target and target.startswith(
                            ("http://", "https://")
                        ):
                            link = target
                key = (_run_style_key(rpr), link)
                if segs and segs[-1][1] == key:
                    segs[-1][0] += t.text
                else:
                    segs.append([t.text, key, rpr])
            elif el.tag == f"{{{A}}}br":
                segs.append(["\n", (None, None), None])
            elif el.tag in _MATH_TAGS:
                # a14:m-wrapped, bare m:oMath, or m:oMathPara equation
                # inline in the paragraph -> $latex$ at its run position
                # (explicit tag set like the reference's
                # _is_math_content_node — endswith('}m') would match
                # local name 'm' in ANY namespace and miss oMathPara)
                from .omml import omml_to_latex

                maths = (
                    [el] if el.tag == f"{{{_M_NS}}}oMath"
                    else el.findall(f"{{{_M_NS}}}oMath")
                    or [
                        d for d in el.iter()
                        if d.tag == f"{{{_M_NS}}}oMath"
                    ]
                )
                for om in maths:
                    latex = omml_to_latex(om)
                    if latex:
                        segs.append([f"${latex}$", (None, None), None])
        parts = []
        for seg_text, (style_key, link), rpr in segs:
            if rpr is not None and style_key:
                seg_text = _wrap_run_style(seg_text, rpr)
            if link:
                seg_text = f"[{seg_text}]({link})"
            parts.append(seg_text)
        text = "".join(parts).strip()
        if not text:
            continue
        ppr = para.find(f"{{{A}}}pPr")
        lvl = int(ppr.get("lvl", "0")) if ppr is not None else 0
        bu_char = ppr.find(f"{{{A}}}buChar") if ppr is not None else None
        bu_auto = ppr.find(f"{{{A}}}buAutoNum") if ppr is not None else None
        bu_none = ppr.find(f"{{{A}}}buNone") if ppr is not None else None
        if bu_char is None and bu_auto is None and bu_none is None:
            bu_char, bu_auto, bu_none = _lststyle_bullet(txbody, lvl)
        if bu_auto is not None and bu_none is None:
            auto_counters[lvl] = auto_counters.get(lvl, 0) + 1
            for deeper in [k for k in auto_counters if k > lvl]:
                auto_counters.pop(deeper)
            text = "  " * lvl + f"{auto_counters[lvl]}. " + text
        elif bu_char is not None and bu_none is None:
            text = "  " * lvl + "- " + text
        out.append(text)
    return out


def _is_title(sp) -> bool:
    ph = sp.find(f".//{{{P}}}ph")
    return ph is not None and (ph.get("type") in ("title", "ctrTitle"))


def _table_to_html(tbl) -> str:
    rows = []
    for tr in tbl.findall(f"{{{A}}}tr"):
        cells = []
        for tc in tr.findall(f"{{{A}}}tc"):
            if tc.get("hMerge") == "1" or tc.get("vMerge") == "1":
                continue
            attrs = ""
            span = tc.get("gridSpan")
            if span and span != "1":
                attrs += f' colspan="{span}"'
            rowspan = tc.get("rowSpan")
            if rowspan and rowspan != "1":
                attrs += f' rowspan="{rowspan}"'
            text = "\n".join(_shape_text(tc) or [""]) or "\n".join(
                t.text or "" for t in tc.iter(f"{{{A}}}t")
            )
            cells.append(f"<td{attrs}>{esc(text.strip())}</td>")
        rows.append("<tr>" + "".join(cells) + "</tr>")
    return "<table>" + "".join(rows) + "</table>"


def _shape_wh(sp) -> tuple[int, int]:
    xfrm = sp.find(f".//{{{A}}}xfrm")
    if xfrm is not None:
        ext = xfrm.find(f"{{{A}}}ext")
        if ext is not None:
            try:
                return int(ext.get("cx", "0")), int(ext.get("cy", "0"))
            except ValueError:
                pass
    return 0, 0


def _sort_shapes(items: list[tuple]) -> list[tuple]:
    """Reading order for slide shapes via XY-cut over their boxes
    (reference: rapid_doc/model/pptx/xycut_pp_sorter.py); items are
    (y, x, w, h, kind, payload) falling back to (y, x) sort when any
    extent is unknown."""
    if len(items) < 2 or any(it[2] <= 0 or it[3] <= 0 for it in items):
        return sorted(items, key=lambda it: (it[0], it[1]))
    from ..reading_order.xycut import sort_boxes_reading_order

    boxes = [[it[1], it[0], it[1] + it[2], it[0] + it[3]] for it in items]
    order = sort_boxes_reading_order(boxes)
    return [items[i] for i in order]


# (scale_x, scale_y, trans_x, trans_y): child EMU -> slide EMU
_IDENTITY = (1.0, 1.0, 0.0, 0.0)


def _compose_group_transform(grp, outer) -> tuple[float, float, float, float]:
    """Group shapes position children in a child coordinate space
    (`a:chOff`/`a:chExt`) mapped onto the group's own box (`a:off`/
    `a:ext`) — compose that affine map with the outer transform
    (reference: pptx_converter.py:342 _group_shape_transform)."""
    xfrm = grp.find(f"{{{P}}}grpSpPr/{{{A}}}xfrm")
    if xfrm is None:
        return outer
    def _pt(el, default=(0, 0)):
        if el is None:
            return default
        try:
            return int(el.get("x", el.get("cx", "0"))), int(
                el.get("y", el.get("cy", "0"))
            )
        except ValueError:
            return default
    ox, oy = _pt(xfrm.find(f"{{{A}}}off"))
    ex, ey = _pt(xfrm.find(f"{{{A}}}ext"), (1, 1))
    cox, coy = _pt(xfrm.find(f"{{{A}}}chOff"))
    cex, cey = _pt(xfrm.find(f"{{{A}}}chExt"), (ex, ey))
    sx = ex / cex if cex else 1.0
    sy = ey / cey if cey else 1.0
    # child -> group-local -> outer
    osx, osy, otx, oty = outer
    return (
        osx * sx,
        osy * sy,
        otx + osx * (ox - sx * cox),
        oty + osy * (oy - sy * coy),
    )


def _collect_shapes(tree, z, rels, tf) -> list[tuple]:
    """Walk an spTree, recursing into p:grpSp with composed transforms;
    returns (y, x, w, h, kind, payload) items in slide coordinates."""
    sx, sy, tx, ty = tf
    items: list[tuple] = []

    def _place(el):
        y, x = _shape_xy(el)
        w, h = _shape_wh(el)
        if x >= (1 << 60) or y >= (1 << 60):
            return y, x, w, h
        return (
            int(ty + sy * y),
            int(tx + sx * x),
            int(sx * w),
            int(sy * h),
        )

    for el in tree:
        if el.tag == f"{{{_MC_NS}}}AlternateContent":
            # take mc:Choice (richer content: equations, new drawing
            # features); mc:Fallback duplicates it as a picture
            branch = el.find(f"{{{_MC_NS}}}Choice")
            if branch is None:
                branch = el.find(f"{{{_MC_NS}}}Fallback")
            if branch is not None:
                items.extend(_collect_shapes(branch, z, rels, tf))
        elif el.tag == f"{{{P}}}grpSp":
            items.extend(
                _collect_shapes(el, z, rels, _compose_group_transform(el, tf))
            )
        elif el.tag == f"{{{P}}}sp":
            texts = _shape_text(el, rels)
            if not texts:
                continue
            y, x, w, h = _place(el)
            kind = "title" if _is_title(el) else "text"
            items.append((y, x, w, h, kind, texts, _shape_style_profile(el)))
        elif el.tag == f"{{{P}}}graphicFrame":
            y, x, w, h = _place(el)
            tbl = el.find(f".//{{{A}}}tbl")
            if tbl is not None:
                items.append((y, x, w, h, "table", _table_to_html(tbl), None))
            else:
                from .chart import chart_part_to_html, find_chart_refs

                for chart_path in find_chart_refs(el, rels):
                    html = chart_part_to_html(z, chart_path)
                    if html:
                        items.append((y, x, w, h, "table", html, None))
        elif el.tag == f"{{{P}}}pic":
            y, x, w, h = _place(el)
            blip = el.find(f".//{{{A}}}blip")
            if blip is not None:
                rid = blip.get(q("r:embed"))
                target = rels.get(rid)
                if target and target in z.namelist():
                    items.append(
                        (y, x, w, h, "image",
                         (os.path.basename(target), z.read(target)), None)
                    )
    return items


# decorative-picture thresholds (reference: pptx_converter.py:38-40)
_MIN_PIC_DIM_RATIO = 0.1
_MIN_PIC_AREA_RATIO = 0.01
_BG_PIC_TEXT_COVERAGE = 0.1


def _filter_pictures(items: list[tuple], sw: int, sh: int) -> list[tuple]:
    """Drop decorative pictures: tiny ones (below 10% of a slide
    dimension or 1% of its area) and background pictures whose box is
    covered >=10% by text shapes drawn ABOVE them in z-order
    (reference: _should_skip_picture pptx_converter.py:470-546)."""
    if sw <= 0 or sh <= 0:
        return items
    out = []
    for i, it in enumerate(items):
        y, x, w, h, kind = it[:5]
        if kind != "image" or w <= 0 or h <= 0:
            out.append(it)
            continue
        if (
            w < _MIN_PIC_DIM_RATIO * sw
            or h < _MIN_PIC_DIM_RATIO * sh
            or (w * h) / float(sw * sh) < _MIN_PIC_AREA_RATIO
        ):
            continue
        # union area of text-shape overlaps from later (on-top) shapes
        overlaps = []
        for jt in items[i + 1 :]:
            jy, jx, jw, jh, jkind = jt[:5]
            if jkind not in ("text", "title") or jw <= 0 or jh <= 0:
                continue
            ox0, oy0 = max(x, jx), max(y, jy)
            ox1, oy1 = min(x + w, jx + jw), min(y + h, jy + jh)
            if ox1 > ox0 and oy1 > oy0:
                overlaps.append((ox0, oy0, ox1, oy1))
        if overlaps:
            covered = _union_area(overlaps)
            if covered / float(w * h) >= _BG_PIC_TEXT_COVERAGE:
                continue
        out.append(it)
    return out


def _union_area(rects: list[tuple]) -> float:
    """Union area of axis-aligned rectangles by x-sweep with interval
    merge (reference: _rectangles_union_area pptx_converter.py:406)."""
    xs = sorted({r[0] for r in rects} | {r[2] for r in rects})
    total = 0.0
    for x0, x1 in zip(xs, xs[1:]):
        if x1 <= x0:
            continue
        spans = sorted(
            (r[1], r[3]) for r in rects if r[0] <= x0 and r[2] >= x1
        )
        covered = 0.0
        cur0 = cur1 = None
        for s0, s1 in spans:
            if cur1 is None or s0 > cur1:
                if cur1 is not None:
                    covered += cur1 - cur0
                cur0, cur1 = s0, s1
            else:
                cur1 = max(cur1, s1)
        if cur1 is not None:
            covered += cur1 - cur0
        total += covered * (x1 - x0)
    return total


def _promote_bold_titles(emitted: list[dict]) -> None:
    """Bold-size title promotion over one slide's text blocks
    (reference: _promote_slide_text_blocks_to_titles
    pptx_converter.py:1706-1824): the unique largest all-bold block at
    >= body+4pt becomes a level-2 title; then the largest remaining
    all-bold size >= body+2 and <= level2-2 becomes level-3 titles."""
    sizes = [
        b["profile"]["font_size_pt"]
        for b in emitted
        if b["kind"] == "text" and b["profile"]
        and b["profile"]["font_size_pt"] is not None
        and not b["profile"]["all_bold"]
    ]
    body = max(set(sizes), key=sizes.count) if sizes else None
    bold_blocks = [
        b for b in emitted
        if b["kind"] == "text" and b["profile"]
        and b["profile"]["all_bold"]
        and b["profile"]["font_size_pt"] is not None
    ]
    if not bold_blocks:
        return
    level2_size = max(b["profile"]["font_size_pt"] for b in bold_blocks)
    l2 = [b for b in bold_blocks if b["profile"]["font_size_pt"] == level2_size]
    if len(l2) != 1:
        return
    if body is not None and level2_size < body + 4:
        return

    def _entitle(b: dict, level: int) -> None:
        b["kind"] = "title"
        b["level"] = level
        # the heading prefix carries the emphasis; bold markers would
        # render as "## **x**"
        b["payload"] = [t.replace("**", "") for t in b["payload"]]

    _entitle(l2[0], 2)
    if body is None:
        return
    l3_sizes = sorted(
        {
            b["profile"]["font_size_pt"]
            for b in bold_blocks
            if b["kind"] == "text"
            and b["profile"]["font_size_pt"] < level2_size
        },
        reverse=True,
    )
    if not l3_sizes:
        return
    level3_size = l3_sizes[0]
    if level3_size < body + 2 or level2_size < level3_size + 2:
        return
    for b in bold_blocks:
        if b["kind"] == "text" and b["profile"]["font_size_pt"] == level3_size:
            _entitle(b, 3)


def pptx_to_blocks(data: bytes) -> OfficeResult:
    result = OfficeResult()
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        # slide order + slide dimensions from presentation.xml + its rels
        slides: list[str] = []
        slide_w = slide_h = 0
        if "ppt/presentation.xml" in z.namelist():
            pres_rels = _load_rels(z, "ppt/presentation.xml")
            root = ET.fromstring(z.read("ppt/presentation.xml"))
            sldsz = root.find(f"{{{P}}}sldSz")
            if sldsz is not None:
                try:
                    slide_w = int(sldsz.get("cx", "0"))
                    slide_h = int(sldsz.get("cy", "0"))
                except ValueError:
                    pass
            for sld in root.iter(f"{{{P}}}sldId"):
                rid = sld.get(q("r:id"))
                target = pres_rels.get(rid)
                if target and target in z.namelist():
                    slides.append(target)
        if not slides:
            slides = sorted(
                (n for n in z.namelist()
                 if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
                key=lambda n: int(re.search(r"(\d+)", n).group(1)),
            )
        result.n_pages = len(slides)

        for page_idx, slide_path in enumerate(slides):
            rels = _load_rels(z, slide_path)
            try:
                root = ET.fromstring(z.read(slide_path))
            except (ET.ParseError, KeyError):
                # per-slide failure isolation (reference: per-page skip,
                # cli/common.py:138-144): one corrupt slide must not
                # take the deck's other slides down
                continue
            tree = root.find(f"{{{P}}}cSld/{{{P}}}spTree")
            if tree is None:
                continue
            items = _collect_shapes(tree, z, rels, _IDENTITY)
            items = _filter_pictures(items, slide_w, slide_h)
            items = _sort_shapes(items)
            notes = _slide_notes(z, slide_path, rels)
            emitted = [
                {"kind": it[4], "payload": it[5], "profile": it[6],
                 "level": 1}
                for it in items
            ]
            _promote_bold_titles(emitted)
            for b in emitted:
                kind, payload = b["kind"], b["payload"]
                if kind == "title":
                    if isinstance(payload, list):
                        result.add_title(
                            payload[0], level=b["level"], page=page_idx
                        )
                        for extra in payload[1:]:
                            result.add_text(extra, page=page_idx)
                    else:
                        result.add_title(
                            payload, level=b["level"], page=page_idx
                        )
                elif kind == "text":
                    result.add_text("\n".join(payload), page=page_idx)
                elif kind == "table":
                    result.add_table(payload, page=page_idx)
                elif kind == "image":
                    name, img = payload
                    result.add_image(f"s{page_idx}_{name}", img, page=page_idx)
            for note in notes:
                result.add_text(note, page=page_idx)
    return result


def _slide_notes(z, slide_path: str, rels: dict) -> list[str]:
    """Speaker-notes paragraphs for a slide, appended after the slide
    body (reference: pptx_converter.py:548 _handle_slide_notes emits
    them as page footnotes). Slide-number/metadata placeholders are
    skipped; bare page numbers are dropped."""
    notes_path = next(
        (t for t in rels.values() if "notesSlide" in t and t in z.namelist()),
        None,
    )
    if notes_path is None:
        return []
    try:
        root = ET.fromstring(z.read(notes_path))
    except ET.ParseError:
        return []
    out: list[str] = []
    for sp in root.iter(f"{{{P}}}sp"):
        ph = sp.find(f".//{{{P}}}ph")
        if ph is not None and ph.get("type") in ("sldNum", "dt", "ftr", "sldImg"):
            continue
        for text in _shape_text(sp):
            if text.strip().isdigit():
                continue
            out.append(text)
    return out
