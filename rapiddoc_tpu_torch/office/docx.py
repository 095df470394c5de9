"""DOCX -> blocks converter (pure OOXML walk over zip+XML).

A copy of ``rapiddoc_tpu/office/docx.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.

Behavioral counterpart of the reference docx converter
(reference: rapid_doc/model/docx/docx_converter.py + main.py:12): body
paragraphs with heading styles, runs + hyperlinks, OMML math -> LaTeX,
tables (gridSpan/vMerge -> HTML), embedded images, numbered/bulleted lists.
"""
from __future__ import annotations

import io
import os
import re
import zipfile
from xml.etree import ElementTree as ET

from .common import NS, OfficeResult, esc, q
from .omml import omml_to_latex

_HEADING_RE = re.compile(r"(?:heading|biaoti)\s*([1-6])", re.I)


def _load_rels(z: zipfile.ZipFile, part: str) -> dict[str, str]:
    """rels for a part: rId -> target path (resolved)."""
    base = os.path.dirname(part)
    rels_path = f"{base}/_rels/{os.path.basename(part)}.rels"
    out: dict[str, str] = {}
    if rels_path not in z.namelist():
        return out
    try:
        root = ET.fromstring(z.read(rels_path))
    except ET.ParseError:
        # a corrupt rels part degrades links/images to plain text; it
        # must never take the document's own text down with it
        return out
    for rel in root:
        rid = rel.get("Id")
        target = rel.get("Target") or ""
        mode = rel.get("TargetMode")
        if mode == "External":
            out[rid] = target
        else:
            resolved = os.path.normpath(os.path.join(base, target)).replace("\\", "/")
            out[rid] = resolved
    return out


def _styles_root(z: zipfile.ZipFile):
    if "word/styles.xml" not in z.namelist():
        return None
    try:
        return ET.fromstring(z.read("word/styles.xml"))
    except ET.ParseError:
        return None


def _style_headings(z: zipfile.ZipFile) -> dict[str, int]:
    """styleId -> heading level from styles.xml: "Heading N"-named styles
    first, then styles whose basedOn chain carries w:outlineLvl 0-8
    (reference: docx_converter _get_heading_and_level +
    _get_effective_outline_level — a custom style based on a heading, or
    any style with an outline level, titles its paragraphs too)."""
    out: dict[str, int] = {}
    root = _styles_root(z)
    if root is None:
        return out
    by_id: dict[str, ET.Element] = {}
    for style in root.findall(q("w:style")):
        sid = style.get(q("w:styleId"))
        if sid:
            by_id[sid] = style
        name_el = style.find(q("w:name"))
        name = name_el.get(q("w:val")) if name_el is not None else ""
        m = _HEADING_RE.search(name or "") or _HEADING_RE.search(sid or "")
        if m and sid:
            out[sid] = int(m.group(1))
    # outline-level fallback, following the basedOn chain (depth-capped)
    for sid, style in by_id.items():
        if sid in out:
            continue
        cur, seen = style, set()
        while cur is not None and len(seen) < 8:
            ppr = cur.find(q("w:pPr"))
            lvl = ppr.find(q("w:outlineLvl")) if ppr is not None else None
            if lvl is not None:
                try:
                    v = int(lvl.get(q("w:val"), "9"))
                except ValueError:
                    break
                if 0 <= v <= 8:
                    out[sid] = v + 1
                break
            based = cur.find(q("w:basedOn"))
            parent = based.get(q("w:val")) if based is not None else None
            if not parent or parent in seen:
                break
            seen.add(parent)
            cur = by_id.get(parent)
    return out


def _char_styles(z: zipfile.ZipFile) -> dict[str, frozenset]:
    """styleId -> inline style set for character styles, with basedOn
    inheritance (reference: docx_converter
    _resolve_run_bool_with_inheritance — a run styled via w:rStyle
    "Strong" is bold even with no direct w:b)."""
    root = _styles_root(z)
    if root is None:
        return {}
    by_id: dict[str, ET.Element] = {}
    for style in root.findall(q("w:style")):
        sid = style.get(q("w:styleId"))
        if sid and style.get(q("w:type")) == "character":
            by_id[sid] = style
    out: dict[str, frozenset] = {}

    def resolve(sid: str, seen: frozenset) -> frozenset:
        if sid in out:
            return out[sid]
        style = by_id.get(sid)
        if style is None or sid in seen:
            return frozenset()
        rpr = style.find(q("w:rPr"))
        s = set(_rpr_style(rpr)) if rpr is not None else set()
        based = style.find(q("w:basedOn"))
        if based is not None:
            parent = based.get(q("w:val"))
            if parent:
                # direct flags win; inherit the rest
                s |= set(resolve(parent, seen | {sid}))
        out[sid] = frozenset(s)
        return out[sid]

    for sid in by_id:
        resolve(sid, frozenset())
    return out


_MC_FALLBACK = (
    "{http://schemas.openxmlformats.org/markup-compatibility/2006}Fallback"
)
_MC_ALTERNATE = (
    "{http://schemas.openxmlformats.org/markup-compatibility/2006}"
    "AlternateContent"
)


def _textbox_contents(el) -> list:
    """w:txbxContent descendants, excluding mc:Fallback duplicates."""
    out: list = []

    def walk(node):
        for c in node:
            if c.tag == _MC_FALLBACK:
                continue
            if c.tag == q("w:txbxContent"):
                out.append(c)
            else:
                walk(c)

    walk(el)
    return out


def _rpr_style(rpr) -> frozenset:
    """Inline style set from a w:rPr element (reference:
    office_rich_text.py formatting_to_style_str — bold/italic/underline/
    strikethrough/super/subscript)."""
    if rpr is None:
        return frozenset()
    s = set()

    def on(tag: str) -> bool:
        el = rpr.find(q(tag))
        return el is not None and el.get(q("w:val"), "1") not in (
            "0", "false", "none"
        )

    if on("w:b"):
        s.add("bold")
    if on("w:i"):
        s.add("italic")
    if on("w:strike"):
        s.add("strikethrough")
    u = rpr.find(q("w:u"))
    if u is not None and u.get(q("w:val"), "single") != "none":
        s.add("underline")
    va = rpr.find(q("w:vertAlign"))
    if va is not None:
        v = va.get(q("w:val"))
        if v == "superscript":
            s.add("superscript")
        elif v == "subscript":
            s.add("subscript")
    return frozenset(s)


def _run_style(r, char_styles: dict[str, frozenset] | None = None) -> frozenset:
    """Inline style set of a run: direct w:rPr flags, inheriting from its
    w:rStyle character style chain when present."""
    rpr = r.find(q("w:rPr"))
    direct = _rpr_style(rpr)
    if char_styles and rpr is not None:
        rstyle = rpr.find(q("w:rStyle"))
        if rstyle is not None:
            inherited = char_styles.get(rstyle.get(q("w:val")) or "")
            if inherited:
                # explicit off-toggles (w:b w:val="0") must beat the
                # style: recompute direct "off" flags
                off = set()
                for tag, key in (("w:b", "bold"), ("w:i", "italic"),
                                 ("w:strike", "strikethrough")):
                    el = rpr.find(q(tag))
                    if el is not None and el.get(q("w:val"), "1") in (
                        "0", "false", "none"
                    ):
                        off.add(key)
                return frozenset((set(inherited) | set(direct)) - off)
    return direct


def _is_hidden_run(r) -> bool:
    """w:vanish / w:webHidden runs render nowhere (reference:
    docx_converter._is_hidden_run:377-391)."""
    rpr = r.find(q("w:rPr"))
    if rpr is None:
        return False
    for tag in ("w:vanish", "w:webHidden"):
        el = rpr.find(q(tag))
        if el is not None and el.get(q("w:val"), "1") not in (
            "0", "false", "none"
        ):
            return True
    return False


def _wrap_style(text: str, style: frozenset) -> str:
    """Render one styled segment as markdown (shared helper; reference
    inline_renderer.py wrapper mapping)."""
    from .common import wrap_inline_style

    return wrap_inline_style(text, style)


def _para_text(
    p, rels: dict[str, str], rich: bool = False, math: bool = True,
    char_styles: dict[str, frozenset] | None = None,
) -> str:
    """Concatenate run text, tabs, breaks and hyperlinks of a paragraph.
    With rich=True, adjacent same-style runs merge and render with
    markdown/HTML inline styling (body paragraphs; table cells and
    titles stay plain because their text is escaped/prefixed later).
    With math=True, OMML equations render inline as ``$latex$`` at
    their position in the run sequence (reference: docx_converter
    `_build_text_with_equations_and_hyperlinks`); pass math=False to
    measure the text-only content (pure-math paragraph detection)."""
    parts: list[str] = []
    # style-run buffer: adjacent runs with one style merge before
    # wrapping so "**a****b**" never appears
    buf: list[str] = []
    buf_style: list[frozenset] = [frozenset()]

    def flush_buf():
        if buf:
            text = "".join(buf)
            parts.append(_wrap_style(text, buf_style[0]) if rich else text)
            buf.clear()

    def walk_runs(el):
        for child in el:
            tag = child.tag
            if tag == q("w:r"):
                if _is_hidden_run(child):
                    continue
                style = _run_style(child, char_styles) if rich else frozenset()
                if style != buf_style[0]:
                    flush_buf()
                    buf_style[0] = style
                for sub in child:
                    if sub.tag == q("w:t"):
                        buf.append(sub.text or "")
                    elif sub.tag == q("w:tab"):
                        buf.append("\t")
                    elif sub.tag in (q("w:br"), q("w:cr")):
                        # markdown wrappers cannot span lines
                        flush_buf()
                        parts.append("\n")
                    elif sub.tag == _MC_ALTERNATE:
                        # run-level AlternateContent: take the Fallback
                        # branch only (Choice requires extensions we
                        # don't implement; walking both doubles text)
                        fb = sub.find(_MC_FALLBACK)
                        if fb is not None:
                            walk_runs(fb)
                # text boxes ride inside run-level drawings (reference:
                # docx_converter textbox handling); mc:Fallback mirrors
                # mc:Choice content and must be skipped to avoid doubles
                for txbx in _textbox_contents(child):
                    for inner_p in txbx.findall(q("w:p")):
                        inner = _para_text(
                            inner_p, rels, rich=rich, char_styles=char_styles
                        )
                        if inner.strip():
                            flush_buf()
                            parts.append(inner.strip() + "\n")
            elif tag == q("w:hyperlink"):
                flush_buf()
                rid = child.get(q("r:id"))
                anchor = child.get(q("w:anchor"))
                text_before = len(parts)
                walk_runs(child)
                flush_buf()
                link_text = "".join(parts[text_before:])
                del parts[text_before:]
                href = rels.get(rid, "")
                if not href and anchor:
                    # internal bookmark target (a TOC entry points at its
                    # heading's _Toc anchor)
                    href = f"#{anchor}"
                if href and link_text:
                    parts.append(f"[{link_text}]({href})")
                else:
                    parts.append(link_text)
            elif math and tag == f"{{{NS['m']}}}oMath":
                latex = omml_to_latex(child)
                if latex:
                    flush_buf()
                    parts.append(f"${latex}$")
            elif math and tag == f"{{{NS['m']}}}oMathPara":
                for sub in child.findall(f"{{{NS['m']}}}oMath"):
                    latex = omml_to_latex(sub)
                    if latex:
                        flush_buf()
                        parts.append(f"${latex}$")
            elif tag in (q("w:ins"), q("w:smartTag")):
                walk_runs(child)
            elif tag == _MC_ALTERNATE:
                fb = child.find(_MC_FALLBACK)
                if fb is not None:
                    walk_runs(fb)
    walk_runs(p)
    flush_buf()
    return "".join(parts)


def _para_images(p, rels: dict[str, str], z: zipfile.ZipFile) -> list[tuple[str, bytes]]:
    out = []
    for blip in p.iter(f"{{{NS['a']}}}blip"):
        rid = blip.get(q("r:embed")) or blip.get(q("r:link"))
        target = rels.get(rid)
        if target and target in z.namelist():
            out.append((os.path.basename(target), z.read(target)))
    return out


def _para_math(p) -> list[str]:
    out = []
    for math_el in list(p.iter(f"{{{NS['m']}}}oMath")):
        latex = omml_to_latex(math_el)
        if latex:
            out.append(latex)
    return out


def _is_list_para(p) -> bool:
    ppr = p.find(q("w:pPr"))
    return ppr is not None and ppr.find(q("w:numPr")) is not None


def _num_pr(p) -> tuple[str, int] | None:
    """(numId, ilvl) of a numbered paragraph."""
    ppr = p.find(q("w:pPr"))
    if ppr is None:
        return None
    npr = ppr.find(q("w:numPr"))
    if npr is None:
        return None
    nid = npr.find(q("w:numId"))
    ilvl = npr.find(q("w:ilvl"))
    if nid is None:
        return None
    try:
        return nid.get(q("w:val"), "0"), int(
            ilvl.get(q("w:val"), "0") if ilvl is not None else 0
        )
    except ValueError:
        return None


def _parse_lvl(lvl) -> tuple[int, tuple[str, str, int]] | None:
    """One w:lvl element -> (ilvl, (numFmt, lvlText, start))."""
    try:
        i = int(lvl.get(q("w:ilvl"), "0"))
    except ValueError:
        return None
    fmt_el = lvl.find(q("w:numFmt"))
    txt_el = lvl.find(q("w:lvlText"))
    start_el = lvl.find(q("w:start"))
    fmt = fmt_el.get(q("w:val"), "decimal") if fmt_el is not None else "decimal"
    txt = txt_el.get(q("w:val"), "") if txt_el is not None else ""
    start = 1
    if start_el is not None:
        try:
            start = int(start_el.get(q("w:val"), "1"))
        except ValueError:
            start = 1
    return i, (fmt, txt, start)


def _load_numbering(z: zipfile.ZipFile) -> dict[str, dict[int, tuple[str, str, int]]]:
    """word/numbering.xml -> numId -> {ilvl: (numFmt, lvlText, start)}.
    w:start and per-num w:lvlOverride/w:startOverride are honored so
    lists starting at values other than 1 render correct markers
    (reference: docx_converter _get_numbering_level_start)."""
    if "word/numbering.xml" not in z.namelist():
        return {}
    try:
        root = ET.fromstring(z.read("word/numbering.xml"))
    except ET.ParseError:
        return {}
    abstract: dict[str, dict[int, tuple[str, str, int]]] = {}
    for an in root.findall(q("w:abstractNum")):
        aid = an.get(q("w:abstractNumId"))
        lvls: dict[int, tuple[str, str, int]] = {}
        for lvl in an.findall(q("w:lvl")):
            parsed = _parse_lvl(lvl)
            if parsed is not None:
                lvls[parsed[0]] = parsed[1]
        if aid is not None:
            abstract[aid] = lvls
    out: dict[str, dict[int, tuple[str, str, int]]] = {}
    for num in root.findall(q("w:num")):
        nid = num.get(q("w:numId"))
        ref = num.find(q("w:abstractNumId"))
        if nid is None or ref is None:
            continue
        lvls = dict(abstract.get(ref.get(q("w:val"), ""), {}))
        # w:lvlOverride: a full w:lvl replaces the abstract level; a bare
        # w:startOverride replaces only its start value
        for ov in num.findall(q("w:lvlOverride")):
            try:
                oi = int(ov.get(q("w:ilvl"), "0"))
            except ValueError:
                continue
            ov_lvl = ov.find(q("w:lvl"))
            if ov_lvl is not None:
                parsed = _parse_lvl(ov_lvl)
                if parsed is not None:
                    lvls[parsed[0]] = parsed[1]
                continue
            so = ov.find(q("w:startOverride"))
            if so is not None:
                try:
                    s = int(so.get(q("w:val"), "1"))
                except ValueError:
                    continue
                fmt, txt, _ = lvls.get(oi, ("decimal", "", 1))
                lvls[oi] = (fmt, txt, s)
        out[nid] = lvls
    return out


def _roman(n: int) -> str:
    vals = [(1000, "m"), (900, "cm"), (500, "d"), (400, "cd"), (100, "c"),
            (90, "xc"), (50, "l"), (40, "xl"), (10, "x"), (9, "ix"),
            (5, "v"), (4, "iv"), (1, "i")]
    out = []
    for v, s in vals:
        while n >= v:
            out.append(s)
            n -= v
    return "".join(out)


def _format_number(fmt: str, n: int) -> str:
    if fmt == "decimal":
        return str(n)
    if fmt == "lowerLetter":
        return chr(ord("a") + (n - 1) % 26)
    if fmt == "upperLetter":
        return chr(ord("A") + (n - 1) % 26)
    if fmt == "lowerRoman":
        return _roman(n)
    if fmt == "upperRoman":
        return _roman(n).upper()
    return str(n)


def _format_marker(
    fmt: str,
    n: int,
    lvl_text: str,
    level_values: dict[int, int] | None = None,
    level_fmts: dict[int, str] | None = None,
) -> str:
    """Render the list marker for one numFmt + counter value. lvlText
    placeholders %N refer to the counter at level N-1, each formatted
    with that level's own numFmt (reference: docx_converter
    _format_numbering_value / _get_numbering_level_format)."""
    if fmt == "bullet":
        return "-"
    body = _format_number(fmt, n)
    # lvlText like "%1.%2." templates the marker across levels
    if lvl_text and "%" in lvl_text:
        import re as _re

        def sub(m):
            i = int(m.group(0)[1:]) - 1
            if level_values is not None and i in level_values:
                f = (level_fmts or {}).get(i, "decimal")
                return _format_number(f, level_values[i])
            return body

        return _re.sub(r"%\d", sub, lvl_text)
    return f"{body}."


class _NumberingState:
    """Per-document list counters with deeper-level resets."""

    def __init__(self, numbering: dict):
        self.numbering = numbering
        self.counters: dict[tuple[str, int], int] = {}

    def marker(self, num_id: str, ilvl: int) -> str:
        key = (num_id, ilvl)
        levels = self.numbering.get(num_id, {})
        fmt, lvl_text, start = levels.get(ilvl, ("bullet", "", 1))
        if key in self.counters:
            self.counters[key] += 1
        else:
            self.counters[key] = start  # w:start / startOverride value
        # restarting a level resets deeper levels
        for (nid, lv) in list(self.counters):
            if nid == num_id and lv > ilvl:
                del self.counters[(nid, lv)]
        # shallower levels not yet seen display at their start value
        # (Word behavior for a deep item without a shallower predecessor)
        values = {
            lv: c for (nid, lv), c in self.counters.items() if nid == num_id
        }
        for lv in range(ilvl):
            values.setdefault(lv, levels.get(lv, ("decimal", "", 1))[2])
        fmts = {lv: levels.get(lv, ("decimal", "", 1))[0] for lv in values}
        return _format_marker(fmt, self.counters[key], lvl_text, values, fmts)


def _load_notes(z: zipfile.ZipFile, part: str, tag: str) -> dict[str, str]:
    """word/footnotes.xml or endnotes.xml -> id -> text."""
    if part not in z.namelist():
        return {}
    try:
        root = ET.fromstring(z.read(part))
    except ET.ParseError:
        return {}
    rels = _load_rels(z, part)
    out = {}
    for note in root.findall(q(tag)):
        nid = note.get(q("w:id"))
        if nid is None or int(nid) < 1:  # separators use ids <= 0
            continue
        text = "\n".join(
            _para_text(p, rels) for p in note.findall(q("w:p"))
        ).strip()
        if text:
            out[nid] = text
    return out


def _note_refs(p) -> list[tuple[str, str]]:
    """(kind, id) for footnote/endnote references inside a paragraph."""
    out = []
    for el in p.iter():
        if el.tag == q("w:footnoteReference"):
            out.append(("footnote", el.get(q("w:id"), "")))
        elif el.tag == q("w:endnoteReference"):
            out.append(("endnote", el.get(q("w:id"), "")))
    return out


def _table_to_html(
    tbl,
    rels: dict[str, str],
    z: zipfile.ZipFile | None = None,
    image_sink: dict[str, bytes] | None = None,
) -> str:
    rows_html = []
    vmerge_tracker: dict[int, int] = {}
    for tr in tbl.findall(q("w:tr")):
        cells = []
        col = 0
        for tc in tr.findall(q("w:tc")):
            tcpr = tc.find(q("w:tcPr"))
            colspan = 1
            vmerge = None
            if tcpr is not None:
                gs = tcpr.find(q("w:gridSpan"))
                if gs is not None:
                    colspan = int(gs.get(q("w:val"), "1"))
                vm = tcpr.find(q("w:vMerge"))
                if vm is not None:
                    vmerge = vm.get(q("w:val"), "continue")
            parts = [
                esc(_para_text(p, rels)) for p in tc.findall(q("w:p"))
            ]
            # pictures inside cells become <img> tags and register in
            # the result's image store (reference keeps in-table images)
            if z is not None and image_sink is not None:
                from .images import normalize_office_image

                for p_el in tc.findall(q("w:p")):
                    for name, img in _para_images(p_el, rels, z):
                        name, img = normalize_office_image(name, img)
                        image_sink[f"images/{name}"] = img
                        parts.append(f'<img src="images/{name}"/>')
            # nested tables render inline inside their cell (pre-escaped)
            parts.extend(
                _table_to_html(sub, rels, z, image_sink)
                for sub in tc.findall(q("w:tbl"))
            )
            text = "\n".join(x for x in parts if x).strip()
            if vmerge == "continue":
                vmerge_tracker[col] = vmerge_tracker.get(col, 1) + 1
                col += colspan
                continue
            attrs = ""
            if colspan > 1:
                attrs += f' colspan="{colspan}"'
            cells.append((col, attrs, text))
            col += colspan
        rows_html.append(cells)
    # second pass: compute rowspans from vmerge-continue counts (approximate:
    # count continues below each restart cell)
    html_rows = []
    for r, cells in enumerate(rows_html):
        tds = []
        for col, attrs, text in cells:
            rowspan = 1
            for r2 in range(r + 1, len(rows_html)):
                cols_present = [c for c, _, _ in rows_html[r2]]
                if col in cols_present:
                    break
                rowspan += 1
            if rowspan > 1 and "rowspan" not in attrs:
                attrs += f' rowspan="{rowspan}"'
            tds.append(f"<td{attrs}>{text}</td>")  # cell text pre-escaped
        html_rows.append("<tr>" + "".join(tds) + "</tr>")
    return "<table>" + "".join(html_rows) + "</table>"


def _para_page_break(p, has_content: bool) -> bool:
    """True when this paragraph ends a section => new page. Mirrors the
    reference's pagination model (docx_converter convert loop +
    _is_layout_only_section_break): pages advance on section breaks
    only, except the synthetic layout-only kind — an empty continuous
    section break whose pgMar margins are all zero."""
    ppr = p.find(q("w:pPr"))
    sect = ppr.find(q("w:sectPr")) if ppr is not None else None
    if sect is None:
        return False
    stype = sect.find(q("w:type"))
    val = stype.get(q("w:val"), "continuous") if stype is not None else "continuous"
    if val == "continuous" and not has_content:
        mar = sect.find(q("w:pgMar"))
        if mar is not None and all(
            mar.get(q(f"w:{a}"), "0") == "0"
            for a in ("header", "footer", "top", "bottom", "left", "right")
        ):
            return False  # layout-only artifact, no pagination
    return True


_TOC_STYLE_RE = re.compile(r"^(?:toc|contents)\s*(\d)", re.I)


def _toc_styles(z: zipfile.ZipFile) -> dict[str, int]:
    """styleId -> 0-based TOC entry level ("TOC1"/"toc 1" -> 0)."""
    out: dict[str, int] = {}
    root = _styles_root(z)
    if root is None:
        return out
    for style in root.findall(q("w:style")):
        sid = style.get(q("w:styleId"))
        name_el = style.find(q("w:name"))
        name = name_el.get(q("w:val")) if name_el is not None else ""
        m = _TOC_STYLE_RE.match(name or "") or _TOC_STYLE_RE.match(sid or "")
        if m and sid:
            out[sid] = max(0, int(m.group(1)) - 1)
    return out


def _toc_sdt_para_ids(body) -> set[int]:
    """ids of paragraphs living inside a Table-of-Contents w:sdt
    (reference: docx_converter._is_toc_sdt:2890-2942 — the sdtPr
    docPartGallery/docPartObj marks the gallery)."""
    ids: set[int] = set()
    for sdt in body.iter(q("w:sdt")):
        pr = sdt.find(q("w:sdtPr"))
        if pr is None:
            continue
        obj = pr.find(q("w:docPartObj"))
        gallery = obj.find(q("w:docPartGallery")) if obj is not None else None
        val = gallery.get(q("w:val")) if gallery is not None else ""
        if val and "table of contents" in val.lower():
            for p in sdt.iter(q("w:p")):
                ids.add(id(p))
    return ids


def _is_toc_entry(p, style: str | None, toc_styles: dict[str, int],
                  toc_ids: set[int]) -> int | None:
    """-> 0-based TOC level when this paragraph is a TOC entry, else None.
    A TOC-styled paragraph anywhere counts; inside a TOC sdt, an internal
    anchor hyperlink marks an entry even without the style (reference:
    _handle_plain_toc_paragraph_as_index + _handle_sdt_as_index)."""
    if style and style in toc_styles:
        return toc_styles[style]
    if id(p) in toc_ids:
        for link in p.iter(q("w:hyperlink")):
            if link.get(q("w:anchor")):
                return 0
    return None


def _has_seq_field(p) -> bool:
    """True when the paragraph carries a SEQ numbering field — Word's
    insert-caption machinery (reference: docx_converter._is_caption
    :3446-3463)."""
    for instr in p.iter(q("w:instrText")):
        if instr.text and "SEQ" in instr.text:
            return True
    for fld in p.iter(q("w:fldSimple")):
        if "SEQ" in (fld.get(q("w:instr")) or ""):
            return True
    return False


def _para_bookmark(p) -> str:
    """First _Toc bookmark on the paragraph — the anchor a TOC entry's
    hyperlink targets (reference: _extract_paragraph_bookmark)."""
    for bm in p.iter(q("w:bookmarkStart")):
        name = bm.get(q("w:name")) or ""
        if name.startswith("_Toc"):
            return name
    return ""


def _emit_header_footer(
    z: zipfile.ZipFile, sect, doc_rels: dict[str, str],
    seen: set, result, page: int,
) -> None:
    """Resolve headerReference/footerReference parts of a section and emit
    deduped header/footer blocks, skipping empty and digit-only (page
    number) content (reference: docx_converter._add_header_footer)."""
    for tag, kind in ((q("w:headerReference"), "header"),
                      (q("w:footerReference"), "footer")):
        for ref in sect.findall(tag):
            target = doc_rels.get(ref.get(q("r:id")))
            if not target or target not in z.namelist():
                continue
            try:
                root = ET.fromstring(z.read(target))
            except ET.ParseError:
                continue
            part_rels = _load_rels(z, target)
            parts = []
            for p in root.iter(q("w:p")):
                t = _para_text(p, part_rels).strip()
                if t:
                    parts.append(t)
            text = " ".join(parts)
            if not text or text.isdigit() or (kind, text) in seen:
                continue
            seen.add((kind, text))
            if kind == "header":
                result.add_header(text, page=page)
            else:
                result.add_footer(text, page=page)


def _iter_body(parent):
    """Body children, transparently descending into w:sdt content
    wrappers (a TOC field lives inside one; skipping the sdt would drop
    the whole table of contents)."""
    for el in parent:
        if el.tag == q("w:sdt"):
            content = el.find(q("w:sdtContent"))
            if content is not None:
                yield from _iter_body(content)
        else:
            yield el


def docx_to_blocks(data: bytes) -> OfficeResult:
    result = OfficeResult()
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        if "word/document.xml" not in z.namelist():
            raise ValueError("invalid docx: no word/document.xml")
        rels = _load_rels(z, "word/document.xml")
        headings = _style_headings(z)
        char_styles = _char_styles(z)
        toc_styles = _toc_styles(z)
        numbering = _NumberingState(_load_numbering(z))
        footnotes = _load_notes(z, "word/footnotes.xml", "w:footnote")
        endnotes = _load_notes(z, "word/endnotes.xml", "w:endnote")
        used_notes: list[tuple[str, str]] = []
        root = ET.fromstring(z.read("word/document.xml"))
        body = root.find(q("w:body"))
        if body is None:
            return result
        toc_ids = _toc_sdt_para_ids(body)
        hf_seen: set = set()
        pending_list: list[str] = []
        pending_index: list[str] = []
        page = 0

        def flush_list():
            if pending_list:
                result.add_list(list(pending_list), page=page)
                pending_list.clear()

        def flush_index():
            if pending_index:
                result.add_index(list(pending_index), page=page)
                pending_index.clear()

        for el in _iter_body(body):
            if el.tag == q("w:p"):
                ppr_early = el.find(q("w:pPr"))
                sect_early = (
                    ppr_early.find(q("w:sectPr"))
                    if ppr_early is not None else None
                )
                if sect_early is not None:
                    _emit_header_footer(z, sect_early, rels, hf_seen,
                                        result, page)
                style_early = None
                if ppr_early is not None:
                    ps_early = ppr_early.find(q("w:pStyle"))
                    if ps_early is not None:
                        style_early = ps_early.get(q("w:val"))
                toc_level = _is_toc_entry(el, style_early, toc_styles, toc_ids)
                if toc_level is not None:
                    entry = _para_text(el, rels).replace("\t", " ").strip()
                    if entry:
                        flush_list()
                        pending_index.append(f"{'    ' * toc_level}{entry}")
                    continue
                flush_index()  # any non-TOC paragraph closes the index
                maths = _para_math(el)
                text = _para_text(el, rels, rich=True, char_styles=char_styles)
                images = _para_images(el, rels, z)
                # a picture-only paragraph IS content (reference
                # _is_layout_only_section_break checks picture_xpath_expr)
                # — without this, its sectPr is misclassified layout-only
                # and the empty-carrier pre-increment would push the
                # images onto the wrong page
                has_content = bool(text.strip() or maths or images)
                breaks_page = _para_page_break(el, has_content)
                # an empty break-carrier paragraph starts the new page
                # before anything else lands; a paragraph with content
                # stays on the old page and paginates after (reference
                # docx_converter convert loop semantics)
                if breaks_page and not has_content:
                    flush_list()
                    page += 1
                    breaks_page = False
                # footnote/endnote references render as [^n] markers
                # (kept separate so the heading path keeps them too)
                note_suffix = ""
                for kind, nid in _note_refs(el):
                    notes = footnotes if kind == "footnote" else endnotes
                    if nid in notes:
                        if (kind, nid) not in used_notes:
                            used_notes.append((kind, nid))
                        idx = used_notes.index((kind, nid)) + 1
                        note_suffix += f"[^{idx}]"
                text += note_suffix
                ppr = el.find(q("w:pPr"))
                style = None
                if ppr is not None:
                    ps = ppr.find(q("w:pStyle"))
                    if ps is not None:
                        style = ps.get(q("w:val"))
                level = headings.get(style or "", 0)
                # pure-math paragraph (no prose outside the equations)
                # -> interline equation blocks; mixed paragraphs keep
                # the $latex$ inline at its run position instead
                if maths and not _para_text(el, rels, math=False).strip():
                    flush_list()
                    for latex in maths:
                        result.add_equation(latex, page=page)
                elif level:
                    flush_list()
                    # titles carry their own # prefix: keep them plain
                    result.add_title(
                        _para_text(el, rels) + note_suffix, level, page=page,
                        anchor=_para_bookmark(el),
                    )
                elif _is_list_para(el) and text.strip():
                    npr = _num_pr(el)
                    if npr is not None:
                        marker = numbering.marker(*npr)
                        indent = "  " * npr[1]
                    else:
                        marker, indent = "-", ""
                    pending_list.append(f"{indent}{marker} {text.strip()}")
                elif _has_seq_field(el) and text.strip():
                    # SEQ field = Word-inserted caption (ref: _is_caption)
                    flush_list()
                    result.add_caption(text, page=page)
                else:
                    flush_list()
                    if text.strip():
                        result.add_text(text, page=page)
                for name, img_data in images:
                    flush_list()
                    result.add_image(name, img_data, page=page)
                from .chart import chart_part_to_html, find_chart_refs

                for chart_path in find_chart_refs(el, rels):
                    html = chart_part_to_html(z, chart_path)
                    if html:
                        flush_list()
                        result.add_table(html, page=page)
                if breaks_page:
                    flush_list()
                    page += 1
            elif el.tag == q("w:tbl"):
                flush_list()
                flush_index()
                result.add_table(
                    _table_to_html(el, rels, z, result.images), page=page
                )
        flush_list()
        flush_index()
        # the body-level sectPr carries the final section's header/footer
        body_sect = body.find(q("w:sectPr"))
        if body_sect is not None:
            _emit_header_footer(z, body_sect, rels, hf_seen, result, page)
        for i, (kind, nid) in enumerate(used_notes, 1):
            notes = footnotes if kind == "footnote" else endnotes
            result.add_text(f"[^{i}]: {notes[nid]}", page=page)
        result.n_pages = page + 1
    return result
