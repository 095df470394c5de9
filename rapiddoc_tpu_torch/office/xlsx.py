"""XLSX -> blocks converter (sheets as HTML tables).

A copy of ``rapiddoc_tpu/office/xlsx.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.

Behavioral counterpart of the reference xlsx converter
(reference: rapid_doc/model/xlsx/xlsx_converter.py): shared strings,
inline strings, numbers, merged-cell spans, one table per sheet with the
sheet name as a title.
"""
from __future__ import annotations

import io
import os
import re
import zipfile
from xml.etree import ElementTree as ET

from .common import NS, OfficeResult, esc, q

S = NS["s"]


def _col_to_idx(ref: str) -> int:
    """'C5' -> column index 2."""
    m = re.match(r"([A-Z]+)", ref)
    col = 0
    for ch in m.group(1) if m else "A":
        col = col * 26 + (ord(ch) - ord("A") + 1)
    return col - 1


def _row_of(ref: str) -> int:
    m = re.search(r"(\d+)", ref)
    return int(m.group(1)) - 1 if m else 0


def _rpr_wrap(rpr, escaped: str) -> str:
    """SpreadsheetML run properties -> inline HTML tags around escaped
    text via the shared office renderer (reference: xlsx_converter
    _apply_inline_font_tags)."""
    if rpr is None or not escaped:
        return escaped

    def on(tag: str) -> bool:
        el = rpr.find(f"{{{S}}}{tag}")
        return el is not None and el.get("val", "1") not in (
            "0", "false", "none"
        )

    styles = set()
    va = rpr.find(f"{{{S}}}vertAlign")
    if va is not None:
        v = va.get("val")
        if v == "superscript":
            styles.add("superscript")
        elif v == "subscript":
            styles.add("subscript")
    if on("u"):
        styles.add("underline")
    if on("strike"):
        styles.add("strikethrough")
    if on("b"):
        styles.add("bold")
    if on("i"):
        styles.add("italic")
    from .common import wrap_inline_style

    return wrap_inline_style(escaped, styles, syntax="html")


def _shared_strings(z: zipfile.ZipFile) -> list[tuple[str, str | None]]:
    """-> [(plain_text, styled_html_or_None)] per shared-string item.
    Rich runs (<r><rPr>...) keep their inline styling as HTML since
    cells land inside HTML tables."""
    out: list[tuple[str, str | None]] = []
    if "xl/sharedStrings.xml" not in z.namelist():
        return out
    root = ET.fromstring(z.read("xl/sharedStrings.xml"))
    for si in root.findall(f"{{{S}}}si"):
        plain = "".join(t.text or "" for t in si.iter(f"{{{S}}}t"))
        html = None
        runs = si.findall(f"{{{S}}}r")
        if runs and any(r.find(f"{{{S}}}rPr") is not None for r in runs):
            parts = []
            for r in runs:
                t = r.find(f"{{{S}}}t")
                parts.append(
                    _rpr_wrap(r.find(f"{{{S}}}rPr"),
                              esc(t.text or "" if t is not None else ""))
                )
            html = "".join(parts)
            if html == esc(plain):  # styling was all-empty
                html = None
        out.append((plain, html))
    return out


_BUILTIN_DATE_FMTS = set(range(14, 23)) | {27, 30, 36, 45, 46, 47}
_BUILTIN_PERCENT_FMTS = {9, 10}


def _load_styles(
    z: zipfile.ZipFile,
) -> tuple[list[str], list[tuple[bool, bool]]]:
    """styles.xml -> (per-xf number kind '' | 'date' | 'percent',
    per-xf (bold, italic) font flags) (reference: xlsx_converter
    number-format handling + _extract_cell_style)."""
    if "xl/styles.xml" not in z.namelist():
        return [], []
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(z.read("xl/styles.xml"))
    except ET.ParseError:
        return [], []
    fonts: list[tuple[bool, bool]] = []
    fonts_el = root.find(f"{{{S}}}fonts")
    if fonts_el is not None:
        def _flag(font, tag: str) -> bool:
            el = font.find(f"{{{S}}}{tag}")
            # <b val="0"/> is an explicit OFF (tools emit it)
            return el is not None and el.get("val", "1") not in (
                "0", "false"
            )

        for f in fonts_el.findall(f"{{{S}}}font"):
            fonts.append((_flag(f, "b"), _flag(f, "i")))
    custom: dict[int, str] = {}
    fmts = root.find(f"{{{S}}}numFmts")
    if fmts is not None:
        for f in fmts.findall(f"{{{S}}}numFmt"):
            try:
                custom[int(f.get("numFmtId", "-1"))] = f.get(
                    "formatCode", ""
                )
            except ValueError:
                pass
    kinds: list[str] = []
    xf_fonts: list[tuple[bool, bool]] = []
    xfs = root.find(f"{{{S}}}cellXfs")
    if xfs is None:
        return [], []
    for xf in xfs.findall(f"{{{S}}}xf"):
        try:
            font_id = int(xf.get("fontId", "-1"))
        except ValueError:
            font_id = -1
        xf_fonts.append(
            fonts[font_id] if 0 <= font_id < len(fonts) else (False, False)
        )
        try:
            fid = int(xf.get("numFmtId", "0"))
        except ValueError:
            fid = 0
        if fid in _BUILTIN_DATE_FMTS:
            kinds.append("date")
        elif fid in _BUILTIN_PERCENT_FMTS:
            kinds.append("percent")
        elif fid in custom:
            code = custom[fid].lower()
            stripped = code.split(";")[0]
            if "%" in stripped:
                kinds.append("percent")
            elif any(ch in stripped for ch in "ymd") and '"' not in stripped:
                kinds.append("date")
            else:
                kinds.append("")
        else:
            kinds.append("")
    return kinds, xf_fonts


def _excel_date(serial: float, date1904: bool = False) -> str:
    """Excel serial -> ISO date. 1900 system carries the Lotus leap bug;
    the 1904 system (workbookPr date1904, classic-Mac files) counts from
    1904-01-01 with no phantom leap day."""
    import datetime

    days = int(serial)
    if date1904:
        base = datetime.date(1904, 1, 1)
    else:
        if days >= 60:
            days -= 1  # Excel pretends 1900-02-29 existed
        base = datetime.date(1899, 12, 31)
    try:
        d = base + datetime.timedelta(days=days)
    except OverflowError:
        return str(serial)
    frac = serial - int(serial)
    if frac > 1e-9:
        secs = round(frac * 86400)
        return f"{d.isoformat()} {secs // 3600:02d}:{secs % 3600 // 60:02d}"
    return d.isoformat()


def _cell_value(
    c, shared: list, styles: list[str] | None = None,
    date1904: bool = False,
) -> tuple[str, str | None]:
    """-> (plain_text, styled_html_or_None) of one cell."""
    ctype = c.get("t", "n")
    kind = ""
    if styles and ctype == "n":
        try:
            si = int(c.get("s", "-1"))
            kind = styles[si] if 0 <= si < len(styles) else ""
        except ValueError:
            kind = ""
    if kind:
        v = c.find(f"{{{S}}}v")
        if v is not None and v.text:
            try:
                f = float(v.text)
                if kind == "date" and f > 0:
                    return _excel_date(f, date1904), None
                if kind == "percent":
                    p = f * 100
                    return (
                        f"{int(p)}%" if p == int(p) else f"{p:g}%"
                    ), None
            except ValueError:
                pass
    if ctype == "s":
        v = c.find(f"{{{S}}}v")
        try:
            if v is not None and v.text:
                return shared[int(v.text)]
            return "", None
        except (ValueError, IndexError):
            return "", None
    if ctype == "inlineStr":
        runs = c.findall(f"{{{S}}}is/{{{S}}}r")
        plain = "".join(t.text or "" for t in c.iter(f"{{{S}}}t"))
        if runs and any(r.find(f"{{{S}}}rPr") is not None for r in runs):
            html = "".join(
                _rpr_wrap(
                    r.find(f"{{{S}}}rPr"),
                    esc((r.find(f"{{{S}}}t").text or "")
                        if r.find(f"{{{S}}}t") is not None else ""),
                )
                for r in runs
            )
            return plain, (html if html != esc(plain) else None)
        return plain, None
    v = c.find(f"{{{S}}}v")
    if v is None or v.text is None:
        return "", None
    if ctype == "b":
        return ("TRUE" if v.text == "1" else "FALSE"), None
    text = v.text
    # trim float noise
    try:
        f = float(text)
        if f == int(f) and abs(f) < 1e15:
            return str(int(f)), None
        return f"{f:g}", None
    except ValueError:
        return text, None


# auto gap-tolerance selection (reference: xlsx_converter.py:33-35 +
# _select_best_gap_candidate:931-977)
_GAP_CANDIDATES = (0, 1, 2)
_GAP_PREFERENCE = {1: 0, 0: 1, 2: 2}
_GAP_PREFERENCE_MARGIN = 0.15


def _candidate_summary(
    islands: list[tuple[int, int, int, int]], occupied: set[tuple[int, int]]
) -> dict:
    """Segmentation-quality features of one gap-tolerance candidate
    (reference: _summarize_candidate_tables:875-929)."""
    import collections

    n = len(islands)
    singletons = severe = sparse_large = 0
    total_area = 0
    blank_num = 0.0
    blank_lines = possible_lines = 0
    row_cover: collections.Counter = collections.Counter()
    for r0, c0, r1, c1 in islands:
        nrows, ncols = r1 - r0 + 1, c1 - c0 + 1
        area = nrows * ncols
        content = sum(
            1 for (r, c) in occupied if r0 <= r <= r1 and c0 <= c <= c1
        )
        blank_ratio = 1.0 - content / max(area, 1)
        int_rows = [
            not any((r, c) in occupied for c in range(c0, c1 + 1))
            for r in range(r0 + 1, r1)
        ] if nrows > 2 else []
        int_cols = [
            not any((r, c) in occupied for r in range(r0, r1 + 1))
            for c in range(c0 + 1, c1)
        ] if ncols > 2 else []

        def _max_run(flags):
            best = cur = 0
            for f in flags:
                cur = cur + 1 if f else 0
                best = max(best, cur)
            return best

        total_area += area
        blank_num += area * blank_ratio
        blank_lines += sum(int_rows) + sum(int_cols)
        possible_lines += max(nrows - 2, 0) + max(ncols - 2, 0)
        for r in range(r0, r1 + 1):
            row_cover[r] += 1
        if nrows == 1 and ncols == 1:
            singletons += 1
        if area >= 6 and blank_ratio > 0.35:
            sparse_large += 1
        if max(_max_run(int_rows), _max_run(int_cols)) >= 2:
            severe += 1
    overlap_excess = sum(
        max(0, cnt - 1) for cnt in row_cover.values()
    ) / max(len(row_cover), 1)
    return {
        "singleton_ratio": singletons / max(n, 1),
        "weighted_blank_ratio": blank_num / max(total_area, 1),
        "interior_blank_line_ratio": blank_lines / max(possible_lines, 1),
        "sparse_large_ratio": sparse_large / max(n, 1),
        "severe_separator_count": severe,
        "row_overlap_excess_ratio": overlap_excess,
    }


def _select_islands(
    occupied: set[tuple[int, int]]
) -> list[tuple[int, int, int, int]]:
    """Try gap tolerances 0/1/2 and keep the segmentation with the
    lowest penalty, preferring gap 1 among near-ties (reference:
    _select_best_gap_candidate:931-977 with the same weights)."""
    candidates = []
    for gap in _GAP_CANDIDATES:
        islands = _data_islands(occupied, gap)
        s = _candidate_summary(islands, occupied)
        penalty = (
            6.0 * s["severe_separator_count"]
            + 2.5 * s["interior_blank_line_ratio"]
            + 1.5 * s["sparse_large_ratio"]
            + 1.0 * s["singleton_ratio"]
            + 0.5 * s["weighted_blank_ratio"]
            + 1.0 * s["row_overlap_excess_ratio"]
        )
        candidates.append({"gap": gap, "penalty": penalty,
                           "islands": islands, **s})
    min_pen = min(c["penalty"] for c in candidates)
    near = [
        c for c in candidates
        if c["penalty"] <= min_pen + _GAP_PREFERENCE_MARGIN
    ]
    best = min(
        near,
        key=lambda c: (
            c["severe_separator_count"],
            _GAP_PREFERENCE[c["gap"]],
            c["interior_blank_line_ratio"],
            c["penalty"],
        ),
    )
    return best["islands"]


def _data_islands(
    occupied: set[tuple[int, int]], gap: int = 1
) -> list[tuple[int, int, int, int]]:
    """Connected components of occupied cells, where cells within a
    Chebyshev distance of gap+1 connect (reference xlsx_converter
    _find_table_bounds flood fill with gap_tolerance). Returns bounding
    rects (r0, c0, r1, c1), row-major order."""
    reach = gap + 1
    remaining = set(occupied)
    islands = []
    while remaining:
        seed = min(remaining)
        stack = [seed]
        remaining.discard(seed)
        r0, c0 = r1, c1 = seed
        while stack:
            r, c = stack.pop()
            r0, c0 = min(r0, r), min(c0, c)
            r1, c1 = max(r1, r), max(c1, c)
            for dr in range(-reach, reach + 1):
                for dc in range(-reach, reach + 1):
                    nb = (r + dr, c + dc)
                    if nb in remaining:
                        remaining.discard(nb)
                        stack.append(nb)
        islands.append((r0, c0, r1, c1))
    islands.sort()
    return islands


def _sheet_to_html(z: zipfile.ZipFile, path: str, shared: list,
                   styles: list[str] | None = None,
                   xf_fonts: list[tuple[bool, bool]] | None = None,
                   date1904: bool = False) -> list[tuple[str, str]]:
    """Sheet XML -> ("table"|"text", payload) blocks: one HTML table per
    compact data island, trimmed to its true bounds, with the gap
    tolerance auto-selected per sheet and lone unmerged cells demoted to
    prose (reference: xlsx_converter.py _find_data_tables /
    _select_best_gap_candidate / _can_render_singleton_as_text). Cells
    keep inline rich-text styling, cell-level bold/italic fonts and
    hyperlinks as HTML (reference: _cell_value_to_html)."""
    root = ET.fromstring(z.read(path))
    data = root.find(f"{{{S}}}sheetData")
    if data is None:
        return []
    grid: dict[tuple[int, int], tuple[str, str | None]] = {}
    for row in data.findall(f"{{{S}}}row"):
        for c in row.findall(f"{{{S}}}c"):
            ref = c.get("r", "A1")
            r, col = _row_of(ref), _col_to_idx(ref)
            val, html = _cell_value(c, shared, styles, date1904)
            if val != "":
                if html is None and xf_fonts:
                    try:
                        si = int(c.get("s", "-1"))
                        bold, italic = (
                            xf_fonts[si]
                            if 0 <= si < len(xf_fonts)
                            else (False, False)
                        )
                    except ValueError:
                        bold = italic = False
                    if bold or italic:
                        html = esc(val)
                        if bold:
                            html = f"<strong>{html}</strong>"
                        if italic:
                            html = f"<em>{html}</em>"
                grid[(r, col)] = (val, html)
    if not grid:
        return []
    # hyperlinks: ref -> external target (worksheet rels)
    links: dict[tuple[int, int], str] = {}
    hls = root.find(f"{{{S}}}hyperlinks")
    if hls is not None:
        from .docx import _load_rels

        sheet_rels = _load_rels(z, path)
        for hl in hls.findall(f"{{{S}}}hyperlink"):
            target = sheet_rels.get(hl.get(q("r:id"))) or ""
            if target.startswith(("http://", "https://", "mailto:")):
                ref = (hl.get("ref") or "A1").split(":")[0]
                links[(_row_of(ref), _col_to_idx(ref))] = target
    # merged cells
    merges: dict[tuple[int, int], tuple[int, int]] = {}
    covered: set[tuple[int, int]] = set()
    occupied = set(grid)
    mc = root.find(f"{{{S}}}mergeCells")
    if mc is not None:
        for m in mc.findall(f"{{{S}}}mergeCell"):
            ref = m.get("ref", "")
            if ":" not in ref:
                continue
            a, b = ref.split(":")
            r0, c0 = _row_of(a), _col_to_idx(a)
            r1, c1 = _row_of(b), _col_to_idx(b)
            merges[(r0, c0)] = (r1 - r0 + 1, c1 - c0 + 1)
            anchored = (r0, c0) in grid
            for rr in range(r0, r1 + 1):
                for cc in range(c0, c1 + 1):
                    if (rr, cc) != (r0, c0):
                        covered.add((rr, cc))
                    if anchored:
                        # a valued merge range is one solid blob for
                        # island connectivity
                        occupied.add((rr, cc))
    blocks: list[tuple[str, str]] = []  # ("table"|"text", payload)
    for ir0, ic0, ir1, ic1 in _select_islands(occupied):
        # a lone 1x1 unmerged cell is prose, not a table (reference:
        # _can_render_singleton_as_text:743-754)
        if (
            ir0 == ir1 and ic0 == ic1
            and (ir0, ic0) not in merges
            and (ir0, ic0) in grid
        ):
            val, html = grid[(ir0, ic0)]
            if html is None and (ir0, ic0) not in links:
                blocks.append(("text", val))
                continue
        rows_html = []
        for r in range(ir0, ir1 + 1):
            cells = []
            for c in range(ic0, ic1 + 1):
                if (r, c) in covered:
                    continue
                attrs = ""
                if (r, c) in merges:
                    rs, cs = merges[(r, c)]
                    rs = min(rs, ir1 - r + 1)
                    cs = min(cs, ic1 - c + 1)
                    if rs > 1:
                        attrs += f' rowspan="{rs}"'
                    if cs > 1:
                        attrs += f' colspan="{cs}"'
                val, html = grid.get((r, c), ("", None))
                content = html if html is not None else esc(val)
                href = links.get((r, c))
                if href and content:
                    content = f'<a href="{esc(href)}">{content}</a>'
                cells.append(f"<td{attrs}>{content}</td>")
            rows_html.append("<tr>" + "".join(cells) + "</tr>")
        blocks.append(("table", "<table>" + "".join(rows_html) + "</table>"))
    return blocks


def xlsx_to_blocks(data: bytes) -> OfficeResult:
    from .docx import _load_rels

    result = OfficeResult()
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        shared = _shared_strings(z)
        styles, xf_fonts = _load_styles(z)
        sheets: list[tuple[str, str]] = []
        date1904 = False
        if "xl/workbook.xml" in z.namelist():
            wb_rels = _load_rels(z, "xl/workbook.xml")
            root = ET.fromstring(z.read("xl/workbook.xml"))
            pr = root.find(f"{{{S}}}workbookPr")
            if pr is not None and pr.get("date1904", "0").lower() in (
                "1", "true"
            ):
                date1904 = True
            include_hidden = os.environ.get(
                "RAPIDDOC_XLSX_INCLUDE_HIDDEN",
                os.environ.get("MINERU_XLSX_INCLUDE_HIDDEN", ""),
            ).lower() in ("1", "true", "yes")
            for sheet in root.iter(f"{{{S}}}sheet"):
                name = sheet.get("name", "Sheet")
                # hidden / veryHidden sheets are skipped (reference:
                # _iter_sheets_to_convert:275-287)
                if not include_hidden and sheet.get(
                    "state", "visible"
                ) != "visible":
                    continue
                rid = sheet.get(q("r:id"))
                target = wb_rels.get(rid)
                if target and target in z.namelist():
                    sheets.append((name, target))
        if not sheets:
            sheets = [
                (f"Sheet{i+1}", n)
                for i, n in enumerate(
                    sorted(
                        n for n in z.namelist()
                        if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)
                    )
                )
            ]
        result.n_pages = max(len(sheets), 1)
        per_sheet = []
        for page_idx, (name, path) in enumerate(sheets):
            per_sheet.append((
                name, page_idx,
                _sheet_to_html(z, path, shared, styles, xf_fonts, date1904),
                _sheet_charts(z, path),
                _sheet_pictures(z, path),
            ))
        # sheet titles only when more than one sheet has content
        # (reference: _should_emit_sheet_titles:297-299 — a single-table
        # workbook gets no title noise)
        nonempty = sum(
            1 for _, _, blocks, charts, pics in per_sheet
            if blocks or charts or pics
        )
        for name, page_idx, blocks, charts, pics in per_sheet:
            if blocks and nonempty > 1:
                result.add_title(name, level=2, page=page_idx)
            for kind, payload in blocks:
                if kind == "text":
                    result.add_text(payload, page=page_idx)
                else:
                    result.add_table(payload, page=page_idx)
            for chart_html in charts:
                result.add_table(chart_html, page=page_idx)
            for img_name, blob in pics:
                result.add_image(f"s{page_idx}_{img_name}", blob,
                                 page=page_idx)
    return result


def _sheet_pictures(
    z: zipfile.ZipFile, sheet_path: str
) -> list[tuple[str, bytes]]:
    """Pictures anchored on a worksheet via its drawing part (sheet rels
    -> drawing -> a:blip r:embed -> media)."""
    from .docx import _load_rels

    out: list[tuple[str, bytes]] = []
    rels = _load_rels(z, sheet_path)
    a_ns = "http://schemas.openxmlformats.org/drawingml/2006/main"
    r_id = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
            "relationships}embed")
    for target in rels.values():
        if "drawings/" not in target or target not in z.namelist():
            continue
        drawing_rels = _load_rels(z, target)
        try:
            droot = ET.fromstring(z.read(target))
        except ET.ParseError:
            continue
        for blip in droot.iter(f"{{{a_ns}}}blip"):
            rid = blip.get(r_id)
            media = drawing_rels.get(rid)
            if media and media in z.namelist():
                out.append((media.rsplit("/", 1)[-1], z.read(media)))
    return out


def _sheet_charts(z: zipfile.ZipFile, sheet_path: str) -> list[str]:
    """Charts anchored on a worksheet (sheet rels -> drawing part ->
    chart parts), rendered as HTML data tables."""
    from .chart import chart_part_to_html, find_chart_refs
    from .docx import _load_rels

    out: list[str] = []
    rels = _load_rels(z, sheet_path)
    for target in rels.values():
        if "drawings/" not in target or target not in z.namelist():
            continue
        drawing_rels = _load_rels(z, target)
        try:
            droot = ET.fromstring(z.read(target))
        except ET.ParseError:
            continue
        for chart_path in find_chart_refs(droot, drawing_rels):
            html = chart_part_to_html(z, chart_path)
            if html:
                out.append(html)
    return out
