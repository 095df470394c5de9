"""OOXML chart (DrawingML) -> HTML data table.

A copy of ``rapiddoc_tpu/office/chart.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.

Behavioral counterpart of the reference chart extractor (reference:
rapid_doc/backend/utils/office_chart.py:40-405 — parse c:chart series
name/category/value caches into an HTML table, falling back to the
chart's embedded workbook). Implemented on stdlib ElementTree + the
package's own xlsx sheet parser (no openpyxl/lxml in this environment).
"""
from __future__ import annotations

import io
import zipfile
from html import escape as esc
from xml.etree import ElementTree as ET

C = "http://schemas.openxmlformats.org/drawingml/2006/chart"
A = "http://schemas.openxmlformats.org/drawingml/2006/main"

PLOT_TAGS = (
    "areaChart", "area3DChart", "barChart", "bar3DChart", "bubbleChart",
    "doughnutChart", "lineChart", "line3DChart", "ofPieChart", "pieChart",
    "pie3DChart", "radarChart", "scatterChart", "stockChart",
    "surfaceChart", "surface3DChart",
)


def _c(tag: str) -> str:
    return f"{{{C}}}{tag}"


def _text_of(el) -> str:
    """All a:t / c:v descendant text joined."""
    if el is None:
        return ""
    parts = [t.text for t in el.iter(f"{{{A}}}t") if t.text]
    if not parts:
        parts = [v.text for v in el.iter(_c("v")) if v.text]
    return " ".join(p.strip() for p in parts if p and p.strip())


# runaway-cache guard (reference: office_chart.py _MAX_CACHE_INDEX_SPAN)
_MAX_CACHE_SPAN = 10_000


def _cache_points(
    ref_parent, date_hint: bool = False, date_1904: bool = False
) -> list[str]:
    """Values from a c:strRef/c:numRef cache (or c:strLit/c:numLit) under
    `ref_parent` (a c:cat / c:val / c:xVal / c:yVal / c:tx element). A
    c:multiLvlStrCache renders each point as its levels joined with
    " / " (reference: _extract_multilevel_string_cache:648-680). With
    date_hint, numeric values convert from Excel serials to ISO dates
    (reference: _stringify_cache_value:899-918)."""
    if ref_parent is None:
        return []
    multi = ref_parent.find(f"{_c('multiLvlStrRef')}/{_c('multiLvlStrCache')}")
    if multi is not None:
        levels = []
        max_idx = -1
        for lvl in multi.findall(_c("lvl")):
            values: dict[int, str] = {}
            for pt in lvl.findall(_c("pt")):
                v = pt.find(_c("v"))
                try:
                    idx = int(pt.get("idx", ""))
                except ValueError:
                    continue
                values[idx] = (v.text or "") if v is not None else ""
                max_idx = max(max_idx, idx)
            levels.append(values)
        if max_idx < 0 or max_idx + 1 > _MAX_CACHE_SPAN:
            return []
        return [
            " / ".join(m[i] for m in levels if m.get(i))
            for i in range(max_idx + 1)
        ]
    pts: dict[int, str] = {}
    for cache_tag in ("strCache", "numCache", "strLit", "numLit"):
        for cache in ref_parent.iter(_c(cache_tag)):
            for pt in cache.findall(_c("pt")):
                v = pt.find(_c("v"))
                if v is not None and v.text is not None:
                    idx = int(pt.get("idx", len(pts)))
                    if date_hint and cache_tag in ("numCache", "numLit"):
                        pts[idx] = _serial_to_iso(v.text, date_1904)
                    else:
                        pts[idx] = _fmt_number(v.text)
    if not pts or max(pts) + 1 > _MAX_CACHE_SPAN:
        return []
    return [pts.get(i, "") for i in range(max(pts) + 1)]


def _serial_to_iso(text: str, date_1904: bool) -> str:
    """Excel date serial -> ISO date string, falling back to the raw text
    (reference: _excel_serial_to_iso:948-963)."""
    try:
        serial = float(text)
    except ValueError:
        return text
    from .xlsx import _excel_date

    try:
        return _excel_date(serial, date_1904)
    except Exception:
        return _fmt_number(text)


def _fmt_number(text: str) -> str:
    try:
        f = float(text)
        if f == int(f) and abs(f) < 1e15:
            return str(int(f))
        return f"{f:.6g}"
    except ValueError:
        return text


def _series_name(ser) -> str:
    tx = ser.find(_c("tx"))
    if tx is None:
        return ""
    vals = _cache_points(tx)
    if vals:
        return vals[0]
    return _text_of(tx)


def _axis_title(plot_area) -> str:
    """x-axis title from the category/date axis (reference:
    parse_chart_spec_from_ooxml:217)."""
    if plot_area is None:
        return ""
    for tag in ("catAx", "dateAx", "valAx"):
        ax = plot_area.find(_c(tag))
        if ax is not None:
            t = ax.find(_c("title"))
            if t is not None:
                return _text_of(t)
            if tag != "valAx":
                return ""
    return ""


def _render_columns(
    headers: list[str], columns: list[list[str]], caption: str = ""
) -> str:
    """Column-oriented HTML table (reference: _render_html_table:972)."""
    n_rows = max((len(c) for c in columns), default=0)
    if n_rows == 0 or len(headers) != len(columns):
        return ""
    head = "".join(f"<td>{esc(h, quote=False)}</td>" for h in headers)
    rows = []
    for r in range(n_rows):
        rows.append(
            "<tr>"
            + "".join(
                f"<td>{esc(c[r] if r < len(c) else '', quote=False)}</td>"
                for c in columns
            )
            + "</tr>"
        )
    return f"<table>{caption}<tr>{head}</tr>{''.join(rows)}</table>"


def chart_xml_to_html(chart_xml: bytes) -> str:
    """Chart part XML -> HTML table of its cached data. Category/date
    charts tabulate categories x series; scatter charts emit per-series
    X/Y columns (one shared X column when every series uses the same x
    sequence); bubble charts add a size column per series; a date axis
    renders category serials as ISO dates (reference:
    office_chart.py:159-455 extract_chart_html_from_ooxml +
    render_chart_html_from_cache + _render_scatter_like/_bubble tables).
    Empty string when the chart carries no usable cache."""
    try:
        root = ET.fromstring(chart_xml)
    except ET.ParseError:
        return ""
    title = ""
    chart = root.find(_c("chart"))
    if chart is not None:
        title_el = chart.find(_c("title"))
        if title_el is not None:
            title = _text_of(title_el)
    d1904 = root.find(f".//{_c('date1904')}")
    date_1904 = d1904 is not None and d1904.get("val") == "1"
    plot_area = root.find(f".//{_c('plotArea')}")
    has_date_ax = (
        plot_area is not None and plot_area.find(_c("dateAx")) is not None
    )
    x_title = _axis_title(plot_area)

    series = []  # (name, cats, vals, sizes, kind)
    for plot_tag in PLOT_TAGS:
        for plot in root.iter(_c(plot_tag)):
            if plot_tag == "scatterChart":
                kind = "scatter"
            elif plot_tag == "bubbleChart":
                kind = "bubble"
            elif has_date_ax:
                kind = "date"
            else:
                kind = "category"
            for ser in plot.findall(_c("ser")):
                name = _series_name(ser)
                cat_el = ser.find(_c("cat"))
                if cat_el is None:
                    cat_el = ser.find(_c("xVal"))
                val_el = ser.find(_c("val"))
                if val_el is None:
                    val_el = ser.find(_c("yVal"))
                cats = _cache_points(
                    cat_el, date_hint=(kind == "date"), date_1904=date_1904
                )
                vals = _cache_points(val_el)
                sizes = _cache_points(ser.find(_c("bubbleSize")))
                if vals:
                    series.append((name, cats, vals, sizes, kind))
    if not series:
        return ""
    caption = (
        f"<caption>{esc(title, quote=False)}</caption>" if title else ""
    )
    names = [
        name or f"Series {i + 1}" for i, (name, *_rest) in enumerate(series)
    ]

    if all(s[4] in ("scatter", "bubble") for s in series):
        bubble = any(s[4] == "bubble" for s in series)
        x_seqs = [s[1] for s in series]
        shared = x_seqs[0] if all(x == x_seqs[0] for x in x_seqs[1:]) else None
        headers: list[str] = []
        columns: list[list[str]] = []
        if shared is not None:
            headers.append(x_title or "")
            columns.append(shared)
            for nm, s in zip(names, series):
                if bubble:
                    headers.extend((nm, f"{nm} size"))
                    columns.extend((s[2], s[3]))
                else:
                    headers.append(nm)
                    columns.append(s[2])
        else:
            for nm, s in zip(names, series):
                if bubble:
                    headers.extend((f"{nm} X", f"{nm} Y", f"{nm} size"))
                    columns.extend((s[1], s[2], s[3]))
                else:
                    headers.extend((f"{nm} X", f"{nm} Y"))
                    columns.extend((s[1], s[2]))
        return _render_columns(headers, columns, caption)

    # category / date: one categories column + one value column per series
    n_rows = max(max(len(s[1]), len(s[2])) for s in series)
    cats_axis = next((s[1] for s in series if len(s[1]) >= n_rows), None)
    if cats_axis is None:
        cats_axis = [str(i + 1) for i in range(n_rows)]
    return _render_columns(
        [x_title or ""] + names,
        [cats_axis] + [s[2] for s in series],
        caption,
    )


def chart_part_to_html(z: zipfile.ZipFile, chart_path: str) -> str:
    """Chart part -> HTML. Prefers the XML value caches; falls back to the
    embedded workbook (reference: office_chart.py
    html_table_from_excel_bytes)."""
    if chart_path not in z.namelist():
        return ""
    html = chart_xml_to_html(z.read(chart_path))
    if html:
        return html
    # fallback: embedded workbook referenced from the chart part rels
    from .docx import _load_rels

    rels = _load_rels(z, chart_path)
    for target in rels.values():
        if target.endswith((".xlsx", ".xlsm")) and target in z.namelist():
            html = _embedded_workbook_to_html(z.read(target))
            if html:
                return html
    return ""


def _embedded_workbook_to_html(xlsx_bytes: bytes) -> str:
    from .xlsx import _shared_strings, _sheet_to_html

    try:
        with zipfile.ZipFile(io.BytesIO(xlsx_bytes)) as wz:
            shared = _shared_strings(wz)
            for name in sorted(wz.namelist()):
                if name.startswith("xl/worksheets/sheet") and name.endswith(
                    ".xml"
                ):
                    for kind, payload in _sheet_to_html(wz, name, shared):
                        if kind == "table":
                            return payload
    except (zipfile.BadZipFile, ET.ParseError, KeyError):
        pass
    return ""


def find_chart_refs(el, rels: dict[str, str]) -> list[str]:
    """Chart part paths referenced from a drawing/graphicFrame element."""
    out = []
    for ch in el.iter(_c("chart")):
        rid = ch.get(
            "{http://schemas.openxmlformats.org/officeDocument/2006/"
            "relationships}id"
        )
        target = rels.get(rid)
        if target:
            out.append(target)
    return out
