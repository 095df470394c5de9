"""Model-free table extraction from ruling lines (img2table-style
fallback).

Port of ``ruling_line_mask`` and ``opencv_table_extract`` of
``rapiddoc_tpu/models/table/img2table.py`` (role parity with the
reference's optional img2table path, rapid_table.py:219-249), with
OpenCV's adaptive threshold and morphological opening replaced by their
bit-equal numpy versions (``utils/morph.py``). Host only: adaptive
threshold -> horizontal and vertical line opening -> lattice -> cell
components, through the UNet's cell and grid recovery. The borderless
extractor (``_cluster_rows``, ``_column_boundaries`` and
``borderless_table_extract``) works from OCR word boxes and is the JAX
package's code, unchanged, with the low finding of ``ADVICE.md`` at
``img2table.py:175`` kept as reference behaviour.
"""
from __future__ import annotations

import numpy as np

from ...utils.morph import adaptive_threshold_mean, morph_open_rect
from ..ocr.pre_post import rgb_to_gray
from .unet import cells_to_grid, extract_cells_from_mask


def ruling_line_mask(img: np.ndarray, min_line_frac: float = 0.25) -> np.ndarray:
    """Binary mask of horizontal+vertical ruling lines. `min_line_frac`
    is the minimum line length as a fraction of the image side."""
    gray = rgb_to_gray(img) if img.ndim == 3 else img
    binary = adaptive_threshold_mean(255 - gray, 255, 15, -2)
    h, w = gray.shape
    hk = max(8, int(w * min_line_frac * 0.5))
    vk = max(8, int(h * min_line_frac * 0.5))
    horiz = morph_open_rect(binary, hk, 1)
    vert = morph_open_rect(binary, 1, vk)
    return ((horiz > 0) | (vert > 0)).astype(np.float32)


def opencv_table_extract(
    img: np.ndarray,
) -> tuple[list[list[float]], list[tuple[int, int, int, int]]]:
    """Image -> (cell boxes in source px, logical grid). Empty when no
    ruling lattice is found (caller falls back to wireless models)."""
    mask = ruling_line_mask(img)
    if mask.sum() < 50:
        return [], []
    cells = extract_cells_from_mask(mask, min_cell_area=100)
    if len(cells) < 2:
        return [], []
    grid = cells_to_grid(cells)
    return cells, grid


# ---------------------------------------------------------- borderless


def _cluster_rows(
    items: list[tuple[list[float], str]]
) -> list[list[tuple[list[float], str]]]:
    """Group OCR boxes into text rows by y-overlap (img2table's implicit
    row recovery, which the external lib performs from word boxes)."""
    items = sorted(items, key=lambda it: (it[0][1] + it[0][3]) / 2)
    rows: list[list[tuple[list[float], str]]] = []
    for it in items:
        y0, y1 = it[0][1], it[0][3]
        placed = False
        for row in rows:
            ry0 = min(b[0][1] for b in row)
            ry1 = max(b[0][3] for b in row)
            inter = min(y1, ry1) - max(y0, ry0)
            if inter > 0.5 * min(y1 - y0, ry1 - ry0):
                row.append(it)
                placed = True
                break
        if not placed:
            rows.append([it])
    for row in rows:
        row.sort(key=lambda it: it[0][0])
    rows.sort(key=lambda r: min(b[0][1] for b in r))
    return rows


def _column_boundaries(
    rows: list[list[tuple[list[float], str]]], width: int,
    min_gap: float = 8.0,
) -> list[float]:
    """Column separator x-positions: maxima of the horizontal whitespace
    shared by (almost) every row — the whitespace-corridor analysis the
    external img2table uses for borderless column detection."""
    if not rows:
        return []
    cover = np.zeros(max(int(width), 1), np.int32)
    for row in rows:
        for (x0, _y0, x1, _y1), _t in row:
            a = max(int(x0), 0)
            b = min(int(x1) + 1, len(cover))
            if b > a:
                cover[a:b] += 1
    n_rows = len(rows)
    # a corridor: consecutive x where at most ~15% of rows have ink
    free = cover <= max(0, round(0.15 * n_rows))
    bounds: list[float] = []
    x = 0
    W = len(cover)
    while x < W:
        if free[x]:
            start = x
            while x < W and free[x]:
                x += 1
            if x - start >= min_gap and start > 0 and x < W:
                bounds.append((start + x) / 2.0)
        else:
            x += 1
    return bounds


def borderless_table_extract(
    items: list[tuple[list[float], str]],
    shape: tuple[int, int],
) -> str:
    """OCR word boxes -> HTML table for BORDERLESS tables (role parity
    with img2table's borderless_tables=True path the reference enables
    for wireless-classified tables, rapid_table.py:228-237).

    Rows come from y-overlap clustering, columns from whitespace
    corridors shared across rows; a box spanning several columns emits
    a colspan. Returns "" when the layout does not look tabular
    (single column or a single row)."""
    items = [
        (list(map(float, b)), t) for b, t in items if t and str(t).strip()
    ]
    if len(items) < 4:
        return ""
    h, w = shape[:2]
    rows = _cluster_rows(items)
    if len(rows) < 2:
        return ""
    bounds = _column_boundaries(rows, w)
    if not bounds:
        return ""
    edges = [0.0] + sorted(bounds) + [float(w)]
    n_cols = len(edges) - 1
    if n_cols < 2:
        return ""

    def col_of(x: float) -> int:
        for c in range(n_cols):
            if edges[c] <= x < edges[c + 1]:
                return c
        return n_cols - 1

    html_rows: list[str] = []
    multi_col_rows = 0
    for row in rows:
        # merge boxes landing in the same column cell
        cells: list[list[str]] = [[] for _ in range(n_cols)]
        spans: dict[int, int] = {}
        for (x0, _y0, x1, _y1), text in row:
            c0 = col_of(x0 + 1)
            c1 = col_of(max(x1 - 1, x0 + 1))
            cells[c0].append(str(text).strip())
            if c1 > c0:
                spans[c0] = max(spans.get(c0, 1), c1 - c0 + 1)
        tds = []
        c = 0
        nonempty = 0
        while c < n_cols:
            span = spans.get(c, 1)
            text = " ".join(x for x in cells[c] if x)
            if text:
                nonempty += 1
            if span > 1:
                tds.append(f'<td colspan="{span}">{text}</td>')
            else:
                tds.append(f"<td>{text}</td>")
            c += span
        if nonempty >= 2:
            multi_col_rows += 1
        html_rows.append("<tr>" + "".join(tds) + "</tr>")
    # tabular sanity: at least two rows must have >1 NON-EMPTY column
    # (empty <td> padding must not make a single-column layout pass)
    if multi_col_rows < 2:
        return ""
    return "<table><tbody>" + "".join(html_rows) + "</tbody></table>"
