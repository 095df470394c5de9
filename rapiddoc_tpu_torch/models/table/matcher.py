"""Table matcher: assign text boxes to predicted cells, emit HTML.

Copy of ``rapiddoc_tpu/models/table/matcher.py`` (role parity with the
reference matcher: rapid_doc/model/table/rapid_table_self/table_matcher/
main.py — match_result :171 IoU+distance assignment, get_pred_html :202,
decode_logic_points :273).
"""
from __future__ import annotations

import html as html_mod

import numpy as np

from ...utils import boxes as B


def match_ocr_to_cells(
    cell_boxes: list[list[float]],
    ocr_items: list[dict],
) -> list[list[int]]:
    """For each cell, indices of OCR items assigned to it (by max overlap,
    falling back to nearest center)."""
    assignments: list[list[int]] = [[] for _ in cell_boxes]
    if not cell_boxes:
        return assignments
    cells = np.asarray(cell_boxes, dtype=np.float64)
    for i, item in enumerate(ocr_items):
        box = item["bbox"]
        overlaps = B.overlap_matrix(np.asarray([box]), cells)[0]
        j = int(np.argmax(overlaps))
        if overlaps[j] <= 0.1:
            j = int(
                np.argmin([B.center_distance(box, c) for c in cell_boxes])
            )
        assignments[j].append(i)
    # reading order inside each cell
    for idxs in assignments:
        idxs.sort(key=lambda i: (ocr_items[i]["bbox"][1], ocr_items[i]["bbox"][0]))
    return assignments


def build_html_from_grid(
    grid: list[tuple[int, int, int, int]],
    cell_texts: list[str],
) -> str:
    """(row, col, rowspan, colspan) cells + texts -> HTML table."""
    if not grid:
        return ""
    n_rows = max(r + rs for r, _, rs, _ in grid)
    rows: dict[int, list[tuple[int, str, int, int]]] = {}
    for (r, c, rs, cs), text in zip(grid, cell_texts):
        rows.setdefault(r, []).append((c, text, rs, cs))
    out = ["<table><tbody>"]
    for r in range(n_rows):
        out.append("<tr>")
        for c, text, rs, cs in sorted(rows.get(r, [])):
            attrs = ""
            if rs > 1:
                attrs += f' rowspan="{rs}"'
            if cs > 1:
                attrs += f' colspan="{cs}"'
            out.append(f"<td{attrs}>{html_mod.escape(text, quote=False)}</td>")
        out.append("</tr>")
    out.append("</tbody></table>")
    return "".join(out)


def html_from_structure_tokens(
    structure_tokens: list[str], cell_texts: list[str]
) -> str:
    """Merge SLANet/UNITABLE structure-token streams with cell texts: each
    '</td>' (or '<td></td>') consumes the next cell text."""
    out: list[str] = []
    cell_i = 0
    for tok in structure_tokens:
        if tok in ("<td></td>", "<td>[]</td>"):
            text = cell_texts[cell_i] if cell_i < len(cell_texts) else ""
            out.append(f"<td>{html_mod.escape(text, quote=False)}</td>")
            cell_i += 1
        elif tok == "</td>":
            text = cell_texts[cell_i] if cell_i < len(cell_texts) else ""
            out.append(html_mod.escape(text, quote=False))
            out.append(tok)
            cell_i += 1
        else:
            out.append(tok)
    html = "".join(out)
    if "<table" not in html:
        html = f"<table><tbody>{html}</tbody></table>"
    return html
