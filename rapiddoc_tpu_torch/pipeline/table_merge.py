"""Cross-page table merging with reference semantics.

Behavioral counterpart of the reference engine (reference:
rapid_doc/backend/utils/utils.py:14 cross_page_table_merge +
rapid_doc/utils/table_merge.py): the last table of page N merges with the
first table of page N+1 when
  - the continuation has no caption, or its caption carries a
    continuation marker ("续表", "(continued)", ... — table_merge.py:13-26);
  - the previous table has no footnote (unless continuation-marked);
  - the two tables have similar width (<10% difference);
  - their column structure matches: same total columns, or the boundary
    rows agree on effective/actual columns or rendered visual segments,
    computed with a rowspan-aware occupancy scan (table_merge.py:85-155,
    :456-480) so a cell spanning the page break still matches;
  - repeated header rows on the continuation (matched structurally by
    cell texts/colspans/rowspans over the first <=5 rows, with a visual
    text-only fallback and rowspan expansion — table_merge.py:483-571)
    are dropped before appending.
On merge, reference-parity refinements apply (table_merge.py:681-948):
  - a column-count mismatch is healed by colspan surgery on the narrower
    table, copying the boundary row's span structure where the visual
    cell count matches and widening the last cell otherwise
    (adjust_table_rows_colspan :681-719);
  - an upstream ``cell_merge`` hint (0/1 per visual column on the
    continuation block) splices first-data-row cell content into the
    previous table's last row, aligned through a rowspan-aware visual
    column mapping; a fully-absorbed row is dropped with its blank
    rowspan placeholders carried down (:738-854);
  - a non-continuation caption sitting BELOW the table body does not
    block the merge and is restored as a plain text block after it
    (:206-260, :993-997).
Merged-away blocks get SplitFlag.LINES_DELETED, footnotes carry over as
cross-page blocks, exactly like perform_table_merge (:857-949).
"""
from __future__ import annotations

import html as _htmlmod
import re
from html.parser import HTMLParser

from ..types import BlockType, ContentType, SplitFlag

CONTINUATION_END_MARKERS = [
    "(续)", "(续表)", "(续上表)", "(continued)", "(cont.)", "(cont’d)",
    "(…continued)", "续表",
]
CONTINUATION_INLINE_MARKERS = ["(continued)"]
MAX_HEADER_ROWS = 5


_SEMANTIC_TAGS = (
    "<img", "<svg", "<math", "<eq", "<table", "<figure", "<object",
    "<embed", "<canvas",
)


class _Cell:
    __slots__ = ("text", "colspan", "rowspan", "tag", "attrs", "inner")

    def __init__(self, text: str, colspan: int, rowspan: int,
                 tag: str = "td", attrs: dict | None = None,
                 inner: str | None = None):
        self.text = text
        self.colspan = colspan
        self.rowspan = rowspan
        self.tag = tag
        self.attrs = dict(attrs or {})
        # inner HTML incl. nested markup (<b>, <img .../>, ...); text is
        # the plain-text projection used for signatures
        self.inner = inner if inner is not None else _htmlmod.escape(text)

    def set_colspan(self, n: int) -> None:
        self.colspan = max(1, int(n))
        if self.colspan > 1:
            self.attrs["colspan"] = str(self.colspan)
        else:
            self.attrs.pop("colspan", None)

    def set_rowspan(self, n: int) -> None:
        self.rowspan = max(1, int(n))
        if self.rowspan > 1:
            self.attrs["rowspan"] = str(self.rowspan)
        else:
            self.attrs.pop("rowspan", None)

    def clear(self) -> None:
        self.text = ""
        self.inner = ""

    def append_content(self, other: "_Cell") -> None:
        self.text = (self.text + other.text).strip() if (
            self.text or other.text
        ) else self.text
        self.inner = self.inner + other.inner

    def has_semantic_content(self) -> bool:
        """Text or an embedded visual element (ref: _cell_has_semantic_content,
        table_merge.py:722-730)."""
        if self.text.strip():
            return True
        low = self.inner.lower()
        return any(t in low for t in _SEMANTIC_TAGS)

    def copy_blank(self) -> "_Cell":
        return _Cell("", self.colspan, self.rowspan, self.tag,
                     self.attrs, "")

    @property
    def html(self) -> str:
        attrs_html = "".join(
            f' {k}="{v}"' for k, v in self.attrs.items() if v is not None
        )
        return f"<{self.tag}{attrs_html}>{self.inner}</{self.tag}>"


class _TableParser(HTMLParser):
    """html -> rows of _Cell (+ raw row html for re-serialization)."""

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.rows: list[list[_Cell]] = []
        self._cur_row: list[_Cell] | None = None
        self._cell_attrs: dict | None = None
        self._cell_tag = "td"
        self._cell_text: list[str] = []
        self._cell_inner: list[str] = []
        self._cell_depth = 0

    @staticmethod
    def _attrs_html(attrs) -> str:
        return "".join(
            f' {k}="{v}"' if v is not None else f" {k}" for k, v in attrs
        )

    def handle_starttag(self, tag, attrs):
        if tag == "tr":
            self._cur_row = []
        elif tag in ("td", "th"):
            if self._cell_depth == 0:
                self._cell_attrs = dict(attrs)
                self._cell_tag = tag
                self._cell_text = []
                self._cell_inner = []
            self._cell_depth += 1
        elif self._cell_depth > 0:
            self._cell_inner.append(f"<{tag}{self._attrs_html(attrs)}>")

    def handle_startendtag(self, tag, attrs):
        if self._cell_depth > 0 and tag not in ("td", "th", "tr"):
            self._cell_inner.append(f"<{tag}{self._attrs_html(attrs)}/>")

    def handle_endtag(self, tag):
        if tag in ("td", "th") and self._cell_depth > 0:
            self._cell_depth -= 1
            if self._cell_depth == 0 and self._cur_row is not None:
                a = self._cell_attrs or {}

                def _int(v):
                    try:
                        return max(1, int(v))
                    except (TypeError, ValueError):
                        return 1

                text = "".join(self._cell_text)
                self._cur_row.append(
                    _Cell(
                        text.strip(),
                        _int(a.get("colspan")),
                        _int(a.get("rowspan")),
                        self._cell_tag,
                        a,
                        "".join(self._cell_inner).strip(),
                    )
                )
        elif tag == "tr" and self._cur_row is not None:
            self.rows.append(self._cur_row)
            self._cur_row = None
        elif self._cell_depth > 0:
            self._cell_inner.append(f"</{tag}>")

    def handle_data(self, data):
        if self._cell_depth > 0:
            self._cell_text.append(data)
            self._cell_inner.append(_htmlmod.escape(data))


def parse_rows(html: str) -> list[list[_Cell]]:
    p = _TableParser()
    try:
        p.feed(html)
    except Exception:
        return []
    return p.rows


def scan_rows(rows: list[list[_Cell]]):
    """Rowspan-aware occupancy scan -> (per-row metrics, total_cols).

    metrics per row: (effective_cols, actual_cols, visual_cols)."""
    occupied: dict[int, set[int]] = {}
    max_cols = 0
    metrics: list[tuple[int, int, int]] = []
    for ridx, row in enumerate(rows):
        occ = occupied.setdefault(ridx, set())
        col = 0
        actual = 0
        for cell in row:
            while col in occ:
                col += 1
            actual += cell.colspan
            for ro in range(cell.rowspan):
                tgt = occupied.setdefault(ridx + ro, set())
                tgt.update(range(col, col + cell.colspan))
            col += cell.colspan
            max_cols = max(max_cols, col)
        eff = max(occ) + 1 if occ else 0
        max_cols = max(max_cols, eff)
        metrics.append((eff, actual, len(row)))
    return metrics, max_cols


def _visual_sources(rows: list[list[_Cell]], target_idx: int):
    """Scan up to target_idx; -> ({col: (source_row, source_cell)}, total_cols)
    for the target row — the identity of the cell whose colspan/rowspan
    covers each grid position (reference: _scan_row_visual_sources,
    table_merge.py:400-429)."""
    if target_idx < 0:
        target_idx += len(rows)
    if not (0 <= target_idx < len(rows)):
        return {}, 0
    occupied: dict[int, dict[int, tuple[int, int]]] = {}
    total_cols = 0
    for ridx in range(target_idx + 1):
        occ = occupied.setdefault(ridx, {})
        col = 0
        for cidx, cell in enumerate(rows[ridx]):
            while col in occ:
                col += 1
            marker = (ridx, cidx)
            for ro in range(cell.rowspan):
                tgt = occupied.setdefault(ridx + ro, {})
                for c in range(col, col + cell.colspan):
                    tgt[c] = marker
            col += cell.colspan
            total_cols = max(total_cols, col)
    return occupied.get(target_idx, {}), total_cols


def rendered_segments(rows: list[list[_Cell]], target_idx: int) -> int:
    """Visual segment count of a row after rendering: each explicit cell is
    one segment regardless of colspan, and a rowspan placeholder inherited
    from an earlier row is a segment too — contiguous columns only count as
    one segment when they come from the same source cell (reference:
    calculate_row_rendered_segments, table_merge.py:456-480)."""
    target, total_cols = _visual_sources(rows, target_idx)
    segments = 0
    prev_marker = None
    for col in range(total_cols):
        marker = target.get(col)
        if marker is None:
            prev_marker = None
            continue
        if marker != prev_marker:
            segments += 1
            prev_marker = marker
    return segments


def visual_col_mapping(rows: list[list[_Cell]], target_idx: int) -> list[int]:
    """Starting visual column of each explicit cell in the target row,
    skipping columns occupied by rowspan placeholders inherited from
    earlier rows (reference: build_visual_col_mapping,
    table_merge.py:432-453)."""
    if target_idx < 0:
        target_idx += len(rows)
    if not (0 <= target_idx < len(rows)):
        return []
    occupied, _ = _visual_sources(rows, target_idx)
    col = 0
    mapping = []
    for cell in rows[target_idx]:
        while col in occupied and occupied[col][0] < target_idx:
            col += 1
        mapping.append(col)
        col += cell.colspan
    return mapping


def adjust_rows_colspan(
    rows: list[list[_Cell]],
    start: int,
    end: int,
    metrics: list[tuple[int, int, int]],
    ref_structure: list[int],
    ref_visual_cols: int,
    target_cols: int,
) -> bool:
    """Widen the narrower table's rows to target_cols by colspan surgery
    (reference: adjust_table_rows_colspan, table_merge.py:681-719): a row
    whose visual cell count matches the reference boundary row copies that
    row's colspan structure; otherwise the last cell absorbs the deficit.
    Returns True when any cell changed."""
    changed = False
    for ridx in range(start, min(end, len(rows))):
        row = rows[ridx]
        if not row:
            continue
        eff, actual, visual = metrics[ridx]
        if eff >= target_cols or actual >= target_cols:
            continue
        if visual == ref_visual_cols:
            if len(row) == len(ref_structure):
                for cell, ref_span in zip(row, ref_structure):
                    if cell.colspan != ref_span:
                        cell.set_colspan(ref_span)
                        changed = True
        else:
            diff = target_cols - eff
            if diff > 0:
                row[-1].set_colspan(row[-1].colspan + diff)
                changed = True
    return changed


def _insert_cell_before_visual_column(
    rows: list[list[_Cell]], target_idx: int, start_vcol: int, cell: _Cell,
) -> None:
    """Insert a cell into the target row just before the first explicit cell
    whose visual column exceeds start_vcol (reference:
    _insert_cell_before_visual_column, table_merge.py:738-749)."""
    row = rows[target_idx]
    mapping = visual_col_mapping(rows, target_idx)
    for idx, cell_vcol in enumerate(mapping):
        if cell_vcol > start_vcol:
            row.insert(idx, cell)
            return
    row.append(cell)


def _carry_rowspan_structure_to_next_row(
    rows: list[list[_Cell]], row_idx: int,
) -> None:
    """Before deleting a row, sink its blank rowspan-bearing placeholder
    cells into the next row (rowspan-1) so downstream column alignment
    survives (reference: _carry_rowspan_structure_to_next_row,
    table_merge.py:752-777)."""
    nxt = row_idx + 1
    if nxt >= len(rows):
        return
    mapping = visual_col_mapping(rows, row_idx)
    carried: list[tuple[int, _Cell]] = []
    for cell, start_vcol in zip(rows[row_idx], mapping):
        if cell.rowspan <= 1 or cell.has_semantic_content():
            continue
        blank = cell.copy_blank()
        blank.set_rowspan(cell.rowspan - 1)
        carried.append((start_vcol, blank))
    for start_vcol, blank in sorted(carried, key=lambda t: t[0], reverse=True):
        _insert_cell_before_visual_column(rows, nxt, start_vcol, blank)


def apply_cell_merge(
    prev_rows: list[list[_Cell]],
    cur_rows: list[list[_Cell]],
    header_count: int,
    cell_merge,
) -> bool:
    """Apply an upstream ``cell_merge`` hint (0/1 per visual column): where
    1, the continuation's first data row cell content is appended to the
    matching cell of the previous table's last row (aligned via the
    rowspan-aware visual column mapping), then cleared; if the whole row
    loses its semantic content it is dropped, sinking blank rowspan
    placeholders first (reference: _apply_cell_merge,
    table_merge.py:780-854). Returns True when the previous table's rows
    changed (its HTML must then be re-serialized)."""
    if not cell_merge:
        return False
    if header_count >= len(cur_rows) or not prev_rows:
        return False
    first_row = cur_rows[header_count]
    last_idx = len(prev_rows) - 1
    last_row = prev_rows[last_idx]
    vmap1 = visual_col_mapping(prev_rows, last_idx)
    vmap2 = visual_col_mapping(cur_rows, header_count)
    # visual column -> explicit cell index, expanding colspans
    vcol_to_cell1: dict[int, int] = {}
    for ci, start in enumerate(vmap1):
        for c in range(start, start + last_row[ci].colspan):
            vcol_to_cell1[c] = ci
    vcol_to_cell2: dict[int, int] = {}
    for ci, start in enumerate(vmap2):
        for c in range(start, start + first_row[ci].colspan):
            vcol_to_cell2[c] = ci
    # one transfer per unique (src, dst) pair, then clear only the sources
    # that actually transferred
    transferred: set[tuple[int, int]] = set()
    for vi, flag in enumerate(cell_merge):
        if flag != 1:
            continue
        ci1, ci2 = vcol_to_cell1.get(vi), vcol_to_cell2.get(vi)
        if ci1 is None or ci2 is None:
            continue
        if (ci1, ci2) in transferred:
            continue
        last_row[ci1].append_content(first_row[ci2])
        transferred.add((ci1, ci2))
    for _, ci2 in transferred:
        first_row[ci2].clear()
    if not any(c.has_semantic_content() for c in first_row):
        _carry_rowspan_structure_to_next_row(cur_rows, header_count)
        del cur_rows[header_count]
    return bool(transferred)


def _norm_text(s: str) -> str:
    return re.sub(r"\s+", "", s).lower()


def _row_signature(row: list[_Cell], eff: int):
    return (
        len(row),
        eff,
        tuple(c.colspan for c in row),
        tuple(c.rowspan for c in row),
        tuple(_norm_text(c.text) for c in row),
    )


def detect_header_rows(
    prev_rows, prev_metrics, cur_rows, cur_metrics,
    max_header_rows: int = MAX_HEADER_ROWS,
) -> int:
    """Leading rows of the continuation that repeat the previous table's
    header (structural match first, text-only visual fallback)."""
    n = min(len(prev_rows), len(cur_rows), max_header_rows)
    count = 0
    for i in range(n):
        if _row_signature(prev_rows[i], prev_metrics[i][0]) == _row_signature(
            cur_rows[i], cur_metrics[i][0]
        ):
            count += 1
        else:
            break
    if count == 0:
        for i in range(n):
            same_texts = tuple(_norm_text(c.text) for c in prev_rows[i]) == tuple(
                _norm_text(c.text) for c in cur_rows[i]
            )
            if same_texts and prev_metrics[i][0] == cur_metrics[i][0]:
                count += 1
            else:
                break
    return count


def expand_header_by_rowspan(rows, header_count: int) -> int:
    """A skipped header row's rowspan must take its covered rows along
    (reference: _expand_header_count_by_rowspan)."""
    if header_count <= 0 or not rows:
        return header_count
    expanded = min(header_count, len(rows))
    i = 0
    while i < expanded:
        for cell in rows[i]:
            if cell.rowspan > 1:
                expanded = min(max(expanded, i + cell.rowspan), len(rows))
        i += 1
    return expanded


# --------------------------------------------------------------- block glue


def _table_html(block: dict) -> str | None:
    for sub in block.get("blocks", []):
        if sub["type"] == BlockType.TABLE_BODY:
            for line in sub.get("lines", []):
                for span in line.get("spans", []):
                    if span.get("type") == ContentType.TABLE and span.get("html"):
                        return span["html"]
    return None


def _set_table_html(block: dict, html: str) -> None:
    for sub in block.get("blocks", []):
        if sub["type"] == BlockType.TABLE_BODY:
            for line in sub.get("lines", []):
                for span in line.get("spans", []):
                    if span.get("type") == ContentType.TABLE:
                        span["html"] = html
                        return


def _caption_text(block: dict) -> str:
    parts = []
    for line in block.get("lines", []):
        for span in line.get("spans", []):
            if span.get("content"):
                parts.append(span["content"])
    return "".join(parts)


def _is_continuation_caption(caption_block: dict) -> bool:
    from .mkcontent import _full_to_half

    text = _full_to_half(_caption_text(caption_block).strip()).lower()
    return any(
        text.endswith(m.lower()) for m in CONTINUATION_END_MARKERS
    ) or any(m.lower() in text for m in CONTINUATION_INLINE_MARKERS)


def _is_post_table_caption(table_block: dict, caption_block: dict) -> bool:
    """A caption that sits BELOW the table body and carries no continuation
    marker is a mis-attached next-paragraph title: it must not block the
    cross-page merge, and is later restored as a plain text block
    (reference: _is_post_table_non_continuation_caption,
    table_merge.py:206-224)."""
    if _is_continuation_caption(caption_block):
        return False
    body_bbox = None
    for sub in table_block.get("blocks", []):
        if sub["type"] == BlockType.TABLE_BODY:
            body_bbox = sub.get("bbox")
            break
    cap_bbox = caption_block.get("bbox")
    if not body_bbox or not cap_bbox:
        return False
    return cap_bbox[1] >= body_bbox[3]


def _post_table_captions(table_block: dict) -> list[dict]:
    return [
        b
        for b in table_block.get("blocks", [])
        if b["type"] == BlockType.TABLE_CAPTION
        and _is_post_table_caption(table_block, b)
    ]


def _can_merge(prev_block: dict, cur_block: dict) -> bool:
    captions = [
        b
        for b in cur_block.get("blocks", [])
        if b["type"] == BlockType.TABLE_CAPTION and b.get("lines")
        and not _is_post_table_caption(cur_block, b)
    ]
    footnotes = sum(
        1
        for b in prev_block.get("blocks", [])
        if b["type"] == BlockType.TABLE_FOOTNOTE
    )
    if captions:
        if not any(_is_continuation_caption(b) for b in captions):
            return False
        if footnotes > 1:
            return False
    elif footnotes > 0:
        return False
    x0a, _, x1a, _ = cur_block["bbox"]
    x0b, _, x1b, _ = prev_block["bbox"]
    wa, wb = x1a - x0a, x1b - x0b
    if wa > 0 and wb > 0 and abs(wa - wb) / min(wa, wb) >= 0.1:
        return False
    return True


def _structure_matches(prev_rows, prev_metrics, prev_total,
                       cur_rows, cur_metrics, cur_total):
    """-> (mergeable, header_rows_to_skip, prev_last_idx, cur_first_idx).

    Boundary rows match when effective or actual column counts agree, or —
    for rowspan-fragmented boundaries — when their rendered visual segment
    counts agree (reference: check_rows_match, table_merge.py:646-665)."""
    headers = detect_header_rows(prev_rows, prev_metrics, cur_rows, cur_metrics)
    headers = expand_header_by_rowspan(cur_rows, headers)
    last_idx = -1
    for i in range(len(prev_rows) - 1, -1, -1):
        if prev_rows[i]:
            last_idx = i
            break
    first_idx = headers if headers < len(cur_rows) else -1
    if prev_total == cur_total:
        return True, headers, last_idx, first_idx
    # boundary rows: previous last data row vs continuation first data row
    if last_idx < 0 or first_idx < 0:
        return False, headers, last_idx, first_idx
    last = prev_metrics[last_idx]
    first = cur_metrics[first_idx]
    if last[0] == first[0] or last[1] == first[1]:
        return True, headers, last_idx, first_idx
    if rendered_segments(prev_rows, last_idx) == rendered_segments(
        cur_rows, first_idx
    ):
        return True, headers, last_idx, first_idx
    return False, headers, last_idx, first_idx


def _merge_html(top: str, cur_rows: list[list[_Cell]], skip: int) -> str:
    body = "".join(
        "<tr>" + "".join(c.html for c in row) + "</tr>"
        for row in cur_rows[skip:]
    )
    if not body:
        return top
    m = re.search(r"</tbody>", top, re.I) or re.search(r"</table>", top, re.I)
    if not m:
        return top + body
    return top[: m.start()] + body + top[m.start() :]


def _rebuild_html(prev_rows: list[list[_Cell]], cur_rows: list[list[_Cell]],
                  skip: int) -> str:
    """Full re-serialization — needed when the PREVIOUS table's cells were
    mutated (colspan surgery / cell_merge), so splicing into its original
    HTML would drop those edits."""
    rows = prev_rows + cur_rows[skip:]
    return (
        "<table>"
        + "".join(
            "<tr>" + "".join(c.html for c in row) + "</tr>" for row in rows
        )
        + "</table>"
    )


def cross_page_table_merge(page_info_list: list[dict]) -> None:
    import os

    enable = os.environ.get(
        "RAPIDDOC_TABLE_MERGE_ENABLE",
        os.environ.get("MINERU_TABLE_MERGE_ENABLE", "true"),
    )
    if enable.lower() in ("false", "0", "no"):
        return
    # walk back-to-front so chains of continuations collapse into page 1
    # (reference: merge_table iterates page_idx descending)
    for page_idx in range(len(page_info_list) - 1, 0, -1):
        next_page = page_info_list[page_idx]
        prev_page = page_info_list[page_idx - 1]
        next_blocks = next_page.get("para_blocks") or next_page.get(
            "preproc_blocks"
        ) or []
        prev_blocks = prev_page.get("para_blocks") or prev_page.get(
            "preproc_blocks"
        ) or []
        if not (next_blocks and next_blocks[0]["type"] == BlockType.TABLE):
            continue
        if not (prev_blocks and prev_blocks[-1]["type"] == BlockType.TABLE):
            continue
        first, last = next_blocks[0], prev_blocks[-1]
        if not _can_merge(last, first):
            continue
        html_top, html_bot = _table_html(last), _table_html(first)
        if not html_top or not html_bot:
            continue
        prev_rows = parse_rows(html_top)
        cur_rows = parse_rows(html_bot)
        if not prev_rows or not cur_rows:
            continue
        prev_metrics, prev_total = scan_rows(prev_rows)
        cur_metrics, cur_total = scan_rows(cur_rows)
        ok, headers, last_idx, first_idx = _structure_matches(
            prev_rows, prev_metrics, prev_total,
            cur_rows, cur_metrics, cur_total,
        )
        if not ok:
            continue
        # mis-attached below-body captions: pull them out before merging,
        # restore as plain text after (ref: perform_table_merge :993-997)
        post_captions = _post_table_captions(first)
        restored: list[dict] = []
        if post_captions:
            from copy import deepcopy

            ids = {id(b) for b in post_captions}
            first["blocks"] = [
                b for b in first.get("blocks", []) if id(b) not in ids
            ]
            for cap in post_captions:
                t = deepcopy(cap)
                t["type"] = BlockType.TEXT
                restored.append(t)
        # column-count mismatch: colspan surgery widens the narrower table
        # toward the other's width (ref: perform_table_merge :872-908)
        prev_dirty = False
        if prev_total != cur_total and last_idx >= 0 and first_idx >= 0:
            if prev_total > cur_total:
                ref_row = prev_rows[last_idx]
                adjust_rows_colspan(
                    cur_rows, headers, len(cur_rows), cur_metrics,
                    [c.colspan for c in ref_row], len(ref_row), prev_total,
                )
            else:
                ref_row = cur_rows[first_idx]
                prev_dirty = adjust_rows_colspan(
                    prev_rows, 0, len(prev_rows), prev_metrics,
                    [c.colspan for c in ref_row], len(ref_row), cur_total,
                )
        prev_dirty = (
            apply_cell_merge(
                prev_rows, cur_rows, headers, first.get("cell_merge")
            )
            or prev_dirty
        )
        if prev_dirty:
            merged = _rebuild_html(prev_rows, cur_rows, headers)
        else:
            merged = _merge_html(html_top, cur_rows, headers)
        _set_table_html(last, merged)
        # footnotes travel to the merged table as cross-page blocks
        carried = [
            dict(b, **{SplitFlag.CROSS_PAGE: True})
            for b in first.get("blocks", [])
            if b["type"] == BlockType.TABLE_FOOTNOTE
        ]
        if carried:
            last["blocks"] = [
                b
                for b in last.get("blocks", [])
                if b["type"] != BlockType.TABLE_FOOTNOTE
            ] + carried
        first[SplitFlag.LINES_DELETED] = True
        for sub in first.get("blocks", []):
            sub["lines"] = []
            sub[SplitFlag.LINES_DELETED] = True
        for key in ("para_blocks", "preproc_blocks"):
            blocks = next_page.get(key)
            if blocks and first in blocks:
                i = blocks.index(first)
                next_page[key] = blocks[:i] + restored + blocks[i + 1 :]
