"""Enhanced (v3) reading order: region model + label tiers + cross-layout.

Behavioral counterpart of the reference's xycut-plus-v3 chain
(reference: rapid_doc/utils/block_sort.py:15-246 — line-height virtual
lines inserted into tall blocks before cutting; rapid_doc/model/
reading_order/layout_parsing/xycut_plus_v3.py + layout_objects.py +
xycut_enhanced/xycuts.py — label-aware region sort with header/footer
tiers, gap-based pre-cuts, cross-layout detection and weighted-distance
insertion). Re-derived, not translated; the behaviors carried over:

1. **label tiers** (xycut_enhanced/xycuts.py:460 onwards): headers sort
   first, footers after the body, unordered blocks (seals, numbers,
   asides) last; doc_title is distance-inserted (first one leads).
2. **gap-based band pre-cuts** (xycuts.py pre_process:44-210): the page
   is pre-cut into top-down bands at y-gaps >= 3 text-line-heights, at
   moderate gaps (1.2-3 line heights) only when the column structure
   above and below differs, and at the boundaries of horizontally
   centered solo blocks; full-content-width blocks also separate bands.
3. **cross-layout detection** (xycuts.py get_layout_structure:271-371):
   a block whose x-projection bridges two blocks that sit side-by-side
   (y-overlapping, x-disjoint) is a column-spanning element — it is
   REMOVED from the xy-cut set (it would otherwise bridge the column
   gap and destroy the cut) and weighted-distance inserted afterwards;
   `reference`-labeled spanners insert at the tail (cross_reference).
4. **virtual lines** (block_sort.py insert_lines_into_block:91-137):
   tall blocks are subdivided into line boxes so projection cuts see
   multi-column structure through figures and long paragraphs.
5. **weighted-distance insert** (xycut_enhanced/utils.py:361-470):
   nearest-edge distance dominates (x1e4), up-edge breaks ties (x1),
   left-edge last (x1e-4); insertion goes after the chosen anchor when
   the block reads later than it.

All pure host-side geometry (numpy) — never traced by XLA.
"""
from __future__ import annotations

import numpy as np

from .xycut import xycut_order

# label tiers (reference: layout_parsing/setting.py BLOCK_LABEL_MAP)
HEADER_LABELS = {"header", "header_image"}
FOOTER_LABELS = {"footer", "footer_image", "footnote", "vision_footnote"}
UNORDERED_LABELS = {"aside_text", "seal", "number", "formula_number"}
DOC_TITLE_LABELS = {"doc_title"}
VISION_LABELS = {"image", "figure", "table", "chart", "vision"}
REFERENCE_LABELS = {"reference", "reference_content"}


def virtual_lines_for_block(
    bbox: list[float], line_height: float, page_w: float, page_h: float
) -> list[list[float]]:
    """Split a block box into stacked line boxes (reference:
    utils/block_sort.py insert_lines_into_block :91-137 heuristics)."""
    x0, y0, x1, y1 = bbox
    bh, bw = y1 - y0, x1 - x0
    if bh <= line_height * 2 or line_height <= 0:
        return [[x0, y0, x1, y1]]
    if bh > page_h * 0.25 and page_w * 0.5 > bw > page_w * 0.25:
        n = max(1, int(bh / line_height))  # probable column fragment: fine
    elif bw > page_w * 0.4:
        n = 3  # wide complex region: keep coarse
    elif bw > page_w * 0.25:
        n = max(1, int(bh / line_height))
    elif bh / max(bw, 1e-6) > 1.2:
        return [[x0, y0, x1, y1]]  # slender: do not split
    else:
        n = 2
    step = bh / n
    return [[x0, y0 + i * step, x1, y0 + (i + 1) * step] for i in range(n)]


def _median_line_height(blocks: list[dict]) -> float:
    heights = [
        ln["bbox"][3] - ln["bbox"][1]
        for b in blocks
        for ln in b.get("lines", [])
        if ln.get("bbox") and ln["bbox"][3] > ln["bbox"][1]
    ]
    return float(np.median(heights)) if heights else 10.0


def _merged_intervals(
    spans: list[tuple[float, float]]
) -> list[tuple[float, float]]:
    """Union of 1-D intervals, sorted (reference
    calculate_discontinuous_projection, xycut_enhanced/utils.py:1070)."""
    if not spans:
        return []
    spans = sorted(spans)
    out = [list(spans[0])]
    for s, e in spans[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _x_gap_pattern(
    blocks: list[dict], idxs: list[int]
) -> tuple[tuple[int, int], ...]:
    """Quantized x-interval union — the 'column structure' signature the
    pre-cut comparison uses (reference pre_process's local-minima gap
    comparison, xycuts.py:160-205, simplified to the observable it
    feeds: does the set of column tracks change across the gap?)."""
    ivs = _merged_intervals(
        [(blocks[i]["bbox"][0], blocks[i]["bbox"][2]) for i in idxs]
    )
    return tuple((int(s // 8), int(e // 8)) for s, e in ivs)


class Region:
    """Per-page sorting context (reference layout_objects.py
    LayoutRegion, reduced to what the sort consumes): text line height,
    content width, and the tier index lists."""

    def __init__(
        self, blocks: list[dict], page_w: float, page_h: float
    ) -> None:
        self.blocks = blocks
        self.page_w = page_w
        self.page_h = page_h
        self.line_h = _median_line_height(blocks)

        def label(i: int) -> str:
            return str(blocks[i].get("original_label") or "")

        self.label = label
        n = len(blocks)
        self.headers = [i for i in range(n) if label(i) in HEADER_LABELS]
        self.footers = [i for i in range(n) if label(i) in FOOTER_LABELS]
        self.unordered = [
            i for i in range(n) if label(i) in UNORDERED_LABELS
        ]
        special = set(self.headers) | set(self.footers) | set(self.unordered)
        self.body = [i for i in range(n) if i not in special]
        xs = [blocks[i]["bbox"][0] for i in self.body] + [
            blocks[i]["bbox"][2] for i in self.body
        ]
        self.content_x0 = min(xs) if xs else 0.0
        self.content_x1 = max(xs) if xs else page_w
        self.content_w = self.content_x1 - self.content_x0


def _pre_cut_bands(region: Region, idxs: list[int]) -> list[list[int]]:
    """Top-down band pre-cuts (reference pre_process, xycuts.py:44-210).

    Cuts happen at: boundaries of full-content-width blocks; y-gaps
    >= 3 line heights; moderate y-gaps (>1.2 line heights) where the
    column structure differs across the gap; and boundaries of
    horizontally centered solo blocks (a centered heading between two
    column sets must not be xy-cut together with either)."""
    blocks = region.blocks
    if len(idxs) <= 1:
        return [idxs]
    line_h = max(region.line_h, 1.0)

    # candidate cut y-coordinates
    cuts: set[float] = set()
    y_ivs = _merged_intervals(
        [(blocks[i]["bbox"][1], blocks[i]["bbox"][3]) for i in idxs]
    )
    for (s0, e0), (s1, e1) in zip(y_ivs, y_ivs[1:]):
        gap = s1 - e0
        if gap >= line_h * 3:
            cuts.add((e0 + s1) / 2)
        elif gap > line_h * 1.2:
            # compare the ADJACENT intervals only (the reference compares
            # the stretch since the previous cut against the next
            # interval — band-local, not cumulative)
            above = [
                i for i in idxs
                if s0 <= (blocks[i]["bbox"][1] + blocks[i]["bbox"][3]) / 2
                <= e0
            ]
            below = [
                i for i in idxs
                if s1 <= (blocks[i]["bbox"][1] + blocks[i]["bbox"][3]) / 2
                <= e1
            ]
            if above and below and _x_gap_pattern(
                blocks, above
            ) != _x_gap_pattern(blocks, below):
                cuts.add((e0 + s1) / 2)

    # full-width separators and centered solo blocks cut above+below
    cx_region = (region.content_x0 + region.content_x1) / 2
    for i in idxs:
        x0, y0, x1, y1 = blocks[i]["bbox"]
        full_width = (x1 - x0) >= region.content_w * 0.86
        centered = (
            abs((x0 + x1) / 2 - cx_region) <= (x1 - x0) / 5
            and (x1 - x0) < region.content_w * 0.86
        )
        solo = all(
            j == i
            or blocks[j]["bbox"][3] <= y0
            or blocks[j]["bbox"][1] >= y1
            for j in idxs
        )
        if full_width or (centered and solo and region.label(i) not in
                          VISION_LABELS):
            if solo:
                cuts.add(y0 - 0.5)
                cuts.add(y1 + 0.5)

    if not cuts:
        return [idxs]
    bounds = sorted(cuts)
    bands: list[list[int]] = [[] for _ in range(len(bounds) + 1)]
    for i in idxs:
        cy = (blocks[i]["bbox"][1] + blocks[i]["bbox"][3]) / 2
        k = int(np.searchsorted(bounds, cy))
        bands[k].append(i)
    return [b for b in bands if b]


def _detect_cross_layout(region: Region, band: list[int]) -> list[int]:
    """Column-spanning blocks inside a band (reference
    get_layout_structure, xycuts.py:271-371): block A bridges columns
    when its x-projection overlaps BOTH of two blocks B, C that are
    x-disjoint from each other but y-overlap (side-by-side columns).
    Overlapped vision blocks also become cross-layout. Returns the
    indices to pull out of the xy-cut set."""
    blocks = region.blocks
    out: set[int] = set()

    def xov(a, b) -> float:
        return min(a[2], b[2]) - max(a[0], b[0])

    def yov(a, b) -> float:
        return min(a[3], b[3]) - max(a[1], b[1])

    def area(a) -> float:
        return max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)

    boxes = {i: blocks[i]["bbox"] for i in band}
    for i in band:
        if i in out:
            continue
        a = boxes[i]
        # real 2-D overlap: the smaller block (or the vision block) yields
        for j in band:
            if j == i or j in out:
                continue
            b = boxes[j]
            ox, oy = xov(a, b), yov(a, b)
            if ox > 0 and oy > 0:
                inter = ox * oy
                if inter > 0.1 * min(area(a), area(b)):
                    loser = (
                        i
                        if region.label(i) in VISION_LABELS
                        or area(a) < area(b)
                        else j
                    )
                    out.add(loser)
        if i in out:
            continue
        # column bridging: find two mutually x-disjoint, y-overlapping
        # blocks that BOTH x-overlap this one
        partners = [
            j for j in band
            if j != i and j not in out
            and xov(a, boxes[j]) > 0 and yov(a, boxes[j]) <= 0
        ]
        for pi in range(len(partners)):
            for pj in range(pi + 1, len(partners)):
                b, c = boxes[partners[pi]], boxes[partners[pj]]
                if xov(b, c) <= 0 and yov(b, c) > 0:
                    # b and c sit side by side; `a` spans both columns.
                    # Only treat sizable spans as cross-layout (reference
                    # guards with an 8-line-width threshold)
                    if (a[2] - a[0]) > region.line_h * 8 or region.label(
                        i
                    ) in VISION_LABELS:
                        out.add(i)
                    break
            if i in out:
                break
    return sorted(out)


def _band_xycut(region: Region, band: list[int]) -> list[int]:
    """Virtual-line recursive xy-cut inside a band; a block's rank is
    the best rank among its lines."""
    blocks = region.blocks
    if len(band) <= 1:
        return list(band)
    line_boxes: list[list[float]] = []
    owners: list[int] = []
    for i in band:
        real = [
            ln["bbox"] for ln in blocks[i].get("lines", []) if ln.get("bbox")
        ]
        vls = (
            real
            if len(real) > 1
            else virtual_lines_for_block(
                blocks[i]["bbox"], region.line_h, region.page_w, region.page_h
            )
        )
        for vb in vls:
            line_boxes.append(vb)
            owners.append(i)
    perm = xycut_order(
        np.asarray(line_boxes, np.float64),
        min_gap_x=region.line_h * 0.5,
        min_gap_y=region.line_h * 0.3,
    )
    best_rank: dict[int, int] = {}
    for rank, li in enumerate(perm):
        b = owners[li]
        if b not in best_rank:
            best_rank[b] = rank
    return sorted(band, key=lambda i: best_rank.get(i, len(perm)))


def _normal_sort(blocks: list[dict], idxs: list[int], line_h: float) -> list[int]:
    """Row-major sort with line-height quantized y (reference
    sort_normal_blocks, xycut_enhanced/utils.py:604)."""
    return sorted(
        idxs,
        key=lambda i: (
            blocks[i]["bbox"][1] // max(line_h, 1.0),
            blocks[i]["bbox"][0],
        ),
    )


def _edge_distance(a: list[float], b: list[float]) -> float:
    """Nearest-edge (gap) distance between two boxes."""
    dx = max(b[0] - a[2], a[0] - b[2], 0.0)
    dy = max(b[1] - a[3], a[1] - b[3], 0.0)
    return float(np.hypot(dx, dy))


def _weighted_insert(
    order: list[int], blocks: list[dict], idx: int
) -> None:
    """Weighted-distance insertion (reference weighted_distance_insert,
    xycut_enhanced/utils.py:361): edge distance dominates, up-edge
    breaks ties, left-edge last; the block goes AFTER its anchor when it
    reads later (greater y, or same row and greater x)."""
    if not order:
        order.append(idx)
        return
    a = blocks[idx]["bbox"]
    best_k, best_w = 0, float("inf")
    for k, j in enumerate(order):
        b = blocks[j]["bbox"]
        w = (
            _edge_distance(a, b) * 1e4
            + b[1] * 1.0
            + b[0] * 1e-4
        )
        if w < best_w:
            best_w, best_k = w, k
    b = blocks[order[best_k]]["bbox"]
    after = (a[1] > b[1] + 1) or (abs(a[1] - b[1]) <= 1 and a[0] >= b[0])
    order.insert(best_k + (1 if after else 0), idx)


def _manhattan_insert(order: list[int], blocks: list[dict], idx: int) -> None:
    """Insert an unordered block after its nearest sorted neighbor
    (reference manhattan_insert flavor)."""
    if not order:
        order.append(idx)
        return
    cx = (blocks[idx]["bbox"][0] + blocks[idx]["bbox"][2]) / 2
    cy = (blocks[idx]["bbox"][1] + blocks[idx]["bbox"][3]) / 2

    def dist(j: int) -> float:
        bx = (blocks[j]["bbox"][0] + blocks[j]["bbox"][2]) / 2
        by = (blocks[j]["bbox"][1] + blocks[j]["bbox"][3]) / 2
        return abs(bx - cx) + abs(by - cy)

    nearest = min(range(len(order)), key=lambda k: dist(order[k]))
    order.insert(nearest + 1, idx)


def sort_blocks_v3(
    blocks: list[dict], page_w: float, page_h: float
) -> list[int]:
    """Reading-order permutation over block dicts (need 'bbox', optional
    'lines' and 'original_label'). Raises on malformed input — callers
    fall back to plain xycut, mirroring the reference's try/except chain.

    Pipeline (reference xycut_enhanced, xycuts.py:460):
    headers → [per pre-cut band: pull doc_title + cross-layout out,
    xy-cut the rest, weighted-distance insert the pulled blocks] →
    cross_reference tail-inserts → footers → unordered.
    """
    n = len(blocks)
    if n <= 1:
        return list(range(n))
    region = Region(blocks, page_w, page_h)

    order: list[int] = []
    deferred_refs: list[int] = []
    for band in _pre_cut_bands(region, region.body):
        titles = [i for i in band if region.label(i) in DOC_TITLE_LABELS]
        rest = [i for i in band if i not in set(titles)]
        cross = _detect_cross_layout(region, rest)
        body = [i for i in rest if i not in set(cross)]
        band_order = _band_xycut(region, body)
        # the FIRST doc_title leads its band (reference xycuts.py
        # match_unsorted_blocks: idx==0 doc_title inserts at front);
        # later ones are distance-inserted
        for k, t in enumerate(
            sorted(titles, key=lambda i: blocks[i]["bbox"][1])
        ):
            if k == 0:
                band_order.insert(0, t)
            else:
                _weighted_insert(band_order, blocks, t)
        for c in cross:
            if region.label(c) in REFERENCE_LABELS:
                deferred_refs.append(c)  # cross_reference: tail insert
            else:
                _weighted_insert(band_order, blocks, c)
        order.extend(band_order)
    for r in sorted(
        deferred_refs, key=lambda i: (blocks[i]["bbox"][1], blocks[i]["bbox"][0])
    ):
        order.append(r)
    # tiers: headers first; footers after the body; unordered last
    # (reference xycut_enhanced final_order_res_list composition)
    order = (
        _normal_sort(blocks, region.headers, region.line_h)
        + order
        + _normal_sort(blocks, region.footers, region.line_h)
    )
    for i in _normal_sort(blocks, region.unordered, region.line_h):
        _manhattan_insert(order, blocks, i)
    return order
