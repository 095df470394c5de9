"""PIL's ImageDraw and Image drawing operations, replayed in numpy.

The JAX package draws vector paths with Pillow (``ImageDraw.polygon``,
``ImageDraw.line``, ``Image.paste`` through a mask, ``ImageChops.multiply``)
onto an RGB canvas, on mode ``1`` and ``L`` layers, and with RGBA ink
blended onto the canvas (``ImageDraw.Draw(canvas, "RGBA")``). This module
gives the same bytes as Pillow 12.1's C code, whose rules were pinned by
experiment against it (``tests/test_torch_pil_draw.py``):

- Polygon vertices are truncated toward zero to ints. Each edge keeps a
  float32 slope; a scanline's crossings are ``(y - y0) * dx + x0`` in
  float32, sorted, and filled in pairs from ``ROUND_UP(a)`` to
  ``ROUND_DOWN(b)`` (round half away from zero, and its mirror).
- An edge's last row counts twice unless it is the polygon's last row.
- Where two edges that slope the same way end on the same row at the same
  rounded x (a corner), the later edge's crossing moves to one past the
  rounded crossing of the adjacent row, so that steep corners connect.
- Horizontal edges are drawn as lines of their own; on an RGBA blend they
  are merged with the spans so that no pixel of one polygon is blended
  twice, and separate polygons (segments of a wide line, subpaths) blend
  again where they overlap.
- A line of width 1 is Bresenham between truncated ends, each segment
  without its last point, then the last point; a wider line is one
  four-edge polygon per segment.

Everything works on the rows and columns a shape covers, never on a
full-canvas layer.
"""
from __future__ import annotations

import math

import numpy as np

_F32_HALF = np.float32(0.5)


# ---------------------------------------------------------------- rounding

def _round_up_f32(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP on float32 values: half away from zero, with the
    +0.5 added in float32."""
    a = np.abs(v)
    r = np.floor(a + _F32_HALF).astype(np.int64)
    return np.where(v >= 0, r, -r)


def _round_down_f32(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    r = np.ceil(a - _F32_HALF).astype(np.int64)
    return np.where(v >= 0, r, -r)


def _round_up(f: float) -> int:
    """ROUND_UP on a double."""
    return int(math.floor(f + 0.5)) if f >= 0.0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    return int(math.ceil(f - 0.5)) if f >= 0.0 else -int(math.ceil(abs(f) - 0.5))


def _roundf(v: np.ndarray) -> np.ndarray:
    """C roundf (half away from zero) of float32 values, as float64."""
    v = v.astype(np.float64)
    return np.copysign(np.floor(np.abs(v) + 0.5), v)


# ------------------------------------------------------------------- edges

def _edges(x0, y0, x1, y1):
    """Pillow's Edge records for segments (x0, y0)-(x1, y1): an (n, 6) int
    array of xmin, ymin, xmax, ymax, x0, y0, and the float32 slopes
    ``(float)(x1 - x0) / (y1 - y0)`` (0 for horizontal edges)."""
    x0, y0, x1, y1 = (np.asarray(v, np.int64).reshape(-1) for v in (x0, y0, x1, y1))
    rec = np.stack([np.minimum(x0, x1), np.minimum(y0, y1), np.maximum(x0, x1),
                    np.maximum(y0, y1), x0, y0], axis=1)
    dy = y1 - y0
    flat = dy == 0
    dx = (x1 - x0).astype(np.float32) / np.where(flat, 1, dy).astype(np.float32)
    return rec, np.where(flat, np.float32(0), dx).astype(np.float32)


def _polygons_edges(polys):
    """ImagingDrawPolygon's edge lists for ``polys`` (float vertices,
    truncated toward zero to ints), all at once: (rec, dx, polygon of each
    edge, polygon count). A polygon's edges are its segments in order, a
    horizontal segment that continues a horizontal segment the same way
    widening the edge last added instead, then the closing edge when the
    last vertex is not the first."""
    pts = [np.asarray(p, np.float64).reshape(-1, 2) for p in polys]
    sizes = np.array([len(p) for p in pts], _I64)
    n_poly = len(pts)
    if not sizes.sum():
        return np.zeros((0, 6), _I64), np.zeros(0, np.float32), _EMPTY, n_poly
    xy = np.trunc(np.concatenate(pts)).astype(_I64)
    x, y = xy[:, 0], xy[:, 1]
    first = np.cumsum(sizes) - sizes
    owner = np.repeat(np.arange(n_poly), sizes)
    local = np.arange(len(x)) - first[owner]
    seg = np.nonzero(local < sizes[owner] - 1)[0]  # segment g -> g + 1
    x0, y0, x1, y1 = x[seg], y[seg], x[seg + 1], y[seg + 1]
    prev_x, prev_y = x[np.maximum(seg - 1, 0)], y[np.maximum(seg - 1, 0)]
    merged = (local[seg] > 0) & (y0 == y1) & (y0 == prev_y) & (
        ((x1 > x0) & (x0 > prev_x)) | ((x1 < x0) & (x0 < prev_x)))
    keep = ~merged
    rec, dx = _edges(x0[keep], y0[keep], x1[keep], y1[keep])
    if merged.any():
        slot = np.cumsum(keep) - 1  # the edge last added, for each segment
        m = np.nonzero(merged)[0]
        grow = x1[m] > x0[m]
        np.maximum.at(rec[:, 2], slot[m][grow], x1[m][grow])
        np.minimum.at(rec[:, 0], slot[m][~grow], x1[m][~grow])
    pid, order = owner[seg][keep], local[seg][keep]
    last = first + sizes - 1
    close = np.nonzero((sizes > 0) & ((x[last] != x[first]) | (y[last] != y[first])))[0]
    if len(close):
        r2, d2 = _edges(x[last[close]], y[last[close]], x[first[close]], y[first[close]])
        rec, dx = np.concatenate([rec, r2]), np.concatenate([dx, d2])
        pid = np.concatenate([pid, close])
        order = np.concatenate([order, sizes[close]])
        srt = np.lexsort((order, pid))
        rec, dx, pid = rec[srt], dx[srt], pid[srt]
    return rec, dx, pid, n_poly


def _wide_line_edges(x0: int, y0: int, x1: int, y1: int, width: int):
    """ImagingDrawWideLine's four edges; None for a zero-length segment
    (drawn as one point)."""
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        return None
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max = _round_up(small) / big
    ratio_min = _round_down(small) / big
    dxmin = _round_down(ratio_min * dy)
    dxmax = _round_down(ratio_max * dy)
    dymin = _round_down(ratio_min * dx)
    dymax = _round_down(ratio_max * dx)
    vx = [x0 - dxmin, x1 - dxmin, x1 + dxmax, x0 + dxmax]
    vy = [y0 + dymax, y1 + dymax, y1 - dymin, y0 - dymin]
    return _edges(vx, vy, vx[1:] + vx[:1], vy[1:] + vy[:1])


# ---------------------------------------------------------------- scanning

_I64 = np.int64


def _crossing(y, y0, dx, x0):
    """An edge's crossing of row y, in float32 as Pillow computes it."""
    return (y - y0).astype(np.float32) * dx + x0.astype(np.float32)


def _scan(edges, height: int, alpha: bool):
    """Pillow's polygon_generic for each polygon of ``edges`` (rec, dx,
    polygon of each edge, polygon count): the pixels each fills, as span
    arrays (polygon, y, x_start, x_end), inclusive and unclipped in x.
    With ``alpha`` (an RGBA blend) no pixel of one polygon is filled
    twice."""
    rec, dx, pid, n_poly = edges
    if not len(rec):
        return (_EMPTY,) * 4
    y_lo = np.full(n_poly, height - 1, _I64)
    y_hi = np.zeros(n_poly, _I64)
    np.minimum.at(y_lo, pid, rec[:, 1])
    np.maximum.at(y_hi, pid, rec[:, 3])
    y_lo = np.maximum(y_lo, 0)
    y_hi = np.minimum(y_hi, height)
    out = []
    flat = rec[:, 1] == rec[:, 3]
    if not alpha and flat.any():
        h = rec[flat]
        out.append((pid[flat], h[:, 1], h[:, 0], h[:, 2]))
    # the sloped edges' crossings of every row of their polygon's scan
    sl = np.nonzero(~flat)[0]
    e_pid = pid[sl]
    e_ymin, e_ymax, e_x0, e_y0 = rec[sl, 1], rec[sl, 3], rec[sl, 4], rec[sl, 5]
    e_dx = dx[sl]
    p_lo, p_hi = y_lo[e_pid], y_hi[e_pid]
    lo = np.maximum(e_ymin, p_lo)
    n_rows = np.maximum(np.minimum(e_ymax, p_hi) - lo + 1, 0)
    first = np.cumsum(n_rows) - n_rows
    ent = np.repeat(np.arange(len(sl)), n_rows)
    ey = lo[ent] + np.arange(len(ent)) - first[ent]
    ex = _crossing(ey, e_y0[ent], e_dx[ent], e_x0[ent])
    dup = (ey == e_ymax[ent]) & (ey < p_hi[ent])
    _connect_corners(ex, first, lo, e_pid, e_ymin, e_ymax, e_x0, e_y0, e_dx, p_lo, p_hi)
    # every crossing, the doubled ones twice, sorted per (polygon, row)
    g_pid = np.concatenate([e_pid[ent], e_pid[ent][dup]])
    g_y = np.concatenate([ey, ey[dup]])
    g_x = np.concatenate([ex, ex[dup]])
    order = np.lexsort((g_x, g_y, g_pid))
    g_pid, g_y, g_x = g_pid[order], g_y[order], g_x[order]
    n = len(g_x)
    if n:
        start = np.ones(n, bool)
        start[1:] = (g_pid[1:] != g_pid[:-1]) | (g_y[1:] != g_y[:-1])
        gs = np.nonzero(start)[0]
        gcount = np.diff(np.append(gs, n))
        gidx = np.cumsum(start) - 1
        pos = np.arange(n) - gs[gidx]
        left = np.nonzero((pos % 2 == 0) & (pos + 1 < gcount[gidx]))[0]
        sp = (g_pid[left], g_y[left], _round_up_f32(g_x[left]), _round_down_f32(g_x[left + 1]))
    else:
        sp = (_EMPTY,) * 4
    if not alpha or not flat.any():
        out.append(sp)
        return tuple(np.concatenate(c) for c in zip(*out))
    # an RGBA blend merges a row's horizontal edges into its spans one x
    # position at a time (draw_horizontal_lines)
    h_pid, h_rec = pid[flat], rec[flat]
    in_scan = (h_rec[:, 1] >= y_lo[h_pid]) & (h_rec[:, 1] <= y_hi[h_pid])
    h_pid, h_rec = h_pid[in_scan], h_rec[in_scan]
    key = lambda p, yy: p * (4 * height + 8) + yy + 2 * height + 2  # noqa: E731
    skey = key(sp[0], sp[1])
    hk = key(h_pid, h_rec[:, 1])
    # a row whose horizontal edges each lie inside one of its spans fills
    # just its spans (the walk draws each pixel once either way)
    wide = np.int64(1) << 32
    span_at = skey * wide + sp[2]
    j = np.searchsorted(span_at, hk * wide + h_rec[:, 0], "right") - 1
    if len(skey):
        jc = np.maximum(j, 0)
        inside = (j >= 0) & (skey[jc] == hk) & (sp[3][jc] >= h_rec[:, 2])
    else:
        inside = np.zeros(len(hk), bool)
    hkeys = np.unique(hk[~inside])
    plain = ~np.isin(skey, hkeys)
    out.append(tuple(c[plain] for c in sp))
    rows_n = {}
    if n:
        gk = key(g_pid[gs], g_y[gs])
        rows_n = dict(zip(gk.tolist(), gcount.tolist()))
    res = ([], [], [], [])
    horder = np.argsort(hk, kind="stable")  # edge order within a row
    hk, h_pid, h_rec = hk[horder], h_pid[horder], h_rec[horder]
    s_lo = np.searchsorted(skey, hkeys, "left").tolist()
    s_hi = np.searchsorted(skey, hkeys, "right").tolist()
    h_lo = np.searchsorted(hk, hkeys, "left").tolist()
    h_hi = np.searchsorted(hk, hkeys, "right").tolist()
    xa_l, xb_l = sp[2].tolist(), sp[3].tolist()
    lines_all = h_rec[:, [0, 2]].tolist()
    for j, k in enumerate(hkeys.tolist()):
        p, yrow = int(h_pid[h_lo[j]]), int(h_rec[h_lo[j], 1])
        _merge_horizontals(res, p, yrow, lines_all[h_lo[j]:h_hi[j]], xa_l[s_lo[j]:s_hi[j]],
                           xb_l[s_lo[j]:s_hi[j]], rows_n.get(k, 0))
    if res[0]:
        out.append(tuple(np.array(c, _I64) for c in res))
    return tuple(np.concatenate(c) for c in zip(*out))


def _merge_horizontals(res, p: int, y: int, lines, starts, ends, n_cross: int) -> None:
    """One row of an RGBA polygon fill with horizontal edges, as Pillow
    walks it: spans and horizontal lines in turn, each clipped to start
    past what is drawn, a line drawn only once the walk has reached it."""
    def draw(lo: int, hi: int) -> None:
        res[0].append(p)
        res[1].append(y)
        res[2].append(lo)
        res[3].append(hi)

    def draw_horizontal(x_pos: int) -> int:
        for lo, hi in lines:
            if x_pos != -1 and x_pos < lo:
                continue
            if x_pos > lo:
                lo = x_pos
                if hi < lo:
                    continue
            draw(lo, hi)
            x_pos = hi + 1
        return x_pos

    x_pos = -1 if n_cross == 0 else 0
    for start, end in zip(starts, ends):
        if end < x_pos:
            continue
        x_pos = draw_horizontal(x_pos)
        if end < x_pos:
            continue
        if x_pos > start:
            start = x_pos
            if end < start:
                continue
        draw(start, end)
        x_pos = end + 1
    draw_horizontal(x_pos)


def _connect_corners(ex, first, lo, e_pid, e_ymin, e_ymax, e_x0, e_y0, e_dx, p_lo, p_hi) -> None:
    """Pillow's "connect discontiguous corners" rule, in place on the
    crossings ``ex`` (edge e's crossing of row y at ``first[e] + y -
    lo[e]``).

    An edge that slopes, ends on a row and does not count twice there (its
    last row, unless the scan's) looks back over the earlier edges of its
    polygon that end on that row without counting twice and whose rounded
    crossing equals its own. The first of them that slopes the other way
    ends the look; one that slopes the same way and covers the adjacent row
    (the next one, or the previous one on the edge's last row) moves the
    crossing to one past the adjacent crossings, when it lies more than one
    pixel beyond both, and ends the look; vertical ones, and ones that miss
    the adjacent row, are passed over."""
    n = len(e_dx)
    if n < 2:
        return
    ev_i = np.concatenate([np.arange(n), np.arange(n)])
    ev_y = np.concatenate([e_ymin, e_ymax])
    keep = (ev_y >= p_lo[ev_i]) & (ev_y <= p_hi[ev_i])
    ev_i, ev_y = ev_i[keep], ev_y[keep]
    order = np.lexsort((ev_i, ev_y, e_pid[ev_i]))
    ev_i, ev_y = ev_i[order], ev_y[order]
    m = len(ev_i)
    if m < 2:
        return
    ev_p = e_pid[ev_i]
    once = (ev_y != e_ymax[ev_i]) | (ev_y == p_hi[ev_i])
    cur = _crossing(ev_y, e_y0[ev_i], e_dx[ev_i], e_x0[ev_i])
    rnd = _roundf(cur)
    sgn = np.sign(e_dx[ev_i])
    off = np.where(ev_y == e_ymax[ev_i], -1, 1)
    yoff = ev_y + off
    looks = once & (sgn != 0)
    # -1: nothing ends the look; -2: an edge sloping the other way does
    chosen = np.full(m, -1)
    for d in range(1, m):
        same = (ev_y[d:] == ev_y[:-d]) & (ev_p[d:] == ev_p[:-d])
        if not same.any():
            break
        k = ev_i[:-d]
        seen = same & looks[d:] & once[:-d] & (sgn[:-d] != 0) & (rnd[d:] == rnd[:-d])
        block = seen & (sgn[:-d] != sgn[d:])
        fire = (seen & ~block & (e_ymin[k] <= yoff[d:]) & (yoff[d:] <= e_ymax[k]))
        # a larger distance is an earlier edge: the first one to end the
        # look decides
        chosen[d:][block] = -2
        chosen[d:][fire] = k[fire]
    hit = np.nonzero(chosen >= 0)[0]
    if not len(hit):
        return
    i, k, ya = ev_i[hit], chosen[hit], yoff[hit]
    a1 = _crossing(ya, e_y0[i], e_dx[i], e_x0[i])
    a2 = _crossing(ya, e_y0[k], e_dx[k], e_x0[k])
    c = cur[hit]
    one = np.float32(1)
    over = (c > a1 + one) & (c > a2 + one)
    under = ~over & (c < a1 - one) & (c < a2 - one)
    new = np.where(over, _roundf(np.maximum(a1, a2)) + 1, _roundf(np.minimum(a1, a2)) - 1)
    upd = over | under
    ex[first[i[upd]] + ev_y[hit][upd] - lo[i[upd]]] = new[upd].astype(np.float32)


# ------------------------------------------------------------- coverage

_EMPTY = np.zeros(0, _I64)


def _counts(spans, width: int, height: int, points=None):
    """How many shapes cover each pixel: ``spans`` (shape, y, x_start,
    x_end) count once per shape however they overlap, each of ``points``
    ((y, x) arrays) once per entry. Returns (x0, y0, counts) over the rows
    and columns reached, or None when nothing lands on the canvas."""
    sid, y, a, b = spans
    a = np.maximum(a, 0)
    b = np.minimum(b, width - 1)
    keep = (y >= 0) & (y < height) & (a <= b)
    sid, y, a, b = sid[keep], y[keep], a[keep], b[keep]
    if len(y):
        # within one shape's row, start each span past the ones before it
        order = np.lexsort((a, y, sid))
        sid, y, a, b = sid[order], y[order], a[order], b[order]
        new = np.ones(len(y), bool)
        new[1:] = (sid[1:] != sid[:-1]) | (y[1:] != y[:-1])
        grp = np.cumsum(new) - 1
        big = np.int64(4 * (width + 2))
        run = np.maximum.accumulate(b + 1 + grp * big) - grp * big
        before = np.empty_like(run)
        before[0] = 0
        before[1:] = run[:-1]
        before[new] = 0
        a = np.maximum(a, before)
        keep = a <= b
        y, a, b = y[keep], a[keep], b[keep]
    if points is not None:
        py, px = points
        pk = (py >= 0) & (py < height) & (px >= 0) & (px < width)
        py, px = py[pk], px[pk]
    else:
        py = px = _EMPTY
    if not len(y) and not len(py):
        return None
    ys = np.concatenate([y, py])
    x0 = int(min(a.min() if len(a) else width, px.min() if len(px) else width))
    x1 = int(max(b.max() if len(b) else -1, px.max() if len(px) else -1)) + 1
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    diff = np.zeros((y1 - y0, x1 - x0 + 1), np.int32)
    np.add.at(diff, (y - y0, a - x0), 1)
    np.add.at(diff, (y - y0, b + 1 - x0), -1)
    counts = np.cumsum(diff[:, :-1], axis=1)
    if len(py):
        np.add.at(counts, (py - y0, px - x0), 1)
    return x0, y0, counts


def _blend(out: np.ndarray, ink, alpha: int) -> np.ndarray:
    """Pillow's BLEND: ``(out * (255 - a) + ink * a) / 255`` rounded, per
    channel, on uint8 values."""
    t = out.astype(np.int32) * (255 - alpha) + np.asarray(ink, np.int32) * alpha + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _blend_counts(canvas: np.ndarray, cov, rgba) -> None:
    """Blend ``rgba`` onto the RGB canvas once per covering shape."""
    if cov is None:
        return
    x0, y0, counts = cov
    region = canvas[y0:y0 + counts.shape[0], x0:x0 + counts.shape[1]]
    ink, a = rgba[:3], int(rgba[3])
    for n in range(1, int(counts.max()) + 1):
        sel = counts >= n
        region[sel] = _blend(region[sel], ink, a)


# ---------------------------------------------------------------- polygons

def polygon_spans(polys, height: int, alpha: bool):
    """The spans ``ImageDraw.polygon(p, fill=...)`` fills for each of
    ``polys``, tagged by polygon (see _scan)."""
    return _scan(_polygons_edges(polys), height, alpha)


def fill_coverage(polys, width: int, height: int):
    """The pixels ``ImageDraw.polygon(p, fill=...)`` sets on a mode ``1``
    or ``L`` image for all of ``polys``: (x0, y0, bool mask over the rows
    and columns reached) or None."""
    cov = _counts(polygon_spans(polys, height, False), width, height)
    return None if cov is None else (cov[0], cov[1], cov[2] > 0)


def _shape_counts(canvas: np.ndarray, spans, points):
    """How many shapes cover each pixel of ``canvas`` (see _counts):
    ``spans`` are span arrays tagged by shape (one shape never twice on a
    pixel; shapes of different arrays are different shapes), ``points``
    (y, x) arrays of single-pixel shapes."""
    h, w = canvas.shape[:2]
    sid, ys, xa, xb = [], [], [], []
    base = 0
    for s_id, y, a, b in spans:
        if len(s_id):
            sid.append(s_id + base)
            base += int(s_id.max()) + 1
            ys.append(y)
            xa.append(a)
            xb.append(b)
    joined = tuple(np.concatenate(c) if c else _EMPTY for c in (sid, ys, xa, xb))
    pts = None
    if points:
        pts = (np.concatenate([p[0] for p in points]), np.concatenate([p[1] for p in points]))
    return _counts(joined, w, h, pts)


def blend_spans(canvas: np.ndarray, spans, points, rgba) -> None:
    """Blend ``rgba`` once per shape over each pixel (``ImageDraw`` in
    "RGBA" mode on an RGB image)."""
    _blend_counts(canvas, _shape_counts(canvas, spans, points), rgba)


def write_spans(canvas: np.ndarray, spans, points, ink) -> None:
    """What ``ImageDraw`` does on an image of its own mode (no blending):
    every pixel a shape covers takes ``ink``, alpha included."""
    cov = _shape_counts(canvas, spans, points)
    if cov is None:
        return
    x0, y0, counts = cov
    region = canvas[y0:y0 + counts.shape[0], x0:x0 + counts.shape[1]]
    region[counts > 0] = np.asarray(ink, np.uint8)


# ------------------------------------------------------------------- lines

def _bresenham(x0: int, y0: int, x1: int, y1: int) -> list[tuple[int, int]]:
    """Pillow's line without its last point."""
    dx, dy = x1 - x0, y1 - y0
    xs = -1 if dx < 0 else 1
    ys = -1 if dy < 0 else 1
    dx, dy = abs(dx), abs(dy)
    if dx == 0:
        return [(x0, y0 + ys * i) for i in range(dy)]
    if dy == 0:
        return [(x0 + xs * i, y0) for i in range(dx)]
    pts = []
    if dx > dy:
        dy2, dx2 = dy + dy, dx + dx
        e = dy2 - dx
        for _ in range(dx):
            pts.append((x0, y0))
            if e >= 0:
                y0 += ys
                e -= dx2
            e += dy2
            x0 += xs
    else:
        dx2, dy2 = dx + dx, dy + dy
        e = dx2 - dy
        for _ in range(dy):
            pts.append((x0, y0))
            if e >= 0:
                x0 += xs
                e -= dy2
            e += dx2
            y0 += ys
    return pts


def line_spans(lines, width: int, height: int, alpha: bool):
    """What ``ImageDraw.line(xy, width=width)`` draws for each of
    ``lines``: (spans, points). Width <= 1 gives Bresenham points between
    truncated ends, each drawn on its own; a wider line gives one
    four-edge polygon per segment (a point for a zero-length one)."""
    dots: list[tuple[int, int]] = []
    polys = []
    for xy in lines:
        pts = [(int(x), int(y)) for x, y in xy]
        if width <= 1:
            for i in range(len(pts) - 1):
                dots.extend(_bresenham(*pts[i], *pts[i + 1]))
            if len(pts) > 1:
                dots.append(pts[-1])
            continue
        for i in range(len(pts) - 1):
            e = _wide_line_edges(*pts[i], *pts[i + 1], width)
            if e is None:
                dots.append(pts[i])
            else:
                polys.append(e)
    if polys:
        pid = np.repeat(np.arange(len(polys)), 4)
        edges = (np.concatenate([r for r, _ in polys]), np.concatenate([d for _, d in polys]),
                 pid, len(polys))
        spans = _scan(edges, height, alpha)
    else:
        spans = (_EMPTY,) * 4
    if not dots:
        return spans, None
    arr = np.array(dots, _I64)
    return spans, (arr[:, 1], arr[:, 0])


def line_coverage(lines, width: int, canvas_w: int, canvas_h: int):
    """The pixels ``ImageDraw.line(xy, width=width)`` sets on an ``L`` image
    for all of ``lines``: (x0, y0, bool mask) or None."""
    spans, points = line_spans(lines, width, canvas_h, False)
    cov = _counts(spans, canvas_w, canvas_h, points)
    return None if cov is None else (cov[0], cov[1], cov[2] > 0)


# ------------------------------------------------------------ compositing

def paste_mask(canvas: np.ndarray, src, mask: np.ndarray, ox: int, oy: int) -> None:
    """``canvas.paste(src, (ox, oy), mask)`` with an ``L`` mask: ``src`` is
    an (h, w, 3) array or one colour; the box is clipped to the canvas."""
    h, w = mask.shape
    H, W = canvas.shape[:2]
    cx0, cy0 = max(ox, 0), max(oy, 0)
    cx1, cy1 = min(ox + w, W), min(oy + h, H)
    if cx1 <= cx0 or cy1 <= cy0:
        return
    m = mask[cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox].astype(np.int32)[..., None]
    out = canvas[cy0:cy1, cx0:cx1]
    if isinstance(src, np.ndarray):
        s = src[cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox].astype(np.int32)
    else:
        s = np.asarray(src, np.int32)
    t = out.astype(np.int32) * (255 - m) + s * m + 128
    out[:] = (((t >> 8) + t) >> 8).astype(np.uint8)


def multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``ImageChops.multiply`` of two ``L`` images: a * b / 255, truncated."""
    return (a.astype(np.int32) * b.astype(np.int32) // 255).astype(np.uint8)


def ink(color, alpha: float) -> tuple[int, int, int, int]:
    """The JAX renderer's RGBA ink: ``int(c * 255)`` per channel."""
    return tuple(int(c * 255) for c in color) + (int(255 * alpha),)


def draw_bitmap_rgba(tile: np.ndarray, mask: np.ndarray, ox: int, oy: int, ink) -> None:
    """``ImageDraw.Draw(tile).draw_bitmap((ox, oy), mask, ink)`` on an RGBA
    tile (what ``ImageDraw.text`` does with a glyph mask and an RGBA fill):
    each colour channel blends toward the ink by the mask, taken as 255
    where the tile is still transparent; alpha blends by the mask."""
    h, w = mask.shape
    H, W = tile.shape[:2]
    cx0, cy0 = max(ox, 0), max(oy, 0)
    cx1, cy1 = min(ox + w, W), min(oy + h, H)
    if cx1 <= cx0 or cy1 <= cy0:
        return
    m = mask[cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox].astype(np.int32)
    out = tile[cy0:cy1, cx0:cx1]
    a = out[..., 3].astype(np.int32)
    cm = np.where((m != 0) & (a == 0), 255, m)
    for i in range(4):
        mi = m if i == 3 else cm
        t = out[..., i].astype(np.int32) * (255 - mi) + int(ink[i]) * mi + 128
        out[..., i] = (((t >> 8) + t) >> 8).astype(np.uint8)
