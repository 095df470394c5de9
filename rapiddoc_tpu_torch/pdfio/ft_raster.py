"""FreeType's smooth rasterizer (``ftgrays.c``), replayed in numpy.

The JAX package draws text with PIL, whose glyph bitmaps are FreeType's
anti-aliased (``FT_RENDER_MODE_NORMAL``) renders of the glyph outline at
the face's pixel size. This module gives the same 8-bit masks from the
same 26.6 outline (``tests/test_torch_ft_raster.py`` holds it to
Pillow 12.1 with FreeType 2.14):

- The outline is decomposed as ``FT_Outline_Decompose`` does it: a contour
  that starts off-curve starts at its last point, or at the midpoint of
  its first and last (C division, truncated toward zero); two conic
  controls in a row meet at their midpoint; every contour closes with a
  line.
- Coordinates are 26.6 upscaled to 24.8 (``PIXEL_BITS`` 8). A line walks
  its cells as ``gray_render_line`` does, with the exit point of each cell
  found from the exact cross product ``prod`` and divided by
  FreeType's reciprocal multiply (``FT_UDIV``: ``(2**56 - 1) // b``, then
  a 64-bit product shifted by 56), which is sometimes one below the exact
  quotient. Each cell sums the cover ``fy2 - fy1`` and the area
  ``(fy2 - fy1) * (fx1 + fx2)``.
- A conic is split into ``2**k`` lines by forward differences in 32.32
  fixed point, ``k`` set by the control's deviation (each halving divides
  it by four until it is at most a quarter pixel). A cubic is split in
  halves on a stack (``gray_split_cubic``, with its shifts) until both
  controls lie within half a pixel of the chord's trisection points.
- The sweep adds the covers of a row from left to right: a pixel's value
  is ``(cover * 512 - area) >> 9``, complemented when negative and
  clipped to 255 (the non-zero rule).

The bitmap is the outline's control box grid-fitted outwards
(``FT_Glyph_To_Bitmap``): its left column ``floor(xMin / 64)`` and top
row ``ceil(yMax / 64)``. Each line's cell walk is Python; the sweep is
numpy over the glyph's cells.
"""
from __future__ import annotations

import numpy as np

PIXEL_BITS = 8
ONE_PIXEL = 1 << PIXEL_BITS
_UDIV_NUM = (1 << (64 - PIXEL_BITS)) - 1  # ULONG_MAX >> PIXEL_BITS
_U64 = (1 << 64) - 1

ON, CONIC, CUBIC = 1, 0, 2


def _udiv_prep(b: int) -> int:
    # C's signed division truncates toward zero
    q = _UDIV_NUM // abs(b)
    return q if b > 0 else -q


def _udiv(a: int, b_r: int) -> int:
    return ((a & _U64) * (b_r & _U64) & _U64) >> (64 - PIXEL_BITS)


class _Worker:
    """One glyph's cells: ``cells[(ex, ey)] = [area, cover]``, filled as
    ``gray_set_cell`` and ``gray_render_line`` fill them."""

    __slots__ = ("cells", "ex", "ey", "area", "cover", "x", "y", "max_ey", "min_ey")

    def __init__(self, rows: int) -> None:
        self.cells: dict = {}
        self.ex = self.ey = 0
        self.area = self.cover = 0
        self.x = self.y = 0
        self.min_ey, self.max_ey = 0, rows

    def set_cell(self, ex: int, ey: int) -> None:
        if self.area or self.cover:
            c = self.cells.get((self.ex, self.ey))
            if c is None:
                self.cells[(self.ex, self.ey)] = [self.area, self.cover]
            else:
                c[0] += self.area
                c[1] += self.cover
        self.ex, self.ey = ex, ey
        self.area = self.cover = 0

    def move_to(self, x: int, y: int) -> None:
        x <<= PIXEL_BITS - 6
        y <<= PIXEL_BITS - 6
        self.set_cell(x >> PIXEL_BITS, y >> PIXEL_BITS)
        self.x, self.y = x, y

    def line(self, to_x: int, to_y: int) -> None:
        """``gray_render_line`` to (to_x, to_y) in 24.8."""
        ey1 = self.y >> PIXEL_BITS
        ey2 = to_y >> PIXEL_BITS
        if (ey1 >= self.max_ey and ey2 >= self.max_ey) or (ey1 < self.min_ey and ey2 < self.min_ey):
            self.x, self.y = to_x, to_y
            return
        ex1 = self.x >> PIXEL_BITS
        ex2 = to_x >> PIXEL_BITS
        fx1 = self.x & (ONE_PIXEL - 1)
        fy1 = self.y & (ONE_PIXEL - 1)
        dx = to_x - self.x
        dy = to_y - self.y
        if ex1 == ex2 and ey1 == ey2:
            pass
        elif dy == 0:
            self.set_cell(ex2, ey2)
            self.x, self.y = to_x, to_y
            return
        elif dx == 0:
            if dy > 0:
                while True:
                    self.cover += ONE_PIXEL - fy1
                    self.area += (ONE_PIXEL - fy1) * fx1 * 2
                    fy1 = 0
                    ey1 += 1
                    self.set_cell(ex1, ey1)
                    if ey1 == ey2:
                        break
            else:
                while True:
                    self.cover -= fy1
                    self.area -= fy1 * fx1 * 2
                    fy1 = ONE_PIXEL
                    ey1 -= 1
                    self.set_cell(ex1, ey1)
                    if ey1 == ey2:
                        break
        else:
            prod = dx * fy1 - dy * fx1
            dx_r = _udiv_prep(dx) if ex1 != ex2 else 0
            dy_r = _udiv_prep(dy) if ey1 != ey2 else 0
            one = ONE_PIXEL
            while True:
                if prod - dx * one > 0 and prod <= 0:  # left
                    fx2 = 0
                    fy2 = _udiv(-prod, -dx_r)
                    prod -= dy * one
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = one
                    fy1 = fy2
                    ex1 -= 1
                elif prod - dx * one + dy * one > 0 and prod - dx * one <= 0:  # up
                    prod -= dx * one
                    fx2 = _udiv(-prod, dy_r)
                    fy2 = one
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = fx2
                    fy1 = 0
                    ey1 += 1
                elif prod + dy * one >= 0 and prod - dx * one + dy * one <= 0:  # right
                    prod += dy * one
                    fx2 = one
                    fy2 = _udiv(prod, dx_r)
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = 0
                    fy1 = fy2
                    ex1 += 1
                else:  # down
                    fx2 = _udiv(prod, -dy_r)
                    fy2 = 0
                    prod += dx * one
                    self.cover += fy2 - fy1
                    self.area += (fy2 - fy1) * (fx1 + fx2)
                    fx1 = fx2
                    fy1 = one
                    ey1 -= 1
                self.set_cell(ex1, ey1)
                if ex1 == ex2 and ey1 == ey2:
                    break
        fx2 = to_x & (ONE_PIXEL - 1)
        fy2 = to_y & (ONE_PIXEL - 1)
        self.cover += fy2 - fy1
        self.area += (fy2 - fy1) * (fx1 + fx2)
        self.x, self.y = to_x, to_y

    def conic(self, cx: int, cy: int, tx: int, ty: int) -> None:
        """``gray_render_conic``: control and end in 26.6."""
        s = PIXEL_BITS - 6
        p0x, p0y = self.x, self.y
        p1x, p1y = cx << s, cy << s
        p2x, p2y = tx << s, ty << s
        lo, hi = self.min_ey, self.max_ey
        ys = (p0y >> PIXEL_BITS, p1y >> PIXEL_BITS, p2y >> PIXEL_BITS)
        if all(v >= hi for v in ys) or all(v < lo for v in ys):
            self.x, self.y = p2x, p2y
            return
        bx, by = p1x - p0x, p1y - p0y
        ax, ay = p2x - p1x - bx, p2y - p1y - by
        d = max(abs(ax), abs(ay))
        if d <= ONE_PIXEL // 4:
            self.line(p2x, p2y)
            return
        shift = 0
        while True:
            d >>= 2
            shift += 1
            if d <= ONE_PIXEL // 4:
                break
        count = 1 << shift
        rx = ax << (33 - 2 * shift)
        ry = ay << (33 - 2 * shift)
        qx = (bx << (33 - shift)) + (ax << (32 - 2 * shift))
        qy = (by << (33 - shift)) + (ay << (32 - 2 * shift))
        px = p0x << 32
        py = p0y << 32
        for _ in range(count):
            px += qx
            py += qy
            qx += rx
            qy += ry
            self.line(px >> 32, py >> 32)

    def cubic(self, c1x: int, c1y: int, c2x: int, c2y: int, tx: int, ty: int) -> None:
        """``gray_render_cubic``: controls and end in 26.6."""
        s = PIXEL_BITS - 6
        arc = [[tx << s, ty << s], [c2x << s, c2y << s], [c1x << s, c1y << s], [self.x, self.y]]
        lo, hi = self.min_ey, self.max_ey
        ys = [p[1] >> PIXEL_BITS for p in arc]
        if all(v >= hi for v in ys) or all(v < lo for v in ys):
            self.x, self.y = arc[0]
            return
        stack = arc + [[0, 0] for _ in range(16 * 3 + 1 - 4)]
        top = 0
        half = ONE_PIXEL // 2
        while True:
            a0, a1, a2, a3 = stack[top], stack[top + 1], stack[top + 2], stack[top + 3]
            if (abs(2 * a0[0] - 3 * a1[0] + a3[0]) > half
                    or abs(2 * a0[1] - 3 * a1[1] + a3[1]) > half
                    or abs(a0[0] - 3 * a2[0] + 2 * a3[0]) > half
                    or abs(a0[1] - 3 * a2[1] + 2 * a3[1]) > half):
                _split_cubic(stack, top)
                top += 3
                continue
            self.line(a0[0], a0[1])
            if top == 0:
                return
            top -= 3


def _split_cubic(base: list, i: int) -> None:
    for k in (0, 1):
        b0, b1, b2, b3 = base[i][k], base[i + 1][k], base[i + 2][k], base[i + 3][k]
        base[i + 6][k] = b3
        a = b0 + b1
        b = b1 + b2
        c = b2 + b3
        base[i + 5][k] = c >> 1
        c += b
        base[i + 4][k] = c >> 2
        base[i + 1][k] = a >> 1
        a += b
        base[i + 2][k] = a >> 2
        base[i + 3][k] = (a + c) >> 3


def _cdiv2(a: int) -> int:
    """C's ``a / 2`` (toward zero)."""
    return a // 2 if a >= 0 else -((-a) // 2)


def decompose(points: np.ndarray, tags: np.ndarray, ends, w: _Worker, dx: int = 0, dy: int = 0) -> None:
    """``FT_Outline_Decompose`` of a 26.6 outline shifted by (dx, dy) into
    ``w``'s move, line, conic and cubic calls."""
    s = PIXEL_BITS - 6
    pts = [(int(x) + dx, int(y) + dy) for x, y in points]
    tg = [int(t) for t in tags]
    first = 0
    for last in ends:
        last = int(last)
        if last < first:
            continue
        v_start = pts[first]
        v_last = pts[last]
        limit = last
        point = first
        tag = tg[first]
        if tag == CUBIC:
            raise ValueError("invalid outline: a contour starts with a cubic control")
        if tag == CONIC:
            if tg[last] == ON:
                v_start = v_last
                limit -= 1
            else:
                v_start = (_cdiv2(v_start[0] + v_last[0]), _cdiv2(v_start[1] + v_last[1]))
            point -= 1
        w.move_to(*v_start)
        closed = False
        while point < limit:
            point += 1
            tag = tg[point]
            if tag == ON:
                x, y = pts[point]
                w.line(x << s, y << s)
                continue
            if tag == CONIC:
                ctrl = pts[point]
                while True:
                    if point < limit:
                        point += 1
                        vec = pts[point]
                        if tg[point] == ON:
                            w.conic(ctrl[0], ctrl[1], vec[0], vec[1])
                            break
                        if tg[point] != CONIC:
                            raise ValueError("invalid outline")
                        mid = (_cdiv2(ctrl[0] + vec[0]), _cdiv2(ctrl[1] + vec[1]))
                        w.conic(ctrl[0], ctrl[1], mid[0], mid[1])
                        ctrl = vec
                        continue
                    w.conic(ctrl[0], ctrl[1], v_start[0], v_start[1])
                    closed = True
                    break
                if closed:
                    break
                continue
            if point + 1 > limit or tg[point + 1] != CUBIC:
                raise ValueError("invalid outline: a lone cubic control")
            point += 2
            c1, c2 = pts[point - 2], pts[point - 1]
            if point <= limit:
                e = pts[point]
                w.cubic(c1[0], c1[1], c2[0], c2[1], e[0], e[1])
                continue
            w.cubic(c1[0], c1[1], c2[0], c2[1], v_start[0], v_start[1])
            closed = True
            break
        if not closed:
            w.line(v_start[0] << s, v_start[1] << s)
        first = last + 1


def cbox_pixels(points: np.ndarray) -> tuple[int, int, int, int]:
    """``FT_Glyph_Get_CBox(FT_GLYPH_BBOX_PIXELS)``: the control box of a
    26.6 outline grid-fitted outwards, in pixels (xMin, yMin, xMax, yMax)."""
    if len(points) == 0:
        return 0, 0, 0, 0
    p = np.asarray(points, np.int64)
    x0, y0 = int(p[:, 0].min()), int(p[:, 1].min())
    x1, y1 = int(p[:, 0].max()), int(p[:, 1].max())
    return x0 >> 6, y0 >> 6, -((-x1) >> 6), -((-y1) >> 6)


def _sweep(points, tags, ends, x0: int, y0: int, width: int, rows: int) -> np.ndarray:
    """The coverage of a 26.6 outline over the pixels from (x0, y0), rows
    bottom to top."""
    w = _Worker(rows)
    decompose(points, tags, ends, w, -x0 * 64, -y0 * 64)
    w.set_cell(0, 0)
    if not w.cells:
        return np.zeros((rows, width), np.uint8)
    keys = np.array(list(w.cells.keys()), np.int64)
    vals = np.array(list(w.cells.values()), np.int64)
    ex, ey = keys[:, 0], keys[:, 1]
    keep = (ey >= 0) & (ey < rows)
    ex, ey, vals = ex[keep], ey[keep], vals[keep]
    # cells left of the bitmap only carry their cover
    left = ex < 0
    ex = np.where(left, 0, ex)
    area = np.where(left, 0, vals[:, 0])
    inside = ex < width
    cover = np.zeros((rows, width + 1), np.int64)
    acc = np.zeros((rows, width), np.int64)
    np.add.at(cover, (ey, np.minimum(ex, width)), vals[:, 1])
    np.add.at(acc, (ey[inside], ex[inside]), area[inside])
    run = np.cumsum(cover[:, :width], axis=1) * (ONE_PIXEL * 2)
    v = (run - acc) >> (PIXEL_BITS * 2 + 1 - 8)
    v = np.where(v < 0, ~v, v)
    return np.minimum(v, 255).astype(np.uint8)


def render(points, tags, ends, overlap: bool = False) -> tuple[np.ndarray, int, int]:
    """The anti-aliased bitmap of a 26.6 outline (y up): (rows, width)
    uint8 top row first, its left column and its top row in pixels.

    ``overlap`` (a glyph flagged OVERLAP_SIMPLE or OVERLAP_COMPOUND) is
    FreeType's overlap-safe render: the outline four times as large over
    the same box, each sub-pixel's coverage ``(c + 8) // 16`` summed over
    the pixel's 16, a full 256 kept at 255."""
    points = np.asarray(points, np.int64).reshape(-1, 2)
    x0, y0, x1, y1 = cbox_pixels(points)
    width, rows = x1 - x0, y1 - y0
    if width <= 0 or rows <= 0:
        return np.zeros((max(rows, 0), max(width, 0)), np.uint8), x0, y1
    if not overlap:
        out = _sweep(points, tags, ends, x0, y0, width, rows)
    else:
        sub = _sweep(points * 4, tags, ends, x0 * 4, y0 * 4, width * 4, rows * 4)
        cov = (sub.astype(np.int32) + 8) // 16
        total = cov.reshape(rows, 4, width, 4).sum(axis=(1, 3))
        out = np.minimum(total, 255).astype(np.uint8)
    # bitmaps run top to bottom
    return out[::-1].copy(), x0, y1
