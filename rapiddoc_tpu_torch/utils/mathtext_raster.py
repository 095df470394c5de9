"""FreeType 2.6.1's smooth rasterizer (``ftgrays.c``), the one matplotlib
bundles and draws mathtext glyphs with.

``pdfio/ft_raster`` replays the rasterizer of FreeType 2.14 (PIL's); the
2.6.1 one differs in three places, each found by comparing glyph bitmaps
with ``FT2Font.draw_glyph_to_bitmap`` (matplotlib 3.10, FreeType 2.6.1):

- a line is cut into scanlines and each scanline into cells with exact
  quotients and remainders (``FT_DIV_MOD``: the remainder kept
  non-negative), where 2.14 walks the cells with a reciprocal multiply;
- a conic is bisected on a stack (``gray_split_conic``, halves taken
  with C's truncating ``/ 2``) as many times as its deviation, divided by
  four per level, stays above a quarter pixel, where 2.14 steps it by
  forward differences;
- a negative coverage is negated (``-c``) where 2.14 complements it
  (``~c``), and 256 or more is kept at 255.

The outline is decomposed as ``pdfio/ft_raster.decompose`` does it
(``FT_Outline_Decompose`` is unchanged between the two). Coordinates are
26.6 upscaled to 24.8; the bitmap is the control box grid-fitted
outwards, as ``FT_Glyph_To_Bitmap`` makes it. The mathtext fonts are
TrueType, so no cubic reaches this module (a cubic raises).
"""
from __future__ import annotations

import numpy as np

from ..pdfio.ft_raster import cbox_pixels, decompose

PIXEL_BITS = 8
ONE_PIXEL = 1 << PIXEL_BITS


def _div_mod(p: int, d: int) -> tuple[int, int]:
    """``FT_DIV_MOD``: C's truncating quotient, moved down one where the
    remainder is negative so that it is kept in [0, d)."""
    q = abs(p) // abs(d)
    if (p < 0) != (d < 0):
        q = -q
    r = p - q * d
    if r < 0:
        q -= 1
        r += d
    return q, r


def _half(a: int) -> int:
    return a // 2 if a >= 0 else -((-a) // 2)


class _Worker:
    """One glyph's cells, filled as ``gray_set_cell``,
    ``gray_render_scanline`` and ``gray_render_line`` of 2.6.1 fill them.
    Cells right of the bitmap are dropped, cells left of it are kept at
    column -1 (they carry their cover only)."""

    __slots__ = ("cells", "ex", "ey", "area", "cover", "x", "y", "last_ey", "width", "rows")

    def __init__(self, width: int, rows: int) -> None:
        self.cells: dict = {}
        self.width, self.rows = width, rows
        self.ex = self.ey = 0
        self.area = self.cover = 0
        self.x = self.y = self.last_ey = 0

    def _record(self) -> None:
        if (self.area or self.cover) and 0 <= self.ey < self.rows and self.ex < self.width:
            c = self.cells.get((self.ex, self.ey))
            if c is None:
                self.cells[(self.ex, self.ey)] = [self.area, self.cover]
            else:
                c[0] += self.area
                c[1] += self.cover

    def set_cell(self, ex: int, ey: int) -> None:
        if ex > self.width:
            ex = self.width
        if ex < 0:
            ex = -1
        if ex != self.ex or ey != self.ey:
            self._record()
            self.area = self.cover = 0
            self.ex, self.ey = ex, ey

    def move_to(self, x: int, y: int) -> None:
        self._record()
        x <<= PIXEL_BITS - 6
        y <<= PIXEL_BITS - 6
        ex, ey = x >> PIXEL_BITS, y >> PIXEL_BITS
        if ex > self.width:
            ex = self.width
        if ex < 0:
            ex = -1
        self.area = self.cover = 0
        self.ex, self.ey = ex, ey
        self.last_ey = ey << PIXEL_BITS
        self.x, self.y = x, y

    def scanline(self, ey: int, x1: int, y1: int, x2: int, y2: int) -> None:
        """``gray_render_scanline``: y1, y2 are fractions in the row."""
        dx = x2 - x1
        ex1, ex2 = x1 >> PIXEL_BITS, x2 >> PIXEL_BITS
        fx1 = x1 - (ex1 << PIXEL_BITS)
        fx2 = x2 - (ex2 << PIXEL_BITS)
        if y1 == y2:
            self.set_cell(ex2, ey)
            return
        if ex1 == ex2:
            delta = y2 - y1
            self.area += (fx1 + fx2) * delta
            self.cover += delta
            return
        p = (ONE_PIXEL - fx1) * (y2 - y1)
        first = ONE_PIXEL
        incr = 1
        if dx < 0:
            p = fx1 * (y2 - y1)
            first = 0
            incr = -1
            dx = -dx
        delta, mod = _div_mod(p, dx)
        self.area += (fx1 + first) * delta
        self.cover += delta
        ex1 += incr
        self.set_cell(ex1, ey)
        y1 += delta
        if ex1 != ex2:
            p = ONE_PIXEL * (y2 - y1 + delta)
            lift, rem = _div_mod(p, dx)
            mod -= dx
            while ex1 != ex2:
                delta = lift
                mod += rem
                if mod >= 0:
                    mod -= dx
                    delta += 1
                self.area += ONE_PIXEL * delta
                self.cover += delta
                y1 += delta
                ex1 += incr
                self.set_cell(ex1, ey)
        delta = y2 - y1
        self.area += (fx2 + ONE_PIXEL - first) * delta
        self.cover += delta

    def line(self, to_x: int, to_y: int) -> None:
        """``gray_render_line`` to (to_x, to_y) in 24.8."""
        ey1 = self.last_ey >> PIXEL_BITS
        ey2 = to_y >> PIXEL_BITS
        fy1 = self.y - self.last_ey
        fy2 = to_y - (ey2 << PIXEL_BITS)
        dx = to_x - self.x
        dy = to_y - self.y
        lo, hi = min(ey1, ey2), max(ey1, ey2)
        if lo >= self.rows or hi < 0:
            pass
        elif ey1 == ey2:
            self.scanline(ey1, self.x, fy1, to_x, fy2)
        elif dx == 0:
            ex = self.x >> PIXEL_BITS
            two_fx = (self.x - (ex << PIXEL_BITS)) << 1
            first, incr = ONE_PIXEL, 1
            if dy < 0:
                first, incr = 0, -1
            delta = first - fy1
            self.area += two_fx * delta
            self.cover += delta
            ey1 += incr
            self.set_cell(ex, ey1)
            delta = first + first - ONE_PIXEL
            area = two_fx * delta
            while ey1 != ey2:
                self.area += area
                self.cover += delta
                ey1 += incr
                self.set_cell(ex, ey1)
            delta = fy2 - ONE_PIXEL + first
            self.area += two_fx * delta
            self.cover += delta
        else:
            p = (ONE_PIXEL - fy1) * dx
            first, incr = ONE_PIXEL, 1
            if dy < 0:
                p = fy1 * dx
                first, incr = 0, -1
                dy = -dy
            delta, mod = _div_mod(p, dy)
            x = self.x + delta
            self.scanline(ey1, self.x, fy1, x, first)
            ey1 += incr
            self.set_cell(x >> PIXEL_BITS, ey1)
            if ey1 != ey2:
                p = ONE_PIXEL * dx
                lift, rem = _div_mod(p, dy)
                mod -= dy
                while ey1 != ey2:
                    delta = lift
                    mod += rem
                    if mod >= 0:
                        mod -= dy
                        delta += 1
                    x2 = x + delta
                    self.scanline(ey1, x, ONE_PIXEL - first, x2, first)
                    x = x2
                    ey1 += incr
                    self.set_cell(x >> PIXEL_BITS, ey1)
            self.scanline(ey1, x, ONE_PIXEL - first, to_x, fy2)
        self.x, self.y = to_x, to_y
        self.last_ey = ey2 << PIXEL_BITS

    def conic(self, cx: int, cy: int, tx: int, ty: int) -> None:
        """``gray_render_conic``: control and end in 26.6."""
        s = PIXEL_BITS - 6
        arc = [[tx << s, ty << s], [cx << s, cy << s], [self.x, self.y]]
        d = max(abs(arc[2][0] + arc[0][0] - 2 * arc[1][0]),
                abs(arc[2][1] + arc[0][1] - 2 * arc[1][1]))
        ys = [p[1] for p in arc]
        if d < ONE_PIXEL // 4 or min(ys) >> PIXEL_BITS >= self.rows or max(ys) >> PIXEL_BITS < 0:
            self.line(arc[0][0], arc[0][1])
            return
        level = 0
        while True:
            d >>= 2
            level += 1
            if d <= ONE_PIXEL // 4:
                break
        stack = arc + [[0, 0] for _ in range(2 * 32)]
        levels = [0] * 34
        levels[0] = level
        top = 0
        base = 0
        while top >= 0:
            lv = levels[top]
            if lv > 0:
                for k in (0, 1):
                    b = stack[base + 1][k]
                    stack[base + 4][k] = stack[base + 2][k]
                    a = stack[base + 3][k] = _half(stack[base + 2][k] + b)
                    b = stack[base + 1][k] = _half(stack[base][k] + b)
                    stack[base + 2][k] = _half(a + b)
                base += 2
                top += 1
                levels[top] = levels[top - 1] = lv - 1
                continue
            self.line(stack[base][0], stack[base][1])
            top -= 1
            base -= 2

    def cubic(self, *_args) -> None:
        raise ValueError("a cubic outline: the mathtext fonts are TrueType")


def render(points, tags, ends) -> tuple[np.ndarray, int, int]:
    """The anti-aliased bitmap of a 26.6 outline (y up): (rows, width)
    uint8 top row first, its left column and its top row in pixels."""
    points = np.asarray(points, np.int64).reshape(-1, 2)
    x0, y0, x1, y1 = cbox_pixels(points)
    width, rows = x1 - x0, y1 - y0
    if width <= 0 or rows <= 0:
        return np.zeros((max(rows, 0), max(width, 0)), np.uint8), x0, y1
    w = _Worker(width, rows)
    decompose(points, tags, ends, w, -x0 * 64, -y0 * 64)
    w._record()
    out = np.zeros((rows, width), np.uint8)
    if w.cells:
        keys = np.array(list(w.cells.keys()), np.int64)
        vals = np.array(list(w.cells.values()), np.int64)
        ex, ey = keys[:, 0], keys[:, 1]
        left = ex < 0
        ex = np.where(left, 0, ex)
        area = np.where(left, 0, vals[:, 0])
        cover = np.zeros((rows, width + 1), np.int64)
        acc = np.zeros((rows, width), np.int64)
        np.add.at(cover, (ey, ex), vals[:, 1])
        np.add.at(acc, (ey, ex), area)
        run = np.cumsum(cover[:, :width], axis=1) * (ONE_PIXEL * 2)
        v = np.abs((run - acc) >> (PIXEL_BITS * 2 + 1 - 8))
        out = np.minimum(v, 255).astype(np.uint8)
    return out[::-1].copy(), x0, y1
