"""Synthetic labeled pages for layout-detector training.

Port of ``rapiddoc_tpu/train/synth_layout.py``. Each page is composed of
labeled blocks from the PP-DocLayoutV2 label set (doc_title /
paragraph_title / text / image / figure_title / table / display_formula /
header / footer / number); the ground truth is each block's tight box and
class id, what the RT-DETR head predicts. Formula regions are mathtext
renders (``utils/mathtext``, matplotlib's replayed), cached: the
(latex, image) cache is also the formula recognizer's corpus.

The random stream is the JAX package's: every call on ``rng`` comes in its
order, and every numpy generator is seeded from it as there. PIL is
replayed: ``ImageDraw.text``/``line``/``rectangle`` through
``synth._text``/``_line``/``_rectangle``, ``Image.paste`` as array writes
and ``pil_draw.paste_mask`` (an RGBA image pasted with its own alpha),
``Image.resize`` (bicubic, RGBA premultiplied) through
``pil_resample.resize``.

Where a glyph's box sets a later bound the streams part, as in
``synth.render_line``: FreeType hints the faces PIL opens and the port
draws the unhinted outline (ROADMAP item 12e), so a text's ``getbbox`` can
differ by a pixel, and ``_paragraph``'s line heights and skips,
``_short_line``'s ``rng.randint(0, (max_w - tw) // 3)`` and the
``y`` that every later block starts from follow those boxes, as do
``_fill_line``'s and ``_truncate``'s word counts. Formulas do not part
the stream: a render's shape is the ``'path'`` parse's, unhinted in
matplotlib too.
"""
from __future__ import annotations

import random

import numpy as np

from ..models.layout.engine import DOCLAYOUT_V2_LABELS
from ..pdfio.pil_draw import paste_mask
from ..pdfio.pil_resample import resize
from ..utils.draw import draw_rectangle
from ..utils.mathtext import math_to_image
from .synth import _fill_line, _font, _line, _rectangle, _text, random_text

LABEL = {name: i for i, name in enumerate(DOCLAYOUT_V2_LABELS)}


# ------------------------------------------------------------- formulas

_GREEK = ["\\alpha", "\\beta", "\\gamma", "\\lambda", "\\mu", "\\sigma",
          "\\theta", "\\phi", "\\omega", "\\pi", "\\rho", "\\tau"]
_VARS = list("abcdefghknpqstuvxyz")


def random_latex(rng: random.Random, depth: int = 0) -> str:
    """A small random LaTeX expression within mathtext's grammar."""
    def atom() -> str:
        r = rng.random()
        if r < 0.45:
            return rng.choice(_VARS)
        if r < 0.65:
            return rng.choice(_GREEK)
        return str(rng.randint(0, 99))

    def term() -> str:
        r = rng.random()
        if r < 0.25 and depth < 2:
            return "\\frac{%s}{%s}" % (
                random_latex(rng, depth + 1), random_latex(rng, depth + 1)
            )
        if r < 0.35:
            return "%s^{%s}" % (atom(), atom())
        if r < 0.45:
            return "%s_{%s}" % (atom(), atom())
        if r < 0.52 and depth < 2:
            return "\\sqrt{%s}" % random_latex(rng, depth + 1)
        if r < 0.60 and depth == 0:
            return "\\sum_{%s=%s}^{%s} %s" % (
                rng.choice(_VARS), rng.randint(0, 9), atom(), atom()
            )
        if r < 0.66 and depth == 0:
            return "\\int_{%s}^{%s} %s(%s) d%s" % (
                rng.randint(0, 9), atom(), rng.choice("fgh"),
                rng.choice(_VARS), rng.choice(_VARS),
            )
        return atom()

    n = rng.randint(1, 3 if depth else 4)
    parts = [term()]
    for _ in range(n - 1):
        parts.append(rng.choice([" + ", " - ", " ", " = ", " + "]))
        parts.append(term())
    expr = "".join(parts)
    if " = " not in expr and depth == 0 and rng.random() < 0.5:
        expr += " = " + term()
    return expr


class FormulaCache:
    """Pre-rendered (latex, RGBA image) pairs, drawn as the JAX cache
    draws them: ``random_latex`` then the dpi, then the render."""

    def __init__(self, n: int = 240, seed: int = 1234):
        self.n = n
        self.seed = seed
        self._items: list[tuple[str, np.ndarray]] | None = None
        self.renders: list[tuple[str, int]] = []  # (latex, dpi) of every render

    def _build(self) -> None:
        rng = random.Random(self.seed)
        items: list[tuple[str, np.ndarray]] = []
        self.renders = []
        while len(items) < self.n:
            latex = random_latex(rng)
            dpi = rng.choice([90, 110, 130])
            self.renders.append((latex, dpi))
            arr = math_to_image(latex, dpi)
            if arr.shape[0] < 8 or arr.shape[1] < 16:
                continue
            items.append((latex, arr))
        self._items = items

    def sample(self, rng: random.Random) -> tuple[str, np.ndarray]:
        if self._items is None:
            self._build()
        return self._items[rng.randrange(len(self._items))]


FORMULAS = FormulaCache()


def paste_rgba(page: np.ndarray, rgba: np.ndarray, x: int, y: int) -> None:
    """``page.paste(im, (x, y), im)`` of an RGBA image: its alpha is the
    mask."""
    paste_mask(page, rgba[..., :3], rgba[..., 3], x, y)


def _paste(page: np.ndarray, src: np.ndarray, x: int, y: int) -> None:
    """``page.paste(Image.fromarray(src), (x, y))``, clipped to the page."""
    H, W = page.shape[:2]
    h, w = src.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x1 > x0 and y1 > y0:
        page[y0:y1, x0:x1] = src[y0 - y:y1 - y, x0 - x:x1 - x]


# ------------------------------------------------------------- blocks

def _truncate(text: str, font, max_w: int):
    bbox = font.getbbox(text)
    while text and bbox[2] - bbox[0] > max_w:
        text = text.rsplit(" ", 1)[0] if " " in text else text[:-2]
        bbox = font.getbbox(text) if text else (0, 0, 0, 0)
    return text, bbox


def _paragraph(img, rng, x0, y, max_w, size, n_lines=None):
    """Tight-leading body paragraph; returns block bbox or None."""
    fsize = rng.randint(11, 20)
    font = _font(rng, fsize)
    fg = rng.randint(0, 80)
    leading = max(2, int(fsize * rng.uniform(0.3, 0.7)))
    n_lines = n_lines or rng.randint(2, 11)
    bx0 = bx1 = by0 = by1 = None
    for li in range(n_lines):
        if y >= size - 30:
            break
        last = li == n_lines - 1
        text, bbox = _fill_line(
            rng, font, max_w,
            rng.uniform(0.3, 0.8) if last else rng.uniform(0.85, 0.98),
        )
        if not text:
            break
        tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        if tw < 4 or th < 4:
            continue
        _text(img, (x0 - bbox[0], y - bbox[1]), text, fg, font)
        bx0 = x0 if bx0 is None else min(bx0, x0)
        by0 = y if by0 is None else by0
        bx1 = x0 + tw if bx1 is None else max(bx1, x0 + tw)
        by1 = y + th
        y += th + leading
    if bx0 is None:
        return None, y
    return (bx0, by0, bx1, by1), y


def _short_line(img, rng, x0, y, max_w, fsize_range, center=False,
                max_words=6, fg_max=60):
    fsize = rng.randint(*fsize_range)
    font = _font(rng, fsize)
    text, bbox = _truncate(random_text(rng, max_words=max_words), font, max_w)
    if not text:
        return None, y
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    if tw < 4 or th < 4:
        return None, y
    x = x0 + (max(0, max_w - tw) // 2 if center
              else rng.randint(0, max(0, max_w - tw) // 3))
    _text(img, (x - bbox[0], y - bbox[1]), text, rng.randint(0, fg_max), font)
    return (x, y, x + tw, y + th), y + th


def _table_block(img, rng, x0, y, max_w, size):
    """Grid with per-cell text; returns bbox."""
    nr, nc = rng.randint(2, 6), rng.randint(2, 5)
    row_h = rng.randint(14, 26)
    gh = nr * row_h
    gw = rng.randint(int(max_w * 0.55), max_w)
    if y + gh > size - 20:
        gh = max(row_h * 2, size - 24 - y)
        nr = max(2, gh // row_h)
        gh = nr * row_h
    gx = x0 + rng.randint(0, max(0, max_w - gw))
    line_col = (rng.randint(60, 140),) * 3
    wired = rng.random() < 0.7
    for ri in range(nr + 1):
        yy = y + ri * row_h
        if wired or ri in (0, 1, nr):  # wireless keeps head/foot rules
            _line(img, [(gx, yy), (gx + gw, yy)], line_col)
    if wired:
        for ci in range(nc + 1):
            xx = gx + ci * gw // nc
            _line(img, [(xx, y), (xx, y + gh)], line_col)
    fsize = max(8, min(13, row_h - 6))
    font = _font(rng, fsize)
    for ri in range(nr):
        for ci in range(nc):
            if rng.random() < 0.15:
                continue
            cell_w = gw // nc
            text, bbox = _truncate(random_text(rng, max_words=2), font, cell_w - 6)
            if not text:
                continue
            cx = gx + ci * cell_w + 3
            cy = y + ri * row_h + 2
            _text(img, (cx - bbox[0], cy - bbox[1]), text, rng.randint(0, 90), font)
    return (gx, y, gx + gw, y + gh)


def _figure_block(img, rng, x0, y, max_w, size):
    gh = rng.randint(50, max(60, size // 4))
    gw = rng.randint(int(max_w * 0.5), max_w)
    if y + gh > size - 20:
        gh = size - 24 - y
    gx = x0 + rng.randint(0, max(0, max_w - gw))
    kind = rng.random()
    if kind < 0.25:  # noise patch
        patch = np.random.default_rng(rng.randrange(1 << 30)).integers(
            60, 220, (gh, gw, 3), np.uint8
        )
        _paste(img, patch, gx, y)
    elif kind < 0.45:  # multi-panel figure: sub-images in a grid with
        # white gutters (the grid arrangement is the table-confusable cue)
        prng = np.random.default_rng(rng.randrange(1 << 30))
        nr, nc = rng.randint(2, 4), rng.randint(2, 4)
        gut = rng.randint(2, 6)
        ph = (gh - (nr - 1) * gut) // nr
        pw = (gw - (nc - 1) * gut) // nc
        if ph > 4 and pw > 4:
            for r in range(nr):
                for c in range(nc):
                    px = gx + c * (pw + gut)
                    py = y + r * (ph + gut)
                    style = prng.integers(0, 3)
                    if style == 0:
                        panel = prng.integers(40, 220, (ph, pw, 3), np.uint8)
                    elif style == 1:  # edge-map-like: white + dark strokes
                        panel = np.full((ph, pw, 3), 245, np.uint8)
                        for _ in range(int(prng.integers(3, 9))):
                            x1p = int(prng.integers(0, pw))
                            y1p = int(prng.integers(0, ph))
                            x2p = int(prng.integers(0, pw))
                            y2p = int(prng.integers(0, ph))
                            _line(panel, [(x1p, y1p), (x2p, y2p)], (20, 20, 20), 1)
                    else:  # smooth gradient (depth-map-like)
                        gy_, gx_ = np.mgrid[0:ph, 0:pw]
                        base = (
                            gy_ / max(ph - 1, 1) * prng.integers(80, 180)
                            + gx_ / max(pw - 1, 1) * prng.integers(0, 60)
                        ).astype(np.uint8)
                        panel = np.stack([base] * 3, axis=-1)
                    _paste(img, panel, px, py)
    elif kind < 0.7:  # chart-ish: axes + polyline/bars
        draw_rectangle(img, [gx, y, gx + gw, y + gh], (90, 90, 90))
        n = rng.randint(4, 9)
        if rng.random() < 0.5:
            pts = [
                (gx + 2 + i * (gw - 4) // (n - 1),
                 y + 4 + rng.randint(0, gh - 8))
                for i in range(n)
            ]
            _line(img, pts, (40, 40, 160), 2)
        else:
            bw = (gw - 8) // n
            for i in range(n):
                bh = rng.randint(4, gh - 6)
                bx = gx + 4 + i * bw
                shade = (rng.randint(60, 200),) * 3
                _rectangle(img, bx, y + gh - 2 - bh, bx + bw - 3, y + gh - 2, shade, shade)
    else:  # flat patch with outline
        shade = rng.randint(130, 225)
        _rectangle(img, gx, y, gx + gw, y + gh, (shade, shade, shade), (80, 80, 80))
    return (gx, y, gx + gw, y + gh)


# ------------------------------------------------------------- page

def render_layout_page(
    rng: random.Random, size: int = 640, height: int | None = None,
    mix: tuple[float, float, float, float] = (0.38, 0.52, 0.68, 0.84),
) -> tuple[np.ndarray, list[tuple[int, int, int, int, int]]]:
    """A labeled page: (uint8 RGB (height or size) x size,
    [(class_id, x0, y0, x1, y1)]).

    ``mix`` sets the cumulative block-type cut points (paragraph, heading,
    figure, table; the rest display formulas): the bench builds its
    table-heavy and formula-dense pages with it. Pages carry optional
    furniture (header, footer, page number), an optional title, then one
    or two columns of paragraphs, headings, figures with captions, tables
    and display formulas. Portrait heights model the pages the detector
    squishes to its square input."""
    w, h = size, height or size
    bg = rng.randint(240, 255)
    img = np.full((h, w, 3), bg, np.uint8)
    gt: list[tuple[int, int, int, int, int]] = []

    top = rng.randint(14, 40)
    if rng.random() < 0.4:
        box, _ = _short_line(img, rng, rng.randint(20, 60), 6, w - 120,
                             (9, 12), max_words=5, fg_max=120)
        if box:
            gt.append((LABEL["header"], *box))
            top = max(top, box[3] + 8)
    if rng.random() < 0.4:
        box, _ = _short_line(img, rng, rng.randint(40, 80), h - 16,
                             w - 160, (9, 12), max_words=5, fg_max=120)
        if box:
            gt.append((LABEL["footer"], *box))
    if rng.random() < 0.5:
        fsize = rng.randint(9, 12)
        font = _font(rng, fsize)
        text = str(rng.randint(1, 99))
        bbox = font.getbbox(text)
        x = w // 2 + rng.randint(-30, 30)
        y = h - 14
        _text(img, (x - bbox[0], y - bbox[1]), text, 90, font)
        gt.append((LABEL["number"], x, y, x + bbox[2] - bbox[0],
                   y + bbox[3] - bbox[1]))

    y_start = top
    if rng.random() < 0.45:
        box, y_after = _short_line(
            img, rng, 40, y_start, w - 80, (22, 32), center=True,
            max_words=7,
        )
        if box:
            gt.append((LABEL["doc_title"], *box))
            y_start = y_after + rng.randint(12, 30)

    two_col = rng.random() < 0.4
    cols = (
        [(rng.randint(16, 36), w // 2 - 14),
         (w // 2 + 14, w - rng.randint(16, 36))]
        if two_col
        else [(rng.randint(16, 56), w - rng.randint(16, 56))]
    )

    for x0_col, x1_col in cols:
        max_w = x1_col - x0_col
        y = y_start + rng.randint(0, 16)
        while y < h - 70:
            r = rng.random()
            if r < mix[0]:  # body paragraph
                box, y = _paragraph(img, rng, x0_col, y, max_w, h)
                if box:
                    gt.append((LABEL["text"], *box))
                y += rng.randint(10, 28)
            elif r < mix[1]:  # section heading
                box, y_after = _short_line(
                    img, rng, x0_col, y, max_w, (14, 22), max_words=6
                )
                if box:
                    gt.append((LABEL["paragraph_title"], *box))
                    y = y_after + rng.randint(8, 24)
                else:
                    y += 20
            elif r < mix[2]:  # figure + caption
                box = _figure_block(img, rng, x0_col, y, max_w, h)
                gt.append((LABEL["image"], *box))
                y = box[3] + rng.randint(4, 10)
                if rng.random() < 0.7 and y < h - 40:
                    cap, y_after = _short_line(
                        img, rng, x0_col, y, max_w, (10, 13),
                        center=True, max_words=8, fg_max=90,
                    )
                    if cap:
                        gt.append((LABEL["figure_title"], *cap))
                        y = y_after
                y += rng.randint(12, 30)
            elif r < mix[3]:  # table, now and then turned 90 degrees
                if rng.random() < 0.12:
                    from .synth_table import render_table

                    s = render_table(rng)
                    rot = np.rot90(s.img, 1 if rng.random() < 0.5 else 3)
                    th_r, tw_r = rot.shape[:2]
                    scale = min(max_w / tw_r, (h - 24 - y) / max(th_r, 1), 1.0)
                    if scale > 0.25:
                        tw_s = max(16, int(tw_r * scale))
                        th_s = max(16, int(th_r * scale))
                        rot_img = resize(np.ascontiguousarray(rot), tw_s, th_s)
                        tx = x0_col + max(0, (max_w - tw_s) // 2)
                        _paste(img, rot_img, tx, y)
                        gt.append((LABEL["table"], tx, y, tx + tw_s, y + th_s))
                        y += th_s + rng.randint(12, 30)
                    else:
                        y += 20
                else:
                    box = _table_block(img, rng, x0_col, y, max_w, h)
                    gt.append((LABEL["table"], *box))
                    y = box[3] + rng.randint(12, 30)
            else:  # display formula
                latex, rgba = FORMULAS.sample(rng)
                fh, fw = rgba.shape[:2]
                scale = min(1.6, (max_w * rng.uniform(0.4, 0.8)) / fw)
                if scale < 1.0 or rng.random() < 0.5:
                    nw, nh = max(16, int(fw * scale)), max(8, int(fh * scale))
                    rgba = resize(rgba, nw, nh)
                    fh, fw = nh, nw
                if y + fh > h - 20:
                    y += 20
                    continue
                fx = x0_col + max(0, (max_w - fw) // 2)
                paste_rgba(img, rgba, fx, y)
                gt.append((LABEL["display_formula"], fx, y, fx + fw, y + fh))
                y += fh + rng.randint(12, 30)

    out = []
    for cid, x0, y0, x1, y1 in gt:
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(w, x1), min(h, y1)
        if x1 - x0 >= 4 and y1 - y0 >= 4:
            out.append((cid, x0, y0, x1, y1))
    return img, out
