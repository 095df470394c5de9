"""Synthetic tables with full ground truth for the table trainers.

Port of ``rapiddoc_tpu/train/synth_table.py``. One generator feeds the
three trainers of ``train/table.py`` and ``train/unitable.py``:

- the UNet's wired-table segmentation: the drawn grid lines are the mask;
- the wired/wireless classifier: a full grid against head and foot rules;
- the SLANet and UniTable structure decoders: the HTML construction emits
  the merged-no-span token stream (``models/table/slanet.STRUCT_TOKENS``)
  and each ``<td>``'s cell box.

The random stream is the JAX package's: every call on ``rng`` comes in its
order, and the noise is ``np.random.default_rng(rng.randrange(1 << 30))``
as there. PIL and cv2 are replayed (``synth._line``, ``synth._text`` and
``SLANetStructure.preprocess``'s ``resize_linear``, cv2's INTER_LINEAR bit
for bit). No draw's bound follows a glyph's size, so the grid, the spans,
the tokens, the cell boxes, the line mask and the shapes equal the JAX
package's for a seed; only the
glyphs' ink differs (FreeType hints the faces PIL opens, the port draws
the unhinted outline: ROADMAP item 12e). Two places could still part the
streams: ``_truncate`` shortening a cell's text differently by a pixel of
width, and a text left empty on one side only, which skips that cell's
``rng.randint(0, 90)``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np

from ..models.table.slanet import IMG_SIZE as SLA_SIZE, SLANetStructure
from .synth import _font, _line, _text, random_text


@dataclass
class TableSample:
    img: np.ndarray                 # uint8 RGB (H, W, 3)
    line_mask: np.ndarray           # uint8 (H, W) 0/1 grid-line mask
    wired: bool
    tokens: list[str] = field(default_factory=list)   # structure tokens
    cell_boxes: list[tuple[float, float, float, float]] = field(
        default_factory=list
    )                               # per-<td> box in image pixels
    cell_texts: list[str] = field(default_factory=list)
    n_rows: int = 0
    n_cols: int = 0


def _truncate(text: str, font, max_w: int):
    bbox = font.getbbox(text)
    while text and bbox[2] - bbox[0] > max_w:
        text = text.rsplit(" ", 1)[0] if " " in text else text[:-2]
        bbox = font.getbbox(text) if text else (0, 0, 0, 0)
    return text, bbox


def render_table(rng: random.Random, wired: bool | None = None) -> TableSample:
    if wired is None:
        wired = rng.random() < 0.5
    nr = rng.randint(2, 7)
    nc = rng.randint(2, 6)
    col_w = [rng.randint(46, 120) for _ in range(nc)]
    row_h = [rng.randint(18, 40) for _ in range(nr)]
    margin = rng.randint(4, 24)
    W = sum(col_w) + 2 * margin
    H = sum(row_h) + 2 * margin
    bg = rng.randint(240, 255)
    img = np.full((H, W, 3), bg, np.uint8)
    mask = np.zeros((H, W), np.uint8)

    xs = [margin]
    for w in col_w:
        xs.append(xs[-1] + w)
    ys = [margin]
    for h in row_h:
        ys.append(ys[-1] + h)

    # span layout: occupancy grid; a few rowspan/colspan merges, often and
    # plural (the head must learn to count crossed row/col boundaries)
    owner = [[(r, c) for c in range(nc)] for r in range(nr)]
    spans: dict[tuple[int, int], tuple[int, int]] = {}
    if rng.random() < 0.8:
        for _ in range(rng.randint(1, 3)):
            r = rng.randrange(nr)
            c = rng.randrange(nc)
            if owner[r][c] != (r, c) or (r, c) in spans:
                continue
            if rng.random() < 0.5 and c + 1 < nc:  # colspan
                span = min(rng.randint(2, 3), nc - c)
                if any(owner[r][c + k] != (r, c + k) for k in range(span)):
                    continue
                for k in range(1, span):
                    owner[r][c + k] = (r, c)
                spans[(r, c)] = (1, span)
            elif r + 1 < nr:  # rowspan
                span = min(rng.randint(2, 3), nr - r)
                if any(owner[r + k][c] != (r + k, c) for k in range(span)):
                    continue
                for k in range(1, span):
                    owner[r + k][c] = (r, c)
                spans[(r, c)] = (span, 1)

    def cell_rect(r, c):
        rs, cs = spans.get((r, c), (1, 1))
        return xs[c], ys[r], xs[c + cs], ys[r + rs]

    line_col = (rng.randint(50, 130),) * 3
    lw = rng.choice([1, 1, 2])

    def put_line(x0, y0, x1, y1):
        _line(img, [(x0, y0), (x1, y1)], line_col, lw)
        mask[max(0, y0 - lw // 2): y1 + lw // 2 + 1,
             max(0, x0 - lw // 2): x1 + lw // 2 + 1] = 1

    if wired:
        # each cell's edges, span-aware: no inner lines through merges
        for r in range(nr):
            for c in range(nc):
                if owner[r][c] != (r, c):
                    continue
                x0, y0, x1, y1 = cell_rect(r, c)
                put_line(x0, y0, x1, y0)
                put_line(x0, y1, x1, y1)
                put_line(x0, y0, x0, y1)
                put_line(x1, y0, x1, y1)
    else:
        put_line(xs[0], ys[0], xs[-1], ys[0])
        put_line(xs[0], ys[1], xs[-1], ys[1])  # under the header
        put_line(xs[0], ys[-1], xs[-1], ys[-1])

    tokens: list[str] = []
    cell_boxes: list[tuple[float, float, float, float]] = []
    cell_texts: list[str] = []
    header_font = _font(rng, rng.randint(11, 15))
    body_font = _font(rng, rng.randint(10, 14))

    def emit_row(r):
        tokens.append("<tr>")
        for c in range(nc):
            if owner[r][c] != (r, c):
                continue
            rs, cs = spans.get((r, c), (1, 1))
            merged = rs > 1 or cs > 1
            x0, y0, x1, y1 = cell_rect(r, c)
            font = header_font if r == 0 else body_font
            # merged cells always carry text, centred in the merged extent
            # (for a wireless table the only visual evidence of the merge)
            empty = (not merged) and rng.random() < 0.12
            text = "" if empty else random_text(rng, max_words=2)
            text, bbox = _truncate(text, font, x1 - x0 - 6)
            if text:
                if merged:
                    tw = bbox[2] - bbox[0]
                    th = bbox[3] - bbox[1]
                    tx = x0 + max(3, (x1 - x0 - tw) // 2)
                    ty = y0 + max(2, (y1 - y0 - th) // 2)
                else:
                    tx = x0 + 3
                    ty = y0 + 2
                _text(img, (tx - bbox[0], ty - bbox[1]), text, rng.randint(0, 90), font)
            if rs == 1 and cs == 1:
                tokens.append("<td></td>")
            else:
                tokens.append("<td")
                if rs > 1:
                    tokens.append(f' rowspan="{rs}"')
                if cs > 1:
                    tokens.append(f' colspan="{cs}"')
                tokens.append(">")
                tokens.append("</td>")
            cell_boxes.append((x0, y0, x1, y1))
            cell_texts.append(text)
        tokens.append("</tr>")

    tokens.append("<thead>")
    emit_row(0)
    tokens.append("</thead>")
    tokens.append("<tbody>")
    for r in range(1, nr):
        emit_row(r)
    tokens.append("</tbody>")

    if rng.random() < 0.3:
        noise = np.random.default_rng(rng.randrange(1 << 30)).normal(
            0, rng.random() * 6, img.shape
        )
        img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    return TableSample(
        img=img, line_mask=mask, wired=wired, tokens=tokens,
        cell_boxes=cell_boxes, cell_texts=cell_texts, n_rows=nr, n_cols=nc,
    )


def slanet_sample(
    rng: random.Random, vocab, max_steps: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int] | None:
    """One teacher-forcing sample on the padded SLANet canvas: (canvas
    uint8 (488, 488, 3), token ids (max_steps,) int32 padded with eos, loc
    (max_steps, 8) float32 normalized, loc_mask (max_steps,) float32,
    length), or None when the structure exceeds the step budget."""
    s = render_table(rng, wired=rng.random() < 0.5)
    ids = [vocab.token_to_id[t] for t in s.tokens] + [vocab.eos_id]
    if len(ids) > max_steps:
        return None
    # the table resized to fit 488 px, top-left on a black canvas
    canvas = SLANetStructure.preprocess(s.img)
    ratio = SLA_SIZE / max(s.img.shape[:2])
    token_ids = np.full((max_steps,), vocab.eos_id, np.int32)
    token_ids[: len(ids)] = ids
    loc = np.zeros((max_steps, 8), np.float32)
    loc_mask = np.zeros((max_steps,), np.float32)
    cell_i = 0
    for t, tok in enumerate(s.tokens):
        if tok in ("<td></td>", "<td"):
            x0, y0, x1, y1 = s.cell_boxes[cell_i]
            cell_i += 1
            quad = np.array(
                [x0, y0, x1, y0, x1, y1, x0, y1], np.float32
            ) * ratio / SLA_SIZE
            loc[t] = quad
            loc_mask[t] = 1.0
    return canvas, token_ids, loc, loc_mask, len(ids)
