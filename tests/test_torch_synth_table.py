"""The port's synthetic tables (``rapiddoc_tpu_torch/train/synth_table.py``
and the pools of ``train/{table,unitable}.py``) against the JAX package's,
on the CPU, from the same seeds.

Equal, because no random draw's bound follows a glyph: every table's
structure tokens, cell boxes, line mask, ``n_rows``/``n_cols`` and
``wired``, and the ``random.Random`` state after it; the image outside the
text boxes (PIL's and the port's, 2 px around); ``slanet_sample``'s token
ids, locs, loc mask and length, ``to_unitable_ids`` and ``unitable_sample``'s
ids, the UNet pool's 1024 x 1024 masks; the resized canvases outside the
text boxes scaled to them.

Where glyphs decide: a cell's text equal, or, where ``_truncate`` measured
a hinted and an unhinted box a pixel apart, one cut a word shorter than the
other (seed 9's second table: PIL keeps "High", the port "High Reference";
the stream stays equal, as that cell draws its ink colour either way). The
ink inside each text box: FreeType hints the faces PIL opens, the port
draws the unhinted outline (ROADMAP item 12e), and at these tables' 10-15
px the hinter moves rows and stems by a pixel, so
``tests/test_torch_text.py``'s pixel bands (mean 10 and 5 % over 64 for
DejaVu, measured on 22-40 px lines) do not hold here: the tables read a
median 24.9 after the best one-pixel shift of each box. Each box is held
instead to its ink: mass within ``INK_MASS`` of PIL's, and the inked
columns' and rows' extents within ``INK_SHIFT`` px.
"""
import random
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

from rapiddoc_tpu.train import synth_table as js  # noqa: E402
from rapiddoc_tpu_torch.train import synth_table as ts  # noqa: E402

SEEDS = (0, 1, 2, 3, 5, 9, 11)  # three tables each; 9 parts a cell's text
# ink of a text box: the port's mass over PIL's, and the first and last
# inked column and row, px (readings over 80 tables: 0.853-1.291; columns
# within 2, rows within 3, one box at 3)
INK_MASS = (0.8, 1.35)
INK_SHIFT = (2, 3)
PAD = 2  # px around a text box


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(2)


class TextBoxes:
    """Records the text boxes both packages draw while open: PIL's
    ``ImageDraw.text`` calls and the port's ``synth_table._text``."""

    def __init__(self, monkeypatch):
        from PIL import ImageDraw

        self.jax, self.port = [], []
        pil_text = ImageDraw.ImageDraw.text
        port_text = ts._text

        def jax_text(draw, xy, text, fill=None, font=None, **kw):
            self.jax.append((xy, text, font.getbbox(text), fill[0]))
            return pil_text(draw, xy, text, fill=fill, font=font, **kw)

        def port(img, xy, text, fg, font):
            self.port.append((xy, text, font.getbbox(text), fg))
            return port_text(img, xy, text, fg, font)

        monkeypatch.setattr(ImageDraw.ImageDraw, "text", jax_text)
        monkeypatch.setattr(ts, "_text", port)

    def clear(self):
        self.jax.clear()
        self.port.clear()

    def boxes(self) -> list[tuple[int, int, int, int]]:
        """Each drawn text's box on the table, PIL's and the port's."""
        return [(int(x + b[0]), int(y + b[1]), int(x + b[2]), int(y + b[3]))
                for (x, y), _, b, _ in self.jax + self.port]


def box_mask(shape, boxes, scale=(1.0, 1.0), pad: int = PAD) -> np.ndarray:
    """True inside each box grown by ``pad`` px of the table, then scaled
    by (sx, sy) (and a pixel more on each side: the linear resize's taps)."""
    mask = np.zeros(shape[:2], bool)
    sx, sy = scale
    grow = 0 if scale == (1.0, 1.0) else 1
    for x0, y0, x1, y1 in boxes:
        mask[max(0, int((y0 - pad) * sy) - grow): int(np.ceil((y1 + pad) * sy)) + grow + 1,
             max(0, int((x0 - pad) * sx) - grow): int(np.ceil((x1 + pad) * sx)) + grow + 1] = True
    return mask


def ink_reading(want: np.ndarray, got: np.ndarray, box, fg: int):
    """(mass ratio, column shifts, row shifts) of one text box's ink."""
    x0, y0, x1, y1 = box
    y0, x0 = max(y0 - PAD, 0), max(x0 - PAD, 0)
    a = want[y0:y1 + PAD, x0:x1 + PAD].min(axis=2).astype(int)
    b = got[y0:y1 + PAD, x0:x1 + PAD].min(axis=2).astype(int)
    bg = int(np.median(a))
    ia, ib = np.clip(bg - a, 0, None), np.clip(bg - b, 0, None)
    thr = max(20, (bg - fg) // 3)
    ma, mb = ia > thr, ib > thr
    if not ma.any() and not mb.any():
        return None  # a face with no outline for these characters
    cols = [np.flatnonzero(m.any(0)) for m in (ma, mb)]
    rows = [np.flatnonzero(m.any(1)) for m in (ma, mb)]
    return (ib.sum() / max(ia.sum(), 1), (cols[1][0] - cols[0][0], cols[1][-1] - cols[0][-1]),
            (rows[1][0] - rows[0][0], rows[1][-1] - rows[0][-1]))


def parted_cells(want, got) -> list[tuple[int, str, str]]:
    return [(i, a, b) for i, (a, b) in enumerate(zip(want.cell_texts, got.cell_texts)) if a != b]


@pytest.mark.parametrize("seed", SEEDS)
def test_render_table_equal_but_glyphs(seed, monkeypatch):
    rec = TextBoxes(monkeypatch)
    a, b = random.Random(seed), random.Random(seed)
    for k in range(3):
        rec.clear()
        want, got = js.render_table(a), ts.render_table(b)
        label = f"seed {seed} table {k}"
        assert got.tokens == want.tokens, label
        assert got.cell_boxes == want.cell_boxes, label
        assert (got.n_rows, got.n_cols, got.wired) == (want.n_rows, want.n_cols, want.wired), label
        np.testing.assert_array_equal(got.line_mask, want.line_mask, err_msg=label)
        assert got.img.shape == want.img.shape and got.img.dtype == np.uint8
        parted = parted_cells(want, got)
        assert a.getstate() == b.getstate(), f"{label}: the stream parted at cells {parted}"
        # a parted cell: _truncate cut one word more on one side
        for i, wa, wb in parted:
            short, long_ = sorted((wa, wb), key=len)
            assert short and long_.startswith(short + " "), (label, i, wa, wb)
        assert len(parted) <= 1, (label, parted)
        assert (seed, k, len(parted)) != (9, 1, 0)  # the known parting is still there
        outside = ~box_mask(want.img.shape, rec.boxes())
        np.testing.assert_array_equal(got.img[outside], want.img[outside], err_msg=label)
        for ((x, y), text, bb, fg), ((_, _), ptext, _, _) in zip(rec.jax, rec.port):
            if text != ptext:
                continue
            box = (int(x + bb[0]), int(y + bb[1]), int(x + bb[2]), int(y + bb[3]))
            reading = ink_reading(want.img, got.img, box, fg)
            if reading is None:
                continue
            mass, cols, rows = reading
            assert INK_MASS[0] <= mass <= INK_MASS[1], (label, text, mass)
            assert max(map(abs, cols)) <= INK_SHIFT[0], (label, text, cols)
            assert max(map(abs, rows)) <= INK_SHIFT[1], (label, text, rows)


def replay_boxes(rec, seed: int, wired_of):
    """Per table of a pool drawn from ``random.Random(seed)`` (table i
    wired as ``wired_of(i, rng)`` decides): (its (w, h), the text boxes
    both packages drew on it)."""
    a, b = random.Random(seed), random.Random(seed)
    i = 0
    while True:
        rec.clear()
        want = js.render_table(a, wired=wired_of(i, a))
        ts.render_table(b, wired=wired_of(i, b))
        yield (want.img.shape[1], want.img.shape[0]), rec.boxes()
        i += 1


def assert_equal_outside(got: np.ndarray, want: np.ndarray, size, boxes, label) -> None:
    """Equal but near a text box scaled from the table's ``size`` to the
    image's."""
    w, h = size
    inside = box_mask(want.shape, boxes, (want.shape[1] / w, want.shape[0] / h))
    np.testing.assert_array_equal(got[~inside], want[~inside], err_msg=label)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_samples_equal_but_glyphs(seed, monkeypatch):
    """``slanet_sample`` (ids, locs, loc mask, length; the 488 canvas
    outside the scaled text boxes), ``unitable_sample`` (ids, length; the
    448 image likewise) and ``to_unitable_ids`` of each table."""
    from rapiddoc_tpu.models.table.slanet import SLANetVocab as JVocab
    from rapiddoc_tpu.train import unitable as ju
    from rapiddoc_tpu_torch.models.table.slanet import IMG_SIZE, SLANetVocab
    from rapiddoc_tpu_torch.train import unitable as tu

    rec = TextBoxes(monkeypatch)
    vocab, jvocab = SLANetVocab(), JVocab()
    assert vocab.tokens == jvocab.tokens
    coin = lambda i, rng: rng.random() < 0.5  # noqa: E731  (the samples' own draw)
    a, b = random.Random(seed), random.Random(seed)
    for k, (size, boxes) in zip(range(3), replay_boxes(rec, seed, coin)):
        want, got = js.slanet_sample(a, jvocab, 160), ts.slanet_sample(b, vocab, 160)
        assert a.getstate() == b.getstate()
        if want is None:
            assert got is None
            continue
        for w, g in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(g, w)
        ratio = IMG_SIZE / max(size)
        rw, rh = max(1, int(size[0] * ratio)), max(1, int(size[1] * ratio))
        assert_equal_outside(got[0][:rh, :rw], want[0][:rh, :rw], size, boxes, f"slanet {seed} {k}")
        assert not got[0][rh:].any() and not got[0][:, rw:].any()
    a, b = random.Random(seed + 50), random.Random(seed + 50)
    for k, (size, boxes) in zip(range(3), replay_boxes(rec, seed + 50, coin)):
        want, got = ju.unitable_sample(a), tu.unitable_sample(b)
        assert a.getstate() == b.getstate()
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert_equal_outside(got[0], want[0], size, boxes, f"unitable {seed} {k}")
    a, b = random.Random(seed + 90), random.Random(seed + 90)
    for _ in range(3):
        want, got = js.render_table(a), ts.render_table(b)
        h, w = want.img.shape[:2]
        assert tu.to_unitable_ids(got.tokens, got.cell_boxes, w, h) == ju.to_unitable_ids(
            want.tokens, want.cell_boxes, w, h)


def test_unet_and_cls_pools_equal_but_glyphs(monkeypatch):
    """The UNet pool's 1024 x 1024 masks equal and its images outside the
    scaled text boxes; the classifier pool's labels and 224 images
    likewise (against ``train_cls``'s pooling)."""
    import cv2

    from rapiddoc_tpu.train import table as jt
    from rapiddoc_tpu_torch.train import table as tt

    rec = TextBoxes(monkeypatch)
    x, y = tt.make_unet_pool(2, seed=4)
    want_x, want_y = jt.make_unet_pool(2, seed=4)
    np.testing.assert_array_equal(y, want_y)
    assert y.any()
    for i, (size, boxes) in zip(range(2), replay_boxes(rec, 4, lambda i, rng: True)):
        assert_equal_outside(x[i], want_x[i], size, boxes, f"unet {i}")
    imgs, labels = tt.make_cls_pool(4, seed=6)
    rng = random.Random(6)
    for i, (size, boxes) in zip(range(4), replay_boxes(rec, 6, lambda i, rng: i % 2 == 0)):
        s = js.render_table(rng, wired=i % 2 == 0)
        assert labels[i] == (0 if i % 2 == 0 else 1)
        assert_equal_outside(imgs[i], cv2.resize(s.img, (224, 224)), size, boxes, f"cls {i}")
