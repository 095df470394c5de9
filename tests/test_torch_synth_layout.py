"""The port's synthetic layout pages and formula corpus
(``rapiddoc_tpu_torch/train/synth_layout.py``, the vocabulary and pools of
``train/formula.py``) against the JAX package's, on the CPU, from the same
seeds.

- ``random_latex``, ``build_vocab``, ``latex_tokenize`` and ``detokenize``
  equal for many seeds.
- ``FormulaCache``: its latex list and every render's latex and dpi equal
  to the JAX cache's (read from its ``mathtext.math_to_image`` calls), the
  renders under 8 x 16 px skipped on both sides; with the JAX cache
  built under ``text.hinting: none``, every image equal too.
- ``render_layout_page`` equal but for glyphs: with both packages drawing
  the same glyphs (the JAX faces report the port's unhinted boxes and PIL's
  ``ImageDraw.text`` draws the port's mask, patched at test time in both
  directions' callers, never in the JAX package) and the JAX formula cache
  unhinted, every page, its ground truth and the ``random.Random`` state
  after it are equal, byte for byte, at square and portrait sizes and under
  the bench's table-heavy and formula-dense mixes.
- Without that patch, PIL's hinted boxes part the streams (read on seeds
  0-9, three 640 px pages each: 5 seeds part, 4 of them on the first page;
  the test holds that seed 0 parts on its first page).
- ``formula.make_pool``: under ``text.hinting: none`` the JAX pool's
  crops, tokens, lengths and texts equal; under matplotlib's default the
  texts equal, the stream unparted: a hinted and an unhinted render land
  in different buckets on 0 of 600 renders (seeds 0-2, 200 each, read
  with both packages' ``preprocess_formula``).
"""
import random
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

from rapiddoc_tpu.train import synth_layout as js  # noqa: E402
from rapiddoc_tpu_torch.train import synth_layout as ts  # noqa: E402

CACHE_N = 40


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(2)


def mpl_unhinted():
    from matplotlib import rc_context

    return rc_context({"text.hinting": "none"})


@pytest.fixture(scope="module")
def caches():
    """The two packages' formula caches of ``CACHE_N`` items from seed
    1234, the JAX one rendered unhinted, with (latex, dpi) of its renders."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import mathtext

    renders = []
    real = mathtext.math_to_image

    def spy(s, buf, dpi=None, format=None, **kw):
        renders.append((s[1:-1], dpi))
        return real(s, buf, dpi=dpi, format=format, **kw)

    mathtext.math_to_image = spy
    try:
        want = js.FormulaCache(CACHE_N, 1234)
        with mpl_unhinted():
            want._build()
    finally:
        mathtext.math_to_image = real
    got = ts.FormulaCache(CACHE_N, 1234)
    got._build()
    return want, got, renders


def test_random_latex_and_vocab_equal():
    from rapiddoc_tpu.train import formula as jf
    from rapiddoc_tpu_torch.models.formula import engine as te
    from rapiddoc_tpu_torch.train import formula as tf

    for seed in range(40):
        a, b = random.Random(seed), random.Random(seed)
        for _ in range(25):
            s = js.random_latex(a)
            assert ts.random_latex(b) == s
            assert tf.latex_tokenize(s) == jf.latex_tokenize(s)
            assert tf.detokenize(tf.latex_tokenize(s)) == jf.detokenize(jf.latex_tokenize(s))
        assert a.getstate() == b.getstate()
    assert tf.build_vocab() == jf.build_vocab()
    assert tf.build_vocab(3, 300) == jf.build_vocab(3, 300)
    assert tf.detokenize is te.detokenize  # one copy, shared with the recognizer


def test_formula_cache_equal(caches):
    want, got, renders = caches
    assert [s for s, _ in got._items] == [s for s, _ in want._items]
    assert got.renders == renders
    assert sorted({d for _, d in renders}) == [90, 110, 130]
    assert len(renders) > CACHE_N  # some renders were too small on both sides
    for (s, a), (_, b) in zip(want._items, got._items):
        np.testing.assert_array_equal(b, a, err_msg=s)
    a, b = random.Random(5), random.Random(5)
    for _ in range(10):
        assert got.sample(b)[0] == want.sample(a)[0]


class SameGlyphs:
    """While open: the JAX synth's faces report the port's boxes and PIL's
    ``ImageDraw.text`` draws the port's mask (the JAX package is not
    edited; its callers get patched objects)."""

    def __init__(self, monkeypatch):
        from PIL import Image, ImageDraw

        from rapiddoc_tpu.train import synth as jsynth, synth_table as jtable
        from rapiddoc_tpu_torch.train import synth as tsynth
        from rapiddoc_tpu_torch.utils.draw import draw_text

        class Face:
            def __init__(self, pil):
                self.pil = pil
                self.face = tsynth._face(pil.path, int(pil.size))

            def getbbox(self, text, *a, **kw):
                return self.face.getbbox(text)

        real_font = jsynth._font

        def font(rng, size):
            return Face(real_font(rng, size))

        def text(draw, xy, s, fill=None, font=None, **kw):
            arr = np.array(draw._image)
            draw_text(arr, xy, s, fill, font.face)
            draw._image.paste(Image.fromarray(arr))

        for mod in (js, jtable):
            monkeypatch.setattr(mod, "_font", font)
        monkeypatch.setattr(ImageDraw.ImageDraw, "text", text)


def use_caches(monkeypatch, caches):
    want, got, _ = caches
    monkeypatch.setattr(js, "FORMULAS", want)
    monkeypatch.setattr(ts, "FORMULAS", got)


CASES = [  # (seed, size, height, mix)
    (0, 640, None, None), (1, 640, 905, None), (2, 480, 620, None),
    (3, 640, 828, (0.1, 0.15, 0.25, 0.85)),   # table-heavy, as the bench draws it
    (4, 640, 905, (0.2, 0.25, 0.35, 0.45)),   # formula-dense
    (5, 640, 768, None),
]


@pytest.mark.parametrize("seed, size, height, mix", CASES)
def test_render_layout_page_equal_with_the_same_glyphs(seed, size, height, mix, caches,
                                                       monkeypatch):
    SameGlyphs(monkeypatch)
    use_caches(monkeypatch, caches)
    kw = {} if mix is None else {"mix": mix}
    a, b = random.Random(seed), random.Random(seed)
    labels = set()
    for k in range(2):
        want_img, want_gt = js.render_layout_page(a, size, height=height, **kw)
        got_img, got_gt = ts.render_layout_page(b, size, height=height, **kw)
        label = f"seed {seed} page {k}"
        assert got_gt == want_gt, label
        assert a.getstate() == b.getstate(), label
        assert got_img.dtype == np.uint8 and got_img.shape == want_img.shape
        np.testing.assert_array_equal(got_img, want_img, err_msg=label)
        labels |= {c for c, *_ in got_gt}
    assert len(labels) >= 4


def test_unpatched_streams_part_at_glyph_boxes(caches, monkeypatch):
    """With PIL's own (hinted) boxes on the JAX side, seed 0 parts on its
    first page."""
    use_caches(monkeypatch, caches)
    a, b = random.Random(0), random.Random(0)
    js.render_layout_page(a, 640)
    ts.render_layout_page(b, 640)
    assert a.getstate() != b.getstate()


@pytest.mark.parametrize("seed", range(3))
def test_formula_pool_equal(seed):
    from rapiddoc_tpu.train import formula as jf
    from rapiddoc_tpu_torch.train import formula as tf

    vocab = tf.build_vocab()
    got = tf.make_pool(12, vocab, seed)
    with mpl_unhinted():
        want = jf.make_pool(12, vocab, seed)
    assert got[3] == want[3]
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(g, w)
    assert jf.make_pool(12, vocab, seed)[3] == got[3]  # hinted: the same stream
