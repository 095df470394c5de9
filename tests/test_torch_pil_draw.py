"""The port's replays of PIL's drawing and resampling against Pillow.

``rapiddoc_tpu_torch/pdfio/pil_draw.py`` and ``pil_resample.py`` replace
the Pillow calls the JAX package's renderer makes; each must give
Pillow's bytes:

- ``ImageDraw.polygon`` fills with float vertices, into mode ``1`` and
  ``L`` images and blended onto RGB with an RGBA ink (``Draw(im,
  "RGBA")``), one polygon or several in turn: random, off-canvas,
  self-crossing, degenerate (repeated vertices, spikes, collinear) and
  1-px-tall shapes;
- ``ImageDraw.line`` at widths 0-9, in ``L`` and blended at alpha 255
  and 128, with several segments;
- ``Image.paste(colour or image, box, mask)`` with an ``L`` mask and
  ``ImageChops.multiply``;
- ``Image.resize`` BILINEAR and BICUBIC of L, RGB and RGBA images,
  shrinking and enlarging, to and from 1 px;
- ``Image.rotate(angle, expand=True)`` (NEAREST) at angles in 45-135 and
  225-315 degrees, on RGB and RGBA;
- the text path's pieces: ``ImageDraw.text`` onto a transparent RGBA tile
  with an RGBA fill (``draw_bitmap`` of a glyph mask, twice over the same
  pixels), the tile pasted through its own alpha, and the RGBA tile's
  ``rotate(angle, expand=True, resample=BICUBIC)``.
"""
import numpy as np
import pytest
from PIL import Image, ImageChops, ImageDraw

from rapiddoc_tpu_torch.pdfio import pil_draw, pil_resample

W, H = 48, 36


def fill(arr, polys, value):
    """``ImageDraw.Draw(im).polygon(p, fill=value)`` for each of ``polys``
    on a 2-D array, through the renderer's coverage."""
    cov = pil_draw.fill_coverage(polys, arr.shape[1], arr.shape[0])
    if cov is not None:
        x0, y0, inside = cov
        arr[y0:y0 + inside.shape[0], x0:x0 + inside.shape[1]][inside] = value


def blend_fill(canvas, polys, ink):
    """``ImageDraw.Draw(canvas, "RGBA").polygon(p, fill=ink)`` for each."""
    pil_draw.blend_spans(canvas, [pil_draw.polygon_spans(polys, canvas.shape[0], True)], [], ink)


def draw_lines(arr, lines, value, width):
    """``ImageDraw.Draw(im).line(xy, fill=value, width=width)`` for each."""
    cov = pil_draw.line_coverage(lines, width, arr.shape[1], arr.shape[0])
    if cov is not None:
        x0, y0, inside = cov
        arr[y0:y0 + inside.shape[0], x0:x0 + inside.shape[1]][inside] = value


def blend_lines(canvas, lines, ink, width):
    """``ImageDraw.Draw(canvas, "RGBA").line(xy, fill=ink, width=width)``
    for each."""
    spans, points = pil_draw.line_spans(lines, width, canvas.shape[0], True)
    pil_draw.blend_spans(canvas, [spans], [points] if points is not None else [], ink)


def random_polygon(rng, t: int) -> list[tuple[float, float]]:
    n = int(rng.integers(2, 12))
    kind = t % 6
    if kind == 0:  # integer vertices, some off the canvas
        pts = rng.integers(-6, 54, (n, 2)).astype(float)
    elif kind == 1:  # float vertices
        pts = rng.uniform(-6, 54, (n, 2))
    elif kind == 2:  # star-shaped, radii from sub-pixel up
        c = rng.uniform(5, 43, 2)
        r = rng.uniform(0.3, 24, n)
        a = np.sort(rng.uniform(0, 2 * np.pi, n))
        pts = np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)], 1)
    elif kind == 3:  # degenerate: repeated vertices and spikes
        pts = rng.integers(-3, 51, (n, 2)).astype(float)
        for _ in range(int(rng.integers(1, 3))):
            i = int(rng.integers(0, n))
            pts = np.insert(pts, int(rng.integers(0, len(pts))), pts[i], axis=0)
    elif kind == 4:  # 1 px tall, or collinear
        y = float(rng.integers(-1, H + 1)) + rng.uniform(0, 0.99)
        pts = np.stack([rng.uniform(-4, 52, n), np.full(n, y) + rng.uniform(0, 0.9, n)], 1)
    else:  # axis-aligned runs (horizontal edges merge in Pillow)
        xs = rng.integers(0, W, n)
        ys = rng.integers(0, H, n)
        pts = np.stack([xs, np.where(np.arange(n) % 3 == 1, np.roll(ys, 1), ys)], 1).astype(float)
    return [(float(x), float(y)) for x, y in pts]


@pytest.mark.parametrize("seed", range(6))
def test_polygon_fill_equals_pil(seed):
    rng = np.random.default_rng(seed)
    for t in range(150):
        xy = random_polygon(rng, t)
        for mode in ("L", "1"):
            im = Image.new(mode, (W, H), 0)
            ImageDraw.Draw(im).polygon(xy, fill=1 if mode == "1" else 200)
            got = np.zeros((H, W), np.uint8)
            fill(got, [xy], 200)
            assert np.array_equal(got > 0, np.asarray(im) > 0), (mode, xy)
            if mode == "L":
                assert np.array_equal(got, np.asarray(im)), xy


@pytest.mark.parametrize("seed", range(6))
def test_polygon_blend_equals_pil(seed):
    rng = np.random.default_rng(100 + seed)
    for t in range(120):
        polys = [random_polygon(rng, t + k) for k in range(int(rng.integers(1, 4)))]
        base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        ink = (int(rng.integers(0, 256)), int(rng.integers(0, 256)), 90,
               int(rng.choice([255, 128, 77, 0])))
        im = Image.fromarray(base)
        draw = ImageDraw.Draw(im, "RGBA")
        for p in polys:
            draw.polygon(p, fill=ink)
        got = base.copy()
        blend_fill(got, polys, ink)
        assert np.array_equal(got, np.asarray(im)), polys


@pytest.mark.parametrize("width", range(0, 10))
def test_lines_equal_pil(width):
    rng = np.random.default_rng(200 + width)
    for t in range(40):
        lines = [random_polygon(rng, t + k) for k in range(int(rng.integers(1, 3)))]
        im = Image.new("L", (W, H), 0)
        for xy in lines:
            ImageDraw.Draw(im).line(xy, fill=180, width=width)
        got = np.zeros((H, W), np.uint8)
        draw_lines(got, lines, 180, width)
        assert np.array_equal(got, np.asarray(im)), (width, lines)
        base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        for alpha in (255, 128):
            ink = (20, 200, 60, alpha)
            im = Image.fromarray(base)
            draw = ImageDraw.Draw(im, "RGBA")
            for xy in lines:
                draw.line(xy, fill=ink, width=width)
            got = base.copy()
            blend_lines(got, lines, ink, width)
            assert np.array_equal(got, np.asarray(im)), (width, alpha, lines)


def test_joint_of_a_wide_translucent_line_blends_twice():
    """A stroke of width > 1 is one polygon per segment: at alpha 128 a
    pixel where two segments meet is blended twice."""
    base = np.full((20, 20, 3), 255, np.uint8)
    xy = [(2, 10), (10, 10), (10, 18)]
    got = base.copy()
    blend_lines(got, [xy], (0, 0, 0, 128), 3)
    im = Image.fromarray(base)
    ImageDraw.Draw(im, "RGBA").line(xy, fill=(0, 0, 0, 128), width=3)
    assert np.array_equal(got, np.asarray(im))
    assert got[10, 5, 0] == 127 and got[10, 10, 0] == 63


@pytest.mark.parametrize("seed", range(3))
def test_paste_mask_and_multiply_equal_pil(seed):
    rng = np.random.default_rng(300 + seed)
    for _ in range(30):
        canvas = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        mask = rng.integers(0, 256, (h, w), dtype=np.uint8)
        src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ox, oy = int(rng.integers(-20, W)), int(rng.integers(-20, H))
        colour = tuple(int(v) for v in rng.integers(0, 256, 3))
        for what in (colour, src):
            im = Image.fromarray(canvas)
            im.paste(Image.new("RGB", (w, h), colour) if what is colour else Image.fromarray(what),
                     (ox, oy), Image.fromarray(mask))
            got = canvas.copy()
            pil_draw.paste_mask(got, what, mask, ox, oy)
            assert np.array_equal(got, np.asarray(im))
        other = rng.integers(0, 256, (h, w), dtype=np.uint8)
        want = ImageChops.multiply(Image.fromarray(mask), Image.fromarray(other))
        assert np.array_equal(pil_draw.multiply(mask, other), np.asarray(want))
    assert pil_draw.ink((0.5, 0.2, 1.0), 0.5) == (127, 51, 255, 127)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_resize_equals_pil(mode, filt):
    rng = np.random.default_rng(len(mode) * 7 + len(filt))
    pil_filter = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[filt]
    sizes = [((1, 1), (9, 7)), ((9, 7), (1, 1)), ((1, 30), (17, 4)), ((40, 31), (13, 12)),
             ((13, 12), (40, 31)), ((64, 48), (128, 96)), ((100, 3), (7, 50))]
    sizes += [((int(rng.integers(1, 60)), int(rng.integers(1, 60))),
               (int(rng.integers(1, 90)), int(rng.integers(1, 90)))) for _ in range(20)]
    for (w, h), (w2, h2) in sizes:
        shape = (h, w) if mode == "L" else (h, w, len(mode))
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        if mode == "RGBA":
            arr[..., 3] = rng.choice([0, 255, 128, 3, 250], (h, w))
        want = np.asarray(Image.fromarray(arr, mode).resize((w2, h2), pil_filter))
        assert np.array_equal(pil_resample.resize(arr, w2, h2, filt), want), ((w, h), (w2, h2))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_rotate_expand_equals_pil(mode):
    rng = np.random.default_rng(len(mode))
    angles = [30.0, 60.0, 90.0, 270.0, 300.0, 45.0, 134.99, 225.0, 314.9]
    angles += [float(rng.uniform(45, 135)) for _ in range(15)]
    angles += [float(rng.uniform(225, 315)) for _ in range(15)]
    for angle in angles:
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        arr = rng.integers(1, 256, (h, w, len(mode)), dtype=np.uint8)
        want = np.asarray(Image.fromarray(arr, mode).rotate(-angle, expand=True))
        got = pil_resample.rotate_expand(arr, -angle)
        assert got.shape == want.shape and np.array_equal(got, want), (angle, h, w)


@pytest.mark.parametrize("seed", range(4))
def test_text_tile_equals_pil(seed):
    """ImageDraw.text's draw_bitmap onto an RGBA tile: two masks (the
    second over the first's pixels), then the tile pasted onto an RGB
    canvas through its alpha."""
    rng = np.random.default_rng(seed)
    h, w = rng.integers(3, 30, 2)
    tile = Image.new("RGBA", (int(w), int(h)), (0, 0, 0, 0))
    arr = np.zeros((h, w, 4), np.uint8)
    draw = ImageDraw.Draw(tile)
    for _ in range(2):
        mh, mw = rng.integers(1, 30, 2)
        mask = rng.integers(0, 256, (mh, mw)).astype(np.uint8)
        mask[rng.random((mh, mw)) < 0.3] = 0
        ink = tuple(int(v) for v in rng.integers(0, 256, 4))
        ox, oy = (int(v) for v in rng.integers(-5, 10, 2))
        draw.draw.draw_bitmap((ox, oy), Image.fromarray(mask, "L").im, draw.draw.draw_ink(ink))
        pil_draw.draw_bitmap_rgba(arr, mask, ox, oy, ink)
        assert np.array_equal(arr, np.asarray(tile)), seed
    canvas = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    want = Image.fromarray(canvas.copy())
    x0, y0 = (int(v) for v in rng.integers(-10, 45, 2))
    want.paste(tile, (x0, y0), tile)
    pil_draw.paste_mask(canvas, arr[..., :3], arr[..., 3], x0, y0)
    assert np.array_equal(canvas, np.asarray(want))


@pytest.mark.parametrize("angle", [30, -30, 330, 12.5, 45, 90, 123.4, 180, 270, -90.0])
def test_rotate_bicubic_rgba_equals_pil(angle):
    rng = np.random.default_rng(int(abs(angle) * 10))
    for h, w in ((1, 1), (7, 19), (30, 12)):
        a = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        a[..., 3] = np.where(rng.random((h, w)) < 0.4, 0, a[..., 3])
        want = np.asarray(Image.fromarray(a, "RGBA").rotate(angle, expand=True,
                                                            resample=Image.BICUBIC))
        assert np.array_equal(pil_resample.rotate_expand_bicubic(a, angle), want), (angle, h, w)
