"""The port's OpenCV-free pre/post-processing against OpenCV and the JAX
package's pre_post, on random inputs from numpy seeds.

Bit-equal: INTER_LINEAR resize, RGB->grey, 2x2 dilation, boxPoints,
getPerspectiveTransform, warpPerspective, fillPoly of polygons inside
the image, the number and order of findContours(RETR_LIST) contours,
det/rec resize.
Within a stated tolerance, each with its reason:
- minAreaRect: within 1e-5 relative (OpenCV's float32 calipers
  replayed in numpy float32 scalars; a few last-bit differences);
- fillPoly of a box crossing the image border: OpenCV clips such edges
  with its own rounding; at most 2 % of such boxes differ, by at most
  one image row or column's worth of boundary pixels.
"""
import cv2
import numpy as np
import pytest
from scipy import ndimage

from rapiddoc_tpu.models.ocr import pre_post as jpp
from rapiddoc_tpu_torch.models.ocr import pre_post as pp


def test_resize_linear_is_bit_equal():
    rng = np.random.default_rng(0)
    for t in range(200):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        oh, ow = (int(v) for v in rng.integers(1, 150, 2))
        if t % 10 == 0:  # exact 2x downscale: OpenCV's box-filter path
            oh, ow = max(h // 2, 1), max(w // 2, 1)
            h, w = 2 * oh, 2 * ow
        shape = [(h, w), (h, w, 1), (h, w, 3)][t % 3]
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, (ow, oh)).reshape((oh, ow) + shape[2:])
        np.testing.assert_array_equal(pp.resize_linear(img, ow, oh), want)


def test_det_and_rec_resize_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(20, 300, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        a, ay, ax = pp.det_resize(img, 160)
        b, by, bx = jpp.det_resize(img, 160)
        np.testing.assert_array_equal(a, b)
        assert (ay, ax) == (by, bx)
        np.testing.assert_array_equal(pp.rec_resize(img, 320), jpp.rec_resize(img, 320))


def test_to_luma_is_bit_equal():
    img = np.random.default_rng(2).integers(0, 256, (300, 400, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pp.to_luma(img)[..., 0], cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def test_dilate_2x2_is_bit_equal():
    seg = (np.random.default_rng(3).random((120, 90)) > 0.8).astype(np.uint8)
    want = cv2.dilate(seg, np.ones((2, 2), np.uint8)).astype(bool)
    np.testing.assert_array_equal(pp._dilate_2x2(seg.astype(bool)), want)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(40, 200, (50, 70, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pp.contrast_stretch(img), jpp.contrast_stretch(img))
    luma = rng.integers(0, 256, (48, 81, 1), dtype=np.uint8)
    np.testing.assert_array_equal(pp.pack_nibbles(luma), jpp.pack_nibbles(luma))
    chars = [chr(33 + i) for i in range(60)]
    ids = rng.integers(0, 62, 40)
    probs = rng.random(40).astype(np.float32)
    assert pp.CTCLabelDecoder(chars)(ids, probs, 30) == jpp.CTCLabelDecoder(chars)(ids, probs, 30)
    for w, h in ((10, 48), (300, 20), (2000, 30)):
        assert pp.rec_width_bucket(w, h, (160, 320, 640)) == jpp.rec_width_bucket(w, h, (160, 320, 640))


def _random_rect(rng, w, h, max_side=40.0, max_angle=90.0):
    c = rng.uniform(-3, [w + 3, h + 3])
    s = rng.uniform(2, max_side, 2)
    return ((float(c[0]), float(c[1])), (float(s[0]), float(s[1])),
            float(rng.uniform(-max_angle, max_angle)))


def test_box_points_is_bit_equal():
    rng = np.random.default_rng(5)
    for _ in range(2000):
        rect = _random_rect(rng, 500, 500, 90)
        rect = tuple(tuple(float(np.float32(v)) for v in p) if isinstance(p, tuple)
                     else float(np.float32(p)) for p in rect)
        np.testing.assert_array_equal(pp.box_points(rect), cv2.boxPoints(rect))
    for angle in (-90.0, -45.0, 0.0, 90.0):
        rect = ((10.5, 20.0), (7.0, 3.0), angle)
        np.testing.assert_array_equal(pp.box_points(rect), cv2.boxPoints(rect))


def test_fill_poly_inside_image_is_bit_equal():
    rng = np.random.default_rng(6)
    for _ in range(1000):
        h, w = (int(v) for v in rng.integers(3, 60, 2))
        pts = rng.integers(0, [w, h], (4, 2)).astype(np.int32)  # any quad, even self-crossing
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        np.testing.assert_array_equal(pp.fill_poly_mask((h, w), pts), want.astype(bool))


def test_fill_poly_of_boxes_crossing_the_border():
    rng = np.random.default_rng(7)
    cases = differ = worst = 0
    for _ in range(3000):
        h, w = (int(v) for v in rng.integers(4, 60, 2))
        pts = pp.box_points(_random_rect(rng, w, h)).astype(np.int32)
        if ((pts >= 0) & (pts < [w, h])).all():
            continue
        cases += 1
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        bad = int((pp.fill_poly_mask((h, w), pts) != want.astype(bool)).sum())
        differ += bad > 0
        worst = max(worst, bad / max(h, w))
    assert cases > 2000
    assert differ <= 0.02 * cases
    assert worst <= 1.0  # at most one image row or column's worth


def _blobs(rng, h, w, holes):
    seg = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 6))):
        cv2.fillPoly(seg, [pp.box_points(_random_rect(rng, w, h, 60, 10)).astype(np.int32)], 1)
    seg = np.maximum(seg, (ndimage.uniform_filter(rng.random((h, w)), 3) > 0.62).astype(np.uint8))
    if holes:
        seg[rng.integers(0, h, 6), rng.integers(0, w, 6)] = 0
    return seg


@pytest.mark.parametrize("holes", [False, True])
def test_contour_rects_match_find_contours(holes):
    rng = np.random.default_rng(8 + holes)
    rects = 0
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(20, 120, 2))
        seg = _blobs(rng, h, w, holes)
        contours, _ = cv2.findContours(seg, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
        want = [cv2.minAreaRect(c) for c in contours]
        got = pp.find_contour_rects(seg.astype(bool))
        assert len(got) == len(want)  # outer borders and holes alike
        for g, r in zip(got, want):  # in OpenCV's order
            assert (min(g[1]) >= 3) == (min(r[1]) >= 3)  # db_postprocess's min_size
            if min(r[1]) < 3:
                continue
            rects += 1
            np.testing.assert_allclose(
                np.array(g[0] + g[1] + (g[2],)), np.array(r[0] + r[1] + (r[2],)),
                rtol=1e-5, atol=1e-4,
            )
    assert rects > 500


def test_perspective_transform_is_bit_equal():
    rng = np.random.default_rng(9)
    for _ in range(200):
        quad = pp._order_quad(pp.box_points(_random_rect(rng, 400, 300, 200, 8)))
        dst = np.array([[0, 0], [120, 0], [120, 30], [0, 30]], np.float32)
        np.testing.assert_array_equal(
            pp.perspective_transform(quad, dst), cv2.getPerspectiveTransform(quad, dst)
        )


def _warp_case(rng, img, offset: float):
    """A random text-line quad (corners moved by up to ``offset`` px, which
    makes the map a true perspective one), its output size and
    OpenCV's warp of ``img``."""
    (cx, cy), _, a = _random_rect(rng, 380, 280, 10, 5)
    rect = ((cx, cy), tuple(rng.uniform([20, 8], [300, 40])), a)
    quad = pp._order_quad(pp.box_points(rect))
    if offset:
        quad = (quad + rng.uniform(-offset, offset, quad.shape)).astype(np.float32)
    w = int(max(np.linalg.norm(quad[0] - quad[1]), np.linalg.norm(quad[2] - quad[3])))
    h = int(max(np.linalg.norm(quad[0] - quad[3]), np.linalg.norm(quad[1] - quad[2])))
    dst = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    m = cv2.getPerspectiveTransform(quad, dst)
    return m, w, h, cv2.warpPerspective(img, m, (w, h))


def test_warp_perspective_matches_opencv():
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    for _ in range(100):
        m, w, h, want = _warp_case(rng, img, 0.0)
        np.testing.assert_array_equal(pp.warp_perspective(img, m, w, h), want)


def test_warp_perspective_matches_opencv_at_subpixel_offsets():
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    for i in range(100):
        src = img if i % 4 else img[..., 0]  # a grey image now and then
        m, w, h, want = _warp_case(rng, src, 0.5)
        np.testing.assert_array_equal(pp.warp_perspective(src, m, w, h), want)


def test_db_postprocess_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(10):
        seg = _blobs(rng, 160, 224, holes=True).astype(np.float32)
        prob = np.clip(ndimage.gaussian_filter(seg, 1.0) + rng.normal(0, 0.02, seg.shape), 0, 1)
        prob = prob.astype(np.float32)
        got_b, got_s = pp.db_postprocess(prob, 320, 448)
        want_b, want_s = jpp.db_postprocess(prob, 320, 448)
        assert got_b.shape == want_b.shape
        np.testing.assert_allclose(got_b, want_b, atol=0.05)
        np.testing.assert_allclose(got_s, want_s, atol=0.02)
