"""The port's OpenCV stand-ins for the table stage (``utils/morph.py``)
against OpenCV itself, bit for bit. cv2 is imported here only as the
witness; the port does not import it.

Inputs from a numpy seed: random grey images, table-like masks (ruling
lines with text specks), random binary masks, 1-px rows and columns and
even element sizes (OpenCV's anchor ``k // 2``). The INTER_LINEAR resize
the table models share (``models/ocr/pre_post.resize_linear``) is held
to cv2 at the table stage's sizes too.
"""
import cv2
import numpy as np
import pytest

from rapiddoc_tpu_torch.models.ocr.pre_post import resize_linear
from rapiddoc_tpu_torch.utils import morph

SIZES = [(1, 1), (1, 37), (29, 1), (2, 3), (15, 15), (31, 64), (64, 321), (97, 140)]


def images(h: int, w: int, seed: int):
    """Grey noise, a table-like page (light paper, dark ruling lines,
    specks of text) and a binary 0/255 mask."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w), dtype=np.uint8)
    table = np.full((h, w), 235, np.uint8) + rng.integers(0, 15, (h, w), dtype=np.uint8)
    table[::max(h // 4, 1)] = 30
    table[:, ::max(w // 5, 1)] = 40
    table[rng.random((h, w)) < 0.05] = 80
    binary = np.where(rng.random((h, w)) < 0.6, 255, 0).astype(np.uint8)
    return noise, table, binary


@pytest.mark.parametrize("h,w", SIZES)
def test_adaptive_threshold_mean_equals_cv2(h, w):
    """cls.py (C = 10, THRESH_BINARY_INV) and img2table.py (C = -2,
    THRESH_BINARY), and fractional C both ways, with a 15x15 box."""
    for img in images(h, w, h * 1000 + w):
        for c, inv in ((10, True), (-2, False), (2.5, False), (-3.5, True), (0.5, True)):
            kind = cv2.THRESH_BINARY_INV if inv else cv2.THRESH_BINARY
            want = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_MEAN_C, kind, 15, c)
            np.testing.assert_array_equal(morph.adaptive_threshold_mean(img, 255, 15, c, inv),
                                          want)
        want = cv2.boxFilter(img, -1, (15, 15), normalize=True,
                             borderType=cv2.BORDER_REPLICATE | cv2.BORDER_ISOLATED)
        np.testing.assert_array_equal(morph.box_mean_u8(img, 15), want)


@pytest.mark.parametrize("h,w", SIZES)
def test_morph_open_rect_equals_cv2(h, w):
    """Horizontal and vertical line elements, odd and even lengths,
    longer than the image too."""
    for img in images(h, w, h * 7 + w)[1:]:
        for k in (1, 2, 3, 4, 8, 9, 12, 40, max(8, int(w * 0.125)), max(8, h // 8)):
            for kw, kh in ((k, 1), (1, k)):
                se = cv2.getStructuringElement(cv2.MORPH_RECT, (kw, kh))
                want = cv2.morphologyEx(img, cv2.MORPH_OPEN, se)
                np.testing.assert_array_equal(morph.morph_open_rect(img, kw, kh), want)


@pytest.mark.parametrize("h,w", SIZES + [(1024, 1024)])
def test_dilate_and_connected_components_equal_cv2(h, w):
    """The UNet's cell recovery: dilate3x3, then 4-connected components
    of the complement with cv2's labels (their order decides the stable
    sort that follows) and stats."""
    rng = np.random.default_rng(h + 3 * w)
    for p in (0.02, 0.1, 0.4):
        mask = (rng.random((h, w)) < p).astype(np.uint8)
        lattice = morph.dilate3x3(mask)
        np.testing.assert_array_equal(lattice, cv2.dilate(mask, np.ones((3, 3), np.uint8)))
        inv = (1 - lattice).astype(np.uint8)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(inv, connectivity=4)
        got = morph.connected_components_with_stats(inv)
        assert got[0] == n
        np.testing.assert_array_equal(got[1], labels)
        np.testing.assert_array_equal(got[2], stats)


@pytest.mark.parametrize("h,w", [(64, 321), (550, 293), (17, 900), (1024, 1024), (2048, 2)])
def test_resize_linear_equals_cv2_at_table_sizes(h, w):
    """INTER_LINEAR to the classifier's 224, the UNet's 1024, UniTable's
    448 and SLANet's aspect fit into 488, RGB."""
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    ratio = 488 / max(h, w)
    for ow, oh in ((224, 224), (1024, 1024), (448, 448),
                   (max(1, int(w * ratio)), max(1, int(h * ratio)))):
        np.testing.assert_array_equal(resize_linear(img, ow, oh), cv2.resize(img, (ow, oh)))
