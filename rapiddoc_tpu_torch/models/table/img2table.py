"""Model-free table extraction from ruling lines (img2table-style
fallback).

Port of ``ruling_line_mask`` and ``opencv_table_extract`` of
``rapiddoc_tpu/models/table/img2table.py`` (role parity with the
reference's optional img2table path, rapid_table.py:219-249), with
OpenCV's adaptive threshold and morphological opening replaced by their
bit-equal numpy versions (``utils/morph.py``). Host only: adaptive
threshold -> horizontal and vertical line opening -> lattice -> cell
components, through the UNet's cell and grid recovery. The borderless
extractor (``borderless_table_extract``, with the low finding of
``ADVICE.md`` at ``img2table.py:175``, which its port is to keep) works
from OCR word boxes, which the table stage does not have yet (ROADMAP
Queue 1 item 7).
"""
from __future__ import annotations

import numpy as np

from ...utils.morph import adaptive_threshold_mean, morph_open_rect
from ..ocr.pre_post import rgb_to_gray
from .unet import cells_to_grid, extract_cells_from_mask


def ruling_line_mask(img: np.ndarray, min_line_frac: float = 0.25) -> np.ndarray:
    """Binary mask of horizontal+vertical ruling lines. `min_line_frac`
    is the minimum line length as a fraction of the image side."""
    gray = rgb_to_gray(img) if img.ndim == 3 else img
    binary = adaptive_threshold_mean(255 - gray, 255, 15, -2)
    h, w = gray.shape
    hk = max(8, int(w * min_line_frac * 0.5))
    vk = max(8, int(h * min_line_frac * 0.5))
    horiz = morph_open_rect(binary, hk, 1)
    vert = morph_open_rect(binary, 1, vk)
    return ((horiz > 0) | (vert > 0)).astype(np.float32)


def opencv_table_extract(
    img: np.ndarray,
) -> tuple[list[list[float]], list[tuple[int, int, int, int]]]:
    """Image -> (cell boxes in source px, logical grid). Empty when no
    ruling lattice is found (caller falls back to wireless models)."""
    mask = ruling_line_mask(img)
    if mask.sum() < 50:
        return [], []
    cells = extract_cells_from_mask(mask, min_cell_area=100)
    if len(cells) < 2:
        return [], []
    grid = cells_to_grid(cells)
    return cells, grid
