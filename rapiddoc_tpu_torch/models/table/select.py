"""Wired/wireless result arbitration + table text normalization.

Copy of ``rapiddoc_tpu/models/table/select.py``. Behavioural counterpart of the reference's
table utils (rapid_doc/model/table/utils.py — count_table_cells_physical,
select_best_table_model :80-140 decision thresholds,
normalize_table_cell_text CJK de-spacing). numpy and the stdlib.
"""
from __future__ import annotations

import re
from html.parser import HTMLParser

import numpy as np

CJK_RE = re.compile(r"[㐀-鿿]")
CJK_PUNCT = "，。、“”‘’；：？！（）《》【】"


def count_cells(html_code: str) -> int:
    if not html_code:
        return 0
    low = html_code.lower()
    return low.count("<td") + low.count("<th")


class _CellTextParser(HTMLParser):
    def __init__(self) -> None:
        super().__init__()
        self.cells: list[str] = []
        self._depth = 0
        self._buf: list[str] = []

    def handle_starttag(self, tag, attrs):
        if tag in ("td", "th"):
            self._depth += 1
            self._buf = []

    def handle_endtag(self, tag):
        if tag in ("td", "th") and self._depth:
            self._depth -= 1
            self.cells.append("".join(self._buf))

    def handle_data(self, data):
        if self._depth:
            self._buf.append(data)


def cell_texts(html_code: str) -> list[str]:
    p = _CellTextParser()
    try:
        p.feed(html_code or "")
    except Exception:
        return []
    return p.cells


def count_blank_cells(html_code: str) -> int:
    return sum(1 for t in cell_texts(html_code) if not t.strip())


def normalize_cell_text(text: str) -> str:
    """Strip OCR-inserted spaces between CJK characters / CJK punctuation."""
    if not text or not CJK_RE.search(text):
        return text
    cjk = r"㐀-鿿"
    text = re.sub(rf"(?<=[{cjk}])\s+(?=[{cjk}])", "", text)
    text = re.sub(rf"(?<=[{cjk}A-Za-z0-9$])\s+(?=[{CJK_PUNCT}])", "", text)
    text = re.sub(rf"(?<=[{CJK_PUNCT}])\s+(?=[{cjk}A-Za-z0-9$])", "", text)
    text = re.sub(rf"(?<=[A-Za-z0-9$])\s+(?=[{cjk}])", "", text)
    text = re.sub(rf"(?<=[{cjk}])\s+(?=[A-Za-z0-9$])", "", text)
    return text


def select_best_table_html(
    ocr_texts: list[str], wired_html: str | None, wireless_html: str | None
) -> str:
    """Pick the better structure result. Signals: physical cell counts,
    how many OCR strings each result absorbed, blank-cell counts, and a
    square-table scale estimate (decision thresholds per the reference,
    utils.py:80-140)."""
    wired_html = wired_html or ""
    wireless_html = wireless_html or ""
    wired_n = count_cells(wired_html)
    wireless_n = count_cells(wireless_html)
    gap = wireless_n - wired_n

    wired_hits = sum(1 for t in ocr_texts if t and t in wired_html)
    wireless_hits = sum(1 for t in ocr_texts if t and t in wireless_html)

    wired_filled = wired_n - count_blank_cells(wired_html)
    wireless_filled = wireless_n - count_blank_cells(wireless_html)

    if wired_hits > wireless_hits and wired_filled >= wireless_filled:
        return wired_html

    switch = False
    if wireless_filled > wired_filled:
        scale = round(wired_filled ** 0.5)
        plus_two_cols = wired_filled + scale * 2
        plus_two_rows = scale * (scale + 2)
        if wireless_filled + 3 >= max(plus_two_cols, plus_two_rows):
            switch = True

    if (
        switch
        or (0 <= gap <= 5 and wired_n <= round(wireless_n * 0.75))
        or (gap == 0 and wired_n <= 4 and wireless_hits >= wired_hits)
        or (wired_hits <= wireless_hits * 0.6 and wireless_hits >= 10)
    ):
        return wireless_html
    return wired_html


def detect_table_rotations(
    crops: list[np.ndarray], ocr_detector
) -> list[bool]:
    """Portrait crops whose text boxes are mostly vertical are rotated
    tables (reference: rapid_table.py:126-165). All portrait candidates
    run through text det in ONE batched call; returns per-crop whether
    it should rotate 90 degrees clockwise before recognition. A failing
    det call means "no rotation", as in the JAX package, except for the
    port's own TextDetector, whose failure (the card or a kernel at
    fault) is raised."""
    out = [False] * len(crops)
    if ocr_detector is None:
        return out
    candidates = [
        i for i, c in enumerate(crops)
        if c.shape[1] > 0 and c.shape[0] / c.shape[1] > 1.2
    ]
    if not candidates:
        return out
    try:
        dets = ocr_detector([crops[i] for i in candidates])
    except Exception:
        from ..ocr.engine import TextDetector

        if isinstance(ocr_detector, TextDetector):
            raise
        return out
    for i, det in zip(candidates, dets):
        if len(det.boxes) == 0:
            continue
        vertical = 0
        for quad in det.boxes:
            bw = float(quad[:, 0].max() - quad[:, 0].min())
            bh = float(quad[:, 1].max() - quad[:, 1].min())
            if bh > 0 and bw / bh < 0.8:
                vertical += 1
        out[i] = vertical >= len(det.boxes) * 0.3
    return out


def detect_table_rotation(crop: np.ndarray, ocr_detector) -> bool:
    """Single-crop convenience wrapper over detect_table_rotations."""
    return detect_table_rotations([crop], ocr_detector)[0]
