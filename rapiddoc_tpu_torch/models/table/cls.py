"""Table classifier (wired vs wireless).

Port of ``rapiddoc_tpu/models/table/cls.py``: ``TableClsNet`` (:20), a
compact conv classifier; ``TableClassifier`` (:34), which resizes each
crop to 224x224 with ``resize_linear`` (cv2's INTER_LINEAR), pads the
batch with zero rows to a power of two, divides by 255 and rounds to
bf16 on the device, and calls a crop ``wired`` when the float32
softmax gives ``p[0] >= p[1]``; and ``heuristic_table_kind`` (:80), the
rule-based kind when no classifier is loaded, with cv2's adaptive
threshold and morphological opening replaced by ``utils/morph.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...engine.session import resolve_device
from ...utils.morph import adaptive_threshold_mean, morph_open_rect
from ..common.layers import ConvBNAct
from ..ocr.pre_post import resize_linear, rgb_to_gray


class TableClsNet(nn.Module):
    """NCHW in, (B, 2) logits out: 0 wired, 1 wireless."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        cin = 3
        for i, f in enumerate((16, 32, 64, 128)):
            self.add_module(f"conv{i}", ConvBNAct(cin, f, 3, 2, act="hardswish"))
            cin = f
        self.fc1 = nn.Linear(cin, 64)
        self.fc2 = nn.Linear(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = getattr(self, f"conv{i}")(x)
        x = x.mean(dim=(2, 3))
        return self.fc2(F.hardswish(self.fc1(x)))


class TableClassifier:
    """``model`` with its weights loaded, on ``device`` (the card by
    default) in ``dtype`` (bf16 by default)."""

    INPUT = 224

    def __init__(self, model: TableClsNet, *, device=None, dtype: torch.dtype | None = None):
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.model = model.to(device=self.device, dtype=self.dtype).eval()

    @torch.no_grad()
    def probs(self, imgs: list[np.ndarray]) -> np.ndarray:
        """(n, 2) float32 class probabilities."""
        batch = np.stack([resize_linear(im, self.INPUT, self.INPUT) for im in imgs])
        n = len(imgs)
        nb = 1
        while nb < n:
            nb *= 2
        if nb != n:
            batch = np.concatenate(
                [batch, np.zeros((nb - n, *batch.shape[1:]), batch.dtype)]
            )
        x = torch.from_numpy(batch).to(self.device)
        x = (x.float() / 255.0).to(torch.bfloat16).to(self.dtype).permute(0, 3, 1, 2)
        logits = self.model(x).float()
        return torch.softmax(logits, dim=-1)[:n].cpu().numpy()

    def __call__(self, imgs: list[np.ndarray]) -> list[str]:
        """Returns 'wired' | 'wireless' per table crop."""
        if not imgs:
            return []
        return ["wired" if p[0] >= p[1] else "wireless" for p in self.probs(imgs)]


def heuristic_table_kind(img: np.ndarray) -> str:
    """Rule-based fallback when no trained classifier exists: count long
    horizontal+vertical ruling lines."""
    gray = rgb_to_gray(img) if img.ndim == 3 else img
    binary = adaptive_threshold_mean(gray, 255, 15, 10, inverse=True)
    h, w = binary.shape
    horiz = morph_open_rect(binary, max(w // 8, 8), 1)
    vert = morph_open_rect(binary, 1, max(h // 8, 8))
    h_lines = (horiz.sum(axis=1) > 0.5 * 255 * w).sum()
    v_lines = (vert.sum(axis=0) > 0.5 * 255 * h).sum()
    return "wired" if h_lines >= 3 and v_lines >= 3 else "wireless"
