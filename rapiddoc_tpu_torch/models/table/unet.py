"""UNet wired-table segmentation + host cell recovery.

Port of ``rapiddoc_tpu/models/table/unet.py``: ``UNet`` (:29),
``extract_cells_from_mask`` (:57), ``cells_to_grid`` (:87) and
``WiredTableStructure`` (:129). The crop is resized to the fixed
1024x1024 input with ``resize_linear`` (cv2's INTER_LINEAR) and sent as
4-bit luma, two pixels a byte (or, with ``RAPIDDOC_UNET_WIRE_BITS=8``,
as uint8 RGB); the device unpacks it, divides by 15 (or 255), rounds
the input to bf16 as the JAX package does, runs the net in the compute
dtype and returns the line decision ``logits[1] > logits[0]`` (float32)
packed to bits, which the host unpacks. Crops go in (1, 2, 4)-row
batches, all dispatched before any mask is fetched.

Two details of the flax net: ``upconv{i}`` is a raw 2x2 ``nn.Conv``
with ``padding="SAME"``, which pads (0, 1) on each axis, and the x2
nearest upsample is a repeat. The cell recovery replaces cv2's dilate
and connected components with ``utils/morph.py``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...engine.buckets import batch_chunks, pad_rows
from ...engine.session import resolve_device
from ...utils.morph import connected_components_with_stats, dilate3x3
from ..common.layers import ConvBNAct, upsample_nearest
from ..ocr.pre_post import pack_nibbles, resize_linear, to_luma


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = ConvBNAct(in_channels, features, 3)
        self.conv2 = ConvBNAct(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class UNet(nn.Module):
    """Classic UNet; NCHW in, 2-channel logits (background, line) out."""

    def __init__(self, base: int = 16, depth: int = 4, out_channels: int = 2,
                 in_channels: int = 3):
        super().__init__()
        self.depth = depth
        f, cin = base, in_channels
        for i in range(depth):
            self.add_module(f"down{i}", DoubleConv(cin, f))
            cin, f = f, f * 2
        self.bottom = DoubleConv(cin, f)
        for i in range(depth - 1, -1, -1):
            f //= 2
            self.add_module(f"upconv{i}", nn.Conv2d(2 * f, f, 2))
            self.add_module(f"up{i}", DoubleConv(2 * f, f))
        self.head = nn.Conv2d(base, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottom(x)
        for i in range(self.depth - 1, -1, -1):
            # flax's SAME padding of a 2x2 kernel: nothing before, one after
            x = F.pad(upsample_nearest(x, 2), (0, 1, 0, 1))
            x = getattr(self, f"upconv{i}")(x)
            x = getattr(self, f"up{i}")(torch.cat([skips[i], x], dim=1))
        return self.head(x)


def extract_cells_from_mask(
    line_mask: np.ndarray, min_cell_area: int = 64
) -> list[list[float]]:
    """Line-probability mask -> cell boxes via connected components of the
    complement inside the table region."""
    mask = (line_mask > 0.5).astype(np.uint8)
    if mask.sum() < 10:
        return []
    # close gaps in the line lattice
    lattice = dilate3x3(mask)
    inv = (1 - lattice).astype(np.uint8)
    n, labels, stats = connected_components_with_stats(inv)
    h, w = mask.shape
    cells = []
    for i in range(1, n):
        x, y, cw, ch, area = stats[i]
        if area < min_cell_area:
            continue
        # drop the outside background (touches the border massively)
        if x == 0 and y == 0 and cw == w and ch == h:
            continue
        touches_border = x == 0 or y == 0 or x + cw >= w or y + ch >= h
        if touches_border and area > 0.5 * h * w:
            continue
        cells.append([float(x), float(y), float(x + cw), float(y + ch)])
    cells.sort(key=lambda b: (b[1], b[0]))
    return cells


def cells_to_grid(cells: list[list[float]]) -> list[tuple[int, int, int, int]]:
    """Assign logical (row, col, rowspan, colspan) to cell boxes.

    Row/column boundaries are clustered with tolerances adaptive to the
    median cell size (reference role: rapid_table_self/table_structure/
    utils_table_recover.py logical row/col recovery); a cell's span is
    one plus the number of interior boundaries it crosses.
    """
    if not cells:
        return []
    widths = sorted(c[2] - c[0] for c in cells)
    heights = sorted(c[3] - c[1] for c in cells)
    med_w = widths[len(widths) // 2]
    med_h = heights[len(heights) // 2]
    tol_x = max(6.0, med_w * 0.3)
    tol_y = max(6.0, med_h * 0.3)

    def cluster(vals: list[float], tol: float) -> list[float]:
        out: list[list[float]] = []
        for v in sorted(vals):
            if not out or v - out[-1][-1] > tol:
                out.append([v])
            else:
                out[-1].append(v)
        return [sum(g) / len(g) for g in out]

    row_edges = cluster([c[1] for c in cells], tol_y)
    col_edges = cluster([c[0] for c in cells], tol_x)

    def nearest(edges: list[float], v: float) -> int:
        return min(range(len(edges)), key=lambda i: abs(edges[i] - v))

    grid = []
    for x0, y0, x1, y1 in cells:
        r = nearest(row_edges, y0)
        c = nearest(col_edges, x0)
        inner_rows = [e for e in row_edges if y0 + tol_y < e < y1 - tol_y * 0.5]
        inner_cols = [e for e in col_edges if x0 + tol_x < e < x1 - tol_x * 0.5]
        grid.append((r, c, 1 + len(inner_rows), 1 + len(inner_cols)))
    return grid


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


class WiredTableStructure:
    """Fixed-1024 UNet session + host recovery. ``model`` with its
    weights loaded; runs on ``device`` (the card by default) in
    ``dtype`` (bf16 by default). ``calls`` counts the UNet's dispatches
    and ``items`` the crops they carried."""

    INPUT = 1024

    def __init__(self, model: UNet, *, device=None, dtype: torch.dtype | None = None):
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.nibble_wire = os.environ.get("RAPIDDOC_UNET_WIRE_BITS", "4") == "4"
        self._bits = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=self.device)
        self.calls = 0
        self.items = 0

    def __call__(self, img: np.ndarray) -> tuple[list[list[float]], list]:
        """Returns (cell boxes in source pixels, logical grid)."""
        return self.batch([img])[0]

    def preprocess(self, img: np.ndarray) -> np.ndarray:
        """The uint8 array the device gets for one crop: (1024, 512)
        packed 4-bit luma, or (1024, 1024, 3) RGB on the 8-bit wire."""
        resized = resize_linear(img, self.INPUT, self.INPUT)
        if self.nibble_wire:
            return pack_nibbles(to_luma(resized))[..., 0]
        return resized

    @torch.no_grad()
    def logit_gap(self, batch: torch.Tensor) -> torch.Tensor:
        """uint8 batch on the device -> (B, 1024, 1024) float32 l1 - l0,
        positive where the pixel is a line."""
        if self.nibble_wire:
            b, h, w2 = batch.shape
            luma = torch.stack([batch >> 4, batch & 15], dim=3).reshape(b, h, w2 * 2)
            x = (luma.float() / 15.0)[:, None].expand(b, 3, h, w2 * 2)
        else:
            x = (batch.float() / 255.0).permute(0, 3, 1, 2)
        logits = self.model(x.to(torch.bfloat16).to(self.dtype)).float()
        return logits[:, 1] - logits[:, 0]

    @torch.no_grad()
    def forward_bits(self, batch: torch.Tensor) -> torch.Tensor:
        """uint8 batch on the device -> (B, 1024, 128) uint8 line bits,
        eight pixels a byte, the first in the high bit (``l1 > l0``)."""
        line = (self.logit_gap(batch) > 0).to(torch.uint8)
        b, h, w = line.shape
        return (line.reshape(b, h, w // 8, 8) * self._bits).sum(-1, dtype=torch.uint8)

    def dispatch(self, prepped: list[np.ndarray]) -> list[tuple[torch.Tensor, int]]:
        """Enqueue the UNet over (1, 2, 4)-row batches; returns (bits on
        the device, rows) per batch without waiting for the device."""
        handles = []
        for s, e, padded in batch_chunks(len(prepped), sizes=(1, 2, 4)):
            batch = torch.from_numpy(pad_rows(np.stack(prepped[s:e]), padded))
            if self.device.type == "cuda":
                batch = batch.pin_memory().to(self.device, non_blocking=True)
            handles.append((self.forward_bits(batch), e - s))
            self.calls += 1
            self.items += e - s
        return handles

    def finish(self, imgs: list[np.ndarray], handles) -> list[tuple[list[list[float]], list]]:
        """Fetch the masks and recover each crop's cells and grid."""
        masks = [bits for h, n in handles for bits in h[:n].cpu().numpy()]
        out = []
        for img, bits in zip(imgs, masks):
            mask = np.unpackbits(bits, axis=-1)[:, : self.INPUT]
            cells = extract_cells_from_mask(mask.astype(np.float32))
            h, w = img.shape[:2]
            sx, sy = w / self.INPUT, h / self.INPUT
            scaled = [
                [c[0] * sx, c[1] * sy, c[2] * sx, c[3] * sy] for c in cells
            ]
            out.append((scaled, cells_to_grid(cells)))
        return out

    def batch(
        self, imgs: list[np.ndarray]
    ) -> list[tuple[list[list[float]], list]]:
        """All tables dispatched before any mask is fetched."""
        if not imgs:
            return []
        return self.finish(imgs, self.dispatch([self.preprocess(im) for im in imgs]))
