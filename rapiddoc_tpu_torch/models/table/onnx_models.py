"""Published-ONNX table models through the port's ONNX interpreter.

Port of ``rapiddoc_tpu/models/table/onnx_models.py``: the checkpoints the
JAX package's registry pins (unet.onnx, paddle_cls.onnx, q_cls.onnx,
slanet-plus.onnx) with the reference IO contracts, run by
``engine/onnx_torch.py`` on ``device`` in float32: paddle_cls
256-short-resize (``resize_lanczos4``, cv2's INTER_LANCZOS4) + 224
centre crop + ImageNet norm (reference: table_cls/main.py:85-130), q_cls
grey (``rgb_to_gray``) -> 3ch 224 resize (:137-165), PADDLE_Q_CLS
consensus = wired only when both agree (:53-66); UNET 1024x1024,
0-255-scale mean/std norm, class map {1: horizontal lines, 2: vertical
lines} (reference: table_structure/unet/main.py:38-97) into the port's
cell recovery; SLANet-plus with its decode Loop inside the graph. Inputs
ship as uint8 and are normalised on the device (each function's
``preproc``); the other resizes are ``resize_linear`` (INTER_LINEAR).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ...engine.onnx_torch import OnnxTorchFunction
from ...tools.onnx_reader import read_onnx_metadata
from ..ocr.pre_post import resize_lanczos4, resize_linear, rgb_to_gray
from .unet import cells_to_grid, extract_cells_from_mask

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_UNET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_UNET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _nchw(v: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(v).to(x.device).reshape(1, 3, 1, 1)


def _norm_imagenet_nchw(x: torch.Tensor) -> torch.Tensor:
    """uint8 NCHW -> ImageNet-normalized float32, on the device."""
    x = x.to(torch.float32) / 255.0
    return (x - _nchw(_IMAGENET_MEAN, x)) / _nchw(_IMAGENET_STD, x)


def _norm_unet_nchw(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) - _nchw(_UNET_MEAN, x)) / _nchw(_UNET_STD, x)


def _load(path: Path, norm, device) -> OnnxTorchFunction:
    fn = OnnxTorchFunction.from_file(path, device=device)
    fn.preproc = {fn.input_names[0]: norm}
    return fn


class OnnxTableClassifier:
    """paddle_cls (+ q_cls consensus when both checkpoints exist)."""

    def __init__(self, paddle_path: Path | None, q_path: Path | None, *, device=None):
        self.paddle = (
            _load(paddle_path, _norm_imagenet_nchw, device) if paddle_path else None
        )
        self.q = _load(q_path, _norm_imagenet_nchw, device) if q_path else None

    @staticmethod
    def _paddle_pre(img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        p = 256.0 / min(h, w)
        img = resize_lanczos4(img, int(round(w * p)), int(round(h * p)))
        h, w = img.shape[:2]
        y0, x0 = (h - 224) // 2, (w - 224) // 2
        img = img[y0 : y0 + 224, x0 : x0 + 224]
        return img.transpose(2, 0, 1)  # uint8; normalized on the device

    @staticmethod
    def _q_pre(img: np.ndarray) -> np.ndarray:
        gray = rgb_to_gray(img)
        img3 = np.stack((gray,) * 3, axis=-1)
        img3 = resize_linear(img3, 224, 224)
        return img3.transpose(2, 0, 1)  # uint8; normalized on the device

    @staticmethod
    def _labels(logits: np.ndarray) -> list[str]:
        return ["wired" if r.argmax() == 0 else "wireless" for r in logits]

    def __call__(self, imgs: list[np.ndarray]) -> list[str]:
        if not imgs:
            return []
        labels = None
        if self.paddle is not None:
            x = np.stack([self._paddle_pre(im) for im in imgs])
            labels = self._labels(np.asarray(self.paddle(x)[0]))
        if self.q is not None:
            xq = np.stack([self._q_pre(im) for im in imgs])
            q_labels = self._labels(np.asarray(self.q(xq)[0]))
            if labels is None:
                labels = q_labels
            else:
                # consensus: disagreement falls back to wireless
                labels = [
                    a if a == b else "wireless"
                    for a, b in zip(labels, q_labels)
                ]
        return labels or ["wireless"] * len(imgs)


class OnnxWiredTableStructure:
    """unet.onnx: 1024 class map -> line mask -> cells/grid (host)."""

    INPUT = 1024

    def __init__(self, path: Path, *, device=None):
        self.fn = _load(path, _norm_unet_nchw, device)

    def batch(
        self, imgs: list[np.ndarray]
    ) -> list[tuple[list[list[float]], list]]:
        out = []
        for img in imgs:
            resized = resize_linear(img, self.INPUT, self.INPUT)
            pred = np.asarray(
                self.fn(resized.transpose(2, 0, 1)[None])[0]
            )
            pred = pred.reshape(pred.shape[-2], pred.shape[-1])
            mask = (pred > 0).astype(np.float32)
            cells = extract_cells_from_mask(mask)
            h, w = img.shape[:2]
            sx, sy = w / self.INPUT, h / self.INPUT
            scaled = [
                [c[0] * sx, c[1] * sy, c[2] * sx, c[3] * sy] for c in cells
            ]
            out.append((scaled, cells_to_grid(cells)))
        return out


class OnnxWirelessStructure:
    """Published slanet-plus.onnx via the ONNX interpreter (the AR Loop
    runs inside the graph: one host read of its exit condition a step).

    Reference contract: table_structure/pp_structure/{main,pre_process,
    post_process}.py — 488 keep-ratio resize + zero pad, ImageNet norm,
    CHW; outputs (bbox_preds (B,T,8) normalized quads, structure_probs
    (B,T,V)); character list from model metadata key 'character';
    merge_no_span_structure vocabulary semantics; SLANet-plus bbox
    rescale folds to quad * max(h, w). Same call contract as
    SLANetStructure: imgs -> [(structure_tokens, cell_bboxes_px)].
    """

    INPUT = 488
    TD_TOKENS = ("<td>", "<td", "<td></td>")

    def __init__(self, path: Path, *, device=None):
        self.fn = _load(path, _norm_imagenet_nchw, device)
        chars = read_onnx_metadata(path).get("character", "").splitlines()
        # merge_no_span_structure (reference post_process.py:15-19)
        if "<td></td>" not in chars:
            chars.append("<td></td>")
        if "<td>" in chars:
            chars.remove("<td>")
        self.tokens = ["sos"] + chars + ["eos"]
        self.sos_id = 0
        self.eos_id = len(self.tokens) - 1

    def _pre(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        ratio = self.INPUT / max(h, w)
        rw = max(1, int(w * ratio))
        rh = max(1, int(h * ratio))
        resized = resize_linear(img, rw, rh)
        # uint8 canvas; pad value normalizes to ~0 on the device (the
        # reference zero-pads the normalized canvas — rounding puts the
        # padded area within 0.01 of that, only outside the table pixels)
        pad = np.round(_IMAGENET_MEAN * 255.0).astype(np.uint8)
        canvas = np.empty((self.INPUT, self.INPUT, 3), np.uint8)
        canvas[:] = pad
        canvas[:rh, :rw] = resized
        return canvas.transpose(2, 0, 1)

    def __call__(
        self, imgs: list[np.ndarray], max_len: int | None = None
    ) -> list[tuple[list[str], list[list[float]]]]:
        if not imgs:
            return []
        n = len(imgs)
        batch = np.stack([self._pre(im) for im in imgs])
        pad = 1 << (n - 1).bit_length()  # pow2 batch buckets
        if pad != n:
            batch = np.concatenate(
                [batch, np.zeros((pad - n,) + batch.shape[1:], batch.dtype)]
            )
        outs = self.fn(batch)
        a, b = np.asarray(outs[0]), np.asarray(outs[1])
        bbox_preds, probs = (a, b) if a.shape[-1] == 8 else (b, a)
        results = []
        for i, img in enumerate(imgs):
            ids = probs[i].argmax(-1)
            h, w = img.shape[:2]
            scale = float(max(h, w))  # bbox_decode + slanet-plus rescale
            structure: list[str] = []
            bboxes: list[list[float]] = []
            for t, cid in enumerate(ids):
                cid = int(cid)
                if t > 0 and cid == self.eos_id:
                    break
                if cid in (self.sos_id, self.eos_id):
                    continue
                tok = self.tokens[cid]
                structure.append(tok)
                if tok in self.TD_TOKENS:
                    quad = bbox_preds[i, t].astype(np.float64)
                    xs = quad[0::2] * scale
                    ys = quad[1::2] * scale
                    if not (xs.any() or ys.any()):
                        continue  # blank placeholder bbox
                    bboxes.append(
                        [float(xs.min()), float(ys.min()),
                         float(xs.max()), float(ys.max())]
                    )
            results.append((structure, bboxes))
        return results
