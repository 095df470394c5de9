"""OCR engine: detector + recognizer over TorchSessions.

Port of ``rapiddoc_tpu/models/ocr/engine.py``: batched, bucket-grouped
det and width-sorted rec, with all geometry on the host. The device
output of det is the JAX package's wire format (a bit-packed threshold
map and a 4-bit 2x-pooled prob map); rec ships 4-bit luma and returns
per-frame (ids, probs) from the fused CTC head.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ...engine.buckets import DET_BUCKETS, REC_BUCKETS, group_by_bucket, pad_image_to
from ...engine.session import TorchSession
from ...utils.unported import check_knob
from .det import DBNet
from .pre_post import (
    CTCLabelDecoder,
    DBPostParams,
    contrast_stretch as pp_contrast_stretch,
    db_postprocess,
    det_normalize_device_nibble,
    det_resize,
    pack_nibbles,
    perspective_transform,
    rec_normalize_device_nibble,
    rec_resize,
    rec_width_bucket,
    to_luma,
    warp_perspective,
)
from .rec import SVTRRec

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


@dataclass
class DetResult:
    boxes: np.ndarray  # (N, 4, 2) quads in source pixels
    scores: np.ndarray


@dataclass
class RecResult:
    text: str
    score: float


def det_wire(prob: torch.Tensor, thresh: float) -> dict[str, torch.Tensor]:
    """(B, H, W) prob map -> the det readback: the full-res threshold
    bitmap packed 8 pixels a byte, and the 2x-pooled map in 4 bits."""
    b, h, w = prob.shape
    bits = (prob > thresh).to(torch.uint8).reshape(b, h, w // 8, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=prob.device)
    packed = (bits * weights).sum(-1, dtype=torch.uint8)
    pooled = prob.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    q = torch.round(pooled * 15.0).to(torch.uint8)
    return {"bits": packed, "prob4": (q[..., 0::2] << 4) | q[..., 1::2]}


class TextDetector:
    """DBNet over DET_BUCKETS, pages limited to 960 px on the long side.
    Pages get the percentile contrast stretch the demo checkpoint was
    trained for."""

    limit_side_len = 960

    def __init__(self, model: DBNet, *, device=None, dtype: torch.dtype | None = None):
        # the JAX package's wire knobs (ocr/engine.py:106-116); the port
        # runs the default 4-bit luma wire and 4-bit prob map only
        check_knob("RAPIDDOC_RGB_TRANSFER", "the RGB det and rec wire", "ocr_family")
        check_knob("RAPIDDOC_DET_WIRE_BITS", "the 8-bit det wire", "ocr_family", "4")
        check_knob("RAPIDDOC_DET_PROB_BITS", "the 8-bit det prob map", "ocr_family", "4")
        self.post_params = DBPostParams()
        thresh = self.post_params.thresh

        def det_apply(m, x):
            prob = torch.clamp(m(x)[..., 0].float(), 0.0, 1.0)
            return det_wire(prob, thresh)

        self.session = TorchSession(
            det_apply, model, DET_BUCKETS, name="ocr_det", device=device,
            dtype=dtype, preproc=det_normalize_device_nibble,
        )

    def __call__(self, images: Sequence[np.ndarray]) -> list[DetResult]:
        """images: uint8 RGB HWC arrays of any sizes. Boxes much taller
        than the page's line height are re-detected at crop resolution
        and replaced by their sub-lines (``_refine_merged``)."""
        return self._refine_merged(images, self._detect(images))

    def _detect(self, images: Sequence[np.ndarray]) -> list[DetResult]:
        prepped = []
        metas = []
        for img in images:
            resized, _, _ = det_resize(img, self.limit_side_len)
            metas.append((img.shape[0], img.shape[1], resized.shape[0], resized.shape[1]))
            prepped.append(to_luma(pp_contrast_stretch(resized)))  # normalize on device
        spec = self.session.bucket_spec
        groups = group_by_bucket([(m[2], m[3]) for m in metas], spec)
        results: list[DetResult | None] = [None] * len(images)
        max_b = spec.max_batch()
        pending = []
        for (bh, bw), idxs in groups.items():
            batch = [pack_nibbles(pad_image_to(prepped[i], bh, bw)) for i in idxs]
            handles = [
                self.session.dispatch(np.stack(batch[j : j + max_b]))
                for j in range(0, len(batch), max_b)
            ]
            pending.append((idxs, handles))
        for idxs, handles in pending:
            for i, out in zip(idxs, self.session.fetch_rows(handles)):
                src_h, src_w, rh, rw = metas[i]
                boxes, scores = db_postprocess(
                    self._reconstruct_prob(out), src_h, src_w,
                    valid_h=rh, valid_w=rw, params=self.post_params,
                )
                results[i] = DetResult(boxes, scores)
        return results  # type: ignore[return-value]

    def _refine_merged(
        self, images: Sequence[np.ndarray], results: list[DetResult]
    ) -> list[DetResult]:
        """Split multi-line det blobs via a second det pass on the crops."""
        jobs: list[tuple[int, int, int, int]] = []  # (img_i, box_j, x0, y0)
        crops: list[np.ndarray] = []
        for i, (img, res) in enumerate(zip(images, results)):
            if not len(res.boxes):
                continue
            heights = [
                float(q[:, 1].max() - q[:, 1].min()) for q in res.boxes
            ]
            small = [h for h in heights if h <= 80]
            med = float(np.median(small)) if small else 32.0
            limit = max(80.0, 2.5 * med)
            ih, iw = img.shape[:2]
            for j, (q, h) in enumerate(zip(res.boxes, heights)):
                w = float(q[:, 0].max() - q[:, 0].min())
                if h > limit and w >= 2.0 * med:
                    x0 = max(int(q[:, 0].min()) - 2, 0)
                    y0 = max(int(q[:, 1].min()) - 2, 0)
                    x1 = min(int(q[:, 0].max()) + 2, iw)
                    y1 = min(int(q[:, 1].max()) + 2, ih)
                    if y1 - y0 < 16 or x1 - x0 < 16:
                        continue
                    jobs.append((i, j, x0, y0))
                    crops.append(img[y0:y1, x0:x1])
        if not jobs:
            return results
        sub_results = self._detect(crops)
        drop: dict[int, set[int]] = {}
        extra: dict[int, tuple[list, list]] = {}
        for (img_i, box_j, x0, y0), sub in zip(jobs, sub_results):
            if len(sub.boxes) <= 1:
                continue  # genuinely one line (e.g. a display heading)
            drop.setdefault(img_i, set()).add(box_j)
            eb, es = extra.setdefault(img_i, ([], []))
            for q, s in zip(sub.boxes, sub.scores):
                eb.append(q + np.asarray([x0, y0], q.dtype))
                es.append(s)
        for img_i, kill in drop.items():
            res = results[img_i]
            boxes = [q for j, q in enumerate(res.boxes) if j not in kill]
            scores = [s for j, s in enumerate(res.scores) if j not in kill]
            eb, es = extra[img_i]
            results[img_i] = DetResult(
                np.stack(boxes + eb).astype(np.float32),
                np.asarray(list(scores) + es, dtype=np.float32),
            )
        return results

    def _reconstruct_prob(self, out: dict[str, np.ndarray]) -> np.ndarray:
        """Rebuild a prob map from the packed device output: the bitmap
        reproduces the exact full-res thresholding; the 2x 4-bit map
        (nearest-neighbour upsampled) supplies the values box scoring
        averages over."""
        bits = out["bits"]
        h, w8 = bits.shape
        bitmap = np.unpackbits(bits, axis=1, count=w8 * 8).astype(bool)
        p4 = out["prob4"]
        prob8 = np.empty((p4.shape[0], p4.shape[1] * 2), np.float32)
        prob8[:, 0::2] = (p4 >> 4).astype(np.float32) / 15.0
        prob8[:, 1::2] = (p4 & 15).astype(np.float32) / 15.0
        prob = prob8.repeat(2, axis=0).repeat(2, axis=1)[:h, : w8 * 8]
        t = self.post_params.thresh
        # force host thresholding to agree with the device bitmap
        return np.where(
            bitmap, np.maximum(prob, t + 1e-3), np.minimum(prob, t - 1e-3)
        )


class TextRecognizer:
    """SVTRRec over REC_BUCKETS with the fused CTC head; crops get the
    demo checkpoint's contrast stretch."""

    def __init__(self, model: SVTRRec, decoder: CTCLabelDecoder, *,
                 device=None, dtype: torch.dtype | None = None):
        # the JAX package's wire knobs (ocr/engine.py:390-398)
        check_knob("RAPIDDOC_RGB_TRANSFER", "the RGB det and rec wire", "ocr_family")
        check_knob("RAPIDDOC_REC_WIRE_BITS", "the 8-bit rec wire", "ocr_family", "4")
        self.decoder = decoder
        self.session = TorchSession(
            lambda m, x: m(x), model, REC_BUCKETS, name="ocr_rec",
            device=device, dtype=dtype, preproc=rec_normalize_device_nibble,
        )

    def __call__(self, crops: Sequence[np.ndarray]) -> list[RecResult]:
        """crops: uint8 RGB text-line images."""
        if not len(crops):
            return []
        spec = self.session.bucket_spec
        groups: dict[int, list[int]] = {}
        for i, c in enumerate(crops):
            wb = rec_width_bucket(c.shape[1], c.shape[0], spec.widths)
            groups.setdefault(wb, []).append(i)
        results: list[RecResult | None] = [None] * len(crops)
        max_b = spec.max_batch()
        pending = []
        for wb, idxs in groups.items():
            # sort by true aspect so padded tails cluster
            idxs = sorted(idxs, key=lambda i: crops[i].shape[1] / max(crops[i].shape[0], 1))
            batch = [
                pack_nibbles(to_luma(rec_resize(pp_contrast_stretch(crops[i]), wb)))
                for i in idxs
            ]
            handles = [
                self.session.dispatch(np.stack(batch[j : j + max_b]))
                for j in range(0, len(batch), max_b)
            ]
            pending.append((wb, idxs, handles))
        for wb, idxs, handles in pending:
            for i, (ids, probs) in zip(idxs, self.session.fetch_rows(handles)):
                ch, cw = crops[i].shape[:2]
                valid_t = max(1, int(math.ceil(min(wb, cw * 48 / max(ch, 1)) / 8)))
                results[i] = RecResult(*self.decoder(ids, probs, valid_t=valid_t))
        return results  # type: ignore[return-value]


def crop_quad(img: np.ndarray, quad: np.ndarray) -> np.ndarray:
    """Perspective-crop a detected quad into an upright text-line image."""
    quad = quad.astype(np.float32)
    w = int(max(np.linalg.norm(quad[0] - quad[1]), np.linalg.norm(quad[2] - quad[3])))
    h = int(max(np.linalg.norm(quad[0] - quad[3]), np.linalg.norm(quad[1] - quad[2])))
    w, h = max(w, 1), max(h, 1)
    # axis-aligned quads crop with a plain slice copy
    xs, ys = quad[:, 0], quad[:, 1]
    if (
        abs(ys[0] - ys[1]) <= 1.0 and abs(ys[2] - ys[3]) <= 1.0
        and abs(xs[0] - xs[3]) <= 1.0 and abs(xs[1] - xs[2]) <= 1.0
    ):
        x0 = max(int(round(xs.min())), 0)
        y0 = max(int(round(ys.min())), 0)
        out = np.ascontiguousarray(img[y0 : y0 + h, x0 : x0 + w])
        if out.shape[0] >= 1 and out.shape[1] >= 1:
            if out.shape[0] > out.shape[1] * 1.5:  # vertical text
                out = np.rot90(out, 3)
            return out
    dst = np.array([[0, 0], [w, 0], [w, h], [0, h]], dtype=np.float32)
    out = warp_perspective(img, perspective_transform(quad, dst), w, h)
    if h > w * 1.5:  # vertical text: rotate to horizontal
        out = np.rot90(out, 3)
    return out


class TextSystem:
    """det + rec pipeline over full images."""

    def __init__(self, detector: TextDetector, recognizer: TextRecognizer,
                 drop_score: float = 0.5):
        self.detector = detector
        self.recognizer = recognizer
        self.drop_score = drop_score

    def __call__(self, images: Sequence[np.ndarray]) -> list[list[dict]]:
        det_results = self.detector(images)
        all_crops: list[np.ndarray] = []
        owners: list[tuple[int, int]] = []
        for img_idx, det in enumerate(det_results):
            for box_idx, quad in enumerate(det.boxes):
                all_crops.append(crop_quad(images[img_idx], quad))
                owners.append((img_idx, box_idx))
        rec_results = self.recognizer(all_crops)
        out: list[list[dict]] = [[] for _ in images]
        for (img_idx, box_idx), rec in zip(owners, rec_results):
            if rec.score < self.drop_score:
                continue
            det = det_results[img_idx]
            out[img_idx].append({
                "box": det.boxes[box_idx].tolist(),
                "det_score": float(det.scores[box_idx]),
                "text": rec.text,
                "score": rec.score,
            })
        return out
