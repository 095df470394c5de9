"""OCR engine: detector + recognizer over TorchSessions.

Port of ``rapiddoc_tpu/models/ocr/engine.py``: batched, bucket-grouped
det and width-sorted rec, with all geometry on the host. The wires are
the JAX package's, with its environment knobs: det and rec ship 4-bit
luma by default (``RAPIDDOC_DET_WIRE_BITS=8`` / ``RAPIDDOC_REC_WIRE_BITS=8``
full-depth luma, ``RAPIDDOC_RGB_TRANSFER=1`` full-depth RGB); det reads
back a bit-packed threshold map and a 2x-pooled prob map in 4 bits
(``RAPIDDOC_DET_PROB_BITS=8``: 8 bits); rec returns per-frame (ids,
probs) from the fused CTC head. ``TextSystem(..., return_word_boxes=True)``
adds each line's word polygons; ``TextDetector.detect_polys`` gives the
curved-text polygons seal OCR straightens.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ...engine.buckets import DET_BUCKETS, REC_BUCKETS, group_by_bucket, pad_image_to
from ...engine.session import TorchSession
from .det import DBNet
from .pre_post import (
    CTCLabelDecoder,
    DBPostParams,
    contrast_stretch as pp_contrast_stretch,
    db_postprocess,
    db_postprocess_poly,
    det_normalize_device,
    det_normalize_device_nibble,
    det_resize,
    map_crop_box_to_quad,
    pack_nibbles,
    perspective_transform,
    rec_normalize_device,
    rec_normalize_device_nibble,
    rec_resize,
    rec_width_bucket,
    split_words,
    to_luma,
    warp_perspective,
    word_boxes_in_crop,
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
    # optional word-level results: (word, score, [x0,y0,x1,y1] in crop px)
    words: list[tuple[str, float, list[float]]] | None = None


def det_wire(prob: torch.Tensor, thresh: float, prob4: bool = True) -> dict[str, torch.Tensor]:
    """(B, H, W) prob map -> the det readback: the full-res threshold
    bitmap packed 8 pixels a byte, and the 2x-pooled map in 4 bits (two
    a byte) or, without ``prob4``, in 8 bits."""
    b, h, w = prob.shape
    bits = (prob > thresh).to(torch.uint8).reshape(b, h, w // 8, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=prob.device)
    packed = (bits * weights).sum(-1, dtype=torch.uint8)
    pooled = prob.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    if not prob4:
        return {"bits": packed, "prob8": torch.round(pooled * 255.0).to(torch.uint8)}
    q = torch.round(pooled * 15.0).to(torch.uint8)
    return {"bits": packed, "prob4": (q[..., 0::2] << 4) | q[..., 1::2]}


class TextDetector:
    """DBNet over DET_BUCKETS. Pages are resized so that their long side
    (``limit_type="max"``) is at most, or their short side (``"min"``) at
    least, ``limit_side_len``; ``contrast_stretch`` applies the
    percentile stretch the demo checkpoint was trained for. The wire
    knobs are read from the environment, as the JAX package reads them."""

    def __init__(self, model: DBNet, *, device=None, dtype: torch.dtype | None = None,
                 limit_side_len: int = 960, limit_type: str = "max",
                 contrast_stretch: bool = False):
        self.post_params = DBPostParams()
        self.limit_side_len = limit_side_len
        self.limit_type = limit_type
        self.contrast_stretch = contrast_stretch
        # 1 byte/px luma unless RAPIDDOC_RGB_TRANSFER is set; 4-bit luma
        # unless RAPIDDOC_DET_WIRE_BITS says otherwise
        self.gray_transfer = not os.environ.get("RAPIDDOC_RGB_TRANSFER")
        self.nibble_wire = (
            self.gray_transfer and os.environ.get("RAPIDDOC_DET_WIRE_BITS", "4") == "4"
        )
        self.prob4_wire = os.environ.get("RAPIDDOC_DET_PROB_BITS", "4") == "4"
        thresh = self.post_params.thresh
        prob4 = self.prob4_wire

        def det_apply(m, x):
            prob = torch.clamp(m(x)[..., 0].float(), 0.0, 1.0)
            return det_wire(prob, thresh, prob4)

        self.session = TorchSession(
            det_apply, model, DET_BUCKETS, name="ocr_det", device=device, dtype=dtype,
            preproc=det_normalize_device_nibble if self.nibble_wire else det_normalize_device,
        )

    def __call__(self, images: Sequence[np.ndarray]) -> list[DetResult]:
        """images: uint8 RGB HWC arrays of any sizes. Boxes much taller
        than the page's line height are re-detected at crop resolution
        and replaced by their sub-lines (``_refine_merged``)."""
        return self._refine_merged(images, self._detect(images))

    def detect_polys(self, images: Sequence[np.ndarray], params=None,
                     n_points: int = 8) -> list[list[np.ndarray]]:
        """Curved-text detection: per image, a list of 2k-point polygons
        (top edge left to right, then bottom edge right to left) in source
        pixels, from ``db_postprocess_poly``. Pass the seal params
        (``models/ocr/seal.SEAL_DET_PARAMS``) for stamp crops."""
        results: list[list[np.ndarray]] = [[] for _ in images]
        for i, prob, (src_h, src_w, rh, rw) in self._prob_maps(images):
            results[i], _ = db_postprocess_poly(
                prob, src_h, src_w, valid_h=rh, valid_w=rw,
                params=params or self.post_params, n_points=n_points,
            )
        return results

    def _detect(self, images: Sequence[np.ndarray]) -> list[DetResult]:
        results: list[DetResult | None] = [None] * len(images)
        for i, prob, (src_h, src_w, rh, rw) in self._prob_maps(images):
            boxes, scores = db_postprocess(
                prob, src_h, src_w, valid_h=rh, valid_w=rw, params=self.post_params,
            )
            results[i] = DetResult(boxes, scores)
        return results  # type: ignore[return-value]

    def _prob_maps(self, images: Sequence[np.ndarray]):
        """Yield (index, prob map at network scale, (src_h, src_w, rh,
        rw)) for each image: resized, grouped by bucket, every group
        dispatched before any is fetched."""
        prepped = []
        metas = []
        for img in images:
            resized, _, _ = det_resize(img, self.limit_side_len, self.limit_type)
            metas.append((img.shape[0], img.shape[1], resized.shape[0], resized.shape[1]))
            if self.contrast_stretch:
                resized = pp_contrast_stretch(resized)
            if self.gray_transfer:
                resized = to_luma(resized)
            prepped.append(resized)  # uint8; normalize happens on device
        spec = self.session.bucket_spec
        groups = group_by_bucket([(m[2], m[3]) for m in metas], spec)
        max_b = spec.max_batch()
        pending = []
        for (bh, bw), idxs in groups.items():
            batch = [pad_image_to(prepped[i], bh, bw) for i in idxs]
            if self.nibble_wire:
                batch = [pack_nibbles(b) for b in batch]
            handles = [
                self.session.dispatch(np.stack(batch[j : j + max_b]))
                for j in range(0, len(batch), max_b)
            ]
            pending.append((idxs, handles))
        for idxs, handles in pending:
            for i, out in zip(idxs, self.session.fetch_rows(handles)):
                yield i, self._reconstruct_prob(out), metas[i]

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
        reproduces the exact full-res thresholding; the 2x map (4 or 8
        bits) supplies the values box scoring averages over, up-scaled
        as cv2's INTER_NEAREST does an exact 2x (each value repeated)."""
        bits = out["bits"]
        h, w8 = bits.shape
        bitmap = np.unpackbits(bits, axis=1, count=w8 * 8).astype(bool)
        if "prob4" in out:
            p4 = out["prob4"]
            prob8 = np.empty((p4.shape[0], p4.shape[1] * 2), np.float32)
            prob8[:, 0::2] = (p4 >> 4).astype(np.float32) / 15.0
            prob8[:, 1::2] = (p4 & 15).astype(np.float32) / 15.0
        else:
            prob8 = out["prob8"].astype(np.float32) / 255.0
        prob = prob8.repeat(2, axis=0).repeat(2, axis=1)[:h, : w8 * 8]
        t = self.post_params.thresh
        # force host thresholding to agree with the device bitmap
        return np.where(
            bitmap, np.maximum(prob, t + 1e-3), np.minimum(prob, t - 1e-3)
        )


class TextRecognizer:
    """SVTRRec over REC_BUCKETS with the fused CTC head at any vocabulary
    width, decoding through ``charset`` (the dictionary's entries; the
    decoder adds blank and space); ``contrast_stretch`` as in
    TextDetector, the wire knobs
    (``RAPIDDOC_RGB_TRANSFER``, ``RAPIDDOC_REC_WIRE_BITS``) read from the
    environment."""

    def __init__(self, model: SVTRRec, charset: list[str], *,
                 device=None, dtype: torch.dtype | None = None,
                 contrast_stretch: bool = False):
        self.decoder = CTCLabelDecoder(charset)
        self.contrast_stretch = contrast_stretch
        self.gray_transfer = not os.environ.get("RAPIDDOC_RGB_TRANSFER")
        self.nibble_wire = (
            self.gray_transfer and os.environ.get("RAPIDDOC_REC_WIRE_BITS", "4") == "4"
        )
        self.session = TorchSession(
            lambda m, x: m(x), model, REC_BUCKETS, name="ocr_rec", device=device, dtype=dtype,
            preproc=rec_normalize_device_nibble if self.nibble_wire else rec_normalize_device,
        )

    def __call__(self, crops: Sequence[np.ndarray], return_words: bool = False
                 ) -> list[RecResult]:
        """crops: uint8 RGB text-line images. With ``return_words``, each
        result carries (word, score, bbox-in-crop) tuples."""
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
                rec_resize(pp_contrast_stretch(crops[i]) if self.contrast_stretch else crops[i], wb)
                for i in idxs
            ]
            if self.gray_transfer:
                batch = [to_luma(b) for b in batch]
            if self.nibble_wire:
                batch = [pack_nibbles(b) for b in batch]
            handles = [
                self.session.dispatch(np.stack(batch[j : j + max_b]))
                for j in range(0, len(batch), max_b)
            ]
            pending.append((wb, idxs, handles))
        for wb, idxs, handles in pending:
            for i, (ids, probs) in zip(idxs, self.session.fetch_rows(handles)):
                ch, cw = crops[i].shape[:2]
                valid_t = max(1, int(math.ceil(min(wb, cw * 48 / max(ch, 1)) / 8)))
                if not return_words:
                    results[i] = RecResult(*self.decoder(ids, probs, valid_t=valid_t))
                    continue
                text, score, frames = self.decoder.decode_with_positions(
                    ids, probs, valid_t=valid_t
                )
                words = split_words(text, frames)
                boxes = word_boxes_in_crop(words, valid_t, cw, ch)
                results[i] = RecResult(
                    text, score, [(w[0], score, box) for w, box in zip(words, boxes)]
                )
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

    def __call__(self, images: Sequence[np.ndarray], return_word_boxes: bool = False
                 ) -> list[list[dict]]:
        """Per image, its lines: box, det_score, text, score and, with
        ``return_word_boxes``, each word's polygon in image pixels (a line
        whose crop was turned upright takes the line quad)."""
        det_results = self.detector(images)
        all_crops: list[np.ndarray] = []
        owners: list[tuple[int, int]] = []
        for img_idx, det in enumerate(det_results):
            for box_idx, quad in enumerate(det.boxes):
                all_crops.append(crop_quad(images[img_idx], quad))
                owners.append((img_idx, box_idx))
        rec_results = self.recognizer(all_crops, return_words=return_word_boxes)
        out: list[list[dict]] = [[] for _ in images]
        for crop, (img_idx, box_idx), rec in zip(all_crops, owners, rec_results):
            if rec.score < self.drop_score:
                continue
            det = det_results[img_idx]
            item = {
                "box": det.boxes[box_idx].tolist(),
                "det_score": float(det.scores[box_idx]),
                "text": rec.text,
                "score": rec.score,
            }
            if return_word_boxes and rec.words:
                item["words"] = _word_polys(det.boxes[box_idx], crop, rec.words)
            out[img_idx].append(item)
        return out


def _word_polys(quad: np.ndarray, crop: np.ndarray, words: list) -> list[dict]:
    """Each word's crop box mapped back onto the line's quad. A vertical
    line's crop was turned by rot90 in crop_quad, where the homography no
    longer applies: its words take the whole line quad."""
    quad = quad.astype(np.float32)
    ch, cw = crop.shape[:2]
    qw = max(np.linalg.norm(quad[0] - quad[1]), np.linalg.norm(quad[2] - quad[3]))
    qh = max(np.linalg.norm(quad[0] - quad[3]), np.linalg.norm(quad[1] - quad[2]))
    rotated = qh > qw * 1.5
    out = []
    for word, score, box in words:
        poly = quad.astype(np.float64) if rotated else map_crop_box_to_quad(box, cw, ch, quad)
        out.append({"word": word, "score": score, "poly": np.asarray(poly).tolist()})
    return out
