"""Layout detection engine: preprocessing, session, postprocessing.

Port of ``rapiddoc_tpu/models/layout/engine.py``: ``DOCLAYOUT_V2_LABELS``,
``DEFAULT_ABANDON_LABELS``, ``V2_CATEGORY_MAP``, ``class_nms`` (:72),
``LayoutConfig`` (:96), ``mask_to_polygon`` (:111) and
``LayoutDetector`` (:144) with its ``build`` (:195). Pages are resized
to the model's square input with ``resize_cubic`` (cv2's INTER_CUBIC),
sent as 4-bit luma (two pixels a byte) and unpacked on the device, as
the JAX package's default nibble wire does, or as RGB uint8 under
``RAPIDDOC_LAYOUT_WIRE_BITS=8`` (its RGB wire). The
postprocess (per-class thresholds, NMS with separate same-class and
cross-class IoU, masks to polygons) is the JAX package's, with cv2's
contour functions replaced by ``utils/contours.py``.

A published ``.onnx`` layout checkpoint in the models dir comes first,
as in the JAX package: ``build`` returns an ``OnnxLayoutDetector``
(``onnx_engine.py``, the ONNX interpreter on the same device, in
float32) with the JAX package's thresholds.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from ...config import DEMO_ASSETS_DIR, get_models_dir
from ...engine.buckets import BucketSpec
from ...engine.session import TorchSession
from ...types import CategoryId
from ...utils import boxes as B
from ...utils import contours
from ...utils.logging import get_logger
from ..ocr.pre_post import pack_nibbles, resize_cubic, to_luma
from ..weights import load_flax_into, load_npz
from .rtdetr import RTDETR

logger = get_logger("rapiddoc_tpu_torch.layout")

# PP-DocLayoutV2/V3 label set (alphabetical — class-id order of the model)
DOCLAYOUT_V2_LABELS = [
    "abstract", "algorithm", "aside_text", "chart", "content",
    "display_formula", "doc_title", "figure_title", "footer", "footer_image",
    "footnote", "formula_number", "header", "header_image", "image",
    "inline_formula", "number", "paragraph_title", "reference",
    "reference_content", "seal", "table", "text", "vertical_text",
    "vision_footnote",
]

DEFAULT_ABANDON_LABELS = {
    "header", "footer", "number", "aside_text", "vision_footnote",
    "header_image", "footer_image", "footnote",
}

V2_CATEGORY_MAP = {
    "abstract": CategoryId.Text,
    "algorithm": CategoryId.Text,
    "aside_text": CategoryId.Text,
    "chart": CategoryId.ImageBody,
    "content": CategoryId.Text,
    "display_formula": CategoryId.InterlineEquation_YOLO,
    "doc_title": CategoryId.Title,
    "figure_title": CategoryId.Text,
    "footer": CategoryId.Text,
    "footer_image": CategoryId.ImageBody,
    "footnote": CategoryId.Text,
    "formula_number": CategoryId.InterlineEquationNumber_Layout,
    "header": CategoryId.Text,
    "header_image": CategoryId.ImageBody,
    "image": CategoryId.ImageBody,
    "inline_formula": CategoryId.InlineEquation,
    "number": CategoryId.Text,
    "paragraph_title": CategoryId.Title,
    "reference": CategoryId.Text,
    "reference_content": CategoryId.Text,
    "seal": CategoryId.ImageBody,
    "table": CategoryId.TableBody,
    "text": CategoryId.Text,
    "vertical_text": CategoryId.Text,
    "vision_footnote": CategoryId.Text,
}

def class_nms(
    boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
    iou_same: float = 0.6, iou_diff: float = 0.98,
) -> list[int]:
    """NMS with separate IoU thresholds for same-class and cross-class pairs
    (reference: pp_doclayout/post_process.py:948)."""
    order = np.argsort(-scores)
    keep: list[int] = []
    if len(boxes) == 0:
        return keep
    ious = B.iou_matrix(boxes, boxes)
    suppressed = np.zeros(len(boxes), dtype=bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        same = labels == labels[i]
        suppressed |= same & (ious[i] > iou_same)
        suppressed |= (~same) & (ious[i] > iou_diff)
        suppressed[i] = True
    return keep


@dataclass
class LayoutConfig:
    model_size: str = "B4"
    input_size: int = 800
    conf_threshold: float = 0.5
    num_queries: int = 300
    dec_layers: int = 6
    markdown_ignore_labels: frozenset = frozenset(DEFAULT_ABANDON_LABELS)
    # V3 irregular-region masks -> polygon_points on dets
    with_masks: bool = True
    # per-class confidence overrides; falls back to conf_threshold for
    # unlisted labels
    class_thresholds: dict | None = None


def mask_to_polygon(
    mask01: np.ndarray, src_w: float, src_h: float, max_points: int = 32
) -> list[list[float]] | None:
    """Binary instance mask (model grid) -> simplified polygon in source
    pixels. None when the mask is empty or effectively rectangular
    (callers keep the plain box then)."""
    m = (mask01 > 0.5).astype(np.uint8)
    if m.sum() < 4:
        return None
    found = contours.find_contours_external_simple(m)
    if not found:
        return None
    areas = [contours.contour_area(c) for c in found]
    contour = found[int(np.argmax(areas))]
    area = max(areas)
    if area < 4:
        return None
    eps = 0.01 * contours.arc_length(contour)
    poly = contours.approx_poly_dp(contour, eps).reshape(-1, 2)
    if len(poly) < 3:
        return None
    if len(poly) > max_points:
        step = len(poly) / max_points
        poly = poly[(np.arange(max_points) * step).astype(int)]
    # rectangular-enough masks carry no extra information over the bbox
    # (the area of a filled rect contour is (w-1)*(h-1))
    x, y, w, h = contours.bounding_rect(contour)
    if len(poly) <= 4 and area > 0.9 * (w - 1) * (h - 1):
        return None
    gh, gw = m.shape
    sx, sy = src_w / gw, src_h / gh
    return [[float(px * sx), float(py * sy)] for px, py in poly]


def _unpack_luma_nibbles(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W/2, 1) uint8 -> (N, H, W, 3) float32 in [0, 1] (x17/255)."""
    y = torch.stack([x >> 4, x & 15], dim=3)
    n, h, w2 = x.shape[:3]
    y = y.reshape(n, h, w2 * 2, 1) * 17
    return y.expand(-1, -1, -1, 3).float() / 255.0


def _rgb_unit(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> float32 in [0, 1]."""
    return x.float() / 255.0


class LayoutDetector:
    """Batched RT-DETR layout detection; output dets in image pixels."""

    demo_txt_fallback = False

    def __init__(self, model: RTDETR | None = None, config: LayoutConfig | None = None,
                 *, device=None, dtype: torch.dtype | None = None, seed: int = 0):
        """``model`` with its weights loaded, or None for a random init
        from ``seed`` (torch's default initialisers)."""
        # 4-bit luma wire by default; RAPIDDOC_LAYOUT_WIRE_BITS=8 ships
        # RGB uint8 (the JAX package's layout/engine.py:172-178)
        self.nibble_wire = os.environ.get("RAPIDDOC_LAYOUT_WIRE_BITS", "4") == "4"
        self.config = cfg = config or LayoutConfig()
        self.labels = DOCLAYOUT_V2_LABELS
        if model is None:
            torch.manual_seed(seed)
            model = self.make_model(cfg)
        spec = BucketSpec(heights=(cfg.input_size,), widths=(cfg.input_size,),
                          batch_sizes=(1, 2, 4, 8))
        self.session = TorchSession(
            lambda m, x: m(x), model, spec, name="layout", device=device, dtype=dtype,
            preproc=_unpack_luma_nibbles if self.nibble_wire else _rgb_unit,
        )

    @staticmethod
    def make_model(cfg: LayoutConfig) -> RTDETR:
        return RTDETR(
            num_classes=len(DOCLAYOUT_V2_LABELS), backbone_size=cfg.model_size,
            num_queries=cfg.num_queries, dec_layers=cfg.dec_layers,
            with_masks=cfg.with_masks,
        )

    @classmethod
    def build(cls, configs: dict, device=None, dtype: torch.dtype | None = None):
        """The JAX package's ``LayoutDetector.build``: a published ``.onnx``
        (``MODEL_SPECS``' stems, ``model_type``'s first) in the models dir,
        else a published ``layout_doclayout_v3.npz`` there, else the demo
        checkpoint when ``RAPIDDOC_DEMO_LAYOUT`` (or
        ``configs["demo_layout"]``) asks for it, else FileNotFoundError
        (the caller's structural fallback layout) unless
        ``allow_random_init``."""
        models_dir = get_models_dir()
        # published .onnx checkpoint -> the ONNX interpreter's detector
        from .onnx_engine import LOW_CONF_MODELS, MODEL_SPECS, OnnxLayoutConfig, OnnxLayoutDetector

        model_type = configs.get("model_type", "pp_doclayoutv3")
        # reference callers pass a ModelType enum; accept its .value
        model_type = getattr(model_type, "value", model_type)
        for stem in ([model_type] if model_type in MODEL_SPECS else []) + list(MODEL_SPECS):
            onnx_path = models_dir / f"{stem}.onnx"
            if onnx_path.is_file():
                logger.info("layout: published ONNX checkpoint %s", onnx_path)
                return OnnxLayoutDetector(onnx_path, OnnxLayoutConfig(
                    model_type=stem,
                    # S / docstructbench under-recall at 0.5; the reference
                    # auto-lowers (rapid_layout.py:30-35)
                    conf_threshold=configs.get(
                        "conf_thresh", 0.2 if stem in LOW_CONF_MODELS else 0.5),
                    class_thresholds=configs.get("class_thresholds"),
                    markdown_ignore_labels=frozenset(
                        configs.get("markdown_ignore_labels", DEFAULT_ABANDON_LABELS)),
                ), device=device)
        flat = None
        published = models_dir / "layout_doclayout_v3.npz"
        if published.is_file():
            flat = load_npz(published)
        demo_used = False
        if flat is None:
            demo_on = configs.get(
                "demo_layout",
                os.environ.get("RAPIDDOC_DEMO_LAYOUT", "").lower() in ("1", "true", "yes"),
            )
            demo_npz = DEMO_ASSETS_DIR / "layout_demo.npz"
            demo_cfg = demo_npz.with_suffix(".json")
            if demo_on and demo_cfg.is_file() and demo_npz.is_file():
                flat = load_npz(demo_npz)
                logger.info("layout: demo synthetic-trained checkpoint")
                configs = {**json.loads(demo_cfg.read_text()), **configs}
                demo_used = True
        if flat is None and not configs.get("allow_random_init", False):
            # without trained weights a random detector is worse than the
            # structural fallback (native text / OCR det drive the layout)
            raise FileNotFoundError("layout checkpoint missing")
        cfg = LayoutConfig(
            model_size=configs.get("model_size", "B4"),
            input_size=configs.get("input_size", 800),
            num_queries=configs.get("num_queries", 300),
            dec_layers=configs.get("dec_layers", 6),
            conf_threshold=configs.get("conf_threshold", 0.5),
            class_thresholds=configs.get("class_thresholds"),
            with_masks=configs.get("with_masks", True),
        )
        if configs.get("markdown_ignore_labels") is not None:
            cfg = dataclasses.replace(
                cfg, markdown_ignore_labels=frozenset(configs["markdown_ignore_labels"]))
        model = load_flax_into(cls.make_model(cfg), flat) if flat is not None else None
        det = cls(model, config=cfg, device=device, dtype=dtype)
        if demo_used:
            # the scheduler routes txt-mode pages to the structural
            # fallback (native text beats a synthetic-trained detector)
            det.demo_txt_fallback = True
        return det

    def preprocess(self, images: list[np.ndarray]) -> np.ndarray:
        """The uint8 batch the session ships: each page resized to the
        square input with INTER_CUBIC, as 4-bit luma pairs (6x fewer
        bytes than RGB) or, on the 8-bit wire, as RGB."""
        size = self.config.input_size
        resized = [resize_cubic(img, size, size) for img in images]
        if self.nibble_wire:
            resized = [pack_nibbles(to_luma(r)) for r in resized]
        return np.stack(resized)

    def batch_predict(self, images: list[np.ndarray]) -> list[list[dict]]:
        """images: uint8 RGB arrays. Returns per-image layout_dets
        ({category_id, poly, score, original_label, original_order})."""
        if not images:
            return []
        outs = self.session(self.preprocess(images))
        results = []
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            masks = None
            if "masks_bits" in outs:
                # unpack the device bitmask (Nq, H/8, ceil(W/8)*8 bits);
                # the grid is square, so the true W is the grid's H
                bits = outs["masks_bits"][i]
                masks = np.unpackbits(bits, axis=-1)[..., : bits.shape[1]]
            results.append(self._postprocess(
                outs["scores"][i], outs["labels"][i], outs["boxes"][i], w, h, masks=masks))
        return results

    def _postprocess(self, scores, labels, boxes_cxcywh, src_w, src_h,
                     masks=None) -> list[dict]:
        cfg = self.config
        if cfg.class_thresholds:
            thresh = np.array([
                cfg.class_thresholds.get(self.labels[int(lab)], cfg.conf_threshold)
                for lab in labels
            ])
            keep_mask = scores > thresh
        else:
            keep_mask = scores > cfg.conf_threshold
        if not keep_mask.any():
            return []
        scores = scores[keep_mask]
        labels = labels[keep_mask]
        b = boxes_cxcywh[keep_mask]
        if masks is not None:
            masks = np.asarray(masks)[keep_mask]
        xyxy = np.stack([
            (b[:, 0] - b[:, 2] / 2) * src_w,
            (b[:, 1] - b[:, 3] / 2) * src_h,
            (b[:, 0] + b[:, 2] / 2) * src_w,
            (b[:, 1] + b[:, 3] / 2) * src_h,
        ], axis=1)
        xyxy[:, 0::2] = np.clip(xyxy[:, 0::2], 0, src_w)
        xyxy[:, 1::2] = np.clip(xyxy[:, 1::2], 0, src_h)
        dets = []
        for i in class_nms(xyxy, scores, labels):
            label = self.labels[int(labels[i])]
            cat = V2_CATEGORY_MAP.get(label, CategoryId.Text)
            if label in cfg.markdown_ignore_labels:
                cat = CategoryId.Abandon
            x0, y0, x1, y1 = xyxy[i]
            det = {
                "category_id": cat,
                "poly": [x0, y0, x1, y0, x1, y1, x0, y1],
                "score": float(scores[i]),
                "original_label": label,
                # RT-DETR query order after NMS is not a reading order;
                # -1 makes page_build fall back to xycut
                "original_order": -1,
            }
            if masks is not None:
                poly_pts = mask_to_polygon((masks[i] > 0).astype(np.float32), src_w, src_h)
                if poly_pts is not None:
                    det["polygon_points"] = poly_pts
            dets.append(det)
        return dets
