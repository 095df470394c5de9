"""Layout detection from published PP-DocLayout ONNX checkpoints.

Port of ``rapiddoc_tpu/models/layout/onnx_engine.py``: the label sets and
CategoryId maps per model type, ``MODEL_SPECS``, ``LOW_CONF_MODELS``,
``OnnxLayoutConfig``, ``OnnxLayoutDetector`` and ``check_inline_formula``.
The published .onnx graphs (PP-DocLayout S/M/L, plus-L, V2, V3, and
DocLayout-YOLO docstructbench) run through the port's ONNX interpreter
(``engine/onnx_torch.py``) on ``device``, in float32, with the reference
handler's IO contract (reference: model_handler/pp_doclayout/main.py:17-80
— fixed-size resize, /255 (+ImageNet mean/std for S/M), inputs
image/scale_factor/im_shape; output [boxes(N,6), box_nums(B), masks?],
boxes already rescaled to source pixels and, for V2/V3, emitted in the
model's reading order). Pages are resized on the host with
``resize_cubic`` (cv2's INTER_CUBIC) and shipped as uint8; the
normalisation runs on the device as the function's ``preproc``. The
YOLO export's letterbox resizes with ``resize_linear`` (INTER_LINEAR).
Post: per-class thresholds, same/diff-class NMS, mask->polygon (shared
with the detector in ``engine.py``).

Label sets and CategoryId maps per model type mirror reference
rapid_doc/model/layout/rapid_layout.py:131-227.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ...engine.onnx_torch import OnnxTorchFunction
from ...types import CategoryId
from ...utils import boxes as B
from ..ocr.pre_post import resize_cubic, resize_linear
from .engine import DEFAULT_ABANDON_LABELS, class_nms, mask_to_polygon

# class-id -> label per model family (class ids are alphabetical label
# order in the PaddleX exports; V2/V3 set verified against the reference
# engine.py list)
PP_DOCLAYOUT_LABELS = [  # S / M / L (23 classes)
    "abstract", "algorithm", "aside_text", "chart", "chart_title",
    "content", "doc_title", "figure_title", "footer", "footer_image",
    "footnote", "formula", "formula_number", "header", "header_image",
    "image", "number", "paragraph_title", "reference", "seal", "table",
    "table_title", "text",
]
PP_DOCLAYOUT_PLUS_LABELS = [  # plus-L (20 classes)
    "abstract", "algorithm", "aside_text", "chart", "content", "doc_title",
    "figure_title", "footer", "footnote", "formula", "formula_number",
    "header", "image", "number", "paragraph_title", "reference",
    "reference_content", "seal", "table", "text",
]
PP_DOCLAYOUT_V2_LABELS = [  # V2 / V3 (25 classes)
    "abstract", "algorithm", "aside_text", "chart", "content",
    "display_formula", "doc_title", "figure_title", "footer",
    "footer_image", "footnote", "formula_number", "header", "header_image",
    "image", "inline_formula", "number", "paragraph_title", "reference",
    "reference_content", "seal", "table", "text", "vertical_text",
    "vision_footnote",
]

# label -> CategoryId (reference rapid_layout.py get_cls_dicts)
_COMMON = {
    "paragraph_title": CategoryId.Title, "image": CategoryId.ImageBody,
    "text": CategoryId.Text, "number": CategoryId.Text,
    "abstract": CategoryId.Text, "content": CategoryId.Text,
    "figure_title": CategoryId.Text, "table": CategoryId.TableBody,
    "reference": CategoryId.Text, "doc_title": CategoryId.Title,
    "footnote": CategoryId.Text, "header": CategoryId.Text,
    "algorithm": CategoryId.Text, "footer": CategoryId.Text,
    "seal": CategoryId.ImageBody, "chart": CategoryId.ImageBody,
    "formula_number": CategoryId.InterlineEquationNumber_Layout,
    "aside_text": CategoryId.Text,
}
CLS_DICT_SML = {
    **_COMMON,
    "formula": CategoryId.InterlineEquation_YOLO,
    "table_title": CategoryId.TableCaption,
    "chart_title": CategoryId.ImageCaption,
    "header_image": CategoryId.ImageBody,
    "footer_image": CategoryId.ImageBody,
}
CLS_DICT_PLUS = {
    **_COMMON,
    "formula": CategoryId.InterlineEquation_YOLO,
    "reference_content": CategoryId.Text,
}
CLS_DICT_V2 = {
    **_COMMON,
    "display_formula": CategoryId.InterlineEquation_YOLO,
    "inline_formula": CategoryId.InlineEquation,
    "header_image": CategoryId.ImageBody,
    "footer_image": CategoryId.ImageBody,
    "reference_content": CategoryId.Text,
    "vertical_text": CategoryId.Text,
    "vision_footnote": CategoryId.Text,
}

# DocLayout-YOLO docstructbench (reference rapid_layout.py:48-50): class
# id doubles as the pipeline CategoryId, except isolate_formula -> 14
DOCLAYOUT_YOLO_LABELS = [
    "title", "plain text", "abandon", "figure", "figure_caption",
    "table", "table_caption", "table_footnote", "isolate_formula",
    "formula_caption", "10", "11", "12", "inline_formula",
    "isolated_formula", "ocr_text",
]
CLS_DICT_YOLO = {
    lab: (CategoryId.InterlineEquation_YOLO if lab == "isolate_formula"
          else i)
    for i, lab in enumerate(DOCLAYOUT_YOLO_LABELS)
}

MODEL_SPECS = {
    # file stem -> (labels, cls_dict, input hw, imagenet_norm, native_order)
    "pp_doclayout_s": (PP_DOCLAYOUT_LABELS, CLS_DICT_SML, 480, True, False),
    "pp_doclayout_m": (PP_DOCLAYOUT_LABELS, CLS_DICT_SML, 640, True, False),
    "pp_doclayout_l": (PP_DOCLAYOUT_LABELS, CLS_DICT_SML, 640, False, False),
    "pp_doclayout_plus_l": (
        PP_DOCLAYOUT_PLUS_LABELS, CLS_DICT_PLUS, 800, False, False
    ),
    "pp_doclayoutv2": (PP_DOCLAYOUT_V2_LABELS, CLS_DICT_V2, 800, False, True),
    "pp_doclayoutv3": (PP_DOCLAYOUT_V2_LABELS, CLS_DICT_V2, 800, False, True),
    "doclayout_docstructbench": (
        DOCLAYOUT_YOLO_LABELS, CLS_DICT_YOLO, 1024, False, False
    ),
}
# reference rapid_layout.py:30-35 auto-lowers these models' threshold
LOW_CONF_MODELS = {"pp_doclayout_s", "doclayout_docstructbench"}

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class OnnxLayoutConfig:
    model_type: str = "pp_doclayoutv3"
    conf_threshold: float = 0.5
    markdown_ignore_labels: frozenset = field(
        default_factory=lambda: frozenset(DEFAULT_ABANDON_LABELS)
    )
    class_thresholds: dict | None = None
    apply_nms: bool = True


def norm_image(imagenet: bool):
    """uint8 NCHW -> float32 / 255 (and ImageNet mean/std), on the device."""
    def norm(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32) / 255.0
        if imagenet:
            mean = torch.from_numpy(_IMAGENET_MEAN).to(x.device).reshape(1, 3, 1, 1)
            std = torch.from_numpy(_IMAGENET_STD).to(x.device).reshape(1, 3, 1, 1)
            x = (x - mean) / std
        return x

    return norm


class OnnxLayoutDetector:
    """batch_predict-compatible with ``LayoutDetector``, on ``device``
    (the card unless the caller names another)."""

    def __init__(self, onnx_path: str | Path,
                 config: OnnxLayoutConfig | None = None, *, device=None):
        self.config = config or OnnxLayoutConfig()
        spec = MODEL_SPECS[self.config.model_type]
        self.labels, self.cls_dict, self.input_size, self.imagenet, \
            self.native_order = spec
        self.yolo = self.config.model_type == "doclayout_docstructbench"
        self.fn = OnnxTorchFunction.from_file(onnx_path, device=device)
        # normalize on the device whatever the image input is called
        # ("image" for PP exports, "images" for the YOLO export)
        img_in = "image" if "image" in self.fn.input_names \
            else self.fn.input_names[0]
        self.fn.preproc = {img_in: norm_image(self.imagenet)}
        self._img_in = img_in

    def batch_predict(self, images: list[np.ndarray]) -> list[list[dict]]:
        if not images:
            return []
        if self.yolo:
            return self._batch_predict_yolo(images)
        size = self.input_size
        batch = []
        scales = []
        for img in images:
            h, w = img.shape[:2]
            x = resize_cubic(img, size, size)
            batch.append(x.transpose(2, 0, 1))  # uint8 NCHW
            scales.append([size / h, size / w])
        feeds = {"image": np.stack(batch)}
        names = self.fn.input_names
        if "scale_factor" in names:
            feeds["scale_factor"] = np.asarray(scales, np.float32)
        if "im_shape" in names:
            feeds["im_shape"] = np.tile(
                np.asarray([[size, size]], np.float32), (len(images), 1)
            )
        outs = self.fn(*[feeds[n] for n in names if n in feeds])
        boxes, box_nums = np.asarray(outs[0]), np.asarray(outs[1])
        masks = np.asarray(outs[2]) if len(outs) > 2 else None
        results = []
        start = 0
        for i, img in enumerate(images):
            n = int(box_nums[i])
            sl = slice(start, start + n)
            results.append(
                self._postprocess(
                    boxes[sl], masks[sl] if masks is not None else None, img
                )
            )
            start += n
        return results

    def _batch_predict_yolo(self, images: list[np.ndarray]) -> list[list[dict]]:
        """DocLayout-YOLO docstructbench: centered letterbox to 1024
        (reference model_handler/doc_layout/pre_process.py — gray-114 pad,
        /255, NCHW), output (B, N, 6) [x0,y0,x1,y1,conf,cls] already
        NMS-free-decoded (YOLOv10 head); unscale per letterbox geometry
        (doc_layout/post_process.py + utils.scale_boxes)."""
        size = self.input_size
        batch, geoms = [], []
        for img in images:
            h, w = img.shape[:2]
            gain = min(size / h, size / w)
            nw, nh = round(w * gain), round(h * gain)
            top = (size - nh) // 2
            left = (size - nw) // 2
            canvas = np.full((size, size, 3), 114, np.uint8)
            canvas[top:top + nh, left:left + nw] = resize_linear(img, nw, nh)
            batch.append(canvas.transpose(2, 0, 1))
            geoms.append((gain, left, top, w, h))
        preds = np.asarray(self.fn(np.stack(batch))[0])
        cfg = self.config
        results = []
        for i, (gain, left, top, w, h) in enumerate(geoms):
            dets = []
            for x0, y0, x1, y1, conf, c in preds[i]:
                c = int(c)
                label = (
                    self.labels[c] if 0 <= c < len(self.labels) else str(c)
                )
                th = (cfg.class_thresholds or {}).get(
                    label, cfg.conf_threshold
                )
                if conf <= th:
                    continue
                cat = self.cls_dict.get(label, CategoryId.Text)
                if label in cfg.markdown_ignore_labels:
                    cat = CategoryId.Abandon
                bx = [
                    float(np.clip((x0 - left) / gain, 0, w)),
                    float(np.clip((y0 - top) / gain, 0, h)),
                    float(np.clip((x1 - left) / gain, 0, w)),
                    float(np.clip((y1 - top) / gain, 0, h)),
                ]
                dets.append({
                    "category_id": cat,
                    "poly": [bx[0], bx[1], bx[2], bx[1],
                             bx[2], bx[3], bx[0], bx[3]],
                    "score": round(float(conf), 3),
                    "original_label": label,
                    "original_order": -1,
                })
            results.append(check_inline_formula(dets))
        return results

    def _postprocess(self, boxes, masks, img) -> list[dict]:
        cfg = self.config
        h, w = img.shape[:2]
        if len(boxes) == 0:
            return []
        cls_ids = boxes[:, 0].astype(int)
        scores = boxes[:, 1]
        xyxy = boxes[:, 2:6]
        if cfg.class_thresholds:
            th = np.array(
                [
                    cfg.class_thresholds.get(
                        self.labels[c] if 0 <= c < len(self.labels) else "",
                        cfg.conf_threshold,
                    )
                    for c in cls_ids
                ]
            )
        else:
            th = cfg.conf_threshold
        keep_mask = (scores > th) & (cls_ids >= 0)
        idx = np.where(keep_mask)[0]
        if cfg.apply_nms and len(idx):
            nms_keep = class_nms(xyxy[idx], scores[idx], cls_ids[idx])
            idx = idx[nms_keep] if len(nms_keep) else idx[:0]
            idx = np.sort(idx)  # preserve model emission order (V2/V3)
        dets = []
        for order, i in enumerate(idx):
            c = int(cls_ids[i])
            label = self.labels[c] if 0 <= c < len(self.labels) else str(c)
            cat = self.cls_dict.get(label, CategoryId.Text)
            if label in cfg.markdown_ignore_labels:
                cat = CategoryId.Abandon
            x0, y0, x1, y1 = np.clip(
                xyxy[i], [0, 0, 0, 0], [w, h, w, h]
            ).tolist()
            det = {
                "category_id": cat,
                "poly": [x0, y0, x1, y0, x1, y1, x0, y1],
                "score": round(float(scores[i]), 3),
                "original_label": label,
                "original_order": order if self.native_order else -1,
            }
            if masks is not None:
                pts = mask_to_polygon(
                    (masks[i] > 0.5).astype(np.float32), w, h
                )
                if pts is not None:
                    det["polygon_points"] = pts
            dets.append(det)
        if not self.native_order:
            dets = check_inline_formula(dets)
        return dets


def check_inline_formula(dets: list[dict]) -> list[dict]:
    """Formulas mostly contained by a text det become inline formulas
    (reference: rapid_layout.py:110-128)."""
    texts = [
        d for d in dets if d["category_id"] == CategoryId.Text
    ]
    for d in dets:
        if d["category_id"] != CategoryId.InterlineEquation_YOLO:
            continue
        fb = _poly_box(d["poly"])
        for t in texts:
            if B.iou(fb, _poly_box(t["poly"])) >= 0.9:
                d["category_id"] = CategoryId.InlineEquation
                break
    return dets


def _poly_box(poly):
    xs, ys = poly[0::2], poly[1::2]
    return [min(xs), min(ys), max(xs), max(ys)]
