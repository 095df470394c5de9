"""Page orientation classifier (0/90/180/270).

Port of ``rapiddoc_tpu/models/orientation/engine.py:20-132``: a four-conv
net (``OrientationNet``), the classifier around it, the landscape gate
(``should_check_orientation``) and the rotation (``rotate_image``). Pages
are resized to 224x224 with ``resize_linear`` (cv2's INTER_LINEAR, bit
for bit), shipped as uint8 and scaled by 1/255 and rounded to bf16 on
the device in every dtype, as the JAX package's jitted function does;
the softmax runs in fp32. The batch is padded to a power of two.

``OnnxOrientationClassifier`` (the JAX package's ``:76-110``) runs a
published ``rapid_orientation.onnx`` through the port's ONNX interpreter
on the same device: the short side resized to 256 with ``resize_linear``
(INTER_LINEAR), a 224 centre crop, ImageNet normalisation on the host in
float32 as the JAX package does it, and the angle labels from the
model's metadata. ``build_orientation_classifier`` takes it where the
JAX package does: no flax leaves, and the file in the models dir.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ...engine.buckets import BucketSpec
from ...engine.session import TorchSession
from ...engine.onnx_torch import OnnxTorchFunction
from ...tools.onnx_reader import read_onnx_metadata
from ..common.layers import ConvBNAct
from ..ocr.pre_post import resize_linear
from ..weights import load_flax_into, random_init

ANGLES = (0, 90, 180, 270)
INPUT = 224
# powers of two, as the JAX package pads the batch; larger batches run
# in chunks of the largest
ORIENTATION_BUCKETS = BucketSpec(heights=(INPUT,), widths=(INPUT,),
                                 batch_sizes=tuple(2 ** i for i in range(9)))


class OrientationNet(nn.Module):
    """Four stride-2 ConvBNAct layers with hardswish, a mean pool and a
    4-way ``fc``. Input (B, H, W, 3) NHWC; output (B, 4) logits."""

    def __init__(self):
        super().__init__()
        chans = (3, 16, 32, 64, 128)
        for i in range(4):
            self.add_module(f"conv{i}", ConvBNAct(chans[i], chans[i + 1], 3, strides=2,
                                                  act="hardswish"))
        self.fc = nn.Linear(128, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"conv{i}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def _to_unit_bf16(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> x / 255 in fp32, rounded to bf16 (the JAX lambda's input)."""
    return (x.float() / 255.0).to(torch.bfloat16)


class OrientationClassifier:
    """``OrientationNet`` on ``device`` (the card by default) in ``dtype``
    (bf16 by default); ``__call__`` gives each image's angle."""

    INPUT = INPUT

    def __init__(self, model: OrientationNet, *, device=None, dtype: torch.dtype | None = None):
        self.session = TorchSession(
            lambda m, x: torch.softmax(m(x).float(), dim=-1), model, ORIENTATION_BUCKETS,
            name="orientation", device=device, dtype=dtype, preproc=_to_unit_bf16,
        )

    def __call__(self, imgs: list[np.ndarray]) -> list[int]:
        """The angle of each uint8 RGB image."""
        if not imgs:
            return []
        probs = self.session(np.stack([resize_linear(im, INPUT, INPUT) for im in imgs]))
        return [ANGLES[int(p.argmax())] for p in probs]


class OnnxOrientationClassifier:
    """Published rapid_orientation.onnx via the ONNX interpreter on
    ``device`` (reference: rapid_orientation/main — resize_short 256,
    center crop 224, ImageNet norm; label order from the model's
    metadata)."""

    def __init__(self, path, *, device=None):
        self.fn = OnnxTorchFunction.from_file(path, device=device)
        meta = read_onnx_metadata(path)
        labels = (meta.get("character") or "").splitlines()
        self.angles = [
            int(x) for x in labels if x.strip().isdigit()
        ] or list(ANGLES)

    @staticmethod
    def _pre(img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        p = 256.0 / min(h, w)
        img = resize_linear(img, int(round(w * p)), int(round(h * p)))
        h, w = img.shape[:2]
        y0, x0 = (h - 224) // 2, (w - 224) // 2
        x = img[y0 : y0 + 224, x0 : x0 + 224].astype(np.float32) / 255.0
        x = (x - np.array([0.485, 0.456, 0.406], np.float32)) / np.array(
            [0.229, 0.224, 0.225], np.float32
        )
        return x.transpose(2, 0, 1)

    def __call__(self, imgs: list[np.ndarray]) -> list[int]:
        if not imgs:
            return []
        x = np.stack([self._pre(im) for im in imgs]).astype(np.float32)
        out = np.asarray(self.fn(x)[0])
        return [self.angles[int(r.argmax())] for r in out]


def build_orientation_classifier(models_dir: Path, flat: dict | None = None, *,
                                 device=None, dtype: torch.dtype | None = None
                                 ) -> OrientationClassifier | OnnxOrientationClassifier:
    """The classifier from flax leaves ``flat``; without them, a published
    ``rapid_orientation.onnx`` in ``models_dir`` through the ONNX
    interpreter (in float32 whatever ``dtype``, as the JAX package runs
    it), else the net random-init from seed 0."""
    onnx_path = Path(models_dir) / "rapid_orientation.onnx"
    if flat is None and onnx_path.is_file():
        return OnnxOrientationClassifier(onnx_path, device=device)
    model = OrientationNet()
    if flat is None:
        random_init(model, np.random.default_rng(0))
    else:
        load_flax_into(model, flat)
    return OrientationClassifier(model, device=device, dtype=dtype)


def should_check_orientation(img: np.ndarray) -> bool:
    """Gate: only landscape-ish pages are worth classifying."""
    h, w = img.shape[:2]
    return w > h * 1.2


def rotate_image(img: np.ndarray, angle: int) -> np.ndarray:
    if angle % 360 == 0:
        return img
    k = (angle // 90) % 4
    return np.ascontiguousarray(np.rot90(img, k))
