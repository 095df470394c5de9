"""Page orientation classifier (0/90/180/270).

Port of ``rapiddoc_tpu/models/orientation/engine.py:20-132``: a four-conv
net (``OrientationNet``), the classifier around it, the landscape gate
(``should_check_orientation``) and the rotation (``rotate_image``). Pages
are resized to 224x224 with ``resize_linear`` (cv2's INTER_LINEAR, bit
for bit), shipped as uint8 and scaled by 1/255 and rounded to bf16 on
the device in every dtype, as the JAX package's jitted function does;
the softmax runs in fp32. The batch is padded to a power of two.

A published ``rapid_orientation.onnx`` needs the ONNX interpreter and
raises NotImplementedError (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ...engine.buckets import BucketSpec
from ...engine.session import TorchSession
from ...utils.unported import not_ported
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


def build_orientation_classifier(models_dir: Path, flat: dict | None = None, *,
                                 device=None, dtype: torch.dtype | None = None
                                 ) -> OrientationClassifier:
    """The classifier from flax leaves ``flat``; without them, a published
    ``rapid_orientation.onnx`` in ``models_dir`` raises (ONNX is not
    ported), else the net is random-init from seed 0."""
    model = OrientationNet()
    if flat is None:
        if (Path(models_dir) / "rapid_orientation.onnx").is_file():
            raise not_ported("the published rapid_orientation.onnx", "sniff")
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
