"""Custom model plug-in contract.

API parity with the reference plug-in hook (reference:
rapid_doc/model/custom/__init__.py:4-21 CustomBaseModel.batch_predict and
the per-stage custom_model override in model_init.py:97-120): users can
substitute any stage (layout/ocr/formula/table) with their own model, e.g.
a remote VL service (the reference's PaddleOCR-VL path). Copy of the
JAX package's module.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Sequence

import numpy as np


class CustomBaseModel(ABC):
    """Implement batch_predict; plug in via the stage config dicts:
    RapidDoc(layout_config={"custom_model": MyLayout()}, ...).
    """

    @abstractmethod
    def batch_predict(self, images: Sequence[np.ndarray]) -> list[Any]:
        """One result per input image. Result shape per stage:
        layout -> list[dict layout_det]; formula -> str latex;
        table -> str html; ocr -> list[dict{box,text,score}]."""


class CustomOCRAdapter:
    """Adapts a CustomBaseModel (region text recognizer) to the TextSystem
    interface used by the scheduler."""

    def __init__(self, model: CustomBaseModel, drop_score: float = 0.5):
        self.model = model
        self.drop_score = drop_score

    def __call__(self, images: Sequence[np.ndarray]):
        return self.model.batch_predict(images)


def resolve_custom(configs: dict | None, stage: str):
    """Pull a custom model out of a per-stage config dict. The string
    shorthand "paddleocr_vl" builds the remote VL client from env
    (reference: model/custom/paddleocr_vl/)."""
    if not configs:
        return None
    model = configs.get("custom_model")
    if model is None:
        return None
    if model == "paddleocr_vl":
        from .vl import build_vl_model

        model = build_vl_model(stage)
        if model is None:
            raise ValueError(
                "paddleocr_vl requested but PADDLEOCRVL_API_BASE is not set"
            )
        return model
    if not hasattr(model, "batch_predict"):
        raise TypeError(
            f"{stage} custom_model must implement batch_predict (see "
            "rapiddoc_tpu_torch.models.custom.CustomBaseModel)"
        )
    return model
