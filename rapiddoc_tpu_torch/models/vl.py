"""PaddleOCR-VL-style remote custom models (OpenAI-compatible server).

Role parity with the reference VL plug-ins (reference:
rapid_doc/model/custom/paddleocr_vl/{paddleocr_vl,predictor,genai}.py —
OCR/Formula/Table/Seal tasks posted as chat completions with a
base64-encoded crop and a task prompt like "OCR:" /
"Formula Recognition:" / "Table Recognition:" against a vLLM-style
/v1/chat/completions endpoint). Implemented on stdlib urllib with a
thread pool (the reference's asyncio loop manager is replaced by
bounded concurrent requests — simpler, and the device pipeline never
blocks on it). Port of the JAX package's module: crops are encoded by
the port's JPEG encoder (``pdfio/jpeg_encode`` at quality 92), which
writes the bytes the JAX package's ``cv2.imencode`` writes.

Configure with env (PADDLEOCRVL_* per the reference, RAPIDDOC_VL_* also
accepted):
  PADDLEOCRVL_API_BASE  e.g. http://localhost:8000/v1
  PADDLEOCRVL_API_KEY   optional bearer token
  PADDLEOCRVL_MODEL     served model name (default "paddleocr-vl")
"""
from __future__ import annotations

import base64
import json
import os
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..pdfio.jpeg_encode import encode_jpeg
from ..utils.logging import get_logger
from .custom import CustomBaseModel

logger = get_logger("rapiddoc_tpu_torch.vl")

OCR_PROMPT = "OCR:"
SEAL_PROMPT = "Seal Recognition:"
FORMULA_PROMPT = "Formula Recognition:"
TABLE_PROMPT = "Table Recognition:"


def _env(*names: str, default: str | None = None) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


class VLClient:
    def __init__(
        self,
        api_base: str | None = None,
        api_key: str | None = None,
        model: str | None = None,
        timeout: float = 120.0,
        max_concurrency: int = 8,
        max_retries: int = 2,
    ):
        self.api_base = (
            api_base
            or _env("PADDLEOCRVL_API_BASE", "RAPIDDOC_VL_API_BASE")
        )
        if not self.api_base:
            raise ValueError(
                "VL server not configured: set PADDLEOCRVL_API_BASE"
            )
        self.api_key = api_key or _env(
            "PADDLEOCRVL_API_KEY", "RAPIDDOC_VL_API_KEY"
        )
        self.model = model or _env(
            "PADDLEOCRVL_MODEL", "RAPIDDOC_VL_MODEL", default="paddleocr-vl"
        )
        self.timeout = timeout
        self.max_retries = max_retries
        self._pool = ThreadPoolExecutor(max_workers=max_concurrency)

    # ------------------------------------------------------------ request

    def _encode(self, img: np.ndarray) -> str:
        if img.size == 0:
            raise ValueError("failed to encode crop")
        return "data:image/jpeg;base64," + base64.b64encode(
            encode_jpeg(np.ascontiguousarray(img, np.uint8), 92)
        ).decode()

    def _complete(self, img: np.ndarray, prompt: str) -> str:
        payload = {
            "model": self.model,
            "temperature": 0.0,
            "messages": [
                {
                    "role": "user",
                    "content": [
                        {"type": "image_url",
                         "image_url": {"url": self._encode(img)}},
                        {"type": "text", "text": prompt},
                    ],
                }
            ],
        }
        url = self.api_base.rstrip("/") + "/chat/completions"
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        body = json.dumps(payload).encode()
        last_err: Exception | None = None
        for _ in range(self.max_retries + 1):
            try:
                req = urllib.request.Request(url, body, headers)
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    out = json.load(r)
                return out["choices"][0]["message"]["content"]
            except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                    TimeoutError) as e:
                last_err = e
        logger.warning("VL request failed after retries: %s", last_err)
        return ""

    def batch(self, images: Sequence[np.ndarray], prompt: str) -> list[str]:
        futures = [
            self._pool.submit(self._complete, img, prompt) for img in images
        ]
        return [f.result() for f in futures]


class PaddleOCRVLOCRModel(CustomBaseModel):
    """Region text recognition via the VL server; plugs into ocr_config.
    Yields per-crop [{box, text, score}] (full-crop box, score 1.0)."""

    def __init__(self, client: VLClient | None = None, seal: bool = False):
        self.client = client or VLClient()
        self.prompt = SEAL_PROMPT if seal else OCR_PROMPT
        self.drop_score = 0.0

    def batch_predict(self, images: Sequence[np.ndarray]) -> list[list[dict]]:
        texts = self.client.batch(images, self.prompt)
        out = []
        for img, text in zip(images, texts):
            h, w = img.shape[:2]
            items = []
            if text.strip():
                items.append(
                    {"box": [[0, 0], [w, 0], [w, h], [0, h]],
                     "text": text.strip(), "score": 1.0}
                )
            out.append(items)
        return out

    def __call__(self, images: Sequence[np.ndarray], **kw):
        return self.batch_predict(images)


class PaddleOCRVLFormulaModel(CustomBaseModel):
    def __init__(self, client: VLClient | None = None):
        self.client = client or VLClient()

    def batch_predict(self, images: Sequence[np.ndarray]) -> list[str]:
        return [
            t.strip().strip("$").strip()
            for t in self.client.batch(images, FORMULA_PROMPT)
        ]


class PaddleOCRVLTableModel(CustomBaseModel):
    def __init__(self, client: VLClient | None = None):
        self.client = client or VLClient()

    def batch_predict(self, images: Sequence[np.ndarray]) -> list[str]:
        out = []
        for text in self.client.batch(images, TABLE_PROMPT):
            text = text.strip()
            if text.startswith("```"):
                text = text.strip("`\n")
                if text.startswith("html"):
                    text = text[4:]
            out.append(text.strip())
        return out


VL_STAGE_MODELS = {
    "ocr": PaddleOCRVLOCRModel,
    "formula": PaddleOCRVLFormulaModel,
    "table": PaddleOCRVLTableModel,
}


def build_vl_model(stage: str):
    """Construct the VL model for a stage from env config; None when the
    server is not configured."""
    cls = VL_STAGE_MODELS.get(stage)
    if cls is None:
        return None
    try:
        return cls()
    except ValueError:
        return None
