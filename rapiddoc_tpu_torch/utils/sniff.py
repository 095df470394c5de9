"""Content-based file-type identification.

Port of ``rapiddoc_tpu/utils/sniff.py``: ``magika_features``,
``magika_classify`` and ``guess_suffix_by_bytes``. The trained Magika
model (a published ``.onnx``: 1024 bytes from each end of the input,
whitespace-stripped and padded with token 256, to 214 file types) runs
through the port's ONNX interpreter (``engine/onnx_torch.py``) on
``device``, the card unless the caller names another. The model is read
from ``RAPIDDOC_MAGIKA_DIR``, then ``<models dir>/magika``, then in place
from the JAX package's asset directory (``config.DEMO_ASSETS_DIR /
"magika"``), as the JAX package looks for it.

Policy: with no model file the magic-bytes sniffer below keeps routing,
as in the JAX package; a model file that fails to load or run raises,
where the JAX package logs and falls back to magic bytes.

Feature extraction per reference magika.py:404-503 — at most `block_size`
bytes from each end, whitespace-stripped, `beg` padded at the end and
`end` padded at the front with `padding_token`.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..config import DEMO_ASSETS_DIR, get_models_dir
from ..engine.onnx_torch import OnnxTorchFunction
from ..engine.session import resolve_device

_BEG = 1024
_END = 1024
_BLOCK = 4096
_PAD = 256

_VENDORED_MODEL_DIR = DEMO_ASSETS_DIR / "magika"


def _model_dir() -> Path | None:
    env = os.environ.get("RAPIDDOC_MAGIKA_DIR")
    if env and Path(env).is_dir():
        # a directory without the model: magic bytes, as the JAX package
        # ends up after its load fails
        return Path(env) if (Path(env) / "model.onnx").is_file() else None
    local = get_models_dir() / "magika"
    if (local / "model.onnx").is_file():
        return local
    # vendored trained magika checkpoint (Apache-2.0 upstream artifact)
    if (_VENDORED_MODEL_DIR / "model.onnx").is_file():
        return _VENDORED_MODEL_DIR
    return None


@lru_cache(maxsize=8)
def _load(model_dir: Path, device: str):
    fn = OnnxTorchFunction.from_file(model_dir / "model.onnx", device=device)
    cfg = json.loads((model_dir / "config.min.json").read_text())
    return fn, cfg["target_labels_space"], cfg.get("overwrite_map", {})


def load_magika(device: str | torch.device | None = None):
    """(function, labels, overwrite map) on ``device``, built once per
    model directory and device; None when there is no model file."""
    d = _model_dir()
    if d is None:
        return None
    return _load(d, str(resolve_device(device)))


def magika_features(data: bytes) -> np.ndarray:
    beg = list(data[:_BLOCK].lstrip()[:_BEG])
    beg += [_PAD] * (_BEG - len(beg))
    end = list(data[-_BLOCK:].rstrip()[-_END:])
    end = [_PAD] * (_END - len(end)) + end
    return np.asarray([beg + end], np.int32)


def magika_classify(data: bytes, device: str | torch.device | None = None) -> tuple[str, float]:
    """-> (label, confidence); ('unknown', 0.0) when the model is absent."""
    loaded = load_magika(device)
    if loaded is None or len(data) < 8:
        return "unknown", 0.0
    fn, labels, overwrite = loaded
    scores = fn(magika_features(data))[0][0]
    idx = int(np.argmax(scores))
    label = labels[idx]
    return overwrite.get(label, label), float(scores[idx])


_MAGIC_SUFFIX = {
    b"%PDF": "pdf",
    b"\x89PNG": "png",
    b"GIF8": "gif",
    b"RIFF": "webp",
    b"\xff\xd8\xff": "jpeg",
    b"PK\x03\x04": "zip",
}

# magika label -> canonical suffix the pipeline routes on
_LABEL_SUFFIX = {
    "pdf": "pdf", "png": "png", "jpeg": "jpg", "gif": "gif", "webp": "webp",
    "bmp": "bmp", "tiff": "tif", "docx": "docx", "pptx": "pptx",
    "xlsx": "xlsx", "doc": "doc", "ppt": "ppt", "xls": "xls", "zip": "zip",
    "html": "html", "markdown": "md", "txt": "txt", "csv": "csv",
}


def guess_suffix_by_bytes(data: bytes, device: str | torch.device | None = None) -> str:
    """Best-effort suffix: trained magika when available, magic bytes
    otherwise (reference: utils/guess_suffix_or_lang.py:174-193)."""
    label, score = magika_classify(data, device)
    if score >= 0.5 and label in _LABEL_SUFFIX:
        suffix = _LABEL_SUFFIX[label]
        if suffix == "zip":
            suffix = _office_zip_kind(data) or "zip"
        return suffix
    for magic, suffix in _MAGIC_SUFFIX.items():
        if data[: len(magic)] == magic:
            if suffix == "zip":
                return _office_zip_kind(data) or "zip"
            return suffix
    return ""


def _office_zip_kind(data: bytes) -> str | None:
    head = data[:4096]
    if b"word/" in head:
        return "docx"
    if b"ppt/" in head:
        return "pptx"
    if b"xl/" in head:
        return "xlsx"
    return None
