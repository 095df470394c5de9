"""Per-window inference checkpointing.

The reference has no compute checkpointing (SURVEY.md §5 — its page-window
loop at main.py:299-368 is the natural unit a resume mechanism would
hook). Here each window's model_infos are persisted as JSON keyed by
(document digest, parse options, window start); re-parsing the same
document resumes from completed windows, skipping the device work.

Enable with RapidDoc(checkpoint_dir=...) or RAPIDDOC_CHECKPOINT_DIR.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any

import numpy as np


def checkpoint_key(pdf_bytes: bytes, parse_method: str, dpi: int,
                   window: int) -> str:
    h = hashlib.sha256()
    h.update(pdf_bytes)
    h.update(f"|{parse_method}|{dpi}|{window}".encode())
    return h.hexdigest()[:32]


def _sanitize(obj: Any) -> Any:
    """Make model_infos JSON-safe (numpy scalars/arrays -> python)."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class WindowCheckpoint:
    def __init__(self, root: str | Path, key: str):
        self.dir = Path(root) / key
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, start: int) -> Path:
        return self.dir / f"win_{start:06d}.json"

    def load(self, start: int) -> list[dict] | None:
        path = self._path(start)
        if not path.exists():
            return None
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None

    def save(self, start: int, model_infos: list[dict]) -> None:
        path = self._path(start)
        tmp = path.with_suffix(".tmp")
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(_sanitize(model_infos), f, ensure_ascii=False)
            os.replace(tmp, path)
        except OSError:
            tmp.unlink(missing_ok=True)


def resolve_checkpoint(
    checkpoint_dir: str | Path | None,
    pdf_bytes: bytes, parse_method: str, dpi: int, window: int,
) -> WindowCheckpoint | None:
    root = checkpoint_dir or os.environ.get("RAPIDDOC_CHECKPOINT_DIR") or \
        os.environ.get("MINERU_CHECKPOINT_DIR")
    if not root:
        return None
    return WindowCheckpoint(
        root, checkpoint_key(pdf_bytes, parse_method, dpi, window)
    )
