"""Configuration: environment variables, user config file, per-call config dicts.

Mirrors the three-tier config system of the reference
(rapid_doc/utils/config_reader.py, rapid_doc/utils/os_env_config.py):
  1. environment variables (RAPIDDOC_* preferred; MINERU_* accepted for compat)
  2. a JSON user-config file (~/rapiddoc.json, overridable via RAPIDDOC_CONFIG_JSON)
  3. per-call config dicts (layout_config / ocr_config / ...)
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from pathlib import Path
from typing import Any


def _env(name: str, default: str | None = None) -> str | None:
    """Look up RAPIDDOC_<name>, falling back to MINERU_<name> for compatibility."""
    for prefix in ("RAPIDDOC_", "MINERU_"):
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


def env_bool(name: str, default: bool = False) -> bool:
    val = _env(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def env_int(name: str, default: int) -> int:
    val = _env(name)
    try:
        return int(val) if val is not None else default
    except ValueError:
        return default


def env_str(name: str, default: str | None = None) -> str | None:
    return _env(name, default)


# --- core knobs (reference: docs/analyze_param.md:22-52) ---

def get_device_mode() -> str:
    """'tpu' | 'cpu' — which JAX backend to prefer."""
    return env_str("DEVICE_MODE", "auto") or "auto"


def get_min_batch_inference_size() -> int:
    return env_int("MIN_BATCH_INFERENCE_SIZE", 384)


def get_processing_window_size() -> int:
    return env_int("PROCESSING_WINDOW_SIZE", 64)


def formula_enable_default(user_value: bool) -> bool:
    return env_bool("FORMULA_ENABLE", user_value)


def table_enable_default(user_value: bool) -> bool:
    return env_bool("TABLE_ENABLE", user_value)


def get_models_dir() -> Path:
    d = env_str("MODELS_DIR") or os.environ.get("RAPID_MODELS_DIR")
    if d:
        return Path(d)
    return Path.home() / ".cache" / "rapiddoc_tpu" / "models"


# the in-repo demo checkpoints, read in place as data files from the JAX
# package's asset directory
DEMO_ASSETS_DIR = Path(__file__).resolve().parents[1] / "rapiddoc_tpu" / "assets"


def get_pdf_render_dpi() -> int:
    return env_int("PDF_RENDER_DPI", 200)


# --- user config file ---

@lru_cache(maxsize=1)
def read_user_config() -> dict[str, Any]:
    path = os.environ.get("RAPIDDOC_CONFIG_JSON") or os.environ.get(
        "MINERU_TOOLS_CONFIG_JSON"
    )
    candidates = [path] if path else [
        str(Path.home() / "rapiddoc.json"),
        str(Path.home() / "magic.json"),
    ]
    for cand in candidates:
        if cand and Path(cand).is_file():
            try:
                return json.loads(Path(cand).read_text())
            except (json.JSONDecodeError, OSError):
                continue
    return {}


def get_latex_delimiter_config() -> dict[str, Any]:
    cfg = read_user_config().get("latex-delimiter-config", {})
    return {
        "display": cfg.get("display", {"left": "$$", "right": "$$"}),
        "inline": cfg.get("inline", {"left": "$", "right": "$"}),
    }


def get_s3_config(bucket_name: str) -> tuple[str, str, str]:
    """ak, sk, endpoint for a bucket from the user config file."""
    cfg = read_user_config()
    bucket_info = cfg.get("bucket_info", {})
    if bucket_name in bucket_info:
        ak, sk, endpoint = bucket_info[bucket_name]
    elif "[default]" in bucket_info:
        ak, sk, endpoint = bucket_info["[default]"]
    else:
        raise KeyError(f"no s3 config for bucket {bucket_name!r}")
    return ak, sk, endpoint
