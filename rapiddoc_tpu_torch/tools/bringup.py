"""One-command real-weight bring-up: download -> convert -> load -> eval.

    python -m rapiddoc_tpu_torch.tools.bringup [asset ...] [--eval] [--force]

Port of ``rapiddoc_tpu/tools/bringup.py``. Per asset: fetch (SHA256
pinned, ``models/download.py``), run the converter where one applies,
then LOAD the result through the production builder of its family, on
the card (or the CPU under ``RAPIDDOC_PLATFORM=cpu``): a converted tree
that does not load is a failure, not a success. ``--eval`` then runs
``tools/eval_quality`` on ``RAPIDDOC_EVAL_DATASET`` against
``RAPIDDOC_EVAL_GT``, or without them parses the port's OCR fixture
(``assets/ocr_smoke_doc.pdf``) and requires non-trivial Markdown.

Exit code = number of failed assets. Zero-egress boxes get a clear
per-asset message and the demo checkpoints keep working.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

from ..config import get_models_dir
from ..models.download import REGISTRY, download_and_convert
from ..utils.logging import get_logger

logger = get_logger("rapiddoc_tpu_torch.bringup")

FIXTURE = Path(__file__).resolve().parents[1] / "assets" / "ocr_smoke_doc.pdf"

# asset key prefix -> family; family -> production loader exercising the
# converted weights
_PREFIX_FAMILY = {
    "ocr": "ocr",
    "formula": "formula",
    "unitable": "table",
    "slanet": "table",
    "table": "table",
    "layout": "layout",
    "doclayout": "layout",
}


def _require(name: str) -> None:
    """The builders fall back to the demo checkpoints; a bring-up load
    must mean the CONVERTED weights are what loads."""
    path = get_models_dir() / name
    if not path.is_file():
        raise FileNotFoundError(f"converted {name} missing under {get_models_dir()}")


def _load_ocr():
    from ..models.registry import build_ocr_system

    for name in ("ocr_det_v6_small.npz", "ocr_rec_v6_small.npz"):
        _require(name)
    return build_ocr_system()


def _load_formula():
    from ..models.registry import build_formula_model

    _require("formula_net_plus_m.npz")
    model = build_formula_model({"allow_random_init": False})
    if model is None:
        raise FileNotFoundError("formula checkpoint did not load")
    return model


def _load_table():
    from ..models.registry import build_table_model

    model = build_table_model({"allow_random_init": False})
    if model is None:
        raise FileNotFoundError("table checkpoints did not load")
    return model


def _load_layout():
    from ..models.registry import build_layout_model

    model = build_layout_model({"allow_random_init": False})
    if model is None:
        raise FileNotFoundError("layout checkpoint did not load")
    return model


_FAMILY_LOADERS = {
    "ocr": _load_ocr,
    "formula": _load_formula,
    "table": _load_table,
    "layout": _load_layout,
}


def _family(key: str) -> str | None:
    for prefix, family in _PREFIX_FAMILY.items():
        if key.startswith(prefix):
            return family
    return None


def bringup(keys: list[str] | None = None, force: bool = False,
            run_eval: bool = False) -> int:
    keys = keys or list(REGISTRY)
    failed: list[str] = []
    loaded_families: set = set()
    for key in keys:
        if key not in REGISTRY:
            logger.error("unknown asset %r", key)
            failed.append(key)
            continue
        try:
            path = download_and_convert(key, force=force)
            logger.info("[fetch+convert] %s -> %s", key, path)
        except Exception as e:
            logger.error("[fetch+convert] %s FAILED: %s", key, e)
            failed.append(key)
            continue
        family = _family(key)
        if family is None or family in loaded_families:
            continue
        try:
            _FAMILY_LOADERS[family]()
            loaded_families.add(family)
            logger.info("[load] %s family loads through production path", family)
        except Exception as e:
            logger.error("[load] %s FAILED: %s", key, e)
            failed.append(key)
    if run_eval and not failed:
        dataset = os.environ.get("RAPIDDOC_EVAL_DATASET")
        gt = os.environ.get("RAPIDDOC_EVAL_GT")
        if dataset and gt:
            from . import eval_quality

            rc = eval_quality.main([dataset, gt])
            if rc:
                logger.error("[eval] quality eval failed (rc=%d)", rc)
                return rc
        else:
            rc = _eval_smoke()
            if rc:
                return rc
    if failed:
        logger.error("bring-up incomplete: %s", ", ".join(failed))
    else:
        logger.info("bring-up complete: %d asset(s) ready", len(keys))
    return len(failed)


def _eval_smoke() -> int:
    """No-dataset eval: parse the port's OCR fixture end-to-end and
    require non-trivial Markdown — catches weights that load but produce
    garbage. Full metrics need RAPIDDOC_EVAL_DATASET + RAPIDDOC_EVAL_GT
    (tools/eval_quality)."""
    from ..api import RapidDoc

    fixture = FIXTURE
    out = RapidDoc()(str(fixture), parse_method="ocr")
    if not out.markdown or len(out.markdown) < 200:
        logger.error("[eval] smoke FAILED: %d chars of markdown from %s",
                     len(out.markdown or ""), fixture)
        return 1
    logger.info("[eval] smoke ok: %d chars markdown from %s", len(out.markdown), fixture)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    force = "--force" in argv
    run_eval = "--eval" in argv
    keys = [a for a in argv if not a.startswith("-")]
    return bringup(keys or None, force=force, run_eval=run_eval)


if __name__ == "__main__":
    raise SystemExit(main())
