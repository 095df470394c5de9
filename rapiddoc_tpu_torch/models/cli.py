"""Standalone per-model CLIs.

The reference ships a main() entry point per vendored stack (layout
rapid_layout_self/main.py:92-113, formula rapid_formula_self/main.py:
65-84, table rapid_table_self/main.py:204-220) — handy for probing a
single model and for parity tests. Equivalent here:

    python -m rapiddoc_tpu_torch.models.layout page.png
    python -m rapiddoc_tpu_torch.models.ocr page.png --words
    python -m rapiddoc_tpu_torch.models.formula crop.png
    python -m rapiddoc_tpu_torch.models.table crop.png

Each prints one JSON object per input image on stdout. --config takes a
JSON dict forwarded to the stage's build function (same keys as the RapidDoc
per-stage configs, e.g. '{"model_type": "pp_doclayout_s"}'). Port of
the JAX package's module: images are read by the port's decoders
(``pdfio/png.decode_image``: PNG, JPEG, BMP, GIF, TIFF, WEBP, JPEG 2000) and
the models run
on the card, or on the CPU under ``RAPIDDOC_PLATFORM=cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys


def _load_rgb(path: str):
    """``Image.open(path).convert("RGB")`` as an (H, W, 3) array."""
    import numpy as np

    from ..pdfio.png import decode_image

    with open(path, "rb") as f:
        px = decode_image(f.read())
    return np.repeat(px[..., None], 3, axis=2) if px.ndim == 2 else px


def _jsonable(x):
    """numpy scalars/arrays -> plain Python for json.dumps."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "item"):
        return x.item()
    return str(x)


def _require(model, stage: str):
    if model is None:
        raise SystemExit(
            f"{stage} model unavailable (disabled via RAPIDDOC_DISABLE_"
            f"{stage.upper()} or no checkpoint; see docs/models.md)"
        )
    return model


def main(stage: str, argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog=f"rapiddoc_tpu_torch.models.{stage}",
        description=f"Run the {stage} model on image files.",
    )
    ap.add_argument("images", nargs="+", help="image file(s)")
    ap.add_argument("--config", default=None,
                    help="JSON dict forwarded to the stage's build function")
    ap.add_argument("--lang", default="ch", help="OCR language (ocr only)")
    ap.add_argument("--words", action="store_true",
                    help="emit per-word boxes (ocr only)")
    ap.add_argument("-o", "--output", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    configs = json.loads(args.config) if args.config else None
    images = [_load_rgb(p) for p in args.images]

    from . import registry

    if stage == "layout":
        model = _require(registry.build_layout_model(configs), stage)
        results = model.batch_predict(images)
    elif stage == "ocr":
        system = _require(
            registry.build_ocr_system(configs, lang=args.lang), stage
        )
        results = system(images, return_word_boxes=args.words)
    elif stage == "formula":
        model = _require(registry.build_formula_model(configs), stage)
        results = [{"latex": s} for s in model.batch_predict(images)]
    elif stage == "table":
        model = _require(registry.build_table_model(configs), stage)
        results = [{"html": s} for s in model.batch_predict(images)]
    else:  # pragma: no cover - guarded by the __main__ wiring
        raise SystemExit(f"unknown stage {stage}")

    lines = []
    for path, res in zip(args.images, results):
        lines.append(json.dumps({"file": path, "result": res},
                                ensure_ascii=False, default=_jsonable))
    out = "\n".join(lines)
    print(out)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out + "\n")


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "",
                  sys.argv[2:]))
