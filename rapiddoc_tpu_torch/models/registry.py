"""Model registry of the port: builds the model stack from the checkpoints
the JAX package would find.

``build_ocr_system(configs, lang)`` is ``rapiddoc_tpu/models/registry.py:72-158``:
DBNet and SVTRRec from the published-format ``ocr_det_v6_small.npz`` /
``ocr_rec_v6_small.npz`` in the models dir (the rec decoding through the
default dictionary, ``ppocrv6_small_dict.txt``: 18,710 classes), else
the in-repo demo checkpoints ``ocr_det_demo.npz`` / ``ocr_rec_demo.npz``
(read in place from the JAX package's asset directory, as data files)
with the demo charset. Another ``lang`` reads ``ocr_rec_<lang>.npz`` with
``ocr_rec_<lang>_dict.txt`` from the models dir, then the in-repo
``ocr_rec_<lang>_demo.npz`` with its dictionary; weights without their
dictionary are refused with a warning. Demo checkpoints get the contrast
stretch (``RAPIDDOC_CONTRAST_STRETCH=0/1`` overrides), and the OCR
config's ``Det.limit_side_len`` sets the det limit. ``charset_path``
swaps in another dictionary over the demo checkpoints, with a head
random-init (from ``HEAD_SEED``) at its width.

``build_formula_recognizer`` is the demo branch of
``FormulaRecognizer.build`` (``rapiddoc_tpu/models/formula/engine.py:197-236``):
``formula_demo.npz`` + ``formula_demo.json`` (PPHGNetV2-B0 encoder, a
2-layer MBart decoder at the published widths, 57 tokens).
``build_published_formula`` is its published branch: a converted
``formula_net_plus_m.npz`` in the models dir (``tools/convert_weights.py
formula``) under the default ``FormulaConfig`` (PP-FormulaNet_plus-M: B6
encoder, 6 decoder layers, d_model 512, 50 000 tokens; a bare-decoder
npz gets a random encoder, as in the JAX package), decoded by
``formula_tokenizer.json`` (``convert_weights formula_dict``) through
``FormulaTokenizer``.

``build_layout_model``, ``build_formula_model``, ``build_table_model``,
``build_orientation_model`` and ``build_analyzer`` are the JAX
package's (``registry.py:161-260``): the layout detector
(``LayoutDetector.build``: a published ``.onnx`` or npz, or the demo
checkpoint under ``RAPIDDOC_DEMO_LAYOUT``) or None where its checkpoint
is missing, the formula recognizer (published, else demo), the table
recognizer (``TableRecognizer.build``: published npz, else the demo
checkpoints, ONNX models only for a model still missing, no OCR system
inside tables, as in the JAX package), the orientation classifier under
``USE_DOC_ORIENTATION_CLASSIFY``, the
OCR system and the document analyzer around them. A stage config's
``custom_model`` (an object with ``batch_predict``, or the shorthand
``"paddleocr_vl"`` for the remote VL client of ``models/vl.py``) takes
that stage's place (``models/custom.resolve_custom``), and the checkbox
config's ``checkbox_enable`` turns on checkbox detection, as in the JAX
package.
"""
from __future__ import annotations

import json
import os
import string
from pathlib import Path

import numpy as np
import torch

from ..config import DEMO_ASSETS_DIR, env_bool, get_models_dir
from ..pipeline.scheduler import DocumentAnalyzer
from ..utils.logging import get_logger
from .custom import resolve_custom
from .formula.engine import DemoFormulaVocab, FormulaConfig, FormulaRecognizer, FormulaTokenizer
from .layout.engine import LayoutDetector
from .ocr.det import DBNet
from .ocr.engine import TextDetector, TextRecognizer, TextSystem
from .ocr.rec import SVTRRec
from .orientation.engine import (OnnxOrientationClassifier, OrientationClassifier,
                                 build_orientation_classifier)
from .table.engine import TableRecognizer
from .weights import load_flax_into, load_npz

PUBLISHED_DICT = DEMO_ASSETS_DIR / "ppocrv6_small_dict.txt"

# printable ASCII without space (space is the implicit final vocab entry
# of CTCLabelDecoder), as rapiddoc_tpu/train/synth.py:55 defines it
DEMO_CHARSET = [c for c in string.printable[:94] if c != " "]
# seed of the random-init head that goes with a dictionary of charset_path
HEAD_SEED = 0

logger = get_logger("rapiddoc_tpu_torch.registry")


def _load_if(path: Path) -> dict | None:
    return load_npz(path) if path.is_file() else None


def _read_charset(path: Path) -> list[str]:
    return [ln.rstrip("\n\r") for ln in path.read_text(encoding="utf-8").splitlines() if ln]


def default_charset_path() -> Path:
    """The published rec's dictionary, as the JAX package finds it:
    RAPIDDOC_OCR_DICT, the models dir, then the vendored copy."""
    p = os.environ.get("RAPIDDOC_OCR_DICT")
    if p and Path(p).is_file():
        return Path(p)
    cand = get_models_dir() / "ppocrv6_small_dict.txt"
    return cand if cand.is_file() else PUBLISHED_DICT


def build_ocr_system(
    configs: dict | None = None,
    lang: str | None = "ch",
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
    charset_path: str | Path | None = None,
) -> TextSystem:
    """The OCR system for ``lang`` on ``device`` (the card by default) in
    ``dtype`` (bf16 by default), from the checkpoints the JAX package's
    ``build_ocr_system(configs, lang)`` would load."""
    cfg = configs or {}
    models_dir = get_models_dir()
    if charset_path is not None:
        det_flat = load_npz(DEMO_ASSETS_DIR / "ocr_det_demo.npz")
        charset = _read_charset(Path(charset_path))
        rec = load_flax_into(SVTRRec(num_classes=len(charset) + 2),
                             load_npz(DEMO_ASSETS_DIR / "ocr_rec_demo.npz"), skip=("head",))
        rng = np.random.default_rng(HEAD_SEED)
        c, v = rec.head.kernel.shape
        with torch.no_grad():
            rec.head.kernel.copy_(torch.from_numpy(
                (rng.standard_normal((c, v)) / np.sqrt(c)).astype(np.float32)
            ))
            rec.head.bias.zero_()
        det_demo = rec_demo = True
    else:
        det_flat = _load_if(models_dir / "ocr_det_v6_small.npz")
        rec_flat, charset, rec_demo = None, None, False
        if lang not in ("ch", "en", "", None):
            rec_flat = _load_if(models_dir / f"ocr_rec_{lang}.npz")
            lang_dict = models_dir / f"ocr_rec_{lang}_dict.txt"
            if rec_flat is None:
                # the in-repo per-language demo checkpoint
                rec_flat = _load_if(DEMO_ASSETS_DIR / f"ocr_rec_{lang}_demo.npz")
                lang_dict = DEMO_ASSETS_DIR / f"ocr_rec_{lang}_dict.txt"
                rec_demo = rec_flat is not None
            if rec_flat is not None and lang_dict.is_file():
                charset = _read_charset(lang_dict)
            elif rec_flat is not None:
                # weights without their dictionary would decode through the
                # wrong glyph table: refuse them, use the default rec
                logger.warning(
                    "per-lang rec weights for %r found but the matching "
                    "dict file (%s) is missing — ignoring them; ship both "
                    "ocr_rec_%s.npz AND ocr_rec_%s_dict.txt",
                    lang, lang_dict.name, lang, lang,
                )
                rec_flat, rec_demo = None, False
        if rec_flat is None:
            rec_flat = _load_if(models_dir / "ocr_rec_v6_small.npz")
            if rec_flat is not None:
                charset = _read_charset(default_charset_path())
        det_demo = det_flat is None
        if det_demo:
            det_flat = load_npz(DEMO_ASSETS_DIR / "ocr_det_demo.npz")
        if rec_flat is None:
            rec_flat = load_npz(DEMO_ASSETS_DIR / "ocr_rec_demo.npz")
            charset, rec_demo = DEMO_CHARSET, True
        # the decoder's vocabulary: blank, the dictionary, space
        rec = load_flax_into(SVTRRec(num_classes=len(charset) + 2), rec_flat)
    det = load_flax_into(DBNet(), det_flat)
    # demo checkpoints saw only full-range synthetic ink: they get the
    # percentile contrast stretch, published ones the reference
    # preprocessing; RAPIDDOC_CONTRAST_STRETCH=0/1 overrides
    stretch_env = os.environ.get("RAPIDDOC_CONTRAST_STRETCH")
    det_stretch = det_demo if stretch_env is None else stretch_env == "1"
    rec_stretch = rec_demo if stretch_env is None else stretch_env == "1"
    return TextSystem(
        TextDetector(det, device=device, dtype=dtype,
                     limit_side_len=int(cfg.get("Det.limit_side_len", 960)),
                     contrast_stretch=det_stretch),
        TextRecognizer(rec, charset, device=device, dtype=dtype,
                       contrast_stretch=rec_stretch),
    )


def build_formula_recognizer(
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
    int8_head: bool | None = None,
) -> FormulaRecognizer:
    """The demo formula recognizer on ``device`` (the card by default) in
    ``dtype`` (bf16 by default); ``int8_head`` as in FormulaRecognizer."""
    npz = DEMO_ASSETS_DIR / "formula_demo.npz"
    meta = json.loads(npz.with_suffix(".json").read_text())
    arch, vocab = meta["arch"], meta["vocab"]
    rec = FormulaRecognizer(
        load_npz(npz),
        config=FormulaConfig(
            max_len=arch["max_len"], vocab_size=len(vocab), layers=arch["layers"],
            backbone_size=arch["backbone_size"], out_index=arch.get("out_index", 3),
            default_length_bucket=min(arch["max_len"], FormulaConfig.default_length_bucket),
        ),
        device=device, dtype=dtype, int8_head=int8_head,
    )
    rec.tokenizer = DemoFormulaVocab(vocab)
    return rec


def build_published_formula(
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> FormulaRecognizer | None:
    """The published formula recognizer from the models dir's converted
    ``formula_net_plus_m.npz`` and ``formula_tokenizer.json``, or None
    where the npz is missing."""
    models_dir = get_models_dir()
    flat = _load_if(models_dir / "formula_net_plus_m.npz")
    if flat is None:
        return None
    rec = FormulaRecognizer(flat, config=FormulaConfig(), device=device, dtype=dtype)
    rec.tokenizer = FormulaTokenizer(models_dir / "formula_tokenizer.json")
    return rec


def build_layout_model(configs: dict | None = None, device=None,
                       dtype: torch.dtype | None = None) -> LayoutDetector | None:
    """The layout detector, or None where the JAX package has none:
    RAPIDDOC_DISABLE_LAYOUT, or no checkpoint (neither a published one
    nor the demo one asked for)."""
    if os.environ.get("RAPIDDOC_DISABLE_LAYOUT"):
        return None
    try:
        return LayoutDetector.build(configs or {}, device=device, dtype=dtype)
    except FileNotFoundError:
        return None


def build_formula_model(configs: dict | None = None, device=None,
                        dtype: torch.dtype | None = None) -> FormulaRecognizer | None:
    """The published formula recognizer where the models dir holds one,
    else the demo one; None under RAPIDDOC_DISABLE_FORMULA."""
    if os.environ.get("RAPIDDOC_DISABLE_FORMULA"):
        return None
    rec = build_published_formula(device=device, dtype=dtype)
    if rec is not None:
        logger.info("formula: published checkpoint formula_net_plus_m.npz")
        return rec
    return build_formula_recognizer(device=device, dtype=dtype)


def build_table_model(configs: dict | None = None, device=None,
                      dtype: torch.dtype | None = None) -> TableRecognizer | None:
    """The table recognizer, or None under RAPIDDOC_DISABLE_TABLE."""
    if os.environ.get("RAPIDDOC_DISABLE_TABLE"):
        return None
    return TableRecognizer.build(configs or {}, device=device, dtype=dtype)


def build_orientation_model(device=None, dtype: torch.dtype | None = None
                            ) -> OrientationClassifier | OnnxOrientationClassifier | None:
    """The orientation classifier under USE_DOC_ORIENTATION_CLASSIFY (the
    JAX package's gate), else None: ``orientation_cls.npz`` from the
    models dir, else the in-repo ``orientation_demo.npz``, else a
    published ``rapid_orientation.onnx`` in the models dir."""
    if not (env_bool("USE_DOC_ORIENTATION_CLASSIFY") or os.environ.get(
        "USE_DOC_ORIENTATION_CLASSIFY", ""
    ).lower() in ("1", "true", "yes")):
        return None
    flat = _load_if(get_models_dir() / "orientation_cls.npz")
    if flat is None:
        flat = _load_if(DEMO_ASSETS_DIR / "orientation_demo.npz")
        if flat is not None:
            logger.info("orientation: demo synthetic-trained checkpoint")
    return build_orientation_classifier(get_models_dir(), flat, device=device, dtype=dtype)


def build_analyzer(
    lang: str = "ch",
    formula_enable: bool = True,
    table_enable: bool = True,
    configs: dict | None = None,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> DocumentAnalyzer:
    """The document analyzer on ``device`` (the card by default) in
    ``dtype`` (bf16 by default): the layout detector, the OCR system and
    the formula and table recognizers and the orientation classifier as
    the JAX package builds them, a stage's custom model in its place, and
    checkbox detection where the checkbox config asks for it."""
    configs = configs or {}
    for stage, cfg in configs.items():
        if isinstance(cfg, dict) and (
            "engine_cfg" in cfg or "use_cuda" in cfg or "use_cann" in cfg
        ):
            logger.warning(
                "%s config: engine_cfg/use_cuda/use_cann are reference "
                "onnxruntime knobs; ignored (the port runs on the device "
                "it is given)", stage,
            )
    custom = {stage: resolve_custom(configs.get(stage), stage)
              for stage in ("layout", "ocr", "formula", "table")}
    ocr = custom["ocr"]
    if ocr is None and not os.environ.get("RAPIDDOC_DISABLE_OCR"):
        ocr = build_ocr_system(configs.get("ocr"), lang=lang, device=device, dtype=dtype)
    layout = custom["layout"] or build_layout_model(configs.get("layout"), device=device,
                                                    dtype=dtype)
    formula = (custom["formula"] or build_formula_model(configs.get("formula"), device=device,
                                                        dtype=dtype)
               if formula_enable else None)
    table = (custom["table"] or build_table_model(configs.get("table"), device=device,
                                                  dtype=dtype)
             if table_enable else None)
    checkbox_cfg = configs.get("checkbox") or {}
    return DocumentAnalyzer(
        layout_model=layout, ocr_system=ocr, formula_model=formula, table_model=table,
        orientation_model=build_orientation_model(device=device, dtype=dtype),
        formula_enable=formula_enable, table_enable=table_enable,
        checkbox_enable=checkbox_cfg.get("checkbox_enable", checkbox_cfg.get("enable", False)),
    )
