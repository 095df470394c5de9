"""Model registry of the port: builds the model stack from the demo
checkpoints.

Port of the demo branch of ``build_ocr_system``
(``rapiddoc_tpu/models/registry.py:72-158``): DBNet and SVTRRec with
``ocr_det_demo.npz`` / ``ocr_rec_demo.npz`` (read in place from the JAX
package's asset directory, as data files), the demo charset, and
contrast stretch on. ``charset_path`` swaps in another dictionary, such
as the published 18,710-entry ``ppocrv6_small_dict.txt``; the head is
then random-init (from ``HEAD_SEED``) at that width over the demo
backbone and neck.

``build_formula_recognizer`` is the demo branch of
``FormulaRecognizer.build`` (``rapiddoc_tpu/models/formula/engine.py:197-236``):
``formula_demo.npz`` + ``formula_demo.json`` (PPHGNetV2-B0 encoder, a
2-layer MBart decoder at the published widths, 57 tokens).

``build_layout_model``, ``build_formula_model``, ``build_table_model``
and ``build_analyzer`` are the JAX package's (``registry.py:161-260``):
the layout detector (``LayoutDetector.build``: a published npz, or the
demo checkpoint under ``RAPIDDOC_DEMO_LAYOUT``) or None where its
checkpoint is missing, the formula recognizer, the table recognizer
(``TableRecognizer.build``: the demo checkpoints, no OCR system inside
tables), the OCR system and the document analyzer around them.
Orientation, checkboxes, custom models, other languages, published OCR
checkpoints and the OCR and layout knobs the port runs only at their
defaults raise NotImplementedError naming their ROADMAP item.
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
from ..utils.unported import not_ported
from .formula.engine import DemoFormulaVocab, FormulaConfig, FormulaRecognizer
from .layout.engine import LayoutDetector
from .ocr.det import DBNet
from .ocr.engine import TextDetector, TextRecognizer, TextSystem
from .ocr.pre_post import CTCLabelDecoder
from .ocr.rec import SVTRRec
from .table.engine import TableRecognizer
from .weights import load_flax_into, load_npz

PUBLISHED_DICT = DEMO_ASSETS_DIR / "ppocrv6_small_dict.txt"

# printable ASCII without space (space is the implicit final vocab entry
# of CTCLabelDecoder), as rapiddoc_tpu/train/synth.py:55 defines it
DEMO_CHARSET = [c for c in string.printable[:94] if c != " "]
# seed of the random-init head that goes with a dictionary of charset_path
HEAD_SEED = 0

logger = get_logger("rapiddoc_tpu_torch.registry")


def build_ocr_system(
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
    charset_path: str | Path | None = None,
) -> TextSystem:
    """The OCR system on ``device`` (the card by default) in ``dtype``
    (bf16 by default)."""
    det = load_flax_into(DBNet(), load_npz(DEMO_ASSETS_DIR / "ocr_det_demo.npz"))
    rec_flat = load_npz(DEMO_ASSETS_DIR / "ocr_rec_demo.npz")
    if charset_path is None:
        decoder = CTCLabelDecoder(DEMO_CHARSET)
        rec = load_flax_into(SVTRRec(num_classes=len(decoder.chars)), rec_flat)
    else:
        decoder = CTCLabelDecoder.from_file(str(charset_path))
        rec = load_flax_into(
            SVTRRec(num_classes=len(decoder.chars)), rec_flat, skip=("head",)
        )
        rng = np.random.default_rng(HEAD_SEED)
        c, v = rec.head.kernel.shape
        with torch.no_grad():
            rec.head.kernel.copy_(torch.from_numpy(
                (rng.standard_normal((c, v)) / np.sqrt(c)).astype(np.float32)
            ))
            rec.head.bias.zero_()
    return TextSystem(
        TextDetector(det, device=device, dtype=dtype),
        TextRecognizer(rec, decoder, device=device, dtype=dtype),
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
    """The demo formula recognizer, or None under RAPIDDOC_DISABLE_FORMULA.
    A published checkpoint under the models dir raises: its HF tokenizer
    is not ported."""
    if os.environ.get("RAPIDDOC_DISABLE_FORMULA"):
        return None
    if (get_models_dir() / "formula_net_plus_m.npz").is_file():
        raise not_ported("the published formula checkpoint and its tokenizer", "checkpoints")
    return build_formula_recognizer(device=device, dtype=dtype)


def build_table_model(configs: dict | None = None, device=None,
                      dtype: torch.dtype | None = None) -> TableRecognizer | None:
    """The table recognizer, or None under RAPIDDOC_DISABLE_TABLE."""
    if os.environ.get("RAPIDDOC_DISABLE_TABLE"):
        return None
    return TableRecognizer.build(configs or {}, device=device, dtype=dtype)


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
    the formula and table recognizers as the JAX package builds them.
    Raises NotImplementedError, naming its ROADMAP item, where the JAX
    package would build a stage the port does not have yet: custom
    models, orientation, checkboxes, other languages, published OCR
    checkpoints and the knobs the port runs only at their defaults."""
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
        if isinstance(cfg, dict) and cfg.get("custom_model") is not None:
            raise not_ported(f"a custom {stage} model", "host_families")
    if env_bool("USE_DOC_ORIENTATION_CLASSIFY") or os.environ.get(
        "USE_DOC_ORIENTATION_CLASSIFY", ""
    ).lower() in ("1", "true", "yes"):
        raise not_ported("the orientation classifier", "orientation_seal")
    checkbox_cfg = configs.get("checkbox") or {}
    if checkbox_cfg.get("checkbox_enable", checkbox_cfg.get("enable", False)):
        raise not_ported("checkbox detection", "host_families")
    ocr = None
    if not os.environ.get("RAPIDDOC_DISABLE_OCR"):
        ocr_cfg = configs.get("ocr") or {}
        if lang not in ("ch", "en", "", None):
            raise not_ported(f"OCR for lang={lang!r}", "ocr_family")
        if int(ocr_cfg.get("Det.limit_side_len", 960)) != 960 or os.environ.get(
            "RAPIDDOC_CONTRAST_STRETCH"
        ) is not None:
            raise not_ported("the OCR knobs", "ocr_family")
        models_dir = get_models_dir()
        if any((models_dir / f).is_file() for f in ("ocr_det_v6_small.npz", "ocr_rec_v6_small.npz")):
            raise not_ported(f"published OCR checkpoints in {models_dir}", "ocr_family")
        ocr = build_ocr_system(device=device, dtype=dtype)
    layout = build_layout_model(configs.get("layout"), device=device, dtype=dtype)
    formula = (build_formula_model(configs.get("formula"), device=device, dtype=dtype)
               if formula_enable else None)
    table = (build_table_model(configs.get("table"), device=device, dtype=dtype)
             if table_enable else None)
    return DocumentAnalyzer(
        layout_model=layout, ocr_system=ocr, formula_model=formula, table_model=table,
        formula_enable=formula_enable, table_enable=table_enable,
    )
