"""Model registry of the port: builds the OCR system and the formula
recognizer from the demo checkpoints.

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
"""
from __future__ import annotations

import json
import string
from pathlib import Path

import numpy as np
import torch

from .formula.engine import DemoFormulaVocab, FormulaConfig, FormulaRecognizer
from .ocr.det import DBNet
from .ocr.engine import TextDetector, TextRecognizer, TextSystem
from .ocr.pre_post import CTCLabelDecoder
from .ocr.rec import SVTRRec
from .weights import load_flax_into, load_npz

DEMO_ASSETS_DIR = Path(__file__).resolve().parents[2] / "rapiddoc_tpu" / "assets"
PUBLISHED_DICT = DEMO_ASSETS_DIR / "ppocrv6_small_dict.txt"

# printable ASCII without space (space is the implicit final vocab entry
# of CTCLabelDecoder), as rapiddoc_tpu/train/synth.py:55 defines it
DEMO_CHARSET = [c for c in string.printable[:94] if c != " "]
# seed of the random-init head that goes with a dictionary of charset_path
HEAD_SEED = 0


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
