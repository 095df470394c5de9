"""Checkpoint conversion: published torch checkpoints -> npz trees.

Usage:
    python -m rapiddoc_tpu_torch.tools.convert_weights det /path/to/det.safetensors
    python -m rapiddoc_tpu_torch.tools.convert_weights rec /path/to/rec.safetensors
    python -m rapiddoc_tpu_torch.tools.convert_weights formula /path/to/formula.pth
    python -m rapiddoc_tpu_torch.tools.convert_weights formula_dict /path/to/inference.yml
    python -m rapiddoc_tpu_torch.tools.convert_weights unitable /path/to/unitable/encoder.pth
    python -m rapiddoc_tpu_torch.tools.convert_weights dict /path/to/dict.txt

An optional third argument names the output file. Converted trees land
in the models dir (config.get_models_dir()) where the registry picks
them up. Port of ``rapiddoc_tpu/tools/convert_weights.py``: the same
converters, targets, arguments and exit codes (2 for a usage error, 1
for a missing checkpoint), and the same npz the JAX package writes.
``.pth`` files are read with ``torch.load`` (a ``state_dict`` entry
unwrapped), ``.safetensors`` with ``utils/safetensors.py`` and the
inference yml with ``utils/yaml_subset.py``, in place of the
``safetensors`` and PyYAML packages.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

from ..config import get_models_dir
from ..models.weights import save_variables
from ..utils import safetensors, yaml_subset
from ..utils.logging import get_logger

logger = get_logger("rapiddoc_tpu_torch.convert")


def _load_torch_state(path: Path) -> dict:
    if path.suffix == ".safetensors":
        return safetensors.load_file(path)
    import torch

    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        return obj["state_dict"]
    return obj


def convert_det(src: Path, out: Path | None = None) -> Path:
    from ..models.ocr.convert import det_variables_from_torch

    variables = det_variables_from_torch(_load_torch_state(src))
    target = out or get_models_dir() / "ocr_det_v6_small.npz"
    save_variables(variables, target)
    logger.info("det weights -> %s", target)
    return target


def convert_rec(src: Path, out: Path | None = None) -> Path:
    from ..models.ocr.convert import rec_variables_from_torch

    variables = rec_variables_from_torch(_load_torch_state(src))
    target = out or get_models_dir() / "ocr_rec_v6_small.npz"
    save_variables(variables, target)
    logger.info("rec weights -> %s", target)
    return target


def convert_formula(src: Path, out: Path | None = None) -> Path:
    """Full PP-FormulaNet_plus .pth (BaseModel layout) -> npz tree: the
    PPHGNetV2-B6 encoder, enc_to_dec_proj, the 6-layer MBart decoder and
    lm_head; a bare HF-MBart decoder checkpoint converts to the decoder
    and the memory projector alone."""
    from ..models.formula.convert import (
        decoder_variables_from_torch,
        formula_variables_from_torch,
    )

    sd = _load_torch_state(src)
    if any(k.startswith("backbone.") for k in sd):
        variables = formula_variables_from_torch(sd)
    else:
        dec_vars, mem_vars = decoder_variables_from_torch(sd)
        variables = {"decoder": dec_vars, "mem_proj": mem_vars}
    target = out or get_models_dir() / "formula_net_plus_m.npz"
    save_variables(variables, target)
    logger.info("formula weights -> %s", target)
    return target


def convert_unitable(src: Path, out: Path | None = None) -> Path:
    """Published UNITABLE checkpoint dir (encoder.pth + decoder.pth +
    vocab.json), or its encoder.pth with decoder.pth beside it -> npz
    tree, and vocab.json -> unitable_vocab.json in the models dir."""
    from ..models.table.convert import unitable_variables_from_torch

    if src.is_dir():
        enc_path, dec_path = src / "encoder.pth", src / "decoder.pth"
    else:
        enc_path, dec_path = src, src.parent / "decoder.pth"
    variables = unitable_variables_from_torch(
        _load_torch_state(enc_path), _load_torch_state(dec_path)
    )
    target = out or get_models_dir() / "table_unitable.npz"
    save_variables(variables, target)
    vocab_src = (src if src.is_dir() else src.parent) / "vocab.json"
    if vocab_src.is_file():
        shutil.copy(vocab_src, get_models_dir() / "unitable_vocab.json")
    logger.info("unitable weights -> %s", target)
    return target


def convert_formula_dict(src: Path, out: Path | None = None) -> Path:
    """Published inference yml -> formula_tokenizer.json: the UniMERNet
    tokenizer is embedded in the yml under
    PostProcess.character_dict.fast_tokenizer_file."""
    data = yaml_subset.safe_load(src.read_text(encoding="utf-8"))
    tok = data["PostProcess"]["character_dict"]["fast_tokenizer_file"]
    target = out or get_models_dir() / "formula_tokenizer.json"
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(tok), encoding="utf-8")
    logger.info("formula tokenizer -> %s", target)
    return target


def convert_dict(src: Path, out: Path | None = None) -> Path:
    """Install a rec character dict (plain copy into the models dir)."""
    target = out or get_models_dir() / src.name
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, target)
    logger.info("dict -> %s", target)
    return target


CONVERTERS = {
    "det": convert_det,
    "rec": convert_rec,
    "formula": convert_formula,
    "formula_dict": convert_formula_dict,
    "unitable": convert_unitable,
    "dict": convert_dict,
}


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2 or argv[0] not in CONVERTERS:
        print(__doc__)
        return 2
    kind, src = argv[0], Path(argv[1])
    if not src.is_file():
        print(f"checkpoint not found: {src}")
        return 1
    out = Path(argv[2]) if len(argv) > 2 else None
    CONVERTERS[kind](src, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
