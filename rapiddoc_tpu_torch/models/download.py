"""Model asset registry + SHA256-verified downloader.

Port of ``rapiddoc_tpu/models/download.py``: the same ``REGISTRY`` of
published checkpoints (URLs and SHA256 pins, mirrored from the
reference's per-stack default_models.yaml), downloaded with ``urllib`` in
place of ``requests``. A download goes to ``<name>.part``, is checked
against its pin, and only then renamed into the models dir; a failed one
removes the ``.part`` file. ``rapiddoc_tpu_torch.tools.convert_weights``
turns torch assets into the npz trees the port loads; ONNX assets run
through ``engine/onnx_torch.py`` as they are. In environments with no
network egress the downloader reports clearly instead of hanging.
"""
from __future__ import annotations

import hashlib
import http.client
import urllib.error
import urllib.request
from dataclasses import dataclass
from pathlib import Path

from ..config import get_models_dir
from ..utils.logging import get_logger

logger = get_logger("rapiddoc_tpu_torch.download")


@dataclass(frozen=True)
class ModelAsset:
    name: str            # local file name under the models dir
    url: str             # source checkpoint (torch/safetensors/onnx)
    sha256: str | None   # pin; None only where the reference publishes none
    converter: str | None  # convert_weights entry; None = used as-is
    # (.onnx assets run directly through engine/onnx_torch.py)


_MS = "https://www.modelscope.cn/models/RapidAI"

# Published checkpoints + SHA256 pins, mirrored from the reference
# registries (reference: rapid_doc/model/layout/rapid_layout_self/configs/
# default_models.yaml, rapid_doc/model/table/rapid_table_self/
# default_models.yaml, rapid_doc/model/formula/rapid_formula_self/configs/
# default_models.yaml). ONNX assets run through the port's ONNX interpreter;
# torch assets convert to npz trees via convert_weights.
REGISTRY: dict[str, ModelAsset] = {
    # ---- OCR (torch safetensors; the reference bundles these in its
    # wheel resources/, no published SHA — reference rapid_ocr.py:110-120)
    "ocr_det_v6_small": ModelAsset(
        "ch_PP-OCRv6_det_small.safetensors",
        f"{_MS}/RapidOCR/resolve/master/torch/PP-OCRv6/det/"
        "ch_PP-OCRv6_det_small.safetensors",
        None,
        "det",
    ),
    "ocr_rec_v6_small": ModelAsset(
        "ch_PP-OCRv6_rec_small.safetensors",
        f"{_MS}/RapidOCR/resolve/master/torch/PP-OCRv6/rec/"
        "ch_PP-OCRv6_rec_small.safetensors",
        None,
        "rec",
    ),
    # ---- formula (torch .pth + tokenizer dict yaml)
    "formula_net_plus_m": ModelAsset(
        "pp_formulanet_plus_m.pth",
        f"{_MS}/RapidDoc/resolve/master/formula/PP-FormulaNet_plus-M/"
        "pp_formulanet_plus_m.pth",
        "034efee70ef56d8ab7cf3b9b945865cdaf22461ad03b0f6e68bf9234f167f035",
        "formula",
    ),
    "formula_dict": ModelAsset(
        "pp_formulanet_plus_m_inference.yml",
        f"{_MS}/RapidDoc/resolve/master/formula/PP-FormulaNet_plus-M/"
        "pp_formulanet_plus_m_inference.yml",
        None,
        "formula_dict",
    ),
    # ---- layout (published ONNX; run via the ONNX interpreter)
    "layout_v3": ModelAsset(
        "pp_doclayoutv3.onnx",
        f"{_MS}/RapidDoc/resolve/master/layout/PP-DocLayoutV3/"
        "pp_doclayoutv3.onnx",
        "b9a2759e51ee2cc9d98f10cea21caf5862043b882b5f57c683eaf6fa247196a3",
        None,
    ),
    "layout_v2": ModelAsset(
        "pp_doclayoutv2.onnx",
        f"{_MS}/RapidDoc/resolve/master/layout/PP-DocLayoutV2/"
        "pp_doclayoutv2.onnx",
        "9fedca3a2ebfdce73fc36f7842a4cabe0a4fe8c0ee33a446ca358ed500907b29",
        None,
    ),
    "layout_plus_l": ModelAsset(
        "pp_doclayout_plus_l.onnx",
        f"{_MS}/RapidDoc/resolve/v1.0.0/layout/PP-DocLayout_plus-L/"
        "pp_doclayout_plus_l.onnx",
        "3e0a48f1eead902e83e04695430597e92207ef50e19b06bdf65f46096ba6bbd3",
        None,
    ),
    "layout_l": ModelAsset(
        "pp_doclayout_l.onnx",
        f"{_MS}/RapidDoc/resolve/v1.0.0/layout/PP-DocLayout-L/"
        "pp_doclayout_l.onnx",
        "116d4a65052187be1ed408d6286fc5a5a07de361a1c85969d633d7ca56a73c05",
        None,
    ),
    "layout_m": ModelAsset(
        "pp_doclayout_m.onnx",
        f"{_MS}/RapidDoc/resolve/v1.0.0/layout/PP-DocLayout-M/"
        "pp_doclayout_m.onnx",
        "2e5997712f69e2db59e78fc837e0e3ee9e71cba4d41fa57125e438950f37196d",
        None,
    ),
    "layout_s": ModelAsset(
        "pp_doclayout_s.onnx",
        f"{_MS}/RapidDoc/resolve/v1.0.0/layout/PP-DocLayout-S/"
        "pp_doclayout_s.onnx",
        "0ae97252feb0d64ee2c70ee0449ec9de4b08140056f32ce3c725c16ca50142e4",
        None,
    ),
    "layout_docstructbench": ModelAsset(
        "doclayout_docstructbench.onnx",
        f"{_MS}/RapidLayout/resolve/v1.0.0/onnx/doclayout/"
        "doclayout_yolo_docstructbench_imgsz1024.onnx",
        "3b452baef10ecabd615491bc82cc4d49475fbc2cd7a8e535044f2c6bb28fb9fe",
        None,
    ),
    "table_cell_det_wired": ModelAsset(
        "rt_detr_l_wired_table_cell_det.onnx",
        f"{_MS}/RapidDoc/resolve/v1.0.0/table/RT-DETR-L_wired_table_cell_det/"
        "rt_detr_l_wired_table_cell_det.onnx",
        "d0996593ce241ecc4ea08811a858a2ac1a7e438e3260f98562010fd8efc6951e",
        None,
    ),
    "table_cell_det_wireless": ModelAsset(
        "rt_detr_l_wireless_table_cell_det.onnx",
        f"{_MS}/RapidDoc/resolve/v1.0.0/table/"
        "RT-DETR-L_wireless_table_cell_det/"
        "rt_detr_l_wireless_table_cell_det.onnx",
        "3085db96c666ac5dfb9ae52b119ac4fa739f4a320c71c51fda28bd7fd700807e",
        None,
    ),
    # ---- tables
    "table_unitable_encoder": ModelAsset(
        "unitable/encoder.pth",
        f"{_MS}/RapidTable/resolve/v2.0.0/unitable/encoder.pth",
        "2c66b3c6a3d1c86a00985bab2cd79412fc2b668ff39d338bc3c63d383b08684d",
        "unitable",
    ),
    "table_unitable_decoder": ModelAsset(
        "unitable/decoder.pth",
        f"{_MS}/RapidTable/resolve/v2.0.0/unitable/decoder.pth",
        "fa342ef3de259576a01a5545ede804208ef35a124935e30df4768e6708dcb6cb",
        "unitable",
    ),
    "table_unitable_vocab": ModelAsset(
        "unitable/vocab.json",
        f"{_MS}/RapidTable/resolve/v2.0.0/unitable/vocab.json",
        "05037d02c48d106639bc90284aa847e5e2151d4746b3f5efe1628599efbd668a",
        "unitable",
    ),
    "table_slanet_plus": ModelAsset(
        "slanet-plus.onnx",
        f"{_MS}/RapidTable/resolve/v2.0.0/slanet-plus.onnx",
        "d57a942af6a2f57d6a4a0372573c696a2379bf5857c45e2ac69993f3b334514b",
        None,
    ),
    "table_unet": ModelAsset(
        "unet.onnx",
        f"{_MS}/RapidTable/resolve/master/unet.onnx",
        "0ea48d3a17e35ef5c2e498a5e799566073234d39b1079ca21d9f4fafe73c6d20",
        None,
    ),
    "table_paddle_cls": ModelAsset(
        "paddle_cls.onnx",
        f"{_MS}/RapidTable/resolve/master/table_cls/paddle_cls.onnx",
        "21c801f0c403cf960f9f1ccaecf506585b3b98421208033755b9e67cd2371492",
        None,
    ),
    "table_q_cls": ModelAsset(
        "q_cls.onnx",
        f"{_MS}/RapidTable/resolve/master/table_cls/q_cls.onnx",
        "ef940037471c49f5d35ba2b1d9df9a19eabddf03f1689026d2a5bcab5efe577b",
        None,
    ),
    # ---- orientation + seal det (bundled in the reference wheel
    # resources/, published via the RapidAI modelscope repos; no SHA in
    # the reference tree)
    "orientation_cls": ModelAsset(
        "rapid_orientation.onnx",
        f"{_MS}/RapidStructure/resolve/master/rapid_orientation.onnx",
        None,
        None,
    ),
    "seal_det": ModelAsset(
        "pp-ocrv4_mobile_seal_det.onnx",
        f"{_MS}/RapidOCR/resolve/master/onnx/PP-OCRv4/det/"
        "pp-ocrv4_mobile_seal_det.onnx",
        None,
        None,
    ),
    # ---- rec character dict (the reference ships it in its wheel
    # resources/; reference rapid_ocr.py:119-120)
    "ocr_dict_v6_small": ModelAsset(
        "ppocrv6_small_dict.txt",
        "https://github.com/RapidAI/RapidDoc/raw/main/rapid_doc/resources/"
        "ppocrv6_small_dict.txt",
        None,
        "dict",
    ),
}


def sha256_of(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_asset(key: str, force: bool = False) -> Path:
    asset = REGISTRY[key]
    target = get_models_dir() / asset.name
    if target.is_file() and not force:
        if asset.sha256 and sha256_of(target) != asset.sha256:
            raise RuntimeError(f"{target} fails SHA256 pin; re-download with force")
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(target.suffix + ".part")
    logger.info("downloading %s -> %s", asset.url, target)
    try:
        with urllib.request.urlopen(asset.url, timeout=60) as resp, open(tmp, "wb") as f:
            for chunk in iter(lambda: resp.read(1 << 20), b""):
                f.write(chunk)
            if resp.length:  # the body ended before its Content-Length
                raise http.client.IncompleteRead(b"", resp.length)
    except (urllib.error.URLError, http.client.HTTPException, OSError, ValueError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"cannot download {key}: {e}. This environment may have no "
            f"network egress — place {asset.name} under {get_models_dir()} "
            f"manually, then run rapiddoc_tpu_torch.tools.convert_weights."
        ) from e
    if asset.sha256 and sha256_of(tmp) != asset.sha256:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"SHA256 mismatch for {key}")
    tmp.rename(target)
    return target


def download_and_convert(key: str, force: bool = False) -> Path:
    """Fetch one asset and run its converter; returns the path the
    runtime will load (npz for torch assets, the file itself for
    onnx/dict assets)."""
    asset = REGISTRY[key]
    path = download_asset(key, force=force)
    if asset.converter is None:
        return path
    from ..tools.convert_weights import CONVERTERS

    return CONVERTERS[asset.converter](path)


def main(argv: list[str] | None = None) -> int:
    """python -m rapiddoc_tpu_torch.models.download [key ...] [--force]

    No keys = the full registry. Each asset downloads (SHA256-pinned),
    converts to the runtime format, and reports; failures don't stop the
    rest (zero-egress boxes get a clear per-asset message instead of a
    dead run). Exit code = number of failed assets."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    force = "--force" in argv
    keys = [a for a in argv if not a.startswith("-")] or list(REGISTRY)
    failed = 0
    for key in keys:
        if key not in REGISTRY:
            logger.error("unknown asset %r (known: %s)", key,
                         ", ".join(REGISTRY))
            failed += 1
            continue
        try:
            path = download_and_convert(key, force=force)
            logger.info("%s ready: %s", key, path)
        except Exception as e:
            logger.error("%s FAILED: %s", key, e)
            failed += 1
    return failed


if __name__ == "__main__":
    raise SystemExit(main())
