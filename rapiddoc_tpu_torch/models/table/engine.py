"""Table recognition engine: cls -> wired (UNet) / wireless (SLANet_plus or
UNITABLE) -> HTML.

Port of ``rapiddoc_tpu/models/table/engine.py``: ``STRATEGIES``,
``TableConfig``, ``TableRecognizer`` with ``build`` (:82),
``batch_predict`` (:159), ``_finish_wired``, ``_fill_text`` and
``_cell_texts``. Crops are whited out under in-table images, routed by
the classifier (or the rule-based kind), and each half runs batched;
``use_compare_table`` arbitrates through ``select_best_table_html``, and
a wired crop the UNet found no cells in goes to the ruling-line
extractor (``img2table.py``). Recognized in-table formulas (``mfd``) and
image placeholders (``fill``) land in their cells.

The JAX package's main path builds the recognizer without an OCR system
(``TableRecognizer.build`` passes none), so every cell holds only
injected formulas and image placeholders; so does the port's. An OCR
system inside tables (word boxes, rotation detection, the borderless
extract, the blank-cell retry) raises NotImplementedError (ROADMAP
Queue 1 item 7), as do published table checkpoints (item 17) and the
published ONNX models (item 13).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...config import DEMO_ASSETS_DIR, get_models_dir
from ...utils.logging import get_logger
from ...utils.unported import not_ported
from ..weights import load_flax_into, load_npz, nest_models, random_init
from .cls import TableClassifier, TableClsNet, heuristic_table_kind
from .matcher import build_html_from_grid, html_from_structure_tokens, match_ocr_to_cells
from .select import normalize_cell_text, select_best_table_html
from .slanet import SLANetConfig, SLANetModel, SLANetStructure, SLANetVocab
from .unet import UNet, WiredTableStructure
from .unitable import UniTableDims, UniTableModel, UniTableStructure, dims_from_variables

logger = get_logger("rapiddoc_tpu_torch.table")

# Composite strategies (reference: rapid_doc/model/table/rapid_table.py:46-96
# — UNET_SLANET_PLUS default, UNET_UNITABLE, plus single-model modes). The
# first element is the wired model ("unet" or None), the second the wireless
# model ("slanet" / "unitable" or None).
STRATEGIES = {
    "unet_slanet_plus": ("unet", "slanet"),
    "unet_unitable": ("unet", "unitable"),
    "slanet_plus": (None, "slanet"),
    "unitable": (None, "unitable"),
    "unet": ("unet", None),
}

# the published checkpoints the JAX package reads from the models dir
PUBLISHED_NPZ = tuple(f"table_{k}.npz" for k in ("unet", "unitable", "slanet", "cls"))
PUBLISHED_ONNX = ("unet.onnx", "paddle_cls.onnx", "q_cls.onnx", "slanet-plus.onnx")


@dataclass
class TableConfig:
    strategy: str = "unet_slanet_plus"
    use_cls_model: bool = False  # heuristic until trained cls weights exist
    wireless_max_len: int = 256
    use_img2table: bool = True  # ruling-line fallback for wired
    # run BOTH structure models and arbitrate (reference:
    # rapid_table.py use_compare_table + select_best_table_model)
    use_compare_table: bool = False


def _model(module: torch.nn.Module, flat: dict | None, rng: np.random.Generator):
    """``module`` with the flax leaves of ``flat`` loaded, or random-init
    from ``rng`` when there are none."""
    if flat is None:
        random_init(module, rng)
        return module
    return load_flax_into(module, flat)


class TableRecognizer:
    """``variables`` maps ``cls``, ``unet``, ``slanet`` and ``unitable``
    to flat flax leaves (the demo npz layout); a missing model is
    random-init from ``seed``. Runs on ``device`` (the card by default)
    in ``dtype`` (bf16 by default)."""

    def __init__(self, config: TableConfig | None = None, ocr_system=None,
                 variables: dict | None = None, *, device=None,
                 dtype: torch.dtype | None = None, seed: int = 0):
        if ocr_system is not None:
            raise not_ported(
                "OCR inside tables (word boxes, rotation detection, the borderless "
                "extract, the blank-cell retry)", "ocr_family")
        self.config = config or TableConfig()
        if self.config.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown table strategy {self.config.strategy!r}; "
                f"one of {sorted(STRATEGIES)}"
            )
        wired_kind, wireless_kind = STRATEGIES[self.config.strategy]
        variables = variables or {}
        rng = np.random.default_rng(seed)
        on = {"device": device, "dtype": dtype}
        self.classifier = (
            TableClassifier(_model(TableClsNet(), variables.get("cls"), rng), **on)
            if self.config.use_cls_model else None
        )
        self.wired = (
            WiredTableStructure(_model(UNet(), variables.get("unet"), rng), **on)
            if wired_kind == "unet" else None
        )
        if wireless_kind == "unitable":
            flat = variables.get("unitable")
            dims = dims_from_variables(flat) if flat is not None else UniTableDims()
            model = _model(UniTableModel(dims), None if flat is None else nest_models(flat), rng)
            self.wireless = UniTableStructure(model, **on)
        elif wireless_kind == "slanet":
            flat = variables.get("slanet")
            model = _model(SLANetModel(SLANetConfig(), len(SLANetVocab())),
                           None if flat is None else nest_models(flat), rng)
            self.wireless = SLANetStructure(model, **on)
        else:
            self.wireless = None
        self.ocr = None

    @classmethod
    def build(cls, configs: dict, device=None,
              dtype: torch.dtype | None = None) -> "TableRecognizer":
        """The JAX package's ``TableRecognizer.build`` with the in-repo
        demo checkpoints (``table_{cls,unet,slanet,unitable}_demo.npz``,
        read in place) and no OCR system. Published checkpoints in the
        models dir raise NotImplementedError."""
        models_dir = get_models_dir()
        for name in PUBLISHED_NPZ + ("unitable_vocab.json",):
            if (models_dir / name).is_file():
                raise not_ported(f"the published table checkpoint {name}", "checkpoints")
        for name in PUBLISHED_ONNX:
            if (models_dir / name).is_file():
                raise not_ported(f"the published ONNX table model {name}", "sniff")
        strategy = configs.get("strategy", "unet_slanet_plus")
        wired_kind, wireless_kind = STRATEGIES.get(strategy, (None, None))
        variables = {
            key: load_npz(DEMO_ASSETS_DIR / f"table_{key}_demo.npz")
            for key in ("cls", wired_kind, wireless_kind) if key is not None
        }
        logger.info("table: demo synthetic-trained checkpoints %s", sorted(variables))
        config = TableConfig(
            strategy=strategy,
            use_cls_model=True,
            wireless_max_len=configs.get("wireless_max_len", 256),
            use_img2table=configs.get("use_img2table", True),
            use_compare_table=configs.get("use_compare_table", False),
        )
        return cls(config, variables=variables, device=device, dtype=dtype)

    def kinds(self, crops: list[np.ndarray]) -> list[str]:
        """'wired' or 'wireless' per crop, as ``batch_predict`` routes it."""
        if self.wired is None:
            return ["wireless"] * len(crops)
        if self.wireless is None:
            return ["wired"] * len(crops)
        if self.classifier is not None:
            return self.classifier(crops)
        return [heuristic_table_kind(c) for c in crops]

    def batch_predict(
        self, crops: list[np.ndarray],
        mfd_items: list[list[tuple[list[float], str]]] | None = None,
        fill_items: list[list[tuple[list[float], str]]] | None = None,
    ) -> list[str]:
        """Table crops -> HTML strings. `mfd_items[i]` carries recognized
        formulas inside crop i as (bbox-in-crop, latex); they go to the
        cells they overlap (reference: rapid_table.py:180-213 in-table
        formula injection). `fill_items[i]` carries in-table images as
        (bbox-in-crop, uuid placeholder): the region is whited out before
        recognition and the uuid lands in its cell, resolved to an <img>
        tag at save time (reference: rapid_table.py:180-196
        fill_image_res)."""
        if not crops:
            return []
        mfd = mfd_items or [[] for _ in crops]
        fill = fill_items or [[] for _ in crops]
        if any(fill):
            crops = list(crops)
            for i, fills in enumerate(fill):
                if not fills:
                    continue
                crop = crops[i].copy()
                h, w = crop.shape[:2]
                for bbox, _uid in fills:
                    x0, y0 = max(int(bbox[0]), 0), max(int(bbox[1]), 0)
                    x1, y1 = min(int(bbox[2]) + 1, w), min(int(bbox[3]) + 1, h)
                    if x1 > x0 and y1 > y0:
                        crop[y0:y1, x0:x1] = 255
                crops[i] = crop
        kinds = self.kinds(crops)
        results = [""] * len(crops)
        wired_idx = [i for i, k in enumerate(kinds) if k == "wired"]
        wireless_idx = [i for i, k in enumerate(kinds) if k == "wireless"]
        compare = (
            self.config.use_compare_table
            and self.wired is not None
            and self.wireless is not None
        )
        if compare:
            wired_idx = list(range(len(crops)))
            wireless_idx = list(range(len(crops)))
        if wired_idx:
            wired_structs = self.wired.batch([crops[i] for i in wired_idx])
            for i, (cell_boxes, grid) in zip(wired_idx, wired_structs):
                results[i] = self._finish_wired(crops[i], cell_boxes, grid, mfd[i], fill[i])
        if wireless_idx:
            structures = self.wireless(
                [crops[i] for i in wireless_idx],
                max_len=self.config.wireless_max_len,
            )
            for i, (structure, bboxes) in zip(wireless_idx, structures):
                wireless_html = self._fill_text(structure, bboxes, mfd[i], fill[i])
                if compare:
                    # no OCR texts inside tables (see the module docstring)
                    results[i] = select_best_table_html([], results[i], wireless_html)
                else:
                    results[i] = wireless_html
        return results

    # ------------------------------------------------------------- wired

    def _finish_wired(self, crop: np.ndarray, cell_boxes: list, grid: list,
                      mfd: list, fill: list) -> str:
        if not cell_boxes and self.config.use_img2table:
            # model-free ruling-line fallback (reference:
            # rapid_table.py:219-249 img2table path)
            from .img2table import opencv_table_extract

            cell_boxes, grid = opencv_table_extract(crop)
        if not cell_boxes:
            return ""
        return build_html_from_grid(grid, self._cell_texts(cell_boxes, mfd, fill))

    def _fill_text(self, structure: list[str], bboxes: list[list[float]],
                   mfd: list, fill: list) -> str:
        if not structure:
            return ""
        texts = self._cell_texts(bboxes, mfd, fill) if bboxes else []
        return html_from_structure_tokens(structure, texts)

    @staticmethod
    def _cell_texts(cell_boxes: list[list[float]], mfd: list, fill: list) -> list[str]:
        """Distribute the in-table formulas (as $latex$) and image
        placeholders into cells (reference: analyze_utils.py:491-527)."""
        if not cell_boxes:
            return []
        if not mfd and not fill:
            return [""] * len(cell_boxes)
        items = [{"bbox": list(box), "text": f"${latex}$"} for box, latex in mfd]
        # uuid placeholder lands verbatim; resolved to <img> at save time
        items += [{"bbox": list(box), "text": uid, "raw": True} for box, uid in fill]
        assignments = match_ocr_to_cells(cell_boxes, items)
        out = []
        for idxs in assignments:
            frags = [items[i]["text"] for i in idxs]
            # CJK fragments join without separator, latin with space
            if frags and all(
                all(ord(c) > 0x2E80 for c in f) for f in frags if f
            ):
                out.append(normalize_cell_text("".join(frags)))
            else:
                out.append(normalize_cell_text(" ".join(frags)))
        return out
