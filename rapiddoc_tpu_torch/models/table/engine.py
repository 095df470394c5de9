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

With an OCR system (``TableRecognizer(ocr_system=...)``, as in the JAX
package), portrait crops with vertical text are turned upright first
(``detect_table_rotations``, one batched det call), every crop goes
through one batched word-box OCR call, and each cell gets the words (or
lines) it holds, CJK fragments joined without a space; blank wired cells
can get a focused retry (``enable_blank_cell_rec``), ``use_compare_table``
arbitrates with the OCR texts, and a table every model left empty gets
the borderless extract from its OCR boxes. The JAX package's fallbacks
around a failing OCR call stay for a custom OCR object; an error of the
port's own ``TextSystem`` is raised (``fallbacks`` counts the fallbacks
taken).

The JAX package's main path builds the recognizer without an OCR system
(``TableRecognizer.build`` passes none), so every cell holds only
injected formulas and image placeholders; so does the port's. Published
table npz checkpoints raise NotImplementedError (ROADMAP Queue 1 item
17); the published ONNX models (``onnx_models.py``) are built where the
JAX package builds them, for a model no checkpoint provides.
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
from .onnx_models import OnnxTableClassifier, OnnxWiredTableStructure, OnnxWirelessStructure
from .select import detect_table_rotations, normalize_cell_text, select_best_table_html
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
    # rotate portrait crops whose text is vertical before recognition
    detect_rotation: bool = True
    # focused per-cell OCR retry on blank wired cells (reference:
    # rapid_table.py:36,99 enable_blank_cell_rec, default off)
    enable_blank_cell_rec: bool = False


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
        self.ocr = ocr_system
        self.fallbacks = 0  # OCR failures a fallback absorbed (custom OCR only)

    @classmethod
    def build(cls, configs: dict, device=None,
              dtype: torch.dtype | None = None) -> "TableRecognizer":
        """The JAX package's ``TableRecognizer.build``, in its order: the
        in-repo demo checkpoints (``table_{cls,unet,slanet,unitable}_demo.npz``,
        read in place) where no published npz is (published npz files
        raise NotImplementedError, ROADMAP Queue 1 item 17), then a
        published ONNX model (``onnx_models.py``, the ONNX interpreter on
        the same device, in float32) only for a model that is still
        missing; no OCR system. With the demo checkpoints in the
        repository, ONNX table models in the models dir change nothing,
        as in the JAX package."""
        models_dir = get_models_dir()
        for name in PUBLISHED_NPZ + ("unitable_vocab.json",):
            if (models_dir / name).is_file():
                raise not_ported(f"the published table checkpoint {name}", "checkpoints")
        strategy = configs.get("strategy", "unet_slanet_plus")
        wired_kind, wireless_kind = STRATEGIES.get(strategy, (None, None))
        # in-repo demo checkpoints trained on synthetic tables
        demos = {key: DEMO_ASSETS_DIR / f"table_{key}_demo.npz"
                 for key in ("unet", "slanet", "cls", "unitable")}
        present = {key for key, path in demos.items() if path.is_file()}
        variables = {
            key: load_npz(demos[key])
            for key in ("cls", wired_kind, wireless_kind) if key in present
        }
        logger.info("table: demo synthetic-trained checkpoints %s", sorted(variables))
        unet_onnx, paddle_cls, q_cls, slanet_onnx = (models_dir / n for n in PUBLISHED_ONNX)
        has_onnx = any(p.is_file() for p in (unet_onnx, paddle_cls, q_cls, slanet_onnx))
        if not present and not has_onnx and not configs.get("allow_random_init", False):
            raise FileNotFoundError("table checkpoints missing")
        config = TableConfig(
            strategy=strategy,
            use_cls_model="cls" in present,
            wireless_max_len=configs.get("wireless_max_len", 256),
            use_img2table=configs.get("use_img2table", True),
            use_compare_table=configs.get("use_compare_table", False),
            detect_rotation=configs.get("detect_rotation", True),
            enable_blank_cell_rec=configs.get("enable_blank_cell_rec", False),
        )
        rec = cls(config, variables=variables, device=device, dtype=dtype)
        # published ONNX models only where a model is still missing
        if "unet" not in present and unet_onnx.is_file():
            logger.info("table: published unet.onnx via onnx_torch")
            rec.wired = OnnxWiredTableStructure(unet_onnx, device=device)
        if "slanet" not in present and slanet_onnx.is_file() and wireless_kind == "slanet":
            logger.info("table: published slanet-plus.onnx via onnx_torch")
            rec.wireless = OnnxWirelessStructure(slanet_onnx, device=device)
        if "cls" not in present and (paddle_cls.is_file() or q_cls.is_file()):
            logger.info("table: published cls .onnx via onnx_torch")
            rec.classifier = OnnxTableClassifier(
                paddle_cls if paddle_cls.is_file() else None,
                q_cls if q_cls.is_file() else None, device=device)
        return rec

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
        if self.config.detect_rotation and self.ocr is not None:
            rotate = detect_table_rotations(crops, getattr(self.ocr, "detector", None))
            crops = [
                np.ascontiguousarray(np.rot90(c, 3)) if r else c
                for c, r in zip(crops, rotate)
            ]
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
        # one batched word-box OCR call over every table crop, cached
        # locally by crop index (instance state would outlive the call)
        ocr_cache: dict[int, list] = {}
        if self.ocr is not None:
            need = sorted(set(wired_idx) | set(wireless_idx))
            ocr_cache = dict(zip(need, self._ocr([crops[i] for i in need], words=True,
                                                 default=[None] * len(need))))
        if wired_idx:
            wired_structs = self.wired.batch([crops[i] for i in wired_idx])
            for i, (cell_boxes, grid) in zip(wired_idx, wired_structs):
                results[i] = self._finish_wired(crops[i], cell_boxes, grid, mfd[i], fill[i],
                                                ocr_out=ocr_cache.get(i))
        if wireless_idx:
            structures = self.wireless(
                [crops[i] for i in wireless_idx],
                max_len=self.config.wireless_max_len,
            )
            for i, (structure, bboxes) in zip(wireless_idx, structures):
                wireless_html = self._fill_text(crops[i], structure, bboxes, mfd[i], fill[i],
                                                ocr_out=ocr_cache.get(i))
                if compare:
                    ocr_texts = self._ocr_texts(crops[i], ocr_out=ocr_cache.get(i))
                    results[i] = select_best_table_html(ocr_texts, results[i], wireless_html)
                else:
                    results[i] = wireless_html
        if self.config.use_img2table and self.ocr is not None:
            # model-free borderless fallback for tables every learned
            # model left empty (reference: rapid_table.py:219-249)
            from .img2table import borderless_table_extract

            for i, html in enumerate(results):
                if html and "<td" in html:
                    continue
                ocr_out = ocr_cache.get(i)
                if ocr_out is None:
                    ocr_out = self._ocr([crops[i]], default=[None])[0]
                    if ocr_out is None:
                        continue
                items = []
                for it in ocr_out:
                    q = np.asarray(it["box"], float).reshape(-1)
                    items.append((
                        [q[0::2].min(), q[1::2].min(), q[0::2].max(), q[1::2].max()],
                        it["text"],
                    ))
                fb = borderless_table_extract(items, crops[i].shape[:2])
                if fb:
                    results[i] = fb
        return results

    def _ocr(self, crops: list[np.ndarray], words: bool = False, default=None,
             catch: bool = True) -> list:
        """The OCR system on ``crops`` (with word boxes where asked and the
        system takes them). A custom OCR object that fails gives
        ``default`` where the JAX package catches the failure (``catch``)
        and is counted in ``fallbacks``; the port's own TextSystem
        raises."""
        from ..ocr.engine import TextSystem

        own = isinstance(self.ocr, TextSystem)
        try:
            if words:
                try:
                    return self.ocr(crops, return_word_boxes=True)
                except TypeError:  # custom OCR without word boxes
                    if own:
                        raise
                    return self.ocr(crops)
            return self.ocr(crops)
        except Exception:
            if own or not catch:
                raise
            logger.exception("table OCR failed; falling back")
            self.fallbacks += 1
            return default

    def _ocr_texts(self, crop: np.ndarray, ocr_out=None) -> list[str]:
        if ocr_out is not None:
            return [it["text"] for it in ocr_out]
        if self.ocr is None:
            return []
        out = self._ocr([crop], default=[[]])[0]
        return [it["text"] for it in out]

    # ------------------------------------------------------------- wired

    def _finish_wired(self, crop: np.ndarray, cell_boxes: list, grid: list,
                      mfd: list, fill: list, ocr_out=None) -> str:
        if not cell_boxes and self.config.use_img2table:
            # model-free ruling-line fallback (reference:
            # rapid_table.py:219-249 img2table path)
            from .img2table import opencv_table_extract

            cell_boxes, grid = opencv_table_extract(crop)
        if not cell_boxes:
            return ""
        texts = self._cell_texts(crop, cell_boxes, mfd, fill, ocr_out=ocr_out)
        if self.config.enable_blank_cell_rec and self.ocr is not None:
            texts = self._retry_blank_cells(crop, cell_boxes, texts)
        return build_html_from_grid(grid, texts)

    def _retry_blank_cells(self, crop: np.ndarray, cell_boxes: list[list[float]],
                           texts: list[str]) -> list[str]:
        """Focused OCR on cells the table-level pass left empty — all
        blank cells of the table go through OCR as one batch."""
        h, w = crop.shape[:2]
        cells, owners = [], []
        for k, (box, text) in enumerate(zip(cell_boxes, texts)):
            if text.strip():
                continue
            x0, y0, x1, y1 = (max(int(box[0]), 0), max(int(box[1]), 0),
                              min(int(box[2]) + 1, w), min(int(box[3]) + 1, h))
            if x1 - x0 < 4 or y1 - y0 < 4:
                continue
            cells.append(crop[y0:y1, x0:x1])
            owners.append(k)
        if not cells:
            return texts
        results = self._ocr(cells)
        if results is None:
            return texts
        for k, items in zip(owners, results):
            if items:
                texts[k] = normalize_cell_text(" ".join(it["text"] for it in items))
        return texts

    def _fill_text(self, crop: np.ndarray, structure: list[str], bboxes: list[list[float]],
                   mfd: list, fill: list, ocr_out=None) -> str:
        if not structure:
            return ""
        texts = self._cell_texts(crop, bboxes, mfd, fill, ocr_out=ocr_out) if bboxes else []
        return html_from_structure_tokens(structure, texts)

    def _cell_texts(self, crop: np.ndarray, cell_boxes: list[list[float]], mfd: list,
                    fill: list, ocr_out=None) -> list[str]:
        """Distribute the OCR text into cells, by word boxes where the OCR
        gives them (one line straddling a cell border splits correctly)
        and by line boxes otherwise, with the in-table formulas (as
        $latex$) and image placeholders (reference:
        analyze_utils.py:491-527)."""
        if not cell_boxes:
            return []
        if self.ocr is None and not mfd and not fill:
            return [""] * len(cell_boxes)
        if ocr_out is None:
            ocr_out = [] if self.ocr is None else self._ocr([crop], words=True, catch=False)[0]
        items = []
        for it in ocr_out:
            if it.get("words"):
                for w in it["words"]:
                    poly = w["poly"]
                    items.append({"bbox": [min(p[0] for p in poly), min(p[1] for p in poly),
                                           max(p[0] for p in poly), max(p[1] for p in poly)],
                                  "text": w["word"]})
            else:
                box = it["box"]
                items.append({"bbox": [min(p[0] for p in box), min(p[1] for p in box),
                                       max(p[0] for p in box), max(p[1] for p in box)],
                              "text": it["text"]})
        items += [{"bbox": list(box), "text": f"${latex}$"} for box, latex in mfd]
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
