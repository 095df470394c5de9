"""RapidDoc facade of the port: the public parse API for documents and images.

Port of ``rapiddoc_tpu/api.py`` (``RapidDoc.__call__``, ``_parse_single``,
``_parse_pipeline``, ``parse_batch``, ``ModelStack``, ``RapidDocOutput``,
``_embed_data_uris``, ``_legacy_office_to_modern``): PDF documents
in ``parse_method="ocr"`` (or "txt" / "auto") with the layout model (the
demo checkpoint under ``RAPIDDOC_DEMO_LAYOUT=1``, else the fallback
layout), OCR, the formula recognizer and the table recognizer
(``table_config`` reaches ``TableRecognizer.build``: ``strategy``
``unet_slanet_plus`` by default or ``unet_unitable``,
``wireless_max_len``, ``use_img2table``, ``use_compare_table``,
``detect_rotation``, ``enable_blank_cell_rec``; the stage is off with
``table_enable=False`` or ``RAPIDDOC_DISABLE_TABLE=1``), with ``lang``
choosing the OCR rec, ``ocr_config``'s ``Det.limit_side_len``, the OCR
wire and contrast knobs and ``USE_DOC_ORIENTATION_CLASSIFY`` read as the
JAX package reads them.
The window loop, its render-ahead and assembly threads, the
``DeferredAR`` packing of formula and table regions across windows
(when there is more than one window and no checkpoint dir: the windows
that wait for a flush are assembled after it, in order) and the
outputs are the JAX package's; the port adds its ``device`` (the card by
default) and ``dtype`` (bf16 by default) arguments. Windows render
serially (the JAX package's process pool renders the same pages).

Image inputs (a PNG, JPEG, BMP, GIF or TIFF path or bytes, an array of
any type ``Image.fromarray`` takes, or an image object with
``__array_interface__`` and a PIL-style ``mode``) become a one-page PDF
through ``pdfio.writer.images_to_pdf`` at the render dpi, with the
pixels the JAX package's PIL gives (an array or image object is
embedded directly: the JAX package's PNG round trip is lossless).
``parse_batch`` (and a call with several documents and no output dir or
overrides) batches pages across documents, with a ``DeferredAR`` across
its chunks; Office slots take no batch slot.
``image_config={"extract_original_image": True}`` keeps an embedded
image's own pixels for an image span that matches it.

Office documents (``.docx``, ``.pptx``, ``.xlsx`` by suffix or zip
sniff) go through the model-free ``office/`` path, as in the JAX
package; ``.doc``, ``.ppt`` and ``.xls`` are converted first by
LibreOffice's ``soffice`` on ``PATH`` (``_legacy_office_to_modern``).
Bytes without a suffix that do not start with ``%PDF`` and are no
PNG/JPEG/GIF/WEBP/Office file are sniffed by Magika
(``utils/sniff.guess_suffix_by_bytes``) on the facade's device and routed
as the JAX package routes them: Office documents to their path, an
image through the PDF writer, anything else parsed as a PDF. URL
inputs, and the image formats the port does not decode, raise
NotImplementedError naming their ROADMAP items. A page whose page object
is broken renders as a blank page, as in the JAX package; anything the
port's renderer cannot draw raises, and so
does an embedded image that the port cannot decode for
``extract_original_image`` (the JAX package logs it and uses the crop).
"""
from __future__ import annotations

import base64
import json
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from . import pdfio
from .config import (
    env_int,
    env_str,
    formula_enable_default,
    get_pdf_render_dpi,
    get_processing_window_size,
    table_enable_default,
)
from .data.io import DataWriter, FanoutDataWriter, FileBasedDataWriter, MemoryDataWriter
from .pdfio.images import to_rgb, xobject_to_array
from .pdfio.placements import original_image_streams
from .pdfio.pil_modes import is_image_object
from .pdfio.writer import images_to_pdf
from .pipeline.middle import build_page_infos, finalize_middle_json
from .pipeline.mkcontent import union_make
from .pipeline.scheduler import DeferredAR
from .types import MakeMode
from .utils.checkpoint import resolve_checkpoint
from .utils.logging import get_logger
from .utils.sniff import guess_suffix_by_bytes
from .utils.trace import GLOBAL_TRACER, stage_timer
from .utils.unported import not_ported

logger = get_logger("rapiddoc_tpu_torch.api")

image_suffixes = (".png", ".jpg", ".jpeg", ".webp", ".gif", ".bmp")
office_suffixes = (".docx", ".pptx", ".xlsx")
old_office_suffixes = (".doc", ".ppt", ".xls")


@dataclass
class RapidDocOutput:
    markdown: str = ""
    images: dict[str, bytes] = field(default_factory=dict)
    middle_json: dict[str, Any] | None = None
    content_list_json: list[Any] | None = None
    # raw per-page model output ({"layout_dets": [...]} each)
    model_json: list[dict] | None = None
    # per-stage {total_s, items, calls, ms_per_item}, cumulative for this
    # process
    stage_report: dict[str, dict] | None = None

    def __iter__(self):
        yield self.markdown
        yield self.images


class ModelStack:
    """Lazily-built model singleton, keyed by config, device and dtype."""

    _instances: dict[tuple, "ModelStack"] = {}

    def __init__(self, lang: str, formula_enable: bool, table_enable: bool,
                 configs: dict, device, dtype):
        from .models.registry import build_analyzer

        self.analyzer = build_analyzer(
            lang=lang, formula_enable=formula_enable, table_enable=table_enable,
            configs=configs, device=device, dtype=dtype,
        )

    # env that changes what build_analyzer produces — part of the cache
    # identity
    _ENV_KEYS = (
        "DISABLE_OCR", "DISABLE_LAYOUT", "DISABLE_FORMULA", "DISABLE_TABLE",
        "DEMO_LAYOUT", "MODELS_DIR", "CONTRAST_STRETCH", "OCR_DICT",
        "USE_DOC_ORIENTATION_CLASSIFY", "RGB_TRANSFER", "DET_WIRE_BITS",
        "DET_PROB_BITS", "REC_WIRE_BITS", "LAYOUT_WIRE_BITS", "UNET_WIRE_BITS",
    )

    @classmethod
    def _env_fingerprint(cls) -> tuple:
        return tuple(env_str(k) for k in cls._ENV_KEYS) + (
            os.environ.get("USE_DOC_ORIENTATION_CLASSIFY"),
        )

    @classmethod
    def get(cls, lang: str, formula_enable: bool, table_enable: bool,
            configs: dict | None = None, device=None, dtype=None) -> "ModelStack":
        key = (lang, formula_enable, table_enable,
               repr(sorted((configs or {}).items())), cls._env_fingerprint(),
               str(device), str(dtype))
        if key not in cls._instances:
            cls._instances[key] = cls(lang, formula_enable, table_enable, configs or {},
                                      device, dtype)
        return cls._instances[key]


class RapidDoc:
    def __init__(
        self,
        layout_config: dict[str, Any] | None = None,
        ocr_config: dict[str, Any] | None = None,
        formula_config: dict[str, Any] | None = None,
        table_config: dict[str, Any] | None = None,
        checkbox_config: dict[str, Any] | None = None,
        image_config: dict[str, Any] | None = None,
        parse_method: str = "auto",
        formula_enable: bool = True,
        table_enable: bool = True,
        lang: str = "ch",
        make_md_mode: str = MakeMode.MM_MD,
        output_dir: str | Path | None = None,
        image_writer: DataWriter | None = None,
        md_writer: DataWriter | None = None,
        image_dir_name: str = "images",
        image_output_mode: str = "url",
        preload_model: bool = False,
        pdf_pages_batch: int | None = None,
        checkpoint_dir: str | Path | None = None,
        device: str | torch.device | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        self.layout_config = layout_config or {}
        self.ocr_config = ocr_config or {}
        self.formula_config = formula_config or {}
        self.table_config = table_config or {}
        self.checkbox_config = checkbox_config or {}
        self.image_config = image_config or {}
        self.parse_method = parse_method
        self.formula_enable = formula_enable_default(formula_enable)
        self.table_enable = table_enable_default(table_enable)
        self.lang = lang
        self.make_md_mode = make_md_mode
        self.default_output_dir = output_dir
        self.default_image_writer = image_writer
        self.default_md_writer = md_writer
        self.image_dir_name = image_dir_name or "images"
        if image_output_mode not in ("url", "data_uri"):
            raise ValueError("image_output_mode must be 'url' or 'data_uri'")
        self.image_output_mode = image_output_mode
        self.pdf_pages_batch = (
            pdf_pages_batch if pdf_pages_batch is not None
            else get_processing_window_size()
        )
        # neither the ctor arg nor the env pinned a window: the parse
        # loop may shrink it per document so the render/compute/assembly
        # pipeline has >= 3 windows of depth
        self._window_auto = (
            pdf_pages_batch is None and env_str("PROCESSING_WINDOW_SIZE") is None
        )
        self.checkpoint_dir = checkpoint_dir
        self.device = device
        self.dtype = dtype
        if preload_model:
            self.warmup()

    def _stack(self, lang: str | None = None, formula_enable: bool | None = None,
               table_enable: bool | None = None) -> ModelStack:
        return ModelStack.get(
            lang or self.lang,
            self.formula_enable if formula_enable is None else formula_enable,
            self.table_enable if table_enable is None else table_enable,
            {
                "layout": self.layout_config,
                "ocr": self.ocr_config,
                "formula": self.formula_config,
                "table": self.table_config,
                "checkbox": self.checkbox_config,
            },
            self.device, self.dtype,
        )

    # -------------------------------------------------------------- warmup

    def warmup(self, lang: str | None = None, formula_enable: bool | None = None,
               table_enable: bool | None = None, precompile: bool = False) -> None:
        """Build the model stack; with `precompile`, also run a blank page
        through the OCR system."""
        stack = self._stack(lang, formula_enable, table_enable)
        if precompile and stack.analyzer.ocr is not None:
            stack.analyzer.ocr([np.full((1056, 816, 3), 255, np.uint8)])

    # ---------------------------------------------------------------- call

    def __call__(
        self,
        inputs: str | bytes | Path | Iterable,
        output_dir: str | Path | None = None,
        **overrides: Any,
    ) -> RapidDocOutput | list[RapidDocOutput]:
        if isinstance(inputs, (bytearray, memoryview)):
            inputs = bytes(inputs)
        # an array dispatches before the iterable branch (an HxWx3 array
        # is iterable row-wise)
        if isinstance(inputs, (str, bytes, Path, np.ndarray)) or is_image_object(inputs):
            return self._parse_single(inputs, output_dir, **overrides)
        if output_dir is None and not overrides:
            # several documents batch their pages across documents
            return self.parse_batch(inputs)
        return [self._parse_single(item, output_dir, **overrides) for item in inputs]

    def _parse_single(
        self, item: str | bytes | Path | np.ndarray, output_dir: str | Path | None, **overrides
    ) -> RapidDocOutput:
        pdf_bytes, name, kind = self._normalize_input(item)
        if kind == "office":
            return self._parse_office(pdf_bytes, name)
        return self._parse_pipeline(pdf_bytes, name, output_dir, **overrides)

    def _parse_office(self, data: bytes, name: str) -> RapidDocOutput:
        """An Office document through its model-free path (``office/``)."""
        from .office.analyze import office_parse

        return office_parse(
            data, name, make_md_mode=self.make_md_mode,
            image_output_mode=self.image_output_mode,
        )

    # ------------------------------------------------------------ pipeline

    def _parse_pipeline(
        self, pdf_bytes: bytes, name: str, output_dir: str | Path | None,
        **overrides,
    ) -> RapidDocOutput:
        parse_method = overrides.get("parse_method", self.parse_method)
        if parse_method == "auto":
            parse_method = pdfio.classify_pdf(pdf_bytes)
        logger.info("parsing %s as %s", name, parse_method)

        mem_writer = MemoryDataWriter(self.image_dir_name)
        writers: list[DataWriter] = [mem_writer]
        out_dir = output_dir or self.default_output_dir
        if out_dir:
            img_dir = Path(out_dir) / name / self.image_dir_name
            writers.append(FileBasedDataWriter(str(img_dir)))
        if self.default_image_writer is not None:
            writers.append(self.default_image_writer)
        image_writer = FanoutDataWriter(*writers)

        stack = self._stack(overrides.get("lang", self.lang))

        doc = pdfio.open_pdf(pdf_bytes)
        n_pages = len(doc)
        dpi = get_pdf_render_dpi()
        scale = dpi / 72.0
        window = max(1, self.pdf_pages_batch)
        if self._window_auto and n_pages > 16:
            # pipeline depth >= 3 windows lets render(N+1) and
            # assembly(N-1) hide under device compute of window N; short
            # docs run as one window
            window = min(window, max(16, math.ceil(n_pages / 3)))

        all_model_infos: list[dict] = []

        def render_window(start: int):
            """Render one window of pages (host work, overlappable)."""
            idxs = list(range(start, min(start + window, n_pages)))
            w_imgs, w_text, w_boxes, dims = [], [], [], []
            with stage_timer("render", len(idxs)):
                for i in idxs:
                    try:
                        page = doc.get_page(i)
                        size = page.size
                    except Exception:
                        # per-page failure isolation: a broken page object
                        # becomes a blank placeholder
                        logger.exception("page %d failed to render", i)
                        w_imgs.append(np.full((int(792 * scale), int(612 * scale), 3),
                                              255, np.uint8))
                        w_text.append(None)
                        w_boxes.append([])
                        dims.append((612.0, 792.0))
                        continue
                    img, tdict, boxes = pdfio.render_page_full(
                        page, dpi=dpi, with_text=(parse_method == "txt"),
                    )
                    w_imgs.append(img)
                    w_text.append(tdict)
                    w_boxes.append(boxes)
                    dims.append(size)
            return w_imgs, w_text, w_boxes, dims

        ckpt = resolve_checkpoint(
            self.checkpoint_dir, pdf_bytes, parse_method, dpi, window
        )
        want_originals = bool(self.image_config.get("extract_original_image"))
        starts = list(range(0, n_pages, window))

        def assemble_window(start, infos, dims, w_imgs, w_text, originals):
            with stage_timer("assembly", len(infos)):
                return build_page_infos(
                    infos, dims, [scale] * len(infos),
                    page_imgs=w_imgs, page_text_dicts=w_text,
                    parse_mode=parse_method, image_writer=image_writer,
                    page_idx_offset=start, originals_per_page=originals,
                    image_config=self.image_config,
                )

        # doc-wide AR packing: formula regions accumulate across windows
        # and decode in full buckets instead of per-window dribbles.
        # Checkpointed runs keep per-window decoding so saved windows
        # stay self-contained.
        deferred = DeferredAR() if (ckpt is None and len(starts) > 1) else None
        asm_futures = []
        pending_asm: list[tuple] = []  # windows awaiting an AR flush

        # three-stage window pipeline: render window N+1 on a prefetch
        # thread AND assemble window N-1 on an assembly thread while the
        # device runs window N
        with ThreadPoolExecutor(max_workers=1) as pool, ThreadPoolExecutor(
            max_workers=1
        ) as asm_pool:

            def submit_pending():
                for args in pending_asm:
                    asm_futures.append(asm_pool.submit(assemble_window, *args))
                pending_asm.clear()

            future = pool.submit(render_window, starts[0]) if starts else None
            for wi, start in enumerate(starts):
                w_imgs, w_text, w_boxes, dims = future.result()
                if wi + 1 < len(starts):
                    future = pool.submit(render_window, starts[wi + 1])
                infos = ckpt.load(start) if ckpt is not None else None
                if infos is None:
                    infos = stack.analyzer.analyze_pages(
                        w_imgs, [parse_method] * len(w_imgs), w_text, w_boxes,
                        [scale] * len(w_imgs), deferred=deferred,
                    )
                    if ckpt is not None:
                        ckpt.save(start, infos)
                else:
                    logger.info("window %d resumed from checkpoint", start)
                originals = (
                    _collect_original_images(doc, len(w_imgs), first_page=start)
                    if want_originals else None
                )
                args = (start, infos, dims, w_imgs, w_text, originals)
                if deferred is not None and deferred.window_added() > 0:
                    pending_asm.append(args)
                elif pending_asm:
                    # keep window order: ride behind the pending flush
                    pending_asm.append(args)
                else:
                    asm_futures.append(asm_pool.submit(assemble_window, *args))
                # flush when a full decode bucket accumulated, or when
                # deferral has stalled assembly for >= 3 windows
                if deferred is not None and pending_asm and (
                    deferred.should_flush() or len(pending_asm) >= 3
                ):
                    stack.analyzer.flush_deferred(deferred)
                    submit_pending()
                all_model_infos.extend(infos)
            if deferred is not None:
                stack.analyzer.flush_deferred(deferred)
            submit_pending()
            page_infos = [p for f in asm_futures for p in f.result()]

        with stage_timer("assembly_final", n_pages):
            middle_json = finalize_middle_json(page_infos, parse_method)

        markdown, content_list, images = self._outputs(middle_json, mem_writer)

        if out_dir:
            md_writer = FileBasedDataWriter(str(Path(out_dir) / name))
            md_writer.write_string(f"{name}.md", markdown)
            md_writer.write_string(
                f"{name}_middle.json", json.dumps(middle_json, ensure_ascii=False,
                                                  default=str)
            )
            md_writer.write_string(
                f"{name}_content_list.json",
                json.dumps(content_list, ensure_ascii=False, default=str),
            )
        if self.default_md_writer is not None:
            self.default_md_writer.write_string(f"{name}.md", markdown)

        report = GLOBAL_TRACER.report()
        if report:
            logger.info(
                "stage ms/page: %s",
                {k: v["ms_per_item"] for k, v in report.items()},
            )
        return RapidDocOutput(
            markdown=markdown,
            images=images,
            middle_json=middle_json,
            content_list_json=content_list,
            model_json=all_model_infos,
            stage_report=report,
        )

    # -------------------------------------------------------- batch parse

    def parse_batch(self, inputs: Iterable) -> list[RapidDocOutput]:
        """Parse many documents with their pages batched across documents
        (shared chunks of ``MIN_BATCH_INFERENCE_SIZE`` pages, at least the
        window size), formula and table regions packed across chunks in a
        ``DeferredAR``. Per-window checkpoints, writers and original
        images apply to the single-document path only, as in the JAX
        package."""
        items = list(inputs)
        outputs: list[RapidDocOutput | None] = [None] * len(items)
        docs: list[tuple[int, bytes, str]] = []  # (slot, pdf_bytes, parse mode)
        for slot, item in enumerate(items):
            pdf_bytes, name, kind = self._normalize_input(item)
            if kind == "office":
                # Office documents take their model-free path one by one
                outputs[slot] = self._parse_office(pdf_bytes, name)
                continue
            mode = self.parse_method
            if mode == "auto":
                mode = pdfio.classify_pdf(pdf_bytes)
            docs.append((slot, pdf_bytes, mode))
        if not docs:
            return outputs
        stack = self._stack()
        dpi = get_pdf_render_dpi()
        scale = dpi / 72.0
        super_batch = max(self.pdf_pages_batch, env_int("MIN_BATCH_INFERENCE_SIZE", 384))
        opened = [(pdfio.open_pdf(b), mode) for _, b, mode in docs]
        tasks = [(k, page_i) for k, (doc, _) in enumerate(opened) for page_i in range(len(doc))]
        per_doc: dict[int, dict[int, tuple]] = {k: {} for k in range(len(opened))}
        # assembly comes after every chunk, so no window gating is needed
        batch_deferred = DeferredAR() if len(tasks) > super_batch else None
        for c0 in range(0, len(tasks), super_batch):
            imgs, modes, tdicts, boxes_l, keys = [], [], [], [], []
            for k, page_i in tasks[c0 : c0 + super_batch]:
                doc, mode = opened[k]
                try:
                    page = doc.get_page(page_i)
                    dims = page.size
                except Exception:
                    # a broken page object becomes a blank placeholder
                    logger.exception("page %d failed to render", page_i)
                    img = np.full((int(792 * scale), int(612 * scale), 3), 255, np.uint8)
                    tdict, boxes, dims = None, [], (612.0, 792.0)
                else:
                    img, tdict, boxes = pdfio.render_page_full(
                        page, dpi=dpi, with_text=(mode == "txt")
                    )
                imgs.append(img)
                modes.append(mode)
                tdicts.append(tdict)
                boxes_l.append(boxes)
                keys.append((k, page_i, dims))
            infos = stack.analyzer.analyze_pages(
                imgs, modes, tdicts, boxes_l, [scale] * len(imgs), deferred=batch_deferred,
            )
            if batch_deferred is not None and batch_deferred.should_flush():
                stack.analyzer.flush_deferred(batch_deferred)
            for (k, page_i, dims), info, img, tdict in zip(keys, infos, imgs, tdicts):
                per_doc[k][page_i] = (info, dims, img, tdict)
        if batch_deferred is not None:
            stack.analyzer.flush_deferred(batch_deferred)

        for k, (doc, mode) in enumerate(opened):
            pages = [per_doc[k][i] for i in sorted(per_doc[k])]
            mem_writer = MemoryDataWriter(self.image_dir_name)
            middle_json = finalize_middle_json(build_page_infos(
                [p[0] for p in pages], [p[1] for p in pages], [scale] * len(pages),
                page_imgs=[p[2] for p in pages], page_text_dicts=[p[3] for p in pages],
                parse_mode=mode, image_writer=mem_writer,
            ), mode)
            markdown, content_list, images = self._outputs(middle_json, mem_writer)
            outputs[docs[k][0]] = RapidDocOutput(
                markdown=markdown,
                images=images,
                middle_json=middle_json,
                content_list_json=content_list,
                model_json=[p[0] for p in pages],
                stage_report=GLOBAL_TRACER.report(),
            )
        return outputs

    def _outputs(self, middle_json: dict, mem_writer: MemoryDataWriter) -> tuple[str, list, dict]:
        """Markdown, content list and payloads by name of a parse."""
        prefix = self.image_dir_name
        markdown = union_make(middle_json["pdf_info"], self.make_md_mode, prefix)
        content_list = union_make(middle_json["pdf_info"], MakeMode.CONTENT_LIST, prefix)
        images = {f"{prefix}/{k}": v for k, v in mem_writer.data.items()}
        if self.image_output_mode == "data_uri":
            markdown = self._embed_data_uris(markdown, images)
        return markdown, content_list, images

    @staticmethod
    def _image_mime(data: bytes) -> str:
        """MIME type from magic bytes."""
        if data[:8] == b"\x89PNG\r\n\x1a\n":
            return "image/png"
        if data[:6] in (b"GIF87a", b"GIF89a"):
            return "image/gif"
        if data[:2] == b"BM":
            return "image/bmp"
        if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
            return "image/webp"
        if data[:5] in (b"<?xml", b"<svg ") or data[:4] == b"<svg":
            return "image/svg+xml"
        return "image/jpeg"

    @staticmethod
    def _embed_data_uris(markdown: str, images: dict[str, bytes]) -> str:
        def repl(m: re.Match) -> str:
            data = images.get(m.group(1))
            if data is None:
                return m.group(0)
            b64 = base64.b64encode(data).decode()
            return f"![](data:{RapidDoc._image_mime(data)};base64,{b64})"

        def repl_html(m: re.Match) -> str:
            data = images.get(m.group(1))
            if data is None:
                return m.group(0)
            b64 = base64.b64encode(data).decode()
            return f'<img src="data:{RapidDoc._image_mime(data)};base64,{b64}"/>'

        markdown = re.sub(r"!\[\]\(([^)]+)\)", repl, markdown)
        return re.sub(r'<img src="([^"]+)"/>', repl_html, markdown)

    # --------------------------------------------------------------- input

    def _normalize_input(self, item) -> tuple[bytes, str, str]:
        """(bytes, doc_name, kind): kind "pdf" for a PDF as it is and for an
        image file, array or image object as a one-page PDF at the render
        dpi, kind "office" for an Office document's bytes (a legacy one
        converted by LibreOffice first); URLs raise."""
        if isinstance(item, np.ndarray) or is_image_object(item):
            return images_to_pdf([item], dpi=get_pdf_render_dpi()), "image", "pdf"
        if isinstance(item, (str, Path)):
            s = str(item)
            if s.startswith(("http://", "https://")):
                raise not_ported("URL inputs", "host_families")
            data = Path(s).read_bytes()
            name = Path(s).name
        else:
            data = bytes(item)
            name = str(getattr(item, "name", "") or "document")
        stem, suffix = os.path.splitext(name)
        suffix = suffix.lower()
        stem = stem or "document"
        if suffix in office_suffixes or _sniff_office(data):
            return data, stem, "office"
        if suffix in old_office_suffixes:
            return _legacy_office_to_modern(data, suffix), stem, "office"
        if suffix in image_suffixes or _sniff_image(data):
            return images_to_pdf([data], dpi=get_pdf_render_dpi()), stem, "pdf"
        known = image_suffixes + office_suffixes + old_office_suffixes + (".pdf",)
        if suffix not in known and data[:4] != b"%PDF":
            # extensionless input: content-based id (Magika through the ONNX
            # interpreter on the facade's device), routed as the JAX package
            # routes it; anything else is parsed as a PDF
            guessed = guess_suffix_by_bytes(data, device=self.device)
            if guessed in ("docx", "pptx", "xlsx"):
                return data, stem, "office"
            if guessed in ("doc", "ppt", "xls"):
                return _legacy_office_to_modern(data, f".{guessed}"), stem, "office"
            if guessed in ("png", "jpg", "gif", "webp", "bmp", "tif"):
                return images_to_pdf([data], dpi=get_pdf_render_dpi()), stem, "pdf"
        return data, stem, "pdf"


def _sniff_image(data: bytes) -> bool:
    return data[:4] in (b"\x89PNG", b"RIFF") or data[:3] == b"\xff\xd8\xff" or data[:6] in (
        b"GIF87a", b"GIF89a"
    )


def _sniff_office(data: bytes) -> bool:
    if data[:4] != b"PK\x03\x04":
        return False
    head = data[:4096]
    return b"word/" in head or b"ppt/" in head or b"xl/" in head


def _legacy_office_to_modern(data: bytes, suffix: str) -> bytes:
    """doc/ppt/xls -> docx/pptx/xlsx through LibreOffice (``soffice`` or
    ``libreoffice`` on ``PATH``), as the JAX package converts them."""
    import shutil
    import subprocess
    import tempfile

    soffice = shutil.which("soffice") or shutil.which("libreoffice")
    if soffice is None:
        raise RuntimeError(
            "legacy office formats require LibreOffice (soffice) on PATH"
        )
    target = {".doc": "docx", ".ppt": "pptx", ".xls": "xlsx"}[suffix]
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / f"input{suffix}"
        src.write_bytes(data)
        subprocess.run(
            [soffice, "--headless", "--convert-to", target, "--outdir", tmp, str(src)],
            check=True, capture_output=True, timeout=300,
        )
        return (Path(tmp) / f"input.{target}").read_bytes()


def _collect_original_images(doc, n_pages: int, first_page: int = 0) -> list:
    """Per page: (bbox in page units, decoded RGB pixels) of each embedded
    image (``pdfio.images.xobject_to_array``, as PIL's ``convert("RGB")``)."""
    out = []
    for i in range(first_page, first_page + n_pages):
        items = []
        for bbox, stream in original_image_streams(doc.get_page(i)):
            img = xobject_to_array(doc, stream)
            if img is not None:
                items.append((bbox, to_rgb(img)))
        out.append(items)
    return out
