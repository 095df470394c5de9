"""Batch parse helpers.

API parity with the reference helpers (reference:
rapid_doc/cli/common.py:396 do_parse, :454 aio_do_parse, :58
convert_pdf_bytes_to_bytes_by_pypdfium2, :177 output dumping). Port of
the JAX package's module: the same output tree (``.md``,
``_middle.json``, ``_content_list.json``, ``_model.json``, the overlay
PDFs and the images) from the port's ``RapidDoc``, on the card unless
``RAPIDDOC_PLATFORM=cpu``; ``do_parse`` raises where CUDA is missing
before it parses anything.
"""
from __future__ import annotations

import asyncio
import json
from pathlib import Path
from typing import Any, Sequence

from ..types import MakeMode

image_suffixes = (".png", ".jpg", ".jpeg", ".webp", ".gif", ".bmp")
office_suffixes = (".docx", ".pptx", ".xlsx")
old_office_suffixes = (".doc", ".ppt", ".xls")


def convert_pdf_bytes_to_bytes_by_pages(
    pdf_bytes: bytes, start_page_id: int = 0, end_page_id: int | None = None
) -> bytes:
    """Slice a PDF to [start, end] pages (reference name kept ~verbatim)."""
    from ..pdfio import open_pdf
    from ..pdfio.writer import select_pages

    n = len(open_pdf(pdf_bytes))
    end = n - 1 if end_page_id is None or end_page_id < 0 else min(end_page_id, n - 1)
    if start_page_id == 0 and end == n - 1:
        return pdf_bytes
    return select_pages(pdf_bytes, range(start_page_id, end + 1))


def do_parse(
    output_dir: str | Path,
    pdf_file_names: Sequence[str],
    pdf_bytes_list: Sequence[bytes],
    p_lang_list: Sequence[str] | None = None,
    parse_method: str = "auto",
    formula_enable: bool = True,
    table_enable: bool = True,
    f_draw_layout_bbox: bool = False,
    f_draw_span_bbox: bool = False,
    f_draw_line_sort_bbox: bool = False,
    f_dump_md: bool = True,
    f_dump_middle_json: bool = True,
    f_dump_model_output: bool = False,
    f_dump_content_list: bool = True,
    f_make_md_mode: str = MakeMode.MM_MD,
    start_page_id: int = 0,
    end_page_id: int | None = None,
    **kwargs: Any,
) -> list[dict]:
    """Parse documents and dump outputs per document directory."""
    from ..api import RapidDoc
    from ..engine.session import resolve_device

    resolve_device(None)  # the card, or RAPIDDOC_PLATFORM=cpu

    langs = list(p_lang_list or ["ch"] * len(pdf_bytes_list))
    out_root = Path(output_dir)
    results = []
    batch_inference = bool(kwargs.get("batch_inference")) and len(
        pdf_bytes_list
    ) > 1
    sliced: list[bytes] = []
    for data in pdf_bytes_list:
        if data[:5].lstrip()[:4] == b"%PDF" and (
            start_page_id or end_page_id is not None
        ):
            data = convert_pdf_bytes_to_bytes_by_pages(
                data, start_page_id, end_page_id
            )
        sliced.append(data)
    batched_outs = None
    if batch_inference:
        # pages of all documents share device batches (reference
        # super-batching); langs must agree for a shared model stack
        engine = RapidDoc(
            parse_method=parse_method,
            lang=langs[0],
            formula_enable=formula_enable,
            table_enable=table_enable,
            make_md_mode=f_make_md_mode,
        )
        batched_outs = engine.parse_batch(sliced)
    for di, (name, data, lang) in enumerate(
        zip(pdf_file_names, sliced, langs)
    ):
        if batched_outs is not None:
            out = batched_outs[di]
        else:
            engine = RapidDoc(
                parse_method=parse_method,
                lang=lang,
                formula_enable=formula_enable,
                table_enable=table_enable,
                make_md_mode=f_make_md_mode,
            )
            out = engine(data)
        doc_dir = out_root / name
        doc_dir.mkdir(parents=True, exist_ok=True)
        if f_dump_md:
            (doc_dir / f"{name}.md").write_text(out.markdown, encoding="utf-8")
        if f_dump_middle_json:
            (doc_dir / f"{name}_middle.json").write_text(
                json.dumps(out.middle_json, ensure_ascii=False, default=str),
                encoding="utf-8",
            )
        if f_dump_content_list:
            (doc_dir / f"{name}_content_list.json").write_text(
                json.dumps(out.content_list_json, ensure_ascii=False,
                           default=str),
                encoding="utf-8",
            )
        if (f_draw_layout_bbox or f_draw_span_bbox or
                f_draw_line_sort_bbox) and data[:5].lstrip()[
            :4
        ] == b"%PDF":
            from ..utils.draw import debug_pdfs_from_output

            overlays = debug_pdfs_from_output(
                data, out.middle_json,
                layout=f_draw_layout_bbox, spans=f_draw_span_bbox,
                line_sort=f_draw_line_sort_bbox,
            )
            if "layout" in overlays:
                (doc_dir / f"{name}_layout.pdf").write_bytes(
                    overlays["layout"]
                )
            if "span" in overlays:
                (doc_dir / f"{name}_span.pdf").write_bytes(overlays["span"])
            if "line_sort" in overlays:
                (doc_dir / f"{name}_line_sort.pdf").write_bytes(
                    overlays["line_sort"]
                )
        if f_dump_model_output and out.model_json is not None:
            (doc_dir / f"{name}_model.json").write_text(
                json.dumps(out.model_json, ensure_ascii=False, default=str),
                encoding="utf-8",
            )
        for rel, blob in out.images.items():
            target = doc_dir / rel
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(blob)
        results.append(
            {
                "name": name,
                "markdown": out.markdown,
                "middle_json": out.middle_json,
                "content_list": out.content_list_json,
            }
        )
    return results


async def aio_do_parse(*args: Any, **kwargs: Any) -> list[dict]:
    """Async wrapper around do_parse (runs in a worker thread)."""
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, lambda: do_parse(*args, **kwargs))


def prepare_env(output_dir: str | Path, pdf_file_name: str, parse_method: str):
    """Create per-document output dirs (reference signature parity)."""
    base = Path(output_dir) / pdf_file_name / parse_method
    image_dir = base / "images"
    image_dir.mkdir(parents=True, exist_ok=True)
    return str(image_dir), str(base)
