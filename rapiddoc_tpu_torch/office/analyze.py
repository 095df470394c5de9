"""Office (docx/pptx/xlsx) parsing entry point.

A copy of ``rapiddoc_tpu/office/analyze.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.

Counterpart of the reference office backend
(reference: rapid_doc/backend/office/office_analyze.py:9-36). Converters
live in rapiddoc_tpu_torch.office.{docx,pptx,xlsx}; this module routes by
container sniffing and assembles the output.
"""
from __future__ import annotations

import zipfile
import io

from ..types import MakeMode
from ..utils.logging import get_logger

logger = get_logger("rapiddoc_tpu_torch.office")


def sniff_office_kind(data: bytes) -> str | None:
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            names = z.namelist()
    except zipfile.BadZipFile:
        return None
    if any(n.startswith("word/") for n in names):
        return "docx"
    if any(n.startswith("ppt/") for n in names):
        return "pptx"
    if any(n.startswith("xl/") for n in names):
        return "xlsx"
    return None


def office_parse(
    data: bytes,
    name: str,
    make_md_mode: str = MakeMode.MM_MD,
    image_output_mode: str = "url",
):
    from ..api import RapidDocOutput

    if not data:
        # zero-byte office file -> empty document output (reference:
        # rapid_doc/utils/empty_office.py normalize_empty_office_bytes,
        # applied in main.py:613 / cli/common.py:40)
        from .common import OfficeResult

        result = OfficeResult()
        return RapidDocOutput(
            markdown="",
            images={},
            middle_json=result.to_middle_json(),
            content_list_json=result.to_content_list(),
        )

    kind = sniff_office_kind(data)
    try:
        if kind == "docx":
            from .docx import docx_to_blocks

            result = docx_to_blocks(data)
        elif kind == "pptx":
            from .pptx import pptx_to_blocks

            result = pptx_to_blocks(data)
        elif kind == "xlsx":
            from .xlsx import xlsx_to_blocks

            result = xlsx_to_blocks(data)
        else:
            raise ValueError(f"not a recognizable office document: {name}")
    except ValueError:
        raise
    except Exception as exc:
        # corrupt zip members / truncated deflate streams surface as a
        # uniform error instead of leaking BadZipFile/zlib internals
        raise ValueError(
            f"corrupt {kind or 'office'} document: {name} ({exc})"
        ) from exc

    markdown = result.to_markdown()
    if image_output_mode == "data_uri":
        from ..api import RapidDoc

        markdown = RapidDoc._embed_data_uris(markdown, result.images)
    return RapidDocOutput(
        markdown=markdown,
        images=result.images,
        middle_json=result.to_middle_json(),
        content_list_json=result.to_content_list(),
    )
