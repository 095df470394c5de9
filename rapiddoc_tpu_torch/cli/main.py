"""Command-line interface.

Port of ``rapiddoc_tpu/cli/main.py`` (reference:
rapid_doc/cli/gradio_app.py:483-537 click main + cli/common.py do_parse
outputs: md / middle / content_list json, debug pdfs) on ``argparse``
with click's option names and defaults, since the card's machine has no
click. The parse runs on the card, or on the CPU under
``RAPIDDOC_PLATFORM=cpu``; without CUDA otherwise it raises before it
parses anything.

    rapiddoc-tpu-torch doc.pdf -o out --checkbox --draw-layout --html
    python -m rapiddoc_tpu_torch.cli.main doc.pdf -o out
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..types import MakeMode


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rapiddoc-tpu-torch",
        description="Parse PDF/image/Office documents into Markdown + JSON.",
    )
    ap.add_argument("inputs", nargs="+", metavar="INPUTS")
    ap.add_argument("-o", "--output-dir", default="./output", help="Output directory")
    ap.add_argument("-m", "--method", default="auto", choices=["auto", "txt", "ocr"])
    ap.add_argument("-l", "--lang", default="ch")
    ap.add_argument("--formula", default=True, action=argparse.BooleanOptionalAction)
    ap.add_argument("--table", default=True, action=argparse.BooleanOptionalAction)
    ap.add_argument("--md-mode", default=MakeMode.MM_MD,
                    choices=[MakeMode.MM_MD, MakeMode.NLP_MD])
    ap.add_argument("--start-page", default=0, type=int)
    ap.add_argument("--end-page", default=None, type=int)
    ap.add_argument("--draw-layout", action="store_true",
                    help="Emit *_layout.pdf debug overlay")
    ap.add_argument("--html", dest="emit_html", action="store_true", help="Also emit .html")
    ap.add_argument("--docx", dest="emit_docx", action="store_true", help="Also emit .docx")
    ap.add_argument("--checkbox", dest="checkbox_enable", action="store_true",
                    help="Detect checkboxes (☐/☑ glyphs in output)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="Per-window resume checkpoints directory")
    return ap


def main(argv: list[str] | None = None) -> int:
    """Parse PDF/image/Office documents into Markdown + JSON."""
    ap = _parser()
    args = ap.parse_args(argv)
    for path in args.inputs:
        if not Path(path).exists():
            ap.error(f"Invalid value for 'INPUTS...': Path '{path}' does not exist.")

    from ..api import RapidDoc
    from ..engine.session import resolve_device

    resolve_device(None)  # the card, or RAPIDDOC_PLATFORM=cpu
    engine = RapidDoc(
        parse_method=args.method,
        lang=args.lang,
        formula_enable=args.formula,
        table_enable=args.table,
        make_md_mode=args.md_mode,
        checkbox_config={"checkbox_enable": True} if args.checkbox_enable else None,
        checkpoint_dir=args.checkpoint_dir,
    )
    out_root = Path(args.output_dir)
    start_page, end_page = args.start_page, args.end_page
    for path in args.inputs:
        path = Path(path)
        print(f"parsing {path} ...", flush=True)
        data: bytes = path.read_bytes()
        if (start_page or end_page is not None) and path.suffix.lower() == ".pdf":
            from ..pdfio import open_pdf
            from ..pdfio.writer import select_pages

            n = len(open_pdf(data))
            end = end_page if end_page is not None else n - 1
            data = select_pages(data, range(start_page, min(end + 1, n)))
        out = engine(data if path.suffix.lower() != "" else str(path))
        name = path.stem
        doc_dir = out_root / name
        doc_dir.mkdir(parents=True, exist_ok=True)
        (doc_dir / f"{name}.md").write_text(out.markdown, encoding="utf-8")
        (doc_dir / f"{name}_middle.json").write_text(
            json.dumps(out.middle_json, ensure_ascii=False, default=str),
            encoding="utf-8",
        )
        (doc_dir / f"{name}_content_list.json").write_text(
            json.dumps(out.content_list_json, ensure_ascii=False, default=str),
            encoding="utf-8",
        )
        for rel, blob in out.images.items():
            target = doc_dir / rel
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(blob)
        if args.draw_layout and data[:5].lstrip()[:4] == b"%PDF":
            from ..utils.draw import debug_pdfs_from_output

            overlays = debug_pdfs_from_output(data, out.middle_json)
            if "layout" in overlays:
                (doc_dir / f"{name}_layout.pdf").write_bytes(overlays["layout"])
        if args.emit_html:
            from ..utils.markdown_convert import markdown_to_html

            (doc_dir / f"{name}.html").write_text(
                markdown_to_html(out.markdown), encoding="utf-8"
            )
        if args.emit_docx:
            from ..utils.markdown_convert import markdown_to_docx

            (doc_dir / f"{name}.docx").write_bytes(markdown_to_docx(out.markdown))
        print(f"  -> {doc_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
