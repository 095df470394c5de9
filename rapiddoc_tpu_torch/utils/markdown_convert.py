"""Markdown -> HTML / DOCX output converters.

Role parity with the reference (reference:
rapid_doc/utils/markdown_to_html.py markdown-it based, and
markdown_to_word.py pypandoc based). HTML uses markdown-it (present in
this environment, imported when called, with an escaped ``<pre>`` where
it is missing); DOCX is emitted directly as minimal OOXML (pypandoc is
not available). Copy of the JAX package's module.
"""
from __future__ import annotations

import html as html_mod
import io
import re
import zipfile

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<style>
body {{ font-family: sans-serif; max-width: 52rem; margin: 2rem auto;
       line-height: 1.6; padding: 0 1rem; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 4px 8px; }}
img {{ max-width: 100%; }}
pre {{ background: #f5f5f5; padding: 0.8rem; overflow-x: auto; }}
</style></head><body>
{body}
</body></html>
"""


def markdown_to_html(markdown: str, full_page: bool = True) -> str:
    try:
        from markdown_it import MarkdownIt

        md = MarkdownIt("commonmark", {"html": True}).enable(
            ["table", "strikethrough"]
        )
        body = md.render(markdown)
    except ImportError:  # pragma: no cover
        body = f"<pre>{html_mod.escape(markdown)}</pre>"
    return _HTML_TEMPLATE.format(body=body) if full_page else body


# ---------------------------------------------------------------- docx out

_W_NS = 'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main"'


# inline markdown/HTML style spans -> OOXML run properties. Emphasis
# content must start/end on non-space (commonmark flanking rule) so
# literal asterisk math like "5 * 3 * 2" stays verbatim.
_INLINE_RE = re.compile(
    r"\*\*\*(?P<bi>\S(?:.*?\S)?)\*\*\*"
    r"|\*\*(?P<b>\S(?:.*?\S)?)\*\*"
    r"|\*(?P<i>[^\s*](?:[^*]*[^\s*])?)\*"
    r"|~~(?P<s>\S(?:.*?\S)?)~~"
    r"|<u>(?P<u>.*?)</u>"
    r"|<sup>(?P<sup>.*?)</sup>"
    r"|<sub>(?P<sub>.*?)</sub>"
)
_RPR = {
    "bi": "<w:b/><w:i/>",
    "b": "<w:b/>",
    "i": "<w:i/>",
    "s": "<w:strike/>",
    "u": '<w:u w:val="single"/>',
    "sup": '<w:vertAlign w:val="superscript"/>',
    "sub": '<w:vertAlign w:val="subscript"/>',
}


def _run_xml(text: str, props: str) -> str:
    rpr = f"<w:rPr>{props}</w:rPr>" if props else ""
    return (
        f"<w:r>{rpr}<w:t xml:space=\"preserve\">"
        f"{html_mod.escape(text)}</w:t></w:r>"
    )


def _runs(text: str, props: str = "", depth: int = 0) -> str:
    """Markdown/HTML inline styling -> styled w:r runs (role parity with
    the reference's pandoc md->docx conversion of inline emphasis).
    Nested spans (e.g. **<u>x</u>**) recurse, merging run properties."""
    out = []
    pos = 0
    if depth < 6:
        for m in _INLINE_RE.finditer(text):
            if m.start() > pos:
                out.append(_run_xml(text[pos:m.start()], props))
            kind = m.lastgroup
            out.append(_runs(m.group(kind), props + _RPR[kind], depth + 1))
            pos = m.end()
    if pos < len(text):
        out.append(_run_xml(text[pos:], props))
    return "".join(out) or ("" if depth else "<w:r><w:t/></w:r>")


def _para(text: str, style: str | None = None) -> str:
    ppr = f"<w:pPr><w:pStyle w:val=\"{style}\"/></w:pPr>" if style else ""
    return f"<w:p>{ppr}{_runs(text)}</w:p>"


def _table(html: str) -> str:
    rows = re.findall(r"<tr[^>]*>(.*?)</tr>", html, re.S | re.I)
    out = [
        "<w:tbl><w:tblPr><w:tblBorders>"
        + "".join(
            f'<w:{side} w:val="single" w:sz="4" w:color="888888"/>'
            for side in ("top", "left", "bottom", "right", "insideH", "insideV")
        )
        + "</w:tblBorders></w:tblPr>"
    ]
    for row in rows:
        cells = re.findall(r"<t[dh][^>]*>(.*?)</t[dh]>", row, re.S | re.I)
        out.append("<w:tr>")
        for cell in cells:
            text = re.sub(r"<[^>]+>", " ", cell)
            text = html_mod.unescape(re.sub(r"\s+", " ", text)).strip()
            out.append(f"<w:tc><w:tcPr/>{_para(text)}</w:tc>")
        out.append("</w:tr>")
    out.append("</w:tbl>")
    # a spacer paragraph is required after tables
    out.append("<w:p/>")
    return "".join(out)


def markdown_to_docx(markdown: str) -> bytes:
    """Minimal but valid DOCX from markdown (headings, paragraphs, tables,
    list items as plain paragraphs)."""
    body_parts: list[str] = []
    lines = markdown.split("\n")
    i = 0
    buffer: list[str] = []

    def flush_buffer():
        text = " ".join(buffer).strip()
        if text:
            body_parts.append(_para(text))
        buffer.clear()

    while i < len(lines):
        line = lines[i]
        if line.lstrip().startswith("<table"):
            flush_buffer()
            tbl_lines = [line]
            while i < len(lines) and "</table>" not in lines[i]:
                i += 1
                if i < len(lines):
                    tbl_lines.append(lines[i])
            body_parts.append(_table("\n".join(tbl_lines)))
        elif m := re.match(r"^(#{1,6})\s+(.*)$", line):
            flush_buffer()
            body_parts.append(_para(m.group(2), style=f"Heading{len(m.group(1))}"))
        elif not line.strip():
            flush_buffer()
        else:
            buffer.append(re.sub(r"!\[\]\([^)]*\)", "", line).strip())
        i += 1
    flush_buffer()

    document = (
        f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f"<w:document {_W_NS}><w:body>{''.join(body_parts)}"
        f"<w:sectPr/></w:body></w:document>"
    )
    styles = (
        f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f"<w:styles {_W_NS}>"
        + "".join(
            f'<w:style w:type="paragraph" w:styleId="Heading{i}">'
            f'<w:name w:val="heading {i}"/>'
            f'<w:rPr><w:b/><w:sz w:val="{40 - 4 * i}"/></w:rPr></w:style>'
            for i in range(1, 7)
        )
        + "</w:styles>"
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/word/document.xml" ContentType="application/vnd.openxmlformats-officedocument.wordprocessingml.document.main+xml"/>'
        '<Override PartName="/word/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.wordprocessingml.styles+xml"/>'
        "</Types>"
    )
    rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="word/document.xml"/>'
        "</Relationships>"
    )
    doc_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/styles" Target="styles.xml"/>'
        "</Relationships>"
    )
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", rels)
        z.writestr("word/document.xml", document)
        z.writestr("word/styles.xml", styles)
        z.writestr("word/_rels/document.xml.rels", doc_rels)
    return buf.getvalue()
