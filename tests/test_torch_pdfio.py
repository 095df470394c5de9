"""The port's PDF parser (copied from the JAX package) against the JAX
package's: page count, page sizes, image placements, native text and the
txt/ocr classification, on the fixture PDF, on PDFs the JAX package's
writer makes here, and on hand-written text PDFs."""
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rapiddoc_tpu import pdfio as jax_pdfio
from rapiddoc_tpu.pdfio.placements import image_placements as jax_placements
from rapiddoc_tpu_torch import pdfio
from rapiddoc_tpu_torch.pdfio.placements import image_placements

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "rapiddoc_tpu_torch" / "assets" / "ocr_smoke_doc.pdf"


def text_pdf(pages: list[str], flate: bool = False, media=(0, 0, 612, 792)) -> bytes:
    """Pages of Helvetica text lines, one PDF object each; the content
    streams optionally Flate-compressed."""
    objs = {1: b"<< /Type /Catalog /Pages 2 0 R >>"}
    font = 3 + 2 * len(pages)
    kids = []
    for i, text in enumerate(pages):
        lines = [ln for ln in text.splitlines() if ln]
        ops = b"BT /F1 12 Tf 72 720 Td 14 TL " + b" ".join(
            b"(" + ln.encode("latin-1") + b") Tj T*" for ln in lines) + b" ET"
        data = zlib.compress(ops) if flate else ops
        head = b"/Filter /FlateDecode " if flate else b""
        objs[3 + 2 * i] = (b"<< /Type /Page /Parent 2 0 R /MediaBox [%d %d %d %d] "
                           % media + b"/Resources << /Font << /F1 %d 0 R >> >> " % font
                           + b"/Contents %d 0 R >>" % (4 + 2 * i))
        objs[4 + 2 * i] = (b"<< " + head + b"/Length %d >>\nstream\n" % len(data)
                           + data + b"\nendstream")
        kids.append(b"%d 0 R" % (3 + 2 * i))
    objs[2] = b"<< /Type /Pages /Kids [" + b" ".join(kids) + b"] /Count %d >>" % len(pages)
    objs[font] = b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"
    out = bytearray(b"%PDF-1.4\n")
    offsets = {}
    for num in sorted(objs):
        offsets[num] = len(out)
        out += b"%d 0 obj\n" % num + objs[num] + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    out += b"".join(b"%010d 00000 n \n" % offsets[n] for n in sorted(objs))
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (len(objs) + 1, xref)
    return bytes(out)


WORDS = ("the quick brown fox jumps over a lazy dog while reading documents "
         "page layout text lines paragraphs tables figures equations").split()


def prose(rng: np.random.Generator, lines: int) -> str:
    return "\n".join(" ".join(rng.choice(WORDS, 9)) for _ in range(lines))


def writer_pdfs() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (80, 50), dtype=np.uint8)
    with np.load(REPO / "rapiddoc_tpu_torch" / "assets" / "ocr_smoke_pages.npz") as z:
        page = z["pages"][1][:400, :640]
    return {
        "fixture": FIXTURE.read_bytes(),
        "writer_72dpi": jax_pdfio.images_to_pdf([Image.fromarray(rgb), Image.fromarray(grey)], dpi=72),
        "writer_200dpi": jax_pdfio.images_to_pdf([Image.fromarray(page)], dpi=200),
        "text": text_pdf([prose(rng, 40), prose(rng, 35)]),
        "text_short": text_pdf(["Hello world\nA second line of text here",
                                "Page two\nwith more words to read"]),
        "text_flate_a4": text_pdf(["Compressed content stream\nline two"] * 3, flate=True,
                                  media=(0, 0, 595, 842)),
    }


PDFS = writer_pdfs()


@pytest.mark.parametrize("name", list(PDFS))
def test_pages_sizes_and_placements_equal_jax(name):
    data = PDFS[name]
    jdoc, doc = jax_pdfio.open_pdf(data), pdfio.open_pdf(data)
    assert len(doc) == len(jdoc) > 0
    for i in range(len(doc)):
        jp, p = jdoc.get_page(i), doc.get_page(i)
        assert p.size == jp.size
        assert p.cropbox == jp.cropbox and p.rotation == jp.rotation
        assert image_placements(p) == jax_placements(jp)


@pytest.mark.parametrize("name", list(PDFS))
def test_text_and_classification_equal_jax(name):
    data = PDFS[name]
    jdoc, doc = jax_pdfio.open_pdf(data), pdfio.open_pdf(data)
    for i in range(len(doc)):
        assert pdfio.page_text(doc.get_page(i)) == jax_pdfio.page_text(jdoc.get_page(i))
        assert pdfio.get_page(doc.get_page(i)) == jax_pdfio.get_page(jdoc.get_page(i))
    assert pdfio.classify_pdf(data) == jax_pdfio.classify_pdf(data)


def test_classification_of_the_two_kinds():
    assert pdfio.classify_pdf(PDFS["fixture"]) == "ocr"
    assert pdfio.classify_pdf(PDFS["text"]) == "txt"


def _lzw_strip(img: Image.Image) -> bytes:
    """The one LZW strip PIL's libtiff writes for ``img``."""
    import io
    import struct

    buf = io.BytesIO()
    img.save(buf, format="TIFF", compression="tiff_lzw", tiffinfo={278: img.height})
    data = buf.getvalue()
    (first,) = struct.unpack_from("<I", data, 4)
    tags = {}
    for i in range(struct.unpack_from("<H", data, first)[0]):
        tag, typ, _, value = struct.unpack_from("<HHII", data, first + 2 + 12 * i)
        tags[tag] = value & 0xFFFF if typ == 3 else value
    return data[tags[273]:tags[273] + tags[279]]


@pytest.mark.parametrize("early", [None, 0, 1, 2])
def test_lzw_decode_equals_jax(early):
    """The port's /LZWDecode against the JAX package's on libtiff's
    streams of seeded images; at EarlyChange 2 (libtiff's code widths,
    which the TIFF decoder uses) both give the strip's bytes back."""
    from rapiddoc_tpu.pdfio.filters import lzw_decode as jax_lzw
    from rapiddoc_tpu_torch.pdfio.filters import lzw_decode

    rng = np.random.default_rng(early or 7)
    params = {} if early is None else {"EarlyChange": early}
    with np.load(REPO / "rapiddoc_tpu_torch" / "assets" / "ocr_smoke_pages.npz") as z:
        page = z["pages"][0][:300, :400]
    images = [rng.integers(0, 256, (40, 60), dtype=np.uint8),
              rng.integers(0, 4, (120, 90), dtype=np.uint8) * 60, page[..., 0]]
    def outcome(fn, strip):
        try:
            return fn(strip, params)
        except IndexError as exc:  # a code past the table, read at a wrong width
            return repr(exc)

    for arr in images:
        strip = _lzw_strip(Image.fromarray(arr))
        got = outcome(lzw_decode, strip)
        assert got == outcome(jax_lzw, strip)
        if early == 2:
            assert got == arr.tobytes()


def test_lzw_decode_time_grows_linearly():
    """A 400 kB stream decodes in well under a second a run: the bit buffer
    is kept short (an unbounded one made each code cost the stream's
    length, about 30 s for this stream)."""
    import time

    from rapiddoc_tpu_torch.pdfio.filters import lzw_decode

    arr = np.random.default_rng(3).integers(0, 256, (640, 640), dtype=np.uint8)
    strip = _lzw_strip(Image.fromarray(arr))
    assert len(strip) > 400_000
    t0 = time.perf_counter()
    assert lzw_decode(strip, {"EarlyChange": 2}) == arr.tobytes()
    assert time.perf_counter() - t0 < 8.0
