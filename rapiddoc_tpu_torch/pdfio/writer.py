"""PDF generation: serialize COS objects, build PDFs from images, subset pages.

Port of ``rapiddoc_tpu/pdfio/writer.py``: ``PdfWriter`` (:69),
``images_to_pdf`` (:115) and ``select_pages`` (:168), with the same
serialisation, so the same inputs give the same bytes. ``images_to_pdf``
takes image file bytes (``pdfio.png.decode_image``: PNG and baseline
JPEG, as PIL opens them) or uint8 arrays, and embeds each image as the
JPEG PIL writes at quality 92 (``pdfio.jpeg_encode``): grey for a (H, W)
array or a mode ``L`` file, RGB otherwise (an alpha channel is dropped,
as ``convert("RGB")`` drops it).
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from .cos import Name, Ref, Stream
from .document import PdfDocument
from .jpeg_encode import encode_jpeg
from .pil_modes import array_pixels, is_image_object, object_pixels
from .png import decode_image

PDF_JPEG_QUALITY = 92


def _serialize(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"null"
    elif isinstance(obj, bool):
        out += b"true" if obj else b"false"
    elif isinstance(obj, Name):
        out += b"/" + _escape_name(str(obj))
    elif isinstance(obj, (int,)):
        out += str(obj).encode()
    elif isinstance(obj, float):
        out += f"{obj:.6g}".encode()
    elif isinstance(obj, bytes):
        out += b"<" + obj.hex().encode() + b">"
    elif isinstance(obj, str):
        out += b"/" + _escape_name(obj)  # bare strings are names in our model
    elif isinstance(obj, Ref):
        out += f"{obj.num} {obj.gen} R".encode()
    elif isinstance(obj, list):
        out += b"["
        for i, v in enumerate(obj):
            if i:
                out += b" "
            _serialize(v, out)
        out += b"]"
    elif isinstance(obj, dict):
        out += b"<<"
        for k, v in obj.items():
            out += b"/" + _escape_name(str(k)) + b" "
            _serialize(v, out)
        out += b">>"
    elif isinstance(obj, Stream):
        d = dict(obj.dict)
        d[Name("Length")] = len(obj.raw)
        _serialize(d, out)
        out += b"\nstream\n"
        out += obj.raw
        out += b"\nendstream"
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def _escape_name(name: str) -> bytes:
    out = bytearray()
    for ch in name.encode("latin-1", errors="replace"):
        if ch <= 32 or ch >= 127 or ch in b"()<>[]{}/%#":
            out += b"#%02X" % ch
        else:
            out.append(ch)
    return bytes(out)


class PdfWriter:
    """Accumulates numbered objects and emits a classic-xref PDF."""

    def __init__(self) -> None:
        self.objects: dict[int, Any] = {}
        self._next = 1

    def add(self, obj: Any) -> Ref:
        num = self._next
        self._next += 1
        self.objects[num] = obj
        return Ref(num)

    def reserve(self) -> Ref:
        return self.add(None)

    def set(self, ref: Ref, obj: Any) -> None:
        self.objects[ref.num] = obj

    def tobytes(self, root_ref: Ref) -> bytes:
        out = bytearray(b"%PDF-1.7\n%\xe2\xe3\xcf\xd3\n")
        offsets: dict[int, int] = {}
        for num in sorted(self.objects):
            offsets[num] = len(out)
            out += f"{num} 0 obj\n".encode()
            _serialize(self.objects[num], out)
            out += b"\nendobj\n"
        xref_pos = len(out)
        maxnum = max(self.objects) if self.objects else 0
        out += f"xref\n0 {maxnum + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        for num in range(1, maxnum + 1):
            if num in offsets:
                out += f"{offsets[num]:010d} 00000 n \n".encode()
            else:
                out += b"0000000000 65535 f \n"
        trailer = {
            Name("Size"): maxnum + 1,
            Name("Root"): root_ref,
        }
        out += b"trailer\n"
        _serialize(trailer, out)
        out += f"\nstartxref\n{xref_pos}\n%%EOF\n".encode()
        return bytes(out)


def _pixels(img) -> np.ndarray:
    """(H, W) grey or (H, W, 3) RGB uint8 pixels of an image file, array
    or image object, as the JAX package's ``images_to_pdf`` embeds them."""
    if isinstance(img, (bytes, bytearray, memoryview)):
        return decode_image(bytes(img))
    if is_image_object(img):
        return object_pixels(img)
    return array_pixels(np.asarray(img))


def images_to_pdf(images: Iterable[bytes | np.ndarray], dpi: int = 72) -> bytes:
    """Build a PDF with one page per image (JPEG-embedded at quality 92)."""
    writer = PdfWriter()
    page_refs: list[Ref] = []
    pages_ref = writer.reserve()
    for img in images:
        pixels = _pixels(img)
        h, w = pixels.shape[:2]
        img_stream = Stream(
            {
                Name("Type"): Name("XObject"),
                Name("Subtype"): Name("Image"),
                Name("Width"): w,
                Name("Height"): h,
                Name("ColorSpace"): Name("DeviceRGB" if pixels.ndim == 3 else "DeviceGray"),
                Name("BitsPerComponent"): 8,
                Name("Filter"): Name("DCTDecode"),
            },
            encode_jpeg(pixels, PDF_JPEG_QUALITY),
        )
        img_ref = writer.add(img_stream)
        # page size in points so that image is `dpi` resolution
        pw, ph = w * 72.0 / dpi, h * 72.0 / dpi
        content = f"q {pw:.2f} 0 0 {ph:.2f} 0 0 cm /Im0 Do Q".encode()
        content_ref = writer.add(Stream({}, content))
        page = {
            Name("Type"): Name("Page"),
            Name("Parent"): pages_ref,
            Name("MediaBox"): [0, 0, round(pw, 2), round(ph, 2)],
            Name("Resources"): {Name("XObject"): {Name("Im0"): img_ref}},
            Name("Contents"): content_ref,
        }
        page_refs.append(writer.add(page))
    writer.set(
        pages_ref,
        {
            Name("Type"): Name("Pages"),
            Name("Kids"): page_refs,
            Name("Count"): len(page_refs),
        },
    )
    root_ref = writer.add({Name("Type"): Name("Catalog"), Name("Pages"): pages_ref})
    return writer.tobytes(root_ref)


def select_pages(pdf_bytes: bytes, page_indices: Iterable[int]) -> bytes:
    """Rebuild a PDF containing only the given 0-based pages (deep-copies the
    object graph; equivalent of the reference's pypdfium2 page import)."""
    doc = PdfDocument(pdf_bytes)
    writer = PdfWriter()
    memo: dict[int, Ref] = {}

    def copy_obj(obj: Any, depth: int = 0) -> Any:
        if depth > 64:
            return None
        if isinstance(obj, Ref):
            if obj.num in memo:
                return memo[obj.num]
            target = doc.get_object(obj.num, obj.gen)
            new_ref = writer.reserve()
            memo[obj.num] = new_ref
            writer.set(new_ref, copy_obj(target, depth + 1))
            return new_ref
        if isinstance(obj, list):
            return [copy_obj(v, depth + 1) for v in obj]
        if isinstance(obj, Stream):
            return Stream(
                {k: copy_obj(v, depth + 1) for k, v in obj.dict.items()}, obj.raw
            )
        if isinstance(obj, dict):
            return {
                k: copy_obj(v, depth + 1)
                for k, v in obj.items()
                if k != "Parent"  # re-parented below
            }
        return obj

    pages_ref = writer.reserve()
    page_refs = []
    n = len(doc)
    for idx in page_indices:
        if not 0 <= idx < n:
            continue
        page = doc.get_page(idx)
        page_dict = dict(page.dict)
        # materialize inherited attributes
        for key in ("Resources", "MediaBox", "CropBox", "Rotate"):
            if key not in page_dict:
                val = page._attr(key)
                if val is not None:
                    page_dict[Name(key)] = val
        copied = copy_obj(page_dict)
        copied[Name("Parent")] = pages_ref
        page_refs.append(writer.add(copied))
    writer.set(
        pages_ref,
        {
            Name("Type"): Name("Pages"),
            Name("Kids"): page_refs,
            Name("Count"): len(page_refs),
        },
    )
    root_ref = writer.add({Name("Type"): Name("Catalog"), Name("Pages"): pages_ref})
    return writer.tobytes(root_ref)
