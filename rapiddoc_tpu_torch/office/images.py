"""Office image normalization: WMF/EMF vector-media placeholders.

A copy of ``rapiddoc_tpu/office/images.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.

Pillow cannot rasterize Windows metafiles off-Windows, so docx/pptx/xlsx
media in WMF/EMF format would otherwise be emitted as bytes no viewer can
render (or silently dropped). Like the reference
(rapid_doc/backend/utils/office_image.py:34-181) we substitute a small
labeled placeholder raster; the original media is unrecoverable here by
design.
"""
from __future__ import annotations

import struct
import zlib
from functools import lru_cache

VECTOR_EXTENSIONS = frozenset({".wmf", ".emf", ".emz", ".wmz"})
VECTOR_CONTENT_TYPES = frozenset({
    "image/x-wmf", "image/wmf", "image/x-emf", "image/emf",
    "application/x-msmetafile",
})
PLACEHOLDER_SIZE = (320, 180)


def is_vector_image_name(name: str, content_type: str | None = None) -> bool:
    dot = name.rfind(".")
    ext = name[dot:].lower() if dot >= 0 else ""
    if ext in VECTOR_EXTENSIONS:
        return True
    ct = (content_type or "").split(";", 1)[0].strip().lower()
    return ct in VECTOR_CONTENT_TYPES


def _encode_png_gray(pixels: bytearray, w: int, h: int) -> bytes:
    """Minimal grayscale PNG encoder (no PIL dependency — the repo's own
    pdfio stack already avoids it on the decode side)."""
    raw = bytearray()
    for y in range(h):
        raw.append(0)  # filter: none
        raw += pixels[y * w:(y + 1) * w]

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw), 6))
            + chunk(b"IEND", b""))


# 5x7 bitmap glyphs for the placeholder label (rows of 5 bits, MSB left)
_GLYPHS = {
    "W": (0b10001, 0b10001, 0b10001, 0b10101, 0b10101, 0b10101, 0b01010),
    "M": (0b10001, 0b11011, 0b10101, 0b10101, 0b10001, 0b10001, 0b10001),
    "F": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000),
    "E": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b11111),
    "/": (0b00001, 0b00010, 0b00010, 0b00100, 0b01000, 0b01000, 0b10000),
    " ": (0, 0, 0, 0, 0, 0, 0),
}


@lru_cache(maxsize=1)
def vector_placeholder_png() -> bytes:
    """320x180 light-gray box with a border and a 'WMF/EMF' label."""
    w, h = PLACEHOLDER_SIZE
    px = bytearray([240]) * (w * h)
    # border
    bw = 2
    for y in range(h):
        for x in range(w):
            if x < bw or x >= w - bw or y < bw or y >= h - bw:
                px[y * w + x] = 190
    # centered label, 4x scale
    label, scale = "WMF/EMF", 4
    lw = len(label) * 6 * scale
    x0, y0 = (w - lw) // 2, (h - 7 * scale) // 2
    for i, ch in enumerate(label):
        rows = _GLYPHS.get(ch, _GLYPHS[" "])
        for ry, bits in enumerate(rows):
            for rx in range(5):
                if bits >> (4 - rx) & 1:
                    for sy in range(scale):
                        for sx in range(scale):
                            x = x0 + (i * 6 + rx) * scale + sx
                            y = y0 + ry * scale + sy
                            if 0 <= x < w and 0 <= y < h:
                                px[y * w + x] = 90
    return _encode_png_gray(px, w, h)


def normalize_office_image(
    name: str, data: bytes, content_type: str | None = None
) -> tuple[str, bytes]:
    """Replace WMF/EMF media with the placeholder PNG (renamed .png so
    MIME sniffing and viewers agree); pass raster media through."""
    if is_vector_image_name(name, content_type):
        dot = name.rfind(".")
        base = name[:dot] if dot >= 0 else name
        return f"{base}.png", vector_placeholder_png()
    return name, data
