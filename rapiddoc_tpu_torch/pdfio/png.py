"""PNG decoding as PIL opens a PNG for ``images_to_pdf``, and a plain PNG
writer, in numpy and zlib.

``decode_png`` returns what ``PIL.Image.open(png)`` holds after
``images_to_pdf``'s conversion (``rapiddoc_tpu/pdfio/writer.py:121-125``:
a mode other than ``L`` or ``RGB`` becomes ``RGB``): a (H, W) array for
mode ``L``, else (H, W, 3). PIL's modes by colour type and bit depth:

- 0 (grey): 1 bit is mode ``1`` (0 and 255 in RGB); 2 and 4 bits are
  ``L`` with each sample scaled to 0..255 (times 85 and 17); 8 bits ``L``;
- 0 (grey), 16 bits: ``I;16``;
- 2 (RGB), 8 and 16 bits: ``RGB``;
- 3 (palette), 1, 2, 4 or 8 bits: ``P``, looked up in ``PLTE`` (an index
  past the palette's end reads black);
- 4 (grey and alpha), 8 bits: ``LA``, the grey repeated in RGB (16
  bits: ``RGBA``, the same);
- 6 (RGBA), 8 and 16 bits: ``RGBA``, the alpha dropped
  (``convert("RGB")`` does not blend).

A ``tRNS`` chunk changes none of these. Rows are unfiltered for all five
filter types (None, Sub, Up, Average, Paeth) along anti-diagonals of
whole pixels (``unfilter``).

16-bit samples keep their high byte (16-bit grey opens as ``I;16``,
which ``convert("RGB")`` clips to 0..255; 16-bit grey and alpha opens
as ``RGBA``); Adam7 interlacing unfilters each pass as an image of its
own and scatters it. ``png_mode`` returns PIL's mode and samples, which
``pdfio.pil_modes.embed_pixels`` converts.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..utils.unported import not_ported
from .bmp import decode_bmp
from .gif import decode_gif
from .jpeg import cmyk_to_rgb_pil, decode_jpeg
from .pil_modes import check_size, embed_pixels, unpack_bits
from .tiff import decode_tiff

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The (height, row_bytes) uint8 samples of filtered scanlines
    (``raw``: each row's filter type byte, then its bytes). Pixel (y, x)
    needs (y, x - 1), (y - 1, x) and (y - 1, x - 1) only, so the image is
    held skewed (column y + x of row y), where each anti-diagonal is one
    column and one numpy step; a pixel is bpp bytes (1 below 8 bits)."""
    lines = raw[: height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    kinds = lines[:, 0].astype(np.int16)
    if (kinds > 4).any():
        raise ValueError(f"PNG filter type {int(kinds.max())}")
    cols = row_bytes // bpp
    filt = lines[:, 1:].reshape(height, cols, bpp).astype(np.int16)
    steps = height + cols - 1
    # skewed planes with a zero row above and two zero columns before
    f = np.zeros((height, steps, bpp), np.int16)
    y, x = np.mgrid[0:height, 0:cols]
    f[y, y + x] = filt
    out = np.zeros((height + 1, steps + 2, bpp), np.int16)
    sub, up, avg, paeth = ((kinds == k)[:, None] for k in (1, 2, 3, 4))
    for s in range(steps):
        rows = slice(max(0, s - cols + 1), min(height, s + 1))  # the rows on this diagonal
        here = slice(rows.start + 1, rows.stop + 1)  # the same rows in ``out``
        a = out[here, s + 1]  # (y, x - 1)
        b = out[rows, s + 1]  # (y - 1, x)
        c = out[rows, s]  # (y - 1, x - 1)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = (np.where(sub[rows], a, 0) + np.where(up[rows], b, 0)
                + np.where(avg[rows], (a + b) >> 1, 0)
                + np.where(paeth[rows], np.where((pa <= pb) & (pa <= pc), a,
                                                 np.where(pb <= pc, b, c)), 0))
        out[here, s + 2] = (f[rows, s] + pred) & 255
    return out[1 + y, 2 + y + x].reshape(height, row_bytes).astype(np.uint8)


# PIL's mode for (bit depth, colour type)
_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
          (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P", (2, 3): "P", (4, 3): "P",
          (8, 3): "P", (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack(samples: np.ndarray, height: int, width: int, channels: int,
            depth: int) -> np.ndarray:
    """(height, row_bytes) unfiltered bytes -> (height, width, channels)
    sample values: uint8 up to 8 bits, big-endian uint16 at 16."""
    if depth == 16:
        return (samples[:, : width * channels * 2].reshape(height, width * channels, 2)
                .view(">u2")[..., 0].astype(np.uint16).reshape(height, width, channels))
    if depth < 8:
        samples = unpack_bits(samples, width, depth)
    return samples[:, : width * channels].reshape(height, width, channels)


def png_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    """PNG bytes -> (PIL's mode, its samples, the palette or None): (H, W)
    for one channel, else (H, W, C)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG")
    header = None
    idat = []
    palette = None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("a PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    check_size(width, height)
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype}")
    if (depth, ctype) not in _MODES:
        raise ValueError(f"PNG colour type {ctype} at {depth} bits")
    mode = _MODES[depth, ctype]
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        row_bytes = (pw * channels * depth + 7) // 8
        size = ph * (row_bytes + 1)
        samples = unfilter(raw[pos:pos + size], ph, row_bytes, bpp)
        pos += size
        out[y0::dy, x0::dx] = _unpack(samples, ph, pw, channels, depth)
    if ctype == 0:
        grey = out[..., 0]
        if depth in (2, 4):  # PIL's L;2 and L;4 scale to 0..255
            grey = (grey.astype(np.int64) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return mode, grey, None
    if ctype == 3:
        if palette is None:
            raise ValueError("a palette PNG without PLTE")
        return mode, out[..., 0], palette
    if depth == 16:  # PIL keeps the high byte of each sample
        out = (out >> 8).astype(np.uint8)
    if ctype == 4 and depth == 16:  # LA;16B unpacks into RGBA
        out = np.concatenate([np.repeat(out[..., :1], 3, axis=2), out[..., 1:]], axis=2)
    return mode, out, None


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) grey or (H, W, 3) RGB uint8, as described in the
    module docstring."""
    return embed_pixels(*png_mode(data))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) grey or (H, W, 3) RGB -> an 8-bit PNG, every row
    unfiltered (filter type 0), one zlib IDAT."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def decode_image(data: bytes) -> np.ndarray:
    """An image file's pixels as ``images_to_pdf`` takes them from PIL:
    (H, W) for mode ``L``, else (H, W, 3) RGB. PNG (``decode_png``), the
    JPEGs ``pdfio.jpeg`` decodes (a CMYK one through Pillow's
    ``convert("RGB")``), BMP (``pdfio.bmp``), GIF's first frame
    (``pdfio.gif``), TIFF's first page (``pdfio.tiff``), WEBP's first
    frame (``pdfio.webp``) and JPEG 2000 (``pdfio.jpx``); the rest raise
    NotImplementedError naming ROADMAP item 12f."""
    if data.startswith(SIGNATURE):
        return decode_png(data)
    if data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(data)
        return cmyk_to_rgb_pil(img) if img.ndim == 3 and img.shape[2] == 4 else img
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return decode_tiff(data)
    if data[:4] == b"RIFF":
        from .webp import decode_webp

        return decode_webp(data)
    if data[:4] == b"\xff\x4f\xff\x51" or data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n":
        from .jpx import decode_jpx

        return decode_jpx(data)
    raise not_ported("image files other than PNG, JPEG, BMP, GIF, TIFF, WEBP and JPEG 2000",
                     "pdfio")
