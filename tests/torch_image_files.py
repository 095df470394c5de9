"""Image files built from seeds for the port's image-file tests.

PIL writes what it can (PNG, BMP, GIF, TIFF in their common forms); the
forms PIL does not write are built here byte by byte: 16-bit and Adam7
PNGs with every filter type, BMPs of every bit depth, compression
(RLE8, RLE4, BITFIELDS), row order and header size, and GIFs with local
palettes, interlaced rows, offsets and transparency. Every file is
decoded by PIL as the JAX package's ``images_to_pdf`` decodes it
(``jax_pixels``); the tests hold the port's pixels to that.
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np


def jax_pixels(data: bytes) -> np.ndarray:
    """The pixels the JAX package's ``images_to_pdf`` embeds for a file."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.load()
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    return np.asarray(img)


def pil_save(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


# ------------------------------------------------------------------ PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_filter(rows: np.ndarray, bpp: int, kinds: np.ndarray) -> bytes:
    """Filter each row of (h, row_bytes) uint8 with its filter type."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for row, kind in zip(rows.astype(np.int32), kinds):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp] if bpp < len(row) else row[:0]])[: len(row)]
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp] if bpp < len(prev) else prev[:0]])[: len(row)]
        b = prev
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - a
        elif kind == 2:
            f = row - b
        elif kind == 3:
            f = row - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(int(kind))
        out += (f & 255).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack(values: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * channels) sample values -> (h, row_bytes) uint8."""
    h = values.shape[0]
    if depth == 16:
        return values.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return values.astype(np.uint8)
    bits = ((values[..., None].astype(np.uint16) >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def png_bytes(values: np.ndarray, depth: int, ctype: int, *, interlace: bool = False,
              palette: np.ndarray | None = None, seed: int = 0) -> bytes:
    """A PNG of (H, W) or (H, W, C) sample values, each row (of each Adam7
    pass) under a filter type drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w = values.shape[:2]
    channels = _PNG_CHANNELS[ctype]
    values = values.reshape(h, w, channels)
    bpp = max(1, channels * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = values[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        raw += _png_filter(rows, bpp, rng.integers(0, 5, len(rows)))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


# ------------------------------------------------------------------ BMP


def _rle8(index: np.ndarray, rng) -> bytes:
    """RLE8 rows (bottom-up), mixing encoded runs, absolute runs and a
    delta; each row ends with an end of line, the bitmap with its end."""
    out = bytearray()
    for row in index[::-1]:
        x = 0
        w = len(row)
        while x < w:
            n = int(min(w - x, rng.integers(1, 9)))
            if n >= 3 and rng.random() < 0.5:  # absolute run
                out += bytes([0, n]) + row[x:x + n].tobytes()
                if n % 2:
                    out.append(0)
            else:  # encoded run of the first pixel's index
                out += bytes([n, row[x]])
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _rle4(index: np.ndarray, rng) -> bytes:
    out = bytearray()
    for row in index[::-1]:
        x = 0
        w = len(row)
        while x < w:
            n = int(min(w - x, rng.integers(1, 9)))
            if n >= 4 and n % 2 == 0 and rng.random() < 0.5:  # absolute run
                pix = row[x:x + n]
                packed = bytes((int(pix[i]) << 4) | int(pix[i + 1]) for i in range(0, n, 2))
                out += bytes([0, n]) + packed
                if len(packed) % 2:
                    out.append(0)
            else:  # encoded run alternating the next two indices
                hi, lo = int(row[x]), int(row[x + 1]) if x + 1 < w else 0
                out += bytes([n, (hi << 4) | lo])
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_bytes(width: int, height: int, bits: int, *, seed: int = 0, compression: int = 0,
              header_size: int = 40, top_down: bool = False, masks=None,
              palette: np.ndarray | None = None, colors: int | None = None) -> bytes:
    """A BMP with seeded pixels: a palette image for 1, 4 and 8 bits (RLE8
    or RLE4 with ``compression`` 1 or 2), packed pixels for 16, 24 and 32
    (BITFIELDS ``masks`` with ``compression`` 3)."""
    rng = np.random.default_rng(seed)
    n_colors = colors or (1 << bits if bits <= 8 else 0)
    if bits <= 8:
        if palette is None:
            palette = rng.integers(0, 256, (n_colors, 3), dtype=np.uint8)
        index = rng.integers(0, len(palette), (height, width), dtype=np.uint8)
        if compression == 1:
            pixels = _rle8(index, rng)
        elif compression == 2:
            pixels = _rle4(index, rng)
        else:
            stride = ((width * bits + 31) >> 3) & ~3
            rows = _pack(index, bits) if bits < 8 else index
            rows = np.pad(rows, ((0, 0), (0, stride - rows.shape[1])))
            pixels = (rows if top_down else rows[::-1]).tobytes()
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        rows = rng.integers(0, 256, (height, stride), dtype=np.uint8)
        pixels = (rows if top_down else rows[::-1]).tobytes()
    if header_size == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        pal = b"".join(bytes([b, g, r]) for r, g, b in palette) if bits <= 8 else b""
    else:
        h = -height if top_down else height
        info = struct.pack("<IiiHHIIiiII", header_size, width, h, 1, bits, compression,
                           len(pixels), 2835, 2835, colors or 0, 0)
        extra = b""
        if masks is not None:
            m = struct.pack("<4I", *(tuple(masks) + (0,) * (4 - len(masks))))
            if header_size == 40:
                extra = m[:12]
            else:
                info += m[: header_size - 40]
        info += b"\x00" * (header_size - len(info))
        info += extra
        pal = b"".join(bytes([b, g, r, 0]) for r, g, b in palette) if bits <= 8 else b""
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    return head + info + pal + pixels


# ------------------------------------------------------------------ GIF


def _lzw_codes(index: np.ndarray, min_size: int) -> bytes:
    """A valid LZW stream that never grows its table: a clear code before
    the table would need a wider code (every pixel one code)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    size = min_size + 1
    limit = (1 << size) - 2 - end  # codes before the table outgrows ``size`` bits
    acc, nbits, out = 0, 0, bytearray()

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    put(clear)
    run = 0
    for v in index.ravel():
        if run == limit:
            put(clear)
            run = 0
        put(int(v))
        run += 1
    put(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out += bytes([len(part)]) + part
    return bytes(out + b"\x00")


def gif_bytes(width: int, height: int, *, seed: int = 0, global_colors: int | None = 16,
              local_colors: int | None = None, frame: tuple | None = None,
              interlace: bool = False, transparency: int | None = None,
              grey_palette: bool = False, frames: int = 1) -> bytes:
    """A GIF with seeded indices: a global and/or local palette (grey
    identity palettes with ``grey_palette``), the first frame placed at
    ``frame`` = (x0, y0, w, h) of the screen, interlaced rows, a
    transparency index; more frames after the first with ``frames``."""
    rng = np.random.default_rng(seed)

    def palette(n):
        if grey_palette:
            return np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, axis=1)
        return rng.integers(0, 256, (n, 3), dtype=np.uint8)

    def bits(n):
        return max(1, int(np.ceil(np.log2(n))))

    out = bytearray(b"GIF89a" + struct.pack("<HH", width, height))
    if global_colors:
        b = bits(global_colors)
        out += bytes([0x80 | (b - 1), 0, 0]) + palette(1 << b).tobytes()
    else:
        out += bytes([0, 0, 0])
    x0, y0, fw, fh = frame or (0, 0, width, height)
    n_index = 1 << bits(local_colors or global_colors or 256)
    for k in range(frames):
        if transparency is not None:
            out += b"!\xf9\x04" + bytes([1]) + b"\x00\x00" + bytes([transparency]) + b"\x00"
        index = rng.integers(0, n_index, (fh, fw), dtype=np.uint8)
        flags = 0x40 if interlace else 0
        local = b""
        if local_colors:
            b = bits(local_colors)
            flags |= 0x80 | (b - 1)
            local = palette(1 << b).tobytes()
        out += b"," + struct.pack("<HHHHB", x0, y0, fw, fh, flags) + local
        rows = index
        if interlace:
            order = [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                     for y in range(start, fh, step)]
            rows = index[order]
        min_size = max(2, bits(n_index))
        out += bytes([min_size]) + _blocks(_lzw_codes(rows, min_size))
    return bytes(out + b";")


# ------------------------------------------------- decompression bombs

def _tiff_header(width: int, height: int, bits: int, compression: int) -> bytes:
    """A little-endian grey TIFF whose one strip holds a few bytes."""
    tags = [(256, 4, width), (257, 4, height), (258, 3, bits), (259, 3, compression),
            (262, 3, 1), (273, 4, 8 + 2 + 12 * 9 + 4), (277, 3, 1), (278, 4, height),
            (279, 4, 4)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", tag, typ, 1) + struct.pack("<I" if typ == 4 else "<HH", value,
                                                       *(() if typ == 4 else (0,)))
        for tag, typ, value in tags) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + b"\x00\x01\x00\x00"


def bomb_bytes(kind: str) -> bytes:
    """A file of a few dozen bytes whose header declares far more pixels
    than PIL's decompression bomb check allows."""
    side = 65535
    if kind == "png":
        def chunk(tag: bytes, body: bytes) -> bytes:
            return (struct.pack(">I", len(body)) + tag + body
                    + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

        return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", side, side, 8, 2,
                                                                  0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"\x00" * 4)) + chunk(b"IEND", b""))
    if kind in ("bmp", "bmp_os2"):
        if kind == "bmp_os2":
            header = struct.pack("<IHHHH", 12, side, side, 1, 24)
        else:
            header = struct.pack("<IiiHHIIiiII", 40, side, side, 1, 24, 0, 0, 0, 0, 0, 0)
        return b"BM" + struct.pack("<IHHI", 14 + len(header) + 4, 0, 0,
                                   14 + len(header)) + header + b"\x00" * 4
    if kind in ("gif_screen", "gif_frame"):
        screen, at, frame = (side, 0, 1) if kind == "gif_screen" else (16, side - 300, 300)
        return (b"GIF89a" + struct.pack("<HHBBB", screen, screen, 0x80, 0, 0) + b"\x00" * 3
                + b"\xff" * 3 + b"," + struct.pack("<HHHHB", at, at, frame, frame, 0)
                + b"\x02\x02\x44\x01\x00;")
    if kind == "tiff_grey":
        return _tiff_header(side, side, 8, 1)
    if kind == "tiff_g4":
        return _tiff_header(side, side, 1, 4)
    if kind == "jpeg":
        from PIL import Image

        data = bytearray(pil_save(Image.new("L", (8, 8), 128), "JPEG"))
        sof = data.index(b"\xff\xc0")
        data[sof + 5:sof + 9] = struct.pack(">HH", side, side)
        return bytes(data)
    raise ValueError(kind)
