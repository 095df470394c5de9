"""BMP decoding as PIL opens a BMP for ``images_to_pdf``.

``bmp_mode`` returns PIL's mode and samples (``pdfio.pil_modes``
converts them). Pillow 12.1's ``BmpImagePlugin``, read and checked by
experiment (``tests/test_torch_image_files.py``):

- headers of 12 bytes (OS/2: 16-bit sizes, 3-byte palette entries,
  bottom-up) and of 40, 52, 56, 64, 108 or 124 bytes (a negative height
  is top-down); the pixel data starts at the file header's offset, moved
  past ``4 * colors`` when it points right after the header of an image
  of at most 8 bits (even for a 12-byte header);
- 1, 4 and 8 bits: mode ``P`` with the palette (``colors``, or ``1 <<
  bits`` entries); a 2-entry palette of black then white is mode ``1``,
  a palette whose entry i is (i, i, i) is mode ``L`` (which PIL cannot
  read at 4 bits: it raises);
- 16 bits: ``BGR;15`` (5-5-5), or ``BGR;16`` (5-6-5) under BITFIELDS;
  24 bits BGR; 32 bits BGRX, or under BITFIELDS the byte order the masks
  give, with alpha (mode ``RGBA``) when a mask names it;
- RLE8 and RLE4 as ``BmpRleDecoder`` runs them, quirks included: a delta
  reads two bytes and then takes the next two, an odd RLE4 absolute run
  writes one pixel fewer than it counts, and data short of the image
  raises.

Other depths, compressions and bitfield layouts raise ValueError, where
PIL raises OSError.
"""
from __future__ import annotations

import struct

import numpy as np

from .pil_modes import check_size, embed_pixels, unpack_bits

_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from("<H", data, pos)[0]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """``BmpRleDecoder.decode``: one byte a pixel, in file row order."""
    out = bytearray()
    x = 0
    need = width * height
    end = len(data)
    while len(out) < need:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, width - x))
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            while len(out) % width:
                out.append(0)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then uses the next two
            if pos + 2 > end:
                break
            pos += 2
            if pos + 2 > end:  # PIL fails to unpack a short read
                raise ValueError("truncated BMP delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # absolute run
            if rle4:
                n = byte // 2
                chunk = data[pos:pos + n]
                pos += len(chunk)
                for b in chunk:
                    out += bytes([b >> 4, b & 15])
            else:
                n = byte
                chunk = data[pos:pos + n]
                pos += len(chunk)
                out += chunk
            if len(chunk) < n:
                break
            x += byte
            if pos % 2:  # word alignment (of the file position)
                pos += 1
    if len(out) < need:
        raise ValueError("not enough image data")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(height, width)


def _unpack(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """Packed rows -> samples, for one of PIL's raw modes."""
    if rawmode in ("P;1", "P;4", "1"):
        return unpack_bits(rows, width, 4 if rawmode == "P;4" else 1)
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        px = rows[:, : 2 * width].reshape(rows.shape[0], width, 2).astype(np.int32)
        px = px[..., 0] | (px[..., 1] << 8)
        if rawmode == "BGR;15":
            r, g, b = (px >> 10) & 31, (px >> 5) & 31, px & 31
            g = g * 255 // 31
        else:
            r, g, b = (px >> 11) & 31, (px >> 5) & 63, px & 31
            g = g * 255 // 63
        return np.stack([r * 255 // 31, g, b * 255 // 31], -1).astype(np.uint8)
    nbytes = len(rawmode.replace(";", ""))
    px = rows[:, : nbytes * width].reshape(rows.shape[0], width, nbytes)
    order = [rawmode.index(c) for c in "RGB"]
    out = px[..., order]
    if "A" in rawmode:
        out = np.concatenate([out, px[..., [rawmode.index("A")]]], axis=-1)
    return out


def bmp_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    """BMP bytes -> (PIL's mode, its samples, the palette or None)."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError("not a BMP")
    offset = _u32(data, 10)
    header_size = _u32(data, 14)
    pos = 18
    compression = 0
    colors = 0
    direction = -1
    masks = None
    if header_size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", data, pos)
        padding = 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        hd = data[pos:14 + header_size]
        if len(hd) < header_size - 4:
            raise ValueError("truncated BMP header")
        flip = hd[7] == 0xFF
        direction = 1 if flip else -1
        width = _u32(hd, 0)
        height = 2 ** 32 - _u32(hd, 4) if flip else _u32(hd, 4)
        bits = _u16(hd, 10)
        compression = _u32(hd, 12)
        colors = _u32(hd, 28)
        padding = 4
        if compression == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = [_u32(hd, 36 + 4 * i) for i in range(n)] + [0] * (4 - n)
            else:
                masks = [_u32(data, 14 + header_size + 4 * i) for i in range(3)] + [0]
    else:
        raise ValueError(f"Unsupported BMP header type ({header_size})")
    check_size(width, height)
    pos = 14 + header_size  # the palette follows the header
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    rawmode = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}.get(bits)
    if rawmode is None:
        raise ValueError(f"Unsupported BMP pixel depth ({bits})")
    mode = "P" if bits <= 8 else "RGB"
    rle = False
    if compression == 3:
        key = (bits, tuple(masks)) if bits == 32 else (bits, tuple(masks[:3]))
        if key not in _MASK_MODES:
            raise ValueError("Unsupported BMP bitfields layout")
        rawmode = _MASK_MODES[key]
        if "A" in rawmode:
            mode = "RGBA"
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise ValueError(f"Unsupported BMP compression ({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"Unsupported BMP Palette size ({colors})")
        raw = data[pos:pos + padding * colors]
        entries = [raw[i * padding:i * padding + 3] for i in range(colors)]
        values = (0, 255) if colors == 2 else range(colors)
        grey = all(i * padding + 3 <= len(raw) and entries[i] == bytes([v]) * 3
                   for i, v in enumerate(values))
        if grey:
            mode = "1" if colors == 2 else "L"
            if not rle:
                rawmode = mode
        else:
            pal = np.frombuffer(raw[: len(raw) // padding * padding], np.uint8)
            palette = pal.reshape(-1, padding)[:, 2::-1]
    if rle:
        index = _rle(data, offset, width, height, compression == 2)
        return mode, index[::-1] if direction == -1 else index, palette
    stride = ((width * bits + 31) >> 3) & ~3
    if rawmode == "L" and bits < 8:
        # PIL reads a grey 4-bit palette as L, one byte a pixel, with the
        # stride of the packed rows: shorter than a row, which it refuses
        raise ValueError("codec configuration error when reading image file")
    body = np.frombuffer(data, np.uint8, offset=min(offset, len(data)))
    if len(body) < stride * height:
        raise ValueError("image file is truncated")
    rows = body[: stride * height].reshape(height, stride)
    if direction == -1:
        rows = rows[::-1]
    return mode, _unpack(rows, width, rawmode), palette


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> what ``images_to_pdf`` embeds."""
    return embed_pixels(*bmp_mode(data))
