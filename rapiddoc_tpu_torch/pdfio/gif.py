"""GIF decoding as PIL opens a GIF's first frame for ``images_to_pdf``.

``gif_mode`` returns PIL's mode and samples (``pdfio.pil_modes``
converts them). Pillow 12.1's ``GifImagePlugin`` and ``GifDecode.c``,
read and checked by experiment (``tests/test_torch_image_files.py``):

- the canvas is the logical screen, grown to hold the first frame's
  extent; it starts as the frame's transparency index where the graphic
  control block gives one, else 0, and the frame's pixels are written at
  its offset (interlaced rows in the four passes);
- the palette is the frame's local one, else the global one; a palette
  whose entry i is (i, i, i) throughout counts as none (a local one so
  even over a global one), and with none the mode is ``L`` with the
  indices as grey levels, else ``P``. ``convert("RGB")`` looks the
  indices up and ignores transparency; an index past the palette reads
  black;
- LZW with clear and end codes, the code width growing to 12 bits and
  the table frozen when full; an end code before the last pixel keeps
  the pixels decoded so far; a file that ends before the frame's last
  pixel raises (a sub-block cut short is not read at all, as PIL's
  decoder waits for it whole), and so does a code past the next free
  entry.
"""
from __future__ import annotations

import struct

import numpy as np

from .pil_modes import check_size, embed_pixels


def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int, bool]:
    """The data sub-blocks from ``pos``: the bytes of the whole ones, the
    position past the terminator, and whether the terminator was there."""
    out = bytearray()
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos, True
        if pos + n > len(data):  # PIL's decoder never reads a partial block
            break
        out += data[pos:pos + n]
        pos += n
    return bytes(out), pos, False


def lzw_decode(data: bytes, bits: int, count: int) -> np.ndarray:
    """At most ``count`` pixel indices of a GIF LZW stream of minimum code
    size ``bits``."""
    clear, end = 1 << bits, (1 << bits) + 1
    table = [bytes([i & 255]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    size, prev = bits + 1, None
    acc = nacc = pos = 0
    n_data = len(data)
    while len(out) < count:
        while nacc < size and pos < n_data:
            acc |= data[pos] << nacc
            nacc += 8
            pos += 1
        if nacc < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            del table[clear + 2:]
            size, prev = bits + 1, None
            continue
        if code == end:
            break
        if prev is None:
            if code > clear:
                raise ValueError("GIF LZW code before the table holds it")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            if len(table) < 4096:
                table.append(entry)
        else:
            raise ValueError("GIF LZW code past the table")
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
    return np.frombuffer(bytes(out[:count]), np.uint8)


def _interlace_rows(height: int) -> np.ndarray:
    return np.array([y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                     for y in range(start, height, step)], np.int64)


def gif_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    """GIF bytes -> (PIL's mode, the first frame's samples, the palette or
    None)."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 128:
        p = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        if _palette_needed(p):
            global_palette = p
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("image not found in GIF frame")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # extension
            label = data[pos]
            _, pos2, _ = _sub_blocks(data, pos + 1)
            if label == 0xF9:
                first_len = data[pos + 1] if pos + 1 < len(data) else 0
                gce = data[pos + 2:pos + 2 + first_len]
                if first_len >= 4 and gce[0] & 1:
                    transparency = gce[3]
            pos = pos2
        elif kind == 0x2C:  # image descriptor
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            palette = global_palette
            if fflags & 128:
                p = data[pos:pos + (3 << ((fflags & 7) + 1))]
                pos += len(p)
                palette = p if _palette_needed(p) else None
            bits = data[pos]
            lzw, _, whole = _sub_blocks(data, pos + 1)
            break
        # anything else is skipped byte by byte, as PIL's loop does
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    check_size(width, height)
    canvas = np.full((height, width), transparency or 0, np.uint8)
    pixels = lzw_decode(lzw, bits, fw * fh)
    if not whole and len(pixels) < fw * fh:
        raise ValueError("image file is truncated")
    frame = np.zeros(fw * fh, np.uint8)
    frame[: len(pixels)] = pixels
    frame = frame.reshape(fh, fw)
    written = np.zeros(fw * fh, bool)
    written[: len(pixels)] = True
    written = written.reshape(fh, fw)
    rows = _interlace_rows(fh) if fflags & 64 else np.arange(fh)
    region = canvas[y0:y0 + fh, x0:x0 + fw]
    region[rows] = np.where(written, frame, region[rows])
    if palette is None:
        return "L", canvas, None
    return "P", canvas, np.frombuffer(palette, np.uint8).reshape(-1, 3)


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> what ``images_to_pdf`` embeds."""
    return embed_pixels(*gif_mode(data))
