"""TIFF decoding as PIL opens a TIFF's first page for ``images_to_pdf``.

``tiff_mode`` returns PIL's mode and samples (``pdfio.pil_modes``
converts them). Pillow 12.1's ``TiffImagePlugin`` (its own raw decoder
for uncompressed strips, libtiff 4.7 for the rest), read and checked by
experiment (``tests/test_torch_image_files.py``):

- the mode comes from (byte order, photometric, sample format, fill
  order, bits per sample, extra samples) as in PIL's ``OPEN_INFO``, for
  the forms below; a key PIL does not know raises;
- grey (photometric 0 and 1) at 1, 2, 4, 8 and 16 bits: ``1`` and ``L``
  (WhiteIsZero inverted, 2 and 4 bits scaled to 0..255), ``I;16`` or
  ``I;16B`` (clipped by ``convert("RGB")``), signed 16 bits ``I``; grey
  and alpha ``LA``; palette (photometric 3) at 1, 2, 4 and 8 bits, the
  colormap's high bytes; RGB at 8 bits with 0, 1 or 2 extra samples
  (unassociated alpha ``RGBA``, associated ``RGBa`` divided out,
  unspecified dropped) and at 16 bits (the high byte); CMYK at 8 bits;
- strips uncompressed, PackBits, LZW (``filters.lzw_decode`` with
  EarlyChange 2, which widens its codes where libtiff does: at 511,
  1023 and 2047 entries), Deflate (8 and 32946), and CCITT
  G3 (``T4Options`` bit 0 for two-dimensional rows) and G4 through
  ``pdfio.ccitt`` (libtiff sets a bit for each run coded black; the
  photometric tag then reads it as PIL's ``1`` or ``1;I`` raw mode
  does); fill order 2 reverses each byte's bits; predictor 2 (horizontal
  differencing, 8 and 16 bits) under LZW and Deflate only, as libtiff
  applies it;
- the orientation tag turns the image as ``ImageOps.exif_transpose``.

Tiled and planar (``PlanarConfiguration`` 2) files, JPEG and the other
compressions raise NotImplementedError naming their ROADMAP item, as do
BigTIFF files.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..utils.unported import not_ported
from .ccitt import decode_bits
from .filters import lzw_decode
from .pil_modes import check_size, embed_pixels, unpack_bits, unpremultiply

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
          10: "ii", 11: "f", 12: "d", 16: "Q"}
_COMPRESSIONS = {1: "raw", 3: "group3", 4: "group4", 5: "lzw", 8: "deflate",
                 32946: "deflate", 32773: "packbits"}


def _open_info(photo: int, fmt: tuple, order: int, bps: tuple, extra: tuple,
               big_endian: bool) -> tuple[str, str] | None:
    """PIL's (mode, raw mode) of a TIFF key, for the forms ported."""
    if photo in (0, 1) and not extra and fmt in ((1,), (2,)) and len(bps) == 1:
        inv = "I" if photo == 0 else ""
        b = bps[0]
        if b in (1, 2, 4) and fmt == (1,):
            name = "1" if b == 1 else f"L;{b}"
            if inv:
                name += ";I" if b == 1 else "I"
            if order == 2:
                name += ";R" if b == 1 and not inv else "R"
            return ("1" if b == 1 else "L"), name
        if b == 8:
            if order == 2 and fmt == (1,):
                return "L", "L;IR" if inv else "L;R"
            if order == 1 and (fmt == (1,) or not inv):
                return "L", "L;I" if inv else "L"
        if b == 16 and order == 1:
            if fmt == (1,) and not big_endian and photo in (0, 1):
                return "I;16", "I;16"
            if fmt == (1,) and big_endian and photo == 1:
                return "I;16B", "I;16B"
            if fmt == (2,) and photo == 1:
                return "I", "I;16BS" if big_endian else "I;16S"
        if b == 16 and order == 2 and not big_endian and photo == 1 and fmt == (1,):
            return "I;16", "I;16R"
        return None
    if fmt != (1,):
        return None
    if photo == 1 and bps == (8, 8) and extra == (2,) and order == 1:
        return "LA", "LA"
    if photo == 2 and order == 1 and bps == (8,) * len(bps) and len(bps) == 3 + len(extra):
        if not extra:
            return "RGB", "RGB"
        if extra[0] == 0:
            return "RGB", "RGB" + "X" * len(extra) if all(e == 0 for e in extra) else None
        if extra[0] in (1, 2) and all(e == 0 for e in extra[1:]):
            return "RGBA", ("RGBa" if extra[0] == 1 else "RGBA") + "X" * (len(extra) - 1)
        return None
    if photo == 2 and bps == (8, 8, 8) and order == 2 and not extra:
        return "RGB", "RGB;R"
    if photo == 2 and order == 1 and bps == (8, 8, 8, 8) and not extra:
        return "RGBA", "RGBA"  # missing ExtraSamples
    if photo == 2 and order == 1 and bps == (16,) * len(bps) and len(bps) in (3, 4):
        e = "B" if big_endian else "L"
        if len(bps) == 3 and not extra:
            return "RGB", f"RGB;16{e}"
        if len(bps) == 4 and extra in ((), (2,)):
            return "RGBA", f"RGBA;16{e}"
        if len(bps) == 4 and extra == (0,):
            return "RGB", f"RGBX;16{e}"
        return None
    if photo == 3 and len(bps) == 1 and bps[0] in (1, 2, 4, 8) and not extra:
        if bps[0] == 8 and order == 2:
            return "P", "P;R"
        return "P", "P" if bps[0] == 8 else f"P;{bps[0]}" + ("R" if order == 2 else "")
    if photo == 5 and bps == (8, 8, 8, 8) and order == 1 and not extra:
        return "CMYK", "CMYK"
    return None


def _ifd(data: bytes, pos: int, e: str) -> dict[int, tuple]:
    (n,) = struct.unpack_from(e + "H", data, pos)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(e + "HHI", data, pos + 2 + 12 * i)
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(e + fmt) * count
        where = pos + 2 + 12 * i + 8
        if size > 4:
            (where,) = struct.unpack_from(e + "I", data, where)
        if where + size > len(data):
            raise ValueError(f"TIFF tag {tag} lies past the end of the file")
        values = struct.unpack_from(e + fmt * count, data, where)
        tags[tag] = values
    return tags


def _packbits(data: bytes, size: int) -> bytes:
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos < len(data):
                out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out)


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _predict(rows: np.ndarray, spp: int, depth: int, e: str) -> np.ndarray:
    """Undo horizontal differencing (predictor 2) on (h, row_bytes) rows."""
    h = rows.shape[0]
    if depth == 8:
        v = rows.reshape(h, -1, spp).astype(np.uint32)
        return (np.cumsum(v, axis=1) & 255).astype(np.uint8).reshape(h, -1)
    if depth == 16:
        dt = np.dtype(e + "u2")
        v = np.ascontiguousarray(rows).view(dt).reshape(h, -1, spp).astype(np.uint32)
        out = (np.cumsum(v, axis=1) & 0xFFFF).astype(dt)
        return out.reshape(h, -1).view(np.uint8)
    raise ValueError(f"horizontal differencing of {depth}-bit samples")


def _unpack(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """Rows in file order (fill order already undone) -> PIL's samples."""
    # fill order 2 was undone on the strip's bytes: drop the raw mode's R
    base = rawmode.replace(";R", "").rstrip("R")
    inv = base.endswith("I") and base[:1] in ("1", "L")
    if base.startswith("1"):
        bits = unpack_bits(rows, width, 1)
        return 1 - bits if inv else bits
    if base.startswith("L;") and base[2] in "24":
        depth = int(base[2])
        v = unpack_bits(rows, width, depth)
        v = (v.astype(np.int32) * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return 255 - v if inv else v
    if base in ("L", "L;I"):
        v = rows[:, :width]
        return 255 - v if inv else v
    if base.startswith("I;16"):
        dt = np.dtype((">" if "B" in base else "<") + ("i2" if base.endswith("S") else "u2"))
        return np.ascontiguousarray(rows[:, : 2 * width]).view(dt).astype(np.int32)
    if base.startswith("P;"):
        return unpack_bits(rows, width, int(base[2]))
    if base == "P":
        return rows[:, :width]
    if base == "LA":
        return rows[:, : 2 * width].reshape(-1, width, 2)
    if ";16" in base:  # 16-bit RGB(A|X): the high byte of each sample
        n = 4 if base.startswith(("RGBA", "RGBX")) else 3
        dt = np.dtype((">" if base.endswith("B") else "<") + "u2")
        v = np.ascontiguousarray(rows[:, : 2 * n * width]).view(dt).reshape(-1, width, n)
        return (v >> 8).astype(np.uint8)
    n = len(base.replace("a", "A"))
    px = rows[:, : n * width].reshape(-1, width, n)
    if base.startswith("RGBa"):
        return unpremultiply(px[..., :4])
    return px[..., :4] if base.startswith(("RGBA", "CMYK")) else px[..., :3]


_TURN = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
    7: lambda a: a.swapaxes(0, 1)[::-1, ::-1], 8: lambda a: np.rot90(a, 1),
}


def tiff_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    """TIFF bytes -> (PIL's mode, the first page's samples, the palette or
    None)."""
    if data[:4] == b"II*\x00":
        e = "<"
    elif data[:4] == b"MM\x00*":
        e = ">"
    elif data[:4] in (b"II+\x00", b"MM\x00+"):
        raise not_ported("BigTIFF images", "pdfio")
    else:
        raise ValueError("not a TIFF file")
    (first,) = struct.unpack_from(e + "I", data, 4)
    tags = _ifd(data, first, e)

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    width, height = one(256), one(257)
    if width is None or height is None:
        raise ValueError("Missing dimensions")
    check_size(width, height)
    compression = _COMPRESSIONS.get(one(259, 1))
    if compression is None:
        raise not_ported(f"TIFF compression {one(259)}", "pdfio")
    photo = one(262, 0)
    order = one(266, 1)
    spp = one(277, 1)
    bps = tuple(tags.get(258, (1,)))
    extra = tuple(tags.get(338, ()))
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("unknown data organization")
    if one(284, 1) != 1:
        raise not_ported("planar TIFF images", "pdfio")
    if 322 in tags or 324 in tags:
        raise not_ported("tiled TIFF images", "pdfio")
    info = _open_info(photo, fmt, order, bps, extra, e == ">")
    if info is None:
        raise ValueError("unknown pixel mode")
    mode, rawmode = info
    offsets = tags.get(273)
    if offsets is None:
        raise ValueError("unknown data organization")
    counts = tags.get(279, (len(data),) * len(offsets))
    rps = min(one(278, height), height) or height
    depth_sum = sum(bps)
    stride = (width * depth_sum + 7) // 8
    predictor = one(317, 1) if compression in ("lzw", "deflate") else 1
    rows = np.zeros((height, stride), np.uint8)
    for s, (off, cnt) in enumerate(zip(offsets, counts)):
        y0 = s * rps
        if y0 >= height:
            break
        n_rows = min(rps, height - y0)
        raw = data[off:off + cnt]
        if order == 2:
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        if compression in ("group3", "group4"):
            k = -1 if compression == "group4" else (1 if one(292, 0) & 1 else 0)
            bits, _ = decode_bits(raw, width, n_rows, k)
            if bps != (1,):
                raise ValueError("CCITT compression of samples wider than a bit")
            rows[y0:y0 + n_rows] = np.packbits(bits, axis=1)[:, :stride]
            continue
        if compression == "lzw":  # EarlyChange 2: libtiff's code widths
            body = lzw_decode(raw, {"EarlyChange": 2})
        elif compression == "deflate":
            body = zlib.decompressobj().decompress(raw)
        elif compression == "packbits":
            body = _packbits(raw, n_rows * stride)
        else:
            body = raw
        need = n_rows * stride
        if len(body) < need:
            raise ValueError("image file is truncated")
        strip = np.frombuffer(body[:need], np.uint8).reshape(n_rows, stride)
        if predictor == 2:
            if len(set(bps)) != 1:
                raise ValueError("horizontal differencing of mixed sample sizes")
            strip = _predict(strip, spp, bps[0], e)
        elif predictor != 1:
            raise not_ported(f"TIFF predictor {predictor}", "pdfio")
        rows[y0:y0 + n_rows] = strip
    samples = _unpack(rows, width, rawmode)
    turn = _TURN.get(one(274, 1))
    if turn is not None:
        samples = np.ascontiguousarray(turn(samples))
    palette = None
    if mode == "P":
        cmap = np.asarray(tags.get(320, ()), np.int64) // 256
        palette = cmap.reshape(3, -1).T.astype(np.uint8) if len(cmap) else np.zeros((0, 3), np.uint8)
    return mode, samples, palette


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> what ``images_to_pdf`` embeds."""
    return embed_pixels(*tiff_mode(data))
