"""PDF stream filters (PDF 1.7 §7.4).

Implemented: FlateDecode (+PNG/TIFF predictors), LZWDecode, ASCIIHexDecode,
ASCII85Decode, RunLengthDecode. DCTDecode/JPXDecode/CCITTFaxDecode/JBIG2Decode
are image codecs: their data is surfaced raw and decoded by pdfio.images
(PIL-backed) at image-build time.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any

from .cos import Name, Ref, Stream

IMAGE_FILTERS = {
    "DCTDecode",
    "DCT",
    "JPXDecode",
    "CCITTFaxDecode",
    "CCF",
    "JBIG2Decode",
}

_ABBREV = {
    "Fl": "FlateDecode",
    "LZW": "LZWDecode",
    "AHx": "ASCIIHexDecode",
    "A85": "ASCII85Decode",
    "RL": "RunLengthDecode",
}


def _apply_predictor(data: bytes, params: dict) -> bytes:
    predictor = int(params.get("Predictor", 1) or 1)
    if predictor <= 1:
        return data
    colors = int(params.get("Colors", 1) or 1)
    bpc = int(params.get("BitsPerComponent", 8) or 8)
    columns = int(params.get("Columns", 1) or 1)
    bpp = max(1, (colors * bpc + 7) // 8)
    row_len = (columns * colors * bpc + 7) // 8

    from ..utils import native

    if predictor == 2:  # TIFF horizontal differencing (8-bit only)
        if bpc != 8:
            return data
        return native.tiff_defilter(data, row_len, bpp)
    # PNG predictors: each row prefixed by a filter-type byte
    return native.png_defilter(data, row_len, bpp)


def tiff_defilter_plain(data: bytes, row_len: int, bpp: int) -> bytes:
    """TIFF predictor 2 undone in Python: the plain version of
    ``csrc/hostops.cu``'s ``tiff_defilter``."""
    out = bytearray(data)
    for r in range(0, len(out) - row_len + 1, row_len):
        for i in range(bpp, row_len):
            out[r + i] = (out[r + i] + out[r + i - bpp]) & 0xFF
    return bytes(out)


def png_defilter_plain(data: bytes, row_len: int, bpp: int) -> bytes:
    """PNG predictors undone in Python: the plain version of
    ``csrc/hostops.cu``'s ``png_defilter``."""
    stride = row_len + 1
    nrows = len(data) // stride
    out = bytearray(nrows * row_len)
    prev = bytearray(row_len)
    for r in range(nrows):
        ftype = data[r * stride]
        row = bytearray(data[r * stride + 1 : r * stride + 1 + row_len])
        if ftype == 1:  # Sub
            for i in range(bpp, row_len):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(row_len):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(row_len):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(row_len):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        out[r * row_len : (r + 1) * row_len] = row
        prev = row
    return bytes(out)


def flate_decode(data: bytes, params: dict) -> bytes:
    try:
        raw = zlib.decompress(data)
    except zlib.error:
        # Tolerate truncated/corrupt streams
        d = zlib.decompressobj()
        try:
            raw = d.decompress(data)
        except zlib.error:
            # Some writers emit raw deflate without zlib header
            try:
                raw = zlib.decompress(data, -15)
            except zlib.error:
                return b""
    return _apply_predictor(raw, params)


def lzw_decode(data: bytes, params: dict) -> bytes:
    early = int(params.get("EarlyChange", 1) or 1)
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    code_len = 9
    prev: bytes | None = None
    bitbuf = 0
    nbits = 0
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        nbits += 8
        while nbits >= code_len:
            nbits -= code_len
            code = (bitbuf >> nbits) & ((1 << code_len) - 1)
            bitbuf &= (1 << nbits) - 1  # keep the buffer short: O(1) a code
            if code == 256:  # clear
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                code_len = 9
                prev = None
                continue
            if code == 257:  # EOD
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if len(table) + early - 1 >= (1 << code_len) and code_len < 12:
                code_len += 1
    return bytes(out)


def ascii_hex_decode(data: bytes, params: dict) -> bytes:
    end = data.find(b">")
    if end >= 0:
        data = data[:end]
    import re

    hex_chars = re.sub(rb"[^0-9A-Fa-f]", b"", data)
    if len(hex_chars) % 2:
        hex_chars += b"0"
    return bytes.fromhex(hex_chars.decode("ascii"))


def ascii85_decode(data: bytes, params: dict) -> bytes:
    data = data.strip()
    if data.startswith(b"<~"):
        data = data[2:]
    end = data.find(b"~>")
    if end >= 0:
        data = data[:end]
    data = bytes(c for c in data if c not in b" \t\r\n\x0c\x00")
    out = bytearray()
    i = 0
    while i < len(data):
        if data[i : i + 1] == b"z":
            out += b"\x00\x00\x00\x00"
            i += 1
            continue
        group = data[i : i + 5]
        i += 5
        pad = 5 - len(group)
        group = group + b"u" * pad
        val = 0
        for c in group:
            val = val * 85 + (c - 33)
        chunk = struct.pack(">I", val & 0xFFFFFFFF)
        out += chunk[: 4 - pad]
    return bytes(out)


def run_length_decode(data: bytes, params: dict) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n == 128:
            break
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        else:
            if i < len(data):
                out += bytes([data[i]]) * (257 - n)
                i += 1
    return bytes(out)


_DECODERS = {
    "FlateDecode": flate_decode,
    "LZWDecode": lzw_decode,
    "ASCIIHexDecode": ascii_hex_decode,
    "ASCII85Decode": ascii85_decode,
    "RunLengthDecode": run_length_decode,
}


def _normalize_filters(stream_dict: dict, resolve) -> tuple[list[str], list[dict]]:
    filt: Any = resolve(stream_dict.get("Filter"))
    if filt is None:
        filters: list[str] = []
    elif isinstance(filt, (Name, str)):
        filters = [str(filt)]
    else:
        filters = [str(resolve(f)) for f in filt]
    filters = [_ABBREV.get(f, f) for f in filters]

    parms: Any = resolve(stream_dict.get("DecodeParms") or stream_dict.get("DP"))
    if parms is None:
        parm_list: list[dict] = [{} for _ in filters]
    elif isinstance(parms, dict):
        parm_list = [parms] + [{} for _ in filters[1:]]
    else:
        parm_list = [resolve(p) or {} for p in parms]
        parm_list += [{} for _ in range(len(filters) - len(parm_list))]
    parm_list = [
        {k: resolve(v) for k, v in p.items()} if isinstance(p, dict) else {}
        for p in parm_list
    ]
    return filters, parm_list


def decode_stream(stream: Stream, resolve=lambda x: x) -> bytes:
    """Run all non-image filters. Image-codec filters terminate the chain
    (their payload is returned as-is for PIL-side decoding)."""
    data = stream.raw
    filters, parms = _normalize_filters(stream.dict, resolve)
    for f, p in zip(filters, parms):
        if f in IMAGE_FILTERS:
            return data
        decoder = _DECODERS.get(f)
        if decoder is None:
            if f == "Crypt":
                continue
            raise NotImplementedError(f"PDF filter {f!r}")
        data = decoder(data, p)
    return data


def image_codec(stream_dict: dict, resolve=lambda x: x) -> str | None:
    """Return the image codec name if the final filter is an image codec."""
    filters, _ = _normalize_filters(stream_dict, resolve)
    for f in filters:
        if f in IMAGE_FILTERS:
            return f
    return None
