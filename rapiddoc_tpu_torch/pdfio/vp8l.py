"""WEBP lossless (VP8L) and the ``ALPH`` chunk, as libwebp 1.6 decodes
them: the plain version of ``csrc/webp.cu``'s ``webp_vp8l_decode`` and
``webp_alpha_unfilter``, bit for bit.

- The bit reader is least significant bit first; a read past the last
  byte fails the image (libwebp's ``eos_``), even when every pixel was
  decoded.
- Prefix codes: simple (one or two symbols) or normal (code-length code
  in ``CODE_LENGTH_ORDER``, repeat codes 16-18, an optional
  ``max_symbol``); canonical codes, read most significant bit first; a
  code that is not complete fails unless it has one symbol, which then
  takes no bits; no symbol at all fails.
- A meta prefix image (level 0 only) picks a group of five codes per
  tile; every group is read, used or not.
- LZ77: 24 length codes and 40 distance codes with extra bits; distance
  codes 1-120 go through the distance map (``webp_tables.CODE_TO_PLANE``),
  and a distance below 1 becomes 1; a copy from before the first pixel
  or past the last fails.
- The colour cache hashes ``argb * 0x1e35a7bd`` (32 bits) to its top
  ``bits`` bits; every pixel produced enters it in order.
- Transforms, each at most once and undone in reverse order: predictor
  (14 modes, 14 and 15 read as black; the top row predicts from the left
  and its first pixel from black, the left column from above, and the
  rightmost pixel's top-right is the current row's first pixel),
  cross-colour (``int8 * int8 >> 5``), subtract-green and colour indexing
  (palette delta-coded, padded with transparent black; 1, 2 or 4 bits a
  pixel bundled into the green byte, least significant first).
- ``ALPH``: method 0 (raw bytes) or 1 (a headerless VP8L stream of the
  image's size; alpha is green), then libwebp's unfilters: horizontal,
  vertical and gradient, the first row always horizontal from 0, the
  first column from the pixel above. Dithering is off, as in PIL.
"""
from __future__ import annotations

import numpy as np

from .webp_tables import CODE_TO_PLANE

CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
NUM_LITERAL = 256
NUM_LENGTH = 24
NUM_DISTANCE = 40
HASH_MUL = 0x1E35A7BD


class BitReader:
    """VP8L's least-significant-first bit reader over ``data``."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = bytes(data) + b"\x00" * 8
        self.nbits = 8 * len(data)
        self.pos = 8 * pos

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little") >> (p & 7)
        self.pos = p + n
        if self.pos > self.nbits:
            raise ValueError("VP8L bitstream ends early")
        return v & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos
        return (int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little") >> (p & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.nbits:
            raise ValueError("VP8L bitstream ends early")


class Code:
    """A canonical prefix code as a lookup table over its longest code's
    bits (least significant first)."""

    def __init__(self, lengths: list[int]):
        used = [s for s, n in enumerate(lengths) if n]
        if not used:
            raise ValueError("VP8L prefix code with no symbol")
        if len(used) == 1:
            self.bits, self.sym, self.len = 0, [used[0]], [0]
            return
        if max(lengths) > 15:
            raise ValueError("VP8L code length above 15")
        if sum(1 << (15 - lengths[s]) for s in used) != 1 << 15:
            raise ValueError("VP8L prefix code is not complete")
        bits = max(lengths)
        sym = np.zeros(1 << bits, np.int32)
        ln = np.zeros(1 << bits, np.int32)
        code = 0
        for n in range(1, bits + 1):
            for s in used:
                if lengths[s] != n:
                    continue
                rev = int(f"{code:0{n}b}"[::-1], 2)
                sym[rev::1 << n] = s
                ln[rev::1 << n] = n
                code += 1
            code <<= 1
        self.bits, self.sym, self.len = bits, sym.tolist(), ln.tolist()

    def read(self, br: BitReader) -> int:
        if self.bits == 0:
            return self.sym[0]
        i = br.peek(self.bits)
        br.skip(self.len[i])
        return self.sym[i]


def _read_code(br: BitReader, alphabet: int) -> Code:
    lengths = [0] * max(alphabet, 256)
    if br.read(1):  # simple code
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return Code(lengths[:alphabet])
    ncl = br.read(4) + 4
    cl = [0] * 19
    for i in range(ncl):
        cl[CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = Code(cl)
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > alphabet:
            raise ValueError("VP8L max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = cl_code.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + offset
            if sym + rep > alphabet:
                raise ValueError("VP8L code lengths past the alphabet")
            val = prev if c == 16 else 0
            for _ in range(rep):
                lengths[sym] = val
                sym += 1
    return Code(lengths[:alphabet])


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_length(sym: int, br: BitReader) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _plane_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    c = CODE_TO_PLANE[code - 1]
    d = (c >> 4) * xsize + 8 - (c & 15)
    return d if d >= 1 else 1


def _decode_stream(br: BitReader, xsize: int, ysize: int, level0: bool,
                   max_rows: int | None = None) -> list[int]:
    """One image stream: transforms (level 0), colour cache, prefix codes,
    then the pixels (ARGB ints); level 0 also undoes the transforms."""
    transforms = []
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError("VP8L transform used twice")
            seen.add(kind)
            if kind in (0, 1):
                bits = br.read(3) + 2
                sub = _decode_stream(br, _sub(xsize, bits), _sub(ysize, bits), False)
                transforms.append((kind, bits, xsize, sub))
            elif kind == 3:
                ncolors = br.read(8) + 1
                bits = 0 if ncolors > 16 else 1 if ncolors > 4 else 2 if ncolors > 2 else 3
                pal = _decode_stream(br, ncolors, 1, False)
                full = [0] * (1 << (8 >> bits))
                prev = 0
                for i, c in enumerate(pal):
                    prev = (((prev & 0xFF00FF00) + (c & 0xFF00FF00)) & 0xFF00FF00) | \
                           (((prev & 0x00FF00FF) + (c & 0x00FF00FF)) & 0x00FF00FF)
                    full[i] = prev
                transforms.append((kind, bits, xsize, full))
                xsize = _sub(xsize, bits)
            else:
                transforms.append((kind, 0, xsize, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("VP8L colour cache bits out of range")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _sub(xsize, meta_bits)
        meta = [(p >> 8) & 0xFFFF for p in _decode_stream(br, mw, _sub(ysize, meta_bits), False)]
        ngroups = max(meta) + 1
    else:
        ngroups = 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(ngroups):
        groups.append([_read_code(br, a) for a in
                       (NUM_LITERAL + NUM_LENGTH + cache_size, 256, 256, 256, NUM_DISTANCE)])
    rows = ysize if max_rows is None else min(ysize, max_rows)
    total = xsize * rows
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    cached = 0
    pos = col = row = 0
    mw = _sub(xsize, meta_bits) if meta is not None else 0
    while pos < total:
        g = groups[meta[(row >> meta_bits) * mw + (col >> meta_bits)]] if meta is not None \
            else groups[0]
        code = g[0].read(br)
        if code < NUM_LITERAL:
            red = g[1].read(br)
            blue = g[2].read(br)
            alpha = g[3].read(br)
            out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            n = 1
        elif code < NUM_LITERAL + NUM_LENGTH:
            length = _copy_length(code - NUM_LITERAL, br)
            dist = _plane_distance(xsize, _copy_length(g[4].read(br), br))
            if dist > pos or length > xsize * ysize - pos:
                raise ValueError("VP8L backward reference out of the image")
            n = min(length, total - pos)
            for i in range(pos, pos + n):
                out[i] = out[i - dist]
            if length > n:  # the band ends inside the copy
                pos += n
                break
        elif code < NUM_LITERAL + NUM_LENGTH + cache_size:
            while cached < pos:
                cache[((out[cached] * HASH_MUL) & 0xFFFFFFFF) >> shift] = out[cached]
                cached += 1
            out[pos] = cache[code - NUM_LITERAL - NUM_LENGTH]
            n = 1
        else:
            raise ValueError("VP8L symbol out of range")
        pos += n
        col += n
        while col >= xsize:
            col -= xsize
            row += 1
        if cache_size:
            while cached < pos:
                cache[((out[cached] * HASH_MUL) & 0xFFFFFFFF) >> shift] = out[cached]
                cached += 1
    if not level0:
        return out
    for kind, bits, width, extra in reversed(transforms):
        out = _inverse(kind, bits, width, rows, extra, out)
    return out


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
           (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, l: int, tl: int) -> int:
    s = 0
    for sh in (24, 16, 8, 0):
        a, b, c = (t >> sh) & 255, (l >> sh) & 255, (tl >> sh) & 255
        s += abs(b - c) - abs(a - c)
    return t if s <= 0 else l


def _full(l: int, t: int, tl: int) -> int:
    o = 0
    for sh in (24, 16, 8, 0):
        o |= _clip(((l >> sh) & 255) + ((t >> sh) & 255) - ((tl >> sh) & 255)) << sh
    return o


def _half(l: int, t: int, tl: int) -> int:
    ave = _avg(l, t)
    o = 0
    for sh in (24, 16, 8, 0):
        a, b = (ave >> sh) & 255, (tl >> sh) & 255
        d = a - b
        o |= _clip(a + (d // 2 if d >= 0 else -((-d) // 2))) << sh
    return o


def _predict(mode: int, l: int, t: int, tr: int, tl: int) -> int:
    if mode == 1:
        return l
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg(_avg(l, tr), t)
    if mode == 6:
        return _avg(l, tl)
    if mode == 7:
        return _avg(l, t)
    if mode == 8:
        return _avg(tl, t)
    if mode == 9:
        return _avg(t, tr)
    if mode == 10:
        return _avg(_avg(l, tl), _avg(t, tr))
    if mode == 11:
        return _select(t, l, tl)
    if mode == 12:
        return _full(l, t, tl)
    if mode == 13:
        return _half(l, t, tl)
    return 0xFF000000  # 0, and 14/15 as libwebp reads them


def _inverse(kind: int, bits: int, width: int, rows: int, extra, data: list[int]) -> list[int]:
    if kind == 2:  # subtract green
        a = np.asarray(data, np.uint32)
        g = (a >> 8) & 0xFF
        rb = ((a & 0x00FF00FF) + ((g << 16) | g)) & 0x00FF00FF
        return ((a & 0xFF00FF00) | rb).tolist()
    if kind == 3:  # colour indexing
        pal = np.asarray(extra, np.uint32)
        a = np.asarray(data, np.uint32)
        packed_w = _sub(width, bits)
        g = ((a >> 8) & 0xFF).reshape(rows, packed_w)
        if bits == 0:
            idx = g
        else:
            bpp = 8 >> bits
            shifts = (np.arange(width) & ((1 << bits) - 1)) * bpp
            idx = (g[:, np.arange(width) >> bits] >> shifts) & ((1 << bpp) - 1)
        return pal[idx].reshape(-1).tolist()
    tw = _sub(width, bits)
    if kind == 1:  # cross colour
        a = np.asarray(data, np.uint32).reshape(rows, width)
        t = np.asarray(extra, np.uint32).reshape(-1, tw)[np.arange(rows) >> bits][
            :, np.arange(width) >> bits]
        g2r = (t & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        g2b = ((t >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        r2b = ((t >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        green = ((a >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        red = ((a >> 16) & 0xFF).astype(np.int32)
        blue = (a & 0xFF).astype(np.int32)
        red = (red + ((g2r * green) >> 5)) & 0xFF
        sred = red.astype(np.uint8).view(np.int8).astype(np.int32)
        blue = (blue + ((g2b * green) >> 5) + ((r2b * sred) >> 5)) & 0xFF
        out = (a & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)
        return out.reshape(-1).tolist()
    # predictor
    out = list(data)
    modes = [(m >> 8) & 0xF for m in extra]
    out[0] = _add(out[0], 0xFF000000)
    for x in range(1, width):
        out[x] = _add(out[x], out[x - 1])
    for y in range(1, rows):
        base = y * width
        up = base - width
        out[base] = _add(out[base], out[up])
        trow = (y >> bits) * tw
        for x in range(1, width):
            i = base + x
            mode = modes[trow + (x >> bits)]
            out[i] = _add(out[i], _predict(mode, out[i - 1], out[up + x], out[up + x + 1],
                                           out[up + x - 1]))
    return out


def read_header(data: bytes) -> tuple[int, int, bool]:
    """(width, height, alpha_is_used) of a VP8L chunk's payload."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        raise ValueError("not a VP8L bitstream")
    bits = int.from_bytes(data[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def decode_argb(data: bytes, width: int, height: int, start: int = 0,
                max_rows: int | None = None) -> np.ndarray:
    """The level-0 image stream from byte ``start`` of ``data`` as (rows,
    width) uint32 ARGB (the first ``max_rows`` rows, or all)."""
    br = BitReader(data, start)
    out = _decode_stream(br, width, height, True, max_rows)
    rows = height if max_rows is None else min(height, max_rows)
    return np.asarray(out, np.uint32).reshape(rows, width)


def argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    out = np.empty(argb.shape + (4,), np.uint8)
    out[..., 0] = argb >> 16
    out[..., 1] = argb >> 8
    out[..., 2] = argb
    out[..., 3] = argb >> 24
    return out


def unfilter(kind: int, a: np.ndarray) -> np.ndarray:
    """libwebp's alpha unfilters (1 horizontal, 2 vertical, 3 gradient)
    over (h, w) uint8 filtered levels."""
    if kind == 0:
        return a
    h, w = a.shape
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0], dtype=np.int64) & 0xFF
    for y in range(1, h):
        if kind == 1:
            row = a[y].astype(np.int64)
            row[0] += out[y - 1, 0]
            out[y] = np.cumsum(row) & 0xFF
        elif kind == 2:
            out[y] = out[y - 1] + a[y]
        else:
            prev = out[y - 1].tolist()
            cur = a[y].tolist()
            left = top_left = prev[0]
            res = [0] * w
            for x in range(w):
                top = prev[x]
                g = left + top - top_left
                g = 0 if g < 0 else 255 if g > 255 else g
                left = (cur[x] + g) & 0xFF
                top_left = top
                res[x] = left
            out[y] = res
    return out


def decode_alpha(data: bytes, width: int, height: int, compiled: bool = False) -> np.ndarray:
    """An ``ALPH`` chunk's payload to (height, width) uint8 alpha."""
    if not data:
        raise ValueError("empty ALPH chunk")
    method, filt, pre, rsrv = data[0] & 3, (data[0] >> 2) & 3, (data[0] >> 4) & 3, data[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError("bad ALPH header")
    if method == 0:
        if len(data) - 1 < width * height:
            raise ValueError("ALPH chunk too short")
        levels = np.frombuffer(data, np.uint8, width * height, 1).reshape(height, width)
    elif compiled:
        from .webp import compiled_argb

        levels = ((compiled_argb(data, width, height, 1) >> 8) & 0xFF).astype(np.uint8)
    else:
        levels = ((decode_argb(data, width, height, 1) >> 8) & 0xFF).astype(np.uint8)
    if compiled and filt:
        from .webp import compiled_unfilter

        return compiled_unfilter(filt, levels)
    return unfilter(filt, levels)
