"""WEBP lossy (VP8 key frames, RFC 6386) as libwebp 1.6 decodes them, and
libwebp's default YUV to RGB: the plain versions of ``csrc/webp.cu``'s
``webp_vp8_decode`` and ``webp_yuv_to_rgb``, bit for bit.

- The boolean decoder keeps libwebp's state (``range - 1``, a value
  register loaded a byte at a time, one zero byte fed past the end and
  ``eof`` set then); ``signed`` is libwebp's ``VP8GetSigned``, which
  always shifts by one bit. A partition read past its end fails the
  image (checked after each row's modes and after each macroblock's
  tokens, as libwebp does).
- Frame header, segments (absolute or delta quantisers and filter
  levels, the tree of the segment map), filter header with reference
  and mode deltas, up to eight token partitions (the last one takes the
  rest and must not be empty), quantisers through RFC 6386's tables
  (``y2`` DC doubled, ``y2`` AC times 155/100 and at least 8), and the
  coefficient probability updates.
- Intra modes: 16x16 (DC, V, H, TM; DC without top and/or left), the ten
  4x4 modes with their contexts, chroma. Prediction reads unfiltered
  pixels: 127 above the frame (top-left and top-right included), 129
  left of it and at the top-left of a row's first macroblock; the 4x4
  blocks of the right column take the top-right pixels of the
  macroblock above-right (the last pixel above, four times, at the right
  edge) on all four rows.
- Coefficients: tokens by band and context, the large-value categories,
  dequantised at parse time (kept as int16), the inverse WHT of the
  16x16 DC and the inverse DCT (``20091`` and ``35468`` multipliers),
  added with clipping; in C's ints or, where libwebp on x86 takes its
  SSE2 transform, with its 16-bit wrapping sums, which only coefficients
  no encoder writes reach (found by fuzzing headers against PIL).
- Loop filter, after reconstruction, macroblock by macroblock in raster
  order: the left edge, the three inner vertical edges, the top edge,
  the three inner horizontal edges; simple (luma only) or normal with
  the high-edge-variance switch; limits from the level, the sharpness,
  the segment and the 4x4 mode delta; inner edges only for 4x4
  macroblocks and those with a non-zero coefficient.
- ``yuv_to_rgb``: libwebp's fancy upsampling (a 9-3-3-1 filter of the
  chroma, the first row and the last row of an even height from one
  chroma row) and ``VP8YUVToR/G/B`` in 14-bit fixed point.
"""
from __future__ import annotations

import numpy as np

from .webp_tables import AC_TABLE, BMODES_PROBA, COEFFS_PROBA0, COEFFS_UPDATE_PROBA, DC_TABLE

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's 4x4 mode tree over its numbering (DC TM VE HE RD VR LD VL HD HU)
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3


class BoolDecoder:
    """libwebp's ``VP8BitReader`` over ``data[start:end]``."""

    __slots__ = ("data", "pos", "end", "value", "bits", "range", "eof")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.range, self.eof = 0, -8, 254, False
        self._load()

    def _load(self) -> None:
        if self.pos < self.end:
            self.bits += 8
            self.value = self.data[self.pos] | (self.value << 8)
            self.pos += 1
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def get(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        rng = self.range
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.bits -= shift
        self.range = (rng << shift) - 1
        return bit

    def signed(self, v: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        self.bits -= 1
        if (self.value >> pos) > split:
            self.range = (self.range - 1) | 1
            self.value -= (split + 1) << pos
            return -v
        self.range |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.get(0x80) << n
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.get(0x80) else v


def frame_info(data: bytes) -> tuple[int, int]:
    """(width, height) of a VP8 key frame, checked as libwebp's
    ``VP8GetInfo``."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("not a VP8 key frame")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1 or ((bits >> 1) & 7) > 3 or not ((bits >> 4) & 1) or (bits >> 5) >= len(data):
        raise ValueError("bad VP8 frame tag")
    w = (data[6] | (data[7] << 8)) & 0x3FFF
    h = (data[8] | (data[9] << 8)) & 0x3FFF
    if not w or not h:
        raise ValueError("VP8 frame of zero size")
    return w, h


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


def _wrap16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


class Header:
    """The frame header, segment, filter, partition, quantiser and
    probability state."""

    def __init__(self, data: bytes):
        self.width, self.height = frame_info(data)
        bits = data[0] | (data[1] << 8) | (data[2] << 16)
        part0 = bits >> 5
        self.mb_w, self.mb_h = (self.width + 15) >> 4, (self.height + 15) >> 4
        start = 10
        if part0 > len(data) - start:
            raise ValueError("bad VP8 partition length")
        br = BoolDecoder(data, start, start + part0)
        self.br = br
        br.get(0x80)  # colour space
        br.get(0x80)  # clamping type
        self.use_segment = br.get(0x80)
        self.update_map = 0
        self.absolute = 1  # libwebp resets absolute_delta_ to 1
        self.quantizer = [0] * 4
        self.filter_strength = [0] * 4
        self.seg_proba = [255, 255, 255]
        if self.use_segment:
            self.update_map = br.get(0x80)
            if br.get(0x80):
                self.absolute = br.get(0x80)
                self.quantizer = [br.signed_value(7) if br.get(0x80) else 0 for _ in range(4)]
                self.filter_strength = [br.signed_value(6) if br.get(0x80) else 0
                                        for _ in range(4)]
            if self.update_map:
                self.seg_proba = [br.value_bits(8) if br.get(0x80) else 255 for _ in range(3)]
        if br.eof:
            raise ValueError("cannot parse VP8 segment header")
        self.simple = br.get(0x80)
        self.level = br.value_bits(6)
        self.sharpness = br.value_bits(3)
        self.use_lf_delta = br.get(0x80)
        self.ref_lf_delta = [0] * 4
        self.mode_lf_delta = [0] * 4
        if self.use_lf_delta and br.get(0x80):
            for i in range(4):
                if br.get(0x80):
                    self.ref_lf_delta[i] = br.signed_value(6)
            for i in range(4):
                if br.get(0x80):
                    self.mode_lf_delta[i] = br.signed_value(6)
        self.filter_type = 0 if self.level == 0 else 1 if self.simple else 2
        if br.eof:
            raise ValueError("cannot parse VP8 filter header")
        nparts = 1 << br.value_bits(2)
        sizes = start + part0
        part_start = sizes + 3 * (nparts - 1)
        if part_start > len(data):
            raise ValueError("cannot parse VP8 partitions")
        left = len(data) - part_start
        self.parts = []
        for p in range(nparts - 1):
            psize = data[sizes + 3 * p] | (data[sizes + 3 * p + 1] << 8) | \
                (data[sizes + 3 * p + 2] << 16)
            psize = min(psize, left)
            self.parts.append(BoolDecoder(data, part_start, part_start + psize))
            part_start += psize
            left -= psize
        self.parts.append(BoolDecoder(data, part_start, len(data)))
        if part_start >= len(data):
            raise ValueError("VP8 partitions end early")
        # quantisers
        base_q0 = br.value_bits(7)
        d = [br.signed_value(4) if br.get(0x80) else 0 for _ in range(5)]
        dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = d
        self.dq = []
        for i in range(4):
            if self.use_segment:
                q = self.quantizer[i] + (0 if self.absolute else base_q0)
            elif i > 0:
                self.dq.append(self.dq[0])
                continue
            else:
                q = base_q0
            y2ac = (AC_TABLE[_clip(q + dqy2_ac, 127)] * 101581) >> 16
            self.dq.append((
                (DC_TABLE[_clip(q + dqy1_dc, 127)], AC_TABLE[_clip(q, 127)]),
                (DC_TABLE[_clip(q + dqy2_dc, 127)] * 2, max(y2ac, 8)),
                (DC_TABLE[_clip(q + dquv_dc, 117)], AC_TABLE[_clip(q + dquv_ac, 127)]),
            ))
        br.get(0x80)  # update_proba, ignored on a key frame
        proba = []
        k = 0
        for t in range(4):
            bands = []
            for b in range(8):
                ctxs = []
                for c in range(3):
                    p = []
                    for _ in range(11):
                        p.append(br.value_bits(8) if br.get(COEFFS_UPDATE_PROBA[k])
                                 else COEFFS_PROBA0[k])
                        k += 1
                    ctxs.append(p)
                bands.append(ctxs)
            proba.append([bands[BANDS[n]] for n in range(17)])
        self.proba = proba
        self.use_skip = br.get(0x80)
        self.skip_p = br.value_bits(8) if self.use_skip else 0
        # filter strengths per segment and 4x4 flag: (limit, ilevel, hev)
        self.fstrength = []
        for s in range(4):
            if self.use_segment:
                base = self.filter_strength[s] + (0 if self.absolute else self.level)
            else:
                base = self.level
            row = []
            for i4 in (0, 1):
                level = base
                if self.use_lf_delta:
                    level += self.ref_lf_delta[0]
                    if i4:
                        level += self.mode_lf_delta[0]
                level = _clip(level, 63)
                if level > 0:
                    il = level
                    if self.sharpness > 0:
                        il >>= 2 if self.sharpness > 4 else 1
                        il = min(il, 9 - self.sharpness)
                    il = max(il, 1)
                    row.append((2 * level + il, il, 2 if level >= 40 else 1 if level >= 15 else 0))
                else:
                    row.append((0, 0, 0))
            self.fstrength.append(row)


def _large(br: BoolDecoder, p: list[int]) -> int:
    if not br.get(p[3]):
        if not br.get(p[4]):
            return 2
        return 3 + br.get(p[5])
    if not br.get(p[6]):
        if not br.get(p[7]):
            return 5 + br.get(159)
        v = 7 + 2 * br.get(165)
        return v + br.get(145)
    bit1 = br.get(p[8])
    bit0 = br.get(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for pr in CAT3456[cat]:
        v += v + br.get(pr)
    return v + 3 + (8 << cat)


def _coeffs(br: BoolDecoder, prob, ctx: int, dq, n: int, out: list[int], base: int) -> int:
    p = prob[n][ctx]
    while n < 16:
        if not br.get(p[0]):
            return n
        while not br.get(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        nxt = prob[n + 1]
        if not br.get(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large(br, p)
            p = nxt[2]
        out[base + ZIGZAG[n]] = _wrap16(br.signed(v) * dq[n > 0])
        n += 1
    return 16


def _wht(src: list[int], out: list[int]) -> None:
    tmp = [0] * 16
    for i in range(4):
        a0 = src[i] + src[12 + i]
        a1 = src[4 + i] + src[8 + i]
        a2 = src[4 + i] - src[8 + i]
        a3 = src[i] - src[12 + i]
        tmp[i] = a0 + a1
        tmp[8 + i] = a0 - a1
        tmp[4 + i] = a3 + a2
        tmp[12 + i] = a3 - a2
    for i in range(4):
        dc = tmp[4 * i] + 3
        a0 = dc + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = dc - tmp[4 * i + 3]
        o = 64 * i
        out[o] = _wrap16((a0 + a1) >> 3)
        out[o + 16] = _wrap16((a3 + a2) >> 3)
        out[o + 32] = _wrap16((a0 - a1) >> 3)
        out[o + 48] = _wrap16((a3 - a2) >> 3)


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _idct_add(c: list[int], base: int, ws: list[list[int]], y0: int, x0: int,
              simd: bool) -> None:
    """The inverse DCT of one 4x4 block added to ws[y0:y0+4][x0:x0+4] with
    clipping: libwebp's C transform in ints, or (``simd``) its SSE2 one,
    whose sums wrap at 16 bits (they differ only on coefficients no
    encoder writes)."""
    w = _wrap16 if simd else _same
    mul1 = _mul1 if not simd else (lambda a: w(((a * 20091) >> 16) + a))
    mul2 = _mul2 if not simd else (lambda a: w(((a * -30068) >> 16) + a))
    tmp = [0] * 16
    for i in range(4):
        i0, i4, i8, i12 = c[base + i], c[base + 4 + i], c[base + 8 + i], c[base + 12 + i]
        a = w(i0 + i8)
        b = w(i0 - i8)
        cc = w(mul2(i4) - mul1(i12))
        d = w(mul1(i4) + mul2(i12))
        tmp[4 * i] = w(a + d)
        tmp[4 * i + 1] = w(b + cc)
        tmp[4 * i + 2] = w(b - cc)
        tmp[4 * i + 3] = w(a - d)
    for i in range(4):
        dc = w(tmp[i] + 4)
        a = w(dc + tmp[8 + i])
        b = w(dc - tmp[8 + i])
        cc = w(mul2(tmp[4 + i]) - mul1(tmp[12 + i]))
        d = w(mul1(tmp[4 + i]) + mul2(tmp[12 + i]))
        row = ws[y0 + i]
        for x, v in ((0, a + d), (1, b + cc), (2, b - cc), (3, a - d)):
            s = row[x0 + x] + (w(v) >> 3)
            row[x0 + x] = 0 if s < 0 else 255 if s > 255 else s


def _same(v: int) -> int:
    return v


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _avg2(a: int, b: int) -> int:
    return (a + b + 1) >> 1


def _pred4(mode: int, ws: list[list[int]], y: int, x: int) -> None:
    """A 4x4 predictor writing ws[y:y+4][x:x+4] from its row y-1 (x-1 to
    x+7) and column x-1."""
    top = ws[y - 1]
    A, B, C, D, E, F, G, H = top[x:x + 8]
    X = top[x - 1]
    I, J, K, L = ws[y][x - 1], ws[y + 1][x - 1], ws[y + 2][x - 1], ws[y + 3][x - 1]
    if mode == 0:  # DC
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        blk = [[v] * 4 for _ in range(4)]
    elif mode == 1:  # TM
        blk = [[min(255, max(0, t + lft - X)) for t in (A, B, C, D)] for lft in (I, J, K, L)]
    elif mode == 2:  # VE
        r = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        blk = [r, r, r, r]
    elif mode == 3:  # HE
        blk = [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))]
    else:
        blk = [[0] * 4 for _ in range(4)]

        def put(v, *xy):
            for px, py in xy:
                blk[py][px] = v
        if mode == 4:  # RD
            put(_avg3(J, K, L), (0, 3))
            put(_avg3(I, J, K), (1, 3), (0, 2))
            put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
            put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
            put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
            put(_avg3(C, B, A), (3, 1), (2, 0))
            put(_avg3(D, C, B), (3, 0))
        elif mode == 5:  # VR
            put(_avg2(X, A), (0, 0), (1, 2))
            put(_avg2(A, B), (1, 0), (2, 2))
            put(_avg2(B, C), (2, 0), (3, 2))
            put(_avg2(C, D), (3, 0))
            put(_avg3(K, J, I), (0, 3))
            put(_avg3(J, I, X), (0, 2))
            put(_avg3(I, X, A), (0, 1), (1, 3))
            put(_avg3(X, A, B), (1, 1), (2, 3))
            put(_avg3(A, B, C), (2, 1), (3, 3))
            put(_avg3(B, C, D), (3, 1))
        elif mode == 6:  # LD
            put(_avg3(A, B, C), (0, 0))
            put(_avg3(B, C, D), (1, 0), (0, 1))
            put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
            put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
            put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
            put(_avg3(F, G, H), (3, 2), (2, 3))
            put(_avg3(G, H, H), (3, 3))
        elif mode == 7:  # VL
            put(_avg2(A, B), (0, 0))
            put(_avg2(B, C), (1, 0), (0, 2))
            put(_avg2(C, D), (2, 0), (1, 2))
            put(_avg2(D, E), (3, 0), (2, 2))
            put(_avg3(A, B, C), (0, 1))
            put(_avg3(B, C, D), (1, 1), (0, 3))
            put(_avg3(C, D, E), (2, 1), (1, 3))
            put(_avg3(D, E, F), (3, 1), (2, 3))
            put(_avg3(E, F, G), (3, 2))
            put(_avg3(F, G, H), (3, 3))
        elif mode == 8:  # HD
            put(_avg2(I, X), (0, 0), (2, 1))
            put(_avg2(J, I), (0, 1), (2, 2))
            put(_avg2(K, J), (0, 2), (2, 3))
            put(_avg2(L, K), (0, 3))
            put(_avg3(A, B, C), (3, 0))
            put(_avg3(X, A, B), (2, 0))
            put(_avg3(I, X, A), (1, 0), (3, 1))
            put(_avg3(J, I, X), (1, 1), (3, 2))
            put(_avg3(K, J, I), (1, 2), (3, 3))
            put(_avg3(L, K, J), (1, 3))
        else:  # HU
            put(_avg2(I, J), (0, 0))
            put(_avg2(J, K), (2, 0), (0, 1))
            put(_avg2(K, L), (2, 1), (0, 2))
            put(_avg3(I, J, K), (1, 0))
            put(_avg3(J, K, L), (3, 0), (1, 1))
            put(_avg3(K, L, L), (3, 1), (1, 2))
            put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    for i in range(4):
        ws[y + i][x:x + 4] = blk[i]


def _pred_block(mode: int, ws: list[list[int]], size: int, has_top: bool, has_left: bool) -> None:
    """16x16 luma or 8x8 chroma prediction into ws[1:][1:], with libwebp's
    DC variants at the frame's edges."""
    top = ws[0][1:size + 1]
    left = [ws[1 + i][0] for i in range(size)]
    shift = 5 if size == 16 else 4
    if mode == DC_PRED:
        if has_top and has_left:
            v = (sum(top) + sum(left) + (size)) >> shift
        elif has_left:
            v = (sum(left) + (size >> 1)) >> (shift - 1)
        elif has_top:
            v = (sum(top) + (size >> 1)) >> (shift - 1)
        else:
            v = 0x80
        for i in range(size):
            ws[1 + i][1:size + 1] = [v] * size
    elif mode == TM_PRED:
        X = ws[0][0]
        for i in range(size):
            lft = left[i] - X
            ws[1 + i][1:size + 1] = [min(255, max(0, t + lft)) for t in top]
    elif mode == V_PRED:
        for i in range(size):
            ws[1 + i][1:size + 1] = list(top)
    else:
        for i in range(size):
            ws[1 + i][1:size + 1] = [left[i]] * size


def _parse_modes(hdr: Header, intra_t: list[int], intra_l: list[int], mb_x: int) -> dict:
    br = hdr.br
    if hdr.update_map:
        p = hdr.seg_proba
        seg = br.get(p[1]) if not br.get(p[0]) else br.get(p[2]) + 2
    else:
        seg = 0
    skip = br.get(hdr.skip_p) if hdr.use_skip else 0
    is_i4 = not br.get(145)
    top = intra_t[4 * mb_x:4 * mb_x + 4]
    if not is_i4:
        if br.get(156):
            ymode = TM_PRED if br.get(128) else H_PRED
        else:
            ymode = V_PRED if br.get(163) else DC_PRED
        modes = [ymode]
        top = [ymode] * 4
        intra_l[:] = [ymode] * 4
    else:
        modes = []
        for y in range(4):
            ymode = intra_l[y]
            for x in range(4):
                prob = BMODES_PROBA[90 * top[x] + 9 * ymode:90 * top[x] + 9 * ymode + 9]
                i = YMODES_INTRA4[br.get(prob[0])]
                while i > 0:
                    i = YMODES_INTRA4[2 * i + br.get(prob[i])]
                ymode = -i
                top[x] = ymode
            modes += top
            intra_l[y] = ymode
    intra_t[4 * mb_x:4 * mb_x + 4] = top
    if not br.get(142):
        uv = DC_PRED
    elif not br.get(114):
        uv = V_PRED
    else:
        uv = TM_PRED if br.get(183) else H_PRED
    return {"seg": seg, "skip": skip, "i4": is_i4, "modes": modes, "uv": uv}


def _nz_code(nz: int, dc: int) -> int:
    """libwebp's ``NzCodeBits`` of a block: 3 for a coefficient past the
    third, 2 past the first, 1 for a DC alone, 0 for none."""
    return 3 if nz > 3 else 2 if nz > 1 else int(dc != 0)


def _residuals(hdr: Header, br: BoolDecoder, mb: dict, tnz: list[int], lnz: list[int]):
    """Coefficients (384, dequantised) and each block's ``_nz_code`` (16
    luma, 4 U, 4 V)."""
    q = hdr.dq[mb["seg"]]
    prob = hdr.proba
    c = [0] * 384
    if not mb["i4"]:
        dc = [0] * 16
        nz = _coeffs(br, prob[1], tnz[8] + lnz[8], q[1], 0, dc, 0)
        tnz[8] = lnz[8] = int(nz > 0)
        if nz > 1:
            _wht(dc, c)
        else:
            dc0 = _wrap16((dc[0] + 3) >> 3)
            for i in range(16):
                c[16 * i] = dc0
        first, ac = 1, prob[0]
    else:
        first, ac = 0, prob[3]
    codes = [0] * 24
    for y in range(4):
        lft = lnz[y]
        for x in range(4):
            b = 16 * (4 * y + x)
            nz = _coeffs(br, ac, lft + tnz[x], q[0], first, c, b)
            lft = int(nz > first)
            tnz[x] = lft
            codes[4 * y + x] = _nz_code(nz, c[b])
        lnz[y] = lft
    for ch in (0, 1):
        for y in range(2):
            lft = lnz[4 + 2 * ch + y]
            for x in range(2):
                b = 256 + 64 * ch + 16 * (2 * y + x)
                nz = _coeffs(br, prob[2], lft + tnz[4 + 2 * ch + x], q[2], 0, c, b)
                lft = int(nz > 0)
                tnz[4 + 2 * ch + x] = lft
                codes[16 + 4 * ch + 2 * y + x] = _nz_code(nz, c[b])
            lnz[4 + 2 * ch + y] = lft
    return c, codes


def _workspace(plane: np.ndarray, size: int, mb_x: int, mb_y: int, extra: int) -> list[list[int]]:
    """libwebp's work buffer for one macroblock: row 0 the unfiltered row
    above (with ``extra`` top-right pixels), column 0 the column left."""
    ws = [[0] * (size + 1 + extra) for _ in range(size + 1)]
    y0, x0 = size * mb_y, size * mb_x
    if mb_y == 0:
        ws[0] = [127] * (size + 1 + extra)
    else:
        above = plane[y0 - 1]
        ws[0][1:size + 1] = above[x0:x0 + size].tolist()
        ws[0][0] = int(above[x0 - 1]) if mb_x > 0 else 129
        if extra:
            if x0 + size >= plane.shape[1]:
                ws[0][size + 1:] = [int(above[x0 + size - 1])] * extra
            else:
                ws[0][size + 1:] = above[x0 + size:x0 + size + extra].tolist()
    for i in range(size):
        ws[1 + i][0] = int(plane[y0 + i, x0 - 1]) if mb_x > 0 else 129
    return ws


def _reconstruct(mb: dict, c: list[int], codes: list[int], ys, us, vs, mb_x: int,
                 mb_y: int) -> None:
    """Prediction and residuals of one macroblock, each block's transform
    picked as libwebp's ``DoTransform``/``DoUVTransform`` pick it: luma
    blocks with a coefficient past the third through SSE2, others in C;
    a chroma plane through SSE2 when any of its blocks has an AC
    coefficient, else C."""
    ws = _workspace(ys, 16, mb_x, mb_y, 4)
    if mb["i4"]:
        tr = ws[0][17:21]
        for n in range(16):
            by, bx = n >> 2, n & 3
            if bx == 3 and by > 0:  # the right column's top-right: the MB above-right's
                ws[4 * by][17:21] = tr
            _pred4(mb["modes"][n], ws, 1 + 4 * by, 1 + 4 * bx)
            if codes[n]:
                _idct_add(c, 16 * n, ws, 1 + 4 * by, 1 + 4 * bx, codes[n] == 3)
    else:
        _pred_block(mb["modes"][0], ws, 16, mb_y > 0, mb_x > 0)
        for n in range(16):
            if codes[n]:
                _idct_add(c, 16 * n, ws, 1 + 4 * (n >> 2), 1 + 4 * (n & 3), codes[n] == 3)
    ys[16 * mb_y:16 * mb_y + 16, 16 * mb_x:16 * mb_x + 16] = [r[1:17] for r in ws[1:]]
    for ch, plane in ((0, us), (1, vs)):
        ws = _workspace(plane, 8, mb_x, mb_y, 0)
        _pred_block(mb["uv"], ws, 8, mb_y > 0, mb_x > 0)
        plane_codes = codes[16 + 4 * ch:20 + 4 * ch]
        if any(plane_codes):
            simd = max(plane_codes) >= 2
            for n in range(4):
                _idct_add(c, 256 + 64 * ch + 16 * n, ws, 1 + 4 * (n >> 1), 1 + 4 * (n & 1), simd)
        plane[8 * mb_y:8 * mb_y + 8, 8 * mb_x:8 * mb_x + 8] = [r[1:9] for r in ws[1:]]


# ------------------------------------------------------------- loop filter

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip1(v):
    return np.clip(v, 0, 255)


def _filter_edge(seg: np.ndarray, thresh: int, ithresh: int, hev_t: int, mode: str) -> None:
    """One edge: ``seg`` (n, 8) int32 lines p3 p2 p1 p0 q0 q1 q2 q3
    across it, filtered in place. ``mode``: "simple", "mb" (6 taps) or
    "inner" (4 taps)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, i] for i in range(8))
    t2 = 2 * thresh + 1
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if mode != "simple":
        need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
                 & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
                 & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(need)
    if not need.any():
        return
    # filter 2 (hev, or simple)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    f2 = need & hev
    n_p0 = np.where(f2, _clip1(p0 + a2), p0)
    n_q0 = np.where(f2, _clip1(q0 - a1), q0)
    n_p1, n_q1, n_p2, n_q2 = p1, q1, p2, q2
    other = need & ~hev
    if mode == "mb" and other.any():
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        b1 = (27 * a + 63) >> 7
        b2 = (18 * a + 63) >> 7
        b3 = (9 * a + 63) >> 7
        n_p2 = np.where(other, _clip1(p2 + b3), p2)
        n_p1 = np.where(other, _clip1(p1 + b2), p1)
        n_p0 = np.where(other, _clip1(p0 + b1), n_p0)
        n_q0 = np.where(other, _clip1(q0 - b1), n_q0)
        n_q1 = np.where(other, _clip1(q1 - b2), q1)
        n_q2 = np.where(other, _clip1(q2 - b3), q2)
    elif mode == "inner" and other.any():
        a = 3 * (q0 - p0)
        b1 = _sclip2((a + 4) >> 3)
        b2 = _sclip2((a + 3) >> 3)
        b3 = (b1 + 1) >> 1
        n_p1 = np.where(other, _clip1(p1 + b3), p1)
        n_p0 = np.where(other, _clip1(p0 + b2), n_p0)
        n_q0 = np.where(other, _clip1(q0 - b1), n_q0)
        n_q1 = np.where(other, _clip1(q1 - b3), q1)
    seg[:, 1], seg[:, 2], seg[:, 3] = n_p2, n_p1, n_p0
    seg[:, 4], seg[:, 5], seg[:, 6] = n_q0, n_q1, n_q2


def _filter_v_edge(plane: np.ndarray, y0: int, n: int, x: int, *args) -> None:
    """The edge left of column x, rows y0..y0+n (libwebp's H filters)."""
    seg = plane[y0:y0 + n, x - 4:x + 4].astype(np.int32)
    _filter_edge(seg, *args)
    plane[y0:y0 + n, x - 4:x + 4] = seg


def _filter_h_edge(plane: np.ndarray, x0: int, n: int, y: int, *args) -> None:
    """The edge above row y, columns x0..x0+n (libwebp's V filters)."""
    seg = np.ascontiguousarray(plane[y - 4:y + 4, x0:x0 + n].T).astype(np.int32)
    _filter_edge(seg, *args)
    plane[y - 4:y + 4, x0:x0 + n] = seg.T


def _filter_mb(hdr: Header, fi: tuple, ys, us, vs, mb_x: int, mb_y: int) -> None:
    limit, ilevel, hev, inner = fi
    if limit == 0:
        return
    x0, y0 = 16 * mb_x, 16 * mb_y
    if hdr.filter_type == 1:
        if mb_x > 0:
            _filter_v_edge(ys, y0, 16, x0, limit + 4, 0, 0, "simple")
        if inner:
            for k in (4, 8, 12):
                _filter_v_edge(ys, y0, 16, x0 + k, limit, 0, 0, "simple")
        if mb_y > 0:
            _filter_h_edge(ys, x0, 16, y0, limit + 4, 0, 0, "simple")
        if inner:
            for k in (4, 8, 12):
                _filter_h_edge(ys, x0, 16, y0 + k, limit, 0, 0, "simple")
        return
    cx, cy = 8 * mb_x, 8 * mb_y
    if mb_x > 0:
        _filter_v_edge(ys, y0, 16, x0, limit + 4, ilevel, hev, "mb")
        _filter_v_edge(us, cy, 8, cx, limit + 4, ilevel, hev, "mb")
        _filter_v_edge(vs, cy, 8, cx, limit + 4, ilevel, hev, "mb")
    if inner:
        for k in (4, 8, 12):
            _filter_v_edge(ys, y0, 16, x0 + k, limit, ilevel, hev, "inner")
        _filter_v_edge(us, cy, 8, cx + 4, limit, ilevel, hev, "inner")
        _filter_v_edge(vs, cy, 8, cx + 4, limit, ilevel, hev, "inner")
    if mb_y > 0:
        _filter_h_edge(ys, x0, 16, y0, limit + 4, ilevel, hev, "mb")
        _filter_h_edge(us, cx, 8, cy, limit + 4, ilevel, hev, "mb")
        _filter_h_edge(vs, cx, 8, cy, limit + 4, ilevel, hev, "mb")
    if inner:
        for k in (4, 8, 12):
            _filter_h_edge(ys, x0, 16, y0 + k, limit, ilevel, hev, "inner")
        _filter_h_edge(us, cx, 8, cy + 4, limit, ilevel, hev, "inner")
        _filter_h_edge(vs, cx, 8, cy + 4, limit, ilevel, hev, "inner")


def decode_planes(data: bytes, max_mb_rows: int | None = None):
    """A VP8 key frame to its loop-filtered (Y, U, V) planes at macroblock
    size: (16 mb_h, 16 mb_w) and (8 mb_h, 8 mb_w) uint8, or the first
    ``max_mb_rows`` macroblock rows of them."""
    hdr = Header(data)
    rows = hdr.mb_h if max_mb_rows is None else min(hdr.mb_h, max_mb_rows)
    ys = np.zeros((16 * rows, 16 * hdr.mb_w), np.uint8)
    us = np.zeros((8 * rows, 8 * hdr.mb_w), np.uint8)
    vs = np.zeros((8 * rows, 8 * hdr.mb_w), np.uint8)
    intra_t = [0] * (4 * hdr.mb_w)
    tnz = [[0] * 9 for _ in range(hdr.mb_w)]
    finfo = []
    for mb_y in range(rows):
        intra_l = [0] * 4
        lnz = [0] * 9
        mbs = [_parse_modes(hdr, intra_t, intra_l, x) for x in range(hdr.mb_w)]
        if hdr.br.eof:
            raise ValueError("premature end of VP8 partition 0")
        br = hdr.parts[mb_y & (len(hdr.parts) - 1)]
        row_info = []
        for mb_x, mb in enumerate(mbs):
            if not mb["skip"]:
                c, codes = _residuals(hdr, br, mb, tnz[mb_x], lnz)
                skip = not any(codes)
            else:
                c, codes = [0] * 384, [0] * 24
                lnz[:8] = [0] * 8
                tnz[mb_x][:8] = [0] * 8
                if not mb["i4"]:
                    lnz[8] = tnz[mb_x][8] = 0
                skip = True
            if br.eof:
                raise ValueError("premature end of VP8 token partition")
            _reconstruct(mb, c, codes, ys, us, vs, mb_x, mb_y)
            if hdr.filter_type:
                limit, ilevel, hev = hdr.fstrength[mb["seg"]][int(mb["i4"])]
                row_info.append((limit, ilevel, hev, mb["i4"] or not skip))
        finfo.append(row_info)
    if hdr.filter_type:
        ys0, us0, vs0 = ys.copy(), us.copy(), vs.copy()
        for mb_y in range(rows):
            for mb_x in range(hdr.mb_w):
                _filter_mb(hdr, finfo[mb_y][mb_x], ys0, us0, vs0, mb_x, mb_y)
        ys, us, vs = ys0, us0, vs0
    return hdr, ys, us, vs


# ---------------------------------------------------------------- YUV->RGB

def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    y = y.astype(np.int32)
    u = u.astype(np.int32)
    v = v.astype(np.int32)
    yy = (y * 19077) >> 8

    def clip8(t):
        return np.where((t & ~16383) == 0, t >> 6, np.where(t < 0, 0, 255))
    r = clip8(yy + ((v * 26149) >> 8) - 14234)
    g = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _upsample_pair(top_uv: np.ndarray, cur_uv: np.ndarray, width: int):
    """Chroma of a row pair at full width: (top row's, bottom row's), each
    (k, width) from (k, uv_w) rows of one plane (libwebp's
    ``UPSAMPLE_FUNC`` lane arithmetic)."""
    tl = top_uv[:, :-1]
    t = top_uv[:, 1:]
    lft = cur_uv[:, :-1]
    c = cur_uv[:, 1:]
    k = top_uv.shape[0]
    top = np.empty((k, width), np.int32)
    bot = np.empty((k, width), np.int32)
    top[:, 0] = (3 * top_uv[:, 0] + cur_uv[:, 0] + 2) >> 2
    bot[:, 0] = (3 * cur_uv[:, 0] + top_uv[:, 0] + 2) >> 2
    npairs = (width - 1) >> 1
    if npairs:
        tl, t, lft, c = tl[:, :npairs], t[:, :npairs], lft[:, :npairs], c[:, :npairs]
        avg = tl + t + lft + c + 8
        d12 = (avg + 2 * (t + lft)) >> 3
        d03 = (avg + 2 * (tl + c)) >> 3
        top[:, 1:2 * npairs:2] = (d12 + tl) >> 1
        top[:, 2:2 * npairs + 1:2] = (d03 + t) >> 1
        bot[:, 1:2 * npairs:2] = (d03 + lft) >> 1
        bot[:, 2:2 * npairs + 1:2] = (d12 + c) >> 1
    if not width & 1:
        tl_last = top_uv[:, npairs]
        l_last = cur_uv[:, npairs]
        top[:, width - 1] = (3 * tl_last + l_last + 2) >> 2
        bot[:, width - 1] = (3 * l_last + tl_last + 2) >> 2
    return top, bot


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, width: int, height: int) -> np.ndarray:
    """libwebp's fancy-upsampled RGB (``EmitFancyRGB``) of planes cropped
    to (height, width) and ((height+1)//2, (width+1)//2)."""
    uw, uh = (width + 1) >> 1, (height + 1) >> 1
    y = y[:height, :width]
    u = u[:uh, :uw].astype(np.int32)
    v = v[:uh, :uw].astype(np.int32)
    uu = np.empty((height, width), np.int32)
    vv = np.empty((height, width), np.int32)
    for plane, full in ((u, uu), (v, vv)):
        first, _ = _upsample_pair(plane[:1], plane[:1], width)
        full[0] = first[0]
        npair = (height - 1) >> 1
        if npair:
            top, bot = _upsample_pair(plane[:npair], plane[1:npair + 1], width)
            full[1:2 * npair:2] = top
            full[2:2 * npair + 1:2] = bot
        if not height & 1:
            last, _ = _upsample_pair(plane[uh - 1:uh], plane[uh - 1:uh], width)
            full[height - 1] = last[0]
    return _yuv_to_rgb(y, uu, vv)


def decode_vp8(data: bytes, compiled: bool = False) -> np.ndarray:
    """A VP8 chunk's payload to (H, W, 3) uint8 RGB as libwebp outputs it."""
    if compiled:
        from .webp import compiled_planes, compiled_rgb

        return compiled_rgb(*compiled_planes(data)[2:], *frame_info(data))
    hdr, ys, us, vs = decode_planes(data)
    return yuv_to_rgb(ys, us, vs, hdr.width, hdr.height)
