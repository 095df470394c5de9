"""Baseline JPEG encoder giving PIL's bytes, in numpy.

The JAX package writes each image, table and display-formula span as
``PIL.Image.save(buf, "JPEG", quality=90)`` of the RGB crop
(``rapiddoc_tpu/utils/images.py:32-35``), and the parse result's
``images`` dict holds those bytes. This module gives the same bytes as
PIL over libjpeg-turbo (3.1) with PIL's defaults at that quality:

- SOI; a JFIF 1.01 APP0 (density 1:1, no units); two DQT (the Annex K
  tables scaled by ``jpeg_quality_scaling``, baseline-clamped, zigzag);
  SOF0 with Y at 2x2 and Cb, Cr at 1x1 (4:2:0); the four Annex K
  Huffman tables; one interleaved SOS; the scan; EOI;
- ``rgb_ycc_convert``'s 16-bit fixed point;
- the component planes padded as libjpeg pads them: Y to whole blocks by
  repeating its last column and row; the image to an even width and
  height (and to twice the chroma width) before ``h2v2_downsample``
  (2x2 sums plus a bias alternating 1, 2 along each row, >> 2), whose
  output is then padded to whole blocks by repeating its last row;
  blocks an MCU needs beyond a plane's blocks are dummy blocks with the
  DC of the block before them and no AC;
- the ISLOW forward DCT (``jfdctint.c``: 13-bit constants, 2 pass bits),
  then quantisation to the nearest integer away from zero on ties
  ((|x| + 4q) // 8q with the sign put back);
- Huffman coding of DC differences per component and of AC run/size
  symbols with ZRL and EOB, 0xFF bytes stuffed with 0x00, the last byte
  filled with 1 bits.

Every step is data parallel once each symbol's code length is known, so
all of it, the bit packing included, is vectorised over the blocks.
Any quality is taken (libjpeg's ``jpeg_quality_scaling``): the span
images are q90 and ``pdfio/writer.images_to_pdf`` writes q92. A grey
image is one component (a 1x1 Y, quant table 0, the two luma Huffman
tables, one non-interleaved scan of its blocks in raster order), as PIL
writes mode ``L``.
"""
from __future__ import annotations

import numpy as np

QUALITY = 90

# ITU T.81 Annex K.1, natural order
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.int64)

# natural index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# ITU T.81 Annex K.3: (bits per code length 1..16, symbol values)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])


def quant_tables(quality: int = QUALITY) -> tuple[np.ndarray, np.ndarray]:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``: the Annex K
    tables scaled by ``jpeg_quality_scaling`` (5000 / q below 50, else
    200 - 2q percent), baseline-clamped, natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2

    def scaled(base: np.ndarray) -> np.ndarray:
        return np.clip((base * scale + 50) // 100, 1, 255)

    return scaled(_STD_LUMA), scaled(_STD_CHROMA)


def _huffman(table: tuple[list[int], list[int]]) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol, as jpeg_make_c_derived_tbl builds them."""
    bits, vals = table
    sizes = [length for length in range(1, 17) for _ in range(bits[length - 1])]
    codes = []
    code, si = 0, sizes[0]
    for s in sizes:
        while s > si:
            code <<= 1
            si += 1
        codes.append(code)
        code += 1
    ehufco = np.zeros(256, np.int64)
    ehufsi = np.zeros(256, np.int64)
    for v, c, s in zip(vals, codes, sizes):
        ehufco[v], ehufsi[v] = c, s
    return ehufco, ehufsi


_TABLES = {name: _huffman(t) for name, t in (
    ("dc0", _DC_LUMA), ("dc1", _DC_CHROMA), ("ac0", _AC_LUMA), ("ac1", _AC_CHROMA))}


def rgb_to_ycc(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libjpeg's ``rgb_ycc_convert`` (16-bit fixed point)."""

    def fix(x: float) -> int:
        return int(x * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = h - plane.shape[0], w - plane.shape[1]
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return plane


def _downsample_h2v2(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``h2v2_downsample`` of a plane already padded to (2*out_h, 2*out_w)."""
    p = plane.reshape(out_h, 2, out_w, 2)
    bias = np.where(np.arange(out_w) % 2 == 0, 1, 2)
    return (p.sum(axis=(1, 3)) + bias) >> 2


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """``jpeg_fdct_islow`` on (..., 8, 8) level-shifted samples; the
    output is scaled up by 8, as libjpeg leaves it."""
    c_bits, p_bits = 13, 2
    f = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
         "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
         "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
         "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, axis, even, odd_shift):
        def at(i):
            return np.take(d, i, axis=axis)

        tmp0, tmp7 = at(0) + at(7), at(0) - at(7)
        tmp1, tmp6 = at(1) + at(6), at(1) - at(6)
        tmp2, tmp5 = at(2) + at(5), at(2) - at(5)
        tmp3, tmp4 = at(3) + at(4), at(3) - at(4)
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        out = [None] * 8
        out[0] = even(tmp10 + tmp11)
        out[4] = even(tmp10 - tmp11)
        z1 = (tmp12 + tmp13) * f["0_541196100"]
        out[2] = descale(z1 + tmp13 * f["0_765366865"], odd_shift)
        out[6] = descale(z1 - tmp12 * f["1_847759065"], odd_shift)
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * f["1_175875602"]
        tmp4 = tmp4 * f["0_298631336"]
        tmp5 = tmp5 * f["2_053119869"]
        tmp6 = tmp6 * f["3_072711026"]
        tmp7 = tmp7 * f["1_501321110"]
        z1 = z1 * -f["0_899976223"]
        z2 = z2 * -f["2_562915447"]
        z3 = z3 * -f["1_961570560"] + z5
        z4 = z4 * -f["0_390180644"] + z5
        out[7] = descale(tmp4 + z1 + z3, odd_shift)
        out[5] = descale(tmp5 + z2 + z4, odd_shift)
        out[3] = descale(tmp6 + z2 + z3, odd_shift)
        out[1] = descale(tmp7 + z1 + z4, odd_shift)
        return np.stack(out, axis=axis)

    d = blocks.astype(np.int64)
    d = one_pass(d, -1, lambda x: x << p_bits, c_bits - p_bits)  # rows
    return one_pass(d, -2, lambda x: descale(x, p_bits), c_bits + p_bits)  # columns


def quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(..., 64) natural-order DCT output (x8) -> quantised values."""
    q = qtable * 8
    mag = (np.abs(coef) + (q >> 1)) // q
    return np.where(coef < 0, -mag, mag)


def _component_blocks(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Quantised (bh, bw, 64) natural-order blocks of a padded plane."""
    blk = _blocks(plane - 128)
    coef = fdct_islow(blk).reshape(*blk.shape[:2], 64)
    return quantize(coef, qtable)


def _interleave(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Blocks in scan order (each MCU: Y top-left, top-right,
    bottom-left, bottom-right, Cb, Cr) and the component of each."""
    mh, mw = cb.shape[:2]
    yy = y.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh, mw, 4, 64)
    mcu = np.concatenate([yy, cb[:, :, None], cr[:, :, None]], axis=2)
    comp = np.broadcast_to(np.array([0, 0, 0, 0, 1, 2]), (mh, mw, 6))
    return mcu.reshape(-1, 64), comp.reshape(-1)


def _dummy_grid(blocks: np.ndarray, mcu_rows: int, mcu_cols: int, v: int, h: int) -> np.ndarray:
    """A component's blocks over the whole MCU grid (v x h blocks per
    MCU), with libjpeg's dummy blocks where the plane has none."""
    bh, bw, _ = blocks.shape
    rows, cols = mcu_rows * v, mcu_cols * h
    out = np.zeros((rows, cols, 64), np.int64)
    out[:bh, :bw] = blocks
    # right edge: each dummy block's DC is the DC of the block before it
    for c in range(bw, cols):
        out[:bh, c, 0] = out[:bh, c - 1, 0]
    # bottom edge: a dummy row takes, in every block of its MCU, the DC
    # of the last block of the MCU row above it
    for r in range(bh, rows):
        for mc in range(mcu_cols):
            out[r, mc * h:(mc + 1) * h, 0] = out[r - 1, mc * h + h - 1, 0]
    return out


def _size(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    a = np.abs(v)
    s = np.zeros_like(a)
    for bit in range(16):
        s += a >= (1 << bit)
    return s


def _extra_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v < 0, v + (1 << s) - 1, v)


def entropy_code(blocks: np.ndarray, comps: np.ndarray) -> bytes:
    """Huffman-code quantised blocks (natural order) in scan order, with
    0xFF stuffing and the final byte filled with 1 bits."""
    n = len(blocks)
    zz = blocks[:, ZIGZAG]
    lum = comps == 0
    # DC differences per component
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in (0, 1, 2):
        idx = np.flatnonzero(comps == c)
        d = dc[idx]
        diff[idx] = np.diff(d, prepend=0)
    dc_size = _size(diff)
    dc_code = np.where(lum, _TABLES["dc0"][0][dc_size], _TABLES["dc1"][0][dc_size])
    dc_len = np.where(lum, _TABLES["dc0"][1][dc_size], _TABLES["dc1"][1][dc_size])
    # AC symbols: every nonzero coefficient, the zero run before it
    ac = zz[:, 1:]
    bi, k = np.nonzero(ac)
    k = k + 1
    vals = ac[bi, k - 1]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev_k = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    zrl, rem = run // 16, run % 16
    size = _size(vals)
    sym = rem * 16 + size
    lum_ac = lum[bi]
    ac_code = np.where(lum_ac, _TABLES["ac0"][0][sym], _TABLES["ac1"][0][sym])
    ac_len = np.where(lum_ac, _TABLES["ac0"][1][sym], _TABLES["ac1"][1][sym])
    zrl_code = np.where(lum_ac, _TABLES["ac0"][0][0xF0], _TABLES["ac1"][0][0xF0])
    zrl_len = np.where(lum_ac, _TABLES["ac0"][1][0xF0], _TABLES["ac1"][1][0xF0])
    # EOB for every block whose last coefficient is zero
    last_k = np.zeros(n, np.int64)
    last_k[bi] = k  # the nonzeros come in increasing k per block
    eob = np.flatnonzero(last_k < 63)
    eob_code = np.where(lum[eob], _TABLES["ac0"][0][0], _TABLES["ac1"][0][0])
    eob_len = np.where(lum[eob], _TABLES["ac0"][1][0], _TABLES["ac1"][1][0])
    # every item: (block, key, value, length), key orders it in its block
    items = [
        (np.arange(n), np.zeros(n, np.int64), dc_code, dc_len),
        (np.arange(n), np.ones(n, np.int64), _extra_bits(diff, dc_size), dc_size),
    ]
    for j in range(3):
        items.append((bi, k * 8 + 2 + j, zrl_code, np.where(zrl > j, zrl_len, 0)))
    items.append((bi, k * 8 + 5, ac_code, ac_len))
    items.append((bi, k * 8 + 6, _extra_bits(vals, size), size))
    items.append((eob, np.full(len(eob), 64 * 8, np.int64), eob_code, eob_len))
    block = np.concatenate([i[0] for i in items])
    key = np.concatenate([i[1] for i in items])
    value = np.concatenate([i[2] for i in items])
    length = np.concatenate([i[3] for i in items])
    order = np.lexsort((key, block))
    value, length = value[order], length[order]
    # expand to bits, MSB first
    total = int(length.sum())
    starts = np.cumsum(length) - length
    owner = np.repeat(np.arange(len(length)), length)
    pos = np.arange(total) - starts[owner]
    bits = (value[owner] >> (length[owner] - 1 - pos)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    # stuff a zero byte after every 0xFF
    ff = data == 0xFF
    out = np.zeros(len(data) + int(ff.sum()), np.uint8)
    dst = np.arange(len(data)) + np.concatenate([[0], np.cumsum(ff)[:-1]])
    out[dst] = data
    return out.tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _headers(height: int, width: int, luma_q: np.ndarray, chroma_q: np.ndarray | None) -> bytes:
    """SOI, JFIF, DQT, SOF0, DHT and SOS of a colour (4:2:0) or, without
    ``chroma_q``, a one-component grey stream."""
    grey = chroma_q is None
    out = b"\xff\xd8"
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tid, q in ((0, luma_q),) if grey else ((0, luma_q), (1, chroma_q)):
        out += _segment(0xDB, bytes([tid]) + bytes(q[ZIGZAG].astype(np.uint8)))
    size = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    if grey:
        out += _segment(0xC0, size + bytes([1, 1, 0x11, 0]))
        tables = ((0x00, _DC_LUMA), (0x10, _AC_LUMA))
    else:
        out += _segment(0xC0, size + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
        tables = ((0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA), (0x11, _AC_CHROMA))
    for cls_id, table in tables:
        bits, vals = table
        out += _segment(0xC4, bytes([cls_id]) + bytes(bits) + bytes(vals))
    if grey:
        return out + _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
    return out + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def encode_jpeg(img: np.ndarray, quality: int = QUALITY) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) grey -> the bytes PIL writes for
    ``Image.fromarray(img).save(buf, "JPEG", quality=quality)`` (4:2:0
    colour, or one component for grey)."""
    img = np.asarray(img)
    grey = img.ndim == 2
    if img.dtype != np.uint8 or not (grey or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg wants uint8 (H, W, 3) or (H, W), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a baseline JPEG holds 1..65535 pixels a side, not {w}x{h}")
    luma_q, chroma_q = quant_tables(quality)
    # Y (or grey): whole blocks by edge repetition
    ybh, ybw = -(-h // 8), -(-w // 8)
    if grey:
        y_blocks = _component_blocks(_pad_edge(img.astype(np.int64), ybh * 8, ybw * 8), luma_q)
        blocks = y_blocks.reshape(-1, 64)
        return (_headers(h, w, luma_q, None)
                + entropy_code(blocks, np.zeros(len(blocks), np.int64)) + b"\xff\xd9")
    y, cb, cr = rgb_to_ycc(img)
    mcu_rows, mcu_cols = -(-h // 16), -(-w // 16)
    y_blocks = _component_blocks(_pad_edge(y, ybh * 8, ybw * 8), luma_q)
    # chroma: even input by edge repetition, 2x2 down, then whole blocks
    ch, cw = -(-h // 2), -(-w // 2)
    cbh, cbw = -(-ch // 8), -(-cw // 8)
    chroma = []
    for plane in (cb, cr):
        small = _downsample_h2v2(_pad_edge(plane, 2 * ch, 2 * cbw * 8), ch, cbw * 8)
        chroma.append(_component_blocks(_pad_edge(small, cbh * 8, cbw * 8), chroma_q))
    y_grid = _dummy_grid(y_blocks, mcu_rows, mcu_cols, 2, 2)
    c_grids = [_dummy_grid(c, mcu_rows, mcu_cols, 1, 1) for c in chroma]
    blocks, comps = _interleave(y_grid, *c_grids)
    return _headers(h, w, luma_q, chroma_q) + entropy_code(blocks, comps) + b"\xff\xd9"
