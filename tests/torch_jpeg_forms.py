"""JPEG forms that PIL does not write, built by hand for the decoder tests.

``hand_jpeg`` writes a sequential Huffman JPEG of random coefficients with
any component count, sampling factors, component ids and Adobe or JFIF
marker: YCCK, RGB-coded streams, h1v2, h4v1, h3v1 and mixed samplings.
``truncated_progression`` cuts a progressive stream after its first scans,
so that its AC coefficients stay unrefined (what libjpeg-turbo
block-smooths).
"""
import numpy as np

from rapiddoc_tpu_torch.pdfio.jpeg_encode import _AC_LUMA, _DC_LUMA, ZIGZAG

def _codes(table):
    bits, vals = table
    code = 0; out = {}; k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length); code += 1; k += 1
        code <<= 1
    return out

DC, AC = _codes(_DC_LUMA), _codes(_AC_LUMA)

def _size(v):
    return 0 if v == 0 else int(abs(v)).bit_length()

def _extra(v, s):
    return v if v >= 0 else v + (1 << s) - 1

def _seg(m, p):
    return bytes([0xFF, m]) + (len(p) + 2).to_bytes(2, "big") + p

def hand_jpeg(w, h, samp, rng, ids=None, adobe=None, jfif=False, q=2):
    """A w x h stream whose component i is sampled ``samp[i]`` = (h, v),
    one interleaved scan, quantiser ``q`` everywhere, every table the
    standard luminance one."""
    n = len(samp)
    ids = ids or list(range(1, n + 1))
    hmax = max(a for a, b in samp); vmax = max(b for a, b in samp)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks = [rng.integers(-6, 7, (my * v, mx * hh, 64)) * (rng.random((my * v, mx * hh, 64)) < 0.15) for hh, v in samp]
    for b in blocks:
        b[..., 0] = rng.integers(-40, 40, b.shape[:2])
    bits = []
    def put(code, length):
        for i in range(length - 1, -1, -1): bits.append((code >> i) & 1)
    pred = [0] * n
    for r in range(my):
        for c in range(mx):
            for ci, (hh, v) in enumerate(samp):
                for by in range(v):
                    for bx in range(hh):
                        blk = blocks[ci][r * v + by, c * hh + bx]
                        zz = blk[ZIGZAG]
                        d = int(zz[0]) - pred[ci]; pred[ci] = int(zz[0])
                        s = _size(d); put(*DC[s]); put(_extra(d, s), s)
                        run = 0
                        last = max([k for k in range(1, 64) if zz[k]] or [0])
                        for k in range(1, last + 1):
                            vv = int(zz[k])
                            if vv == 0: run += 1; continue
                            while run > 15: put(*AC[0xF0]); run -= 16
                            s = _size(vv); put(*AC[run * 16 + s]); put(_extra(vv, s), s); run = 0
                        if last < 63: put(*AC[0])
    bits += [1] * (-len(bits) % 8)
    data = bytearray()
    for i in range(0, len(bits), 8):
        byte = int("".join(map(str, bits[i:i + 8])), 2); data.append(byte)
        if byte == 0xFF: data.append(0)
    out = b"\xff\xd8"
    if jfif: out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None: out += _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    out += _seg(0xDB, bytes([0]) + bytes([q] * 64))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([n])
    for ci, (hh, v) in enumerate(samp): sof += bytes([ids[ci], hh * 16 + v, 0])
    out += _seg(0xC0, sof)
    for cls, (b_, v_) in ((0x00, _DC_LUMA), (0x10, _AC_LUMA)):
        out += _seg(0xC4, bytes([cls]) + bytes(b_) + bytes(v_))
    sos = bytes([n]) + b"".join(bytes([ids[ci], 0]) for ci in range(n)) + bytes([0, 63, 0])
    return out + _seg(0xDA, sos) + bytes(data) + b"\xff\xd9"


def truncated_progression(data: bytes, scans: int) -> bytes:
    """A progressive stream cut after its first ``scans`` scans (each
    with the tables before it), then EOI."""
    pos = data.index(b"\xff\xda")
    for _ in range(scans - 1):
        pos = data.index(b"\xff\xda", pos + 2)
    nxt = data.find(b"\xff\xc4", pos + 2)
    nxt2 = data.find(b"\xff\xda", pos + 2)
    ends = [e for e in (nxt, nxt2) if e > 0]
    end = min(ends) if ends else len(data) - 2
    return data[:end] + b"\xff\xd9"
