"""JPEG 2000 tier 1 (EBCOT, T.800 Annex D) for one code-block, as
OpenJPEG 2.5 decodes it: the plain version of ``csrc/jpx.cu``'s
``jpx_t1_decode``, bit for bit.

- The MQ decoder is ``jbig2.PyMQDecoder`` (T.800 Annex C is T.88 Annex
  E): OpenJPEG's artificial ``0xFF 0xFF`` after a segment is the same
  feed of ``0xFF00`` past the end. Nineteen contexts: nine for zero
  coding, five for signs, three for refinement, run-length and uniform;
  run-length starts at state 3, uniform at 46 and the first zero-coding
  context at 4.
- The passes run in stripes of four rows, column by column: cleanup at
  the first bit-plane, then significance propagation, magnitude
  refinement and cleanup at each lower one, for as many passes as the
  packets brought. Run-length coding needs a whole stripe column of
  insignificant, unvisited samples with no significant neighbour.
- Zero-coding contexts follow Table D.1 with horizontal and vertical
  neighbours swapped for the HL band (``orient`` 1: LL 0, HL 1, LH 2,
  HH 3, the tile's band numbers); sign contexts Table D.3.
- Values keep one extra fractional bit, as OpenJPEG's do: a sample that
  becomes significant at bit-plane p is 3 * 2^p with its sign, and a
  refinement bit at p adds or takes 2^p from its magnitude; the result is
  the midpoint of the last interval (reconstruction offset 1/2), twice
  the coefficient.
"""
from __future__ import annotations

import numpy as np

from .jbig2 import PyMQDecoder

CTX_RL, CTX_UNI = 17, 18


def _zc_lut(orient: int) -> list[int]:
    """Zero-coding context by (h, v, d) index ``(h * 3 + v) * 5 + d``."""
    lut = []
    for h0 in range(3):
        for v0 in range(3):
            for d in range(5):
                h, v = (v0, h0) if orient == 1 else (h0, v0)
                if orient == 3:
                    hv = h + v
                    if d == 0:
                        n = 0 if hv == 0 else 1 if hv == 1 else 2
                    elif d == 1:
                        n = 3 if hv == 0 else 4 if hv == 1 else 5
                    elif d == 2:
                        n = 6 if hv == 0 else 7
                    else:
                        n = 8
                elif h == 0:
                    n = (0 if d == 0 else 1 if d == 1 else 2) if v == 0 else 3 if v == 1 else 4
                elif h == 1:
                    n = (5 if d == 0 else 6) if v == 0 else 7
                else:
                    n = 8
                lut.append(n)
    return lut


ZC_LUTS = [_zc_lut(o) for o in range(4)]
# sign context and xor bit by (H + 1) * 3 + (V + 1), H and V in -1..1
SC_LUT = [(13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0), (12, 0), (13, 0)]


def decode_cblock(data: bytes, w: int, h: int, orient: int, first_plane: int,
                  segments: list[tuple[int, int]]) -> np.ndarray:
    """One code-block's coding passes (first a cleanup at ``first_plane``)
    over ``data``, cut into ``segments`` of (passes, bytes), each read by
    an MQ decoder of its own over the same contexts: (h, w) int32
    coefficients, doubled."""
    out = np.zeros((h, w), np.int32)
    if not segments or first_plane < 0 or w <= 0 or h <= 0:
        return out
    data = bytes(data)
    cx = [0] * 19
    cx[0] = 4 << 1
    cx[CTX_RL] = 3 << 1
    cx[CTX_UNI] = 46 << 1
    W = w + 2
    n = W * (h + 2)
    sig = [0] * n   # 1 significant
    neg = [0] * n
    visited = [0] * n
    refined = [0] * n
    val = [0] * n
    # each sample's significant neighbours as the zero-coding index
    # (h * 3 + v) * 5 + d, kept up to date as samples become significant
    nbr = [0] * n
    zc = ZC_LUTS[orient]
    decode = None
    stripes = [(y0, [(y + 1) * W + 1 for y in range(y0, min(y0 + 4, h))])
               for y0 in range(0, h, 4)]

    def set_sig(i: int, p: int) -> None:
        hc = (sig[i - 1] * (1 - 2 * neg[i - 1])) + (sig[i + 1] * (1 - 2 * neg[i + 1]))
        vc = (sig[i - W] * (1 - 2 * neg[i - W])) + (sig[i + W] * (1 - 2 * neg[i + W]))
        hc = -1 if hc < -1 else 1 if hc > 1 else hc
        vc = -1 if vc < -1 else 1 if vc > 1 else vc
        ctx, xor = SC_LUT[(hc + 1) * 3 + vc + 1]
        s = decode(cx, ctx) ^ xor
        sig[i] = 1
        neg[i] = s
        v = 3 << p
        val[i] = -v if s else v
        nbr[i - 1] += 15
        nbr[i + 1] += 15
        nbr[i - W] += 5
        nbr[i + W] += 5
        nbr[i - W - 1] += 1
        nbr[i - W + 1] += 1
        nbr[i + W - 1] += 1
        nbr[i + W + 1] += 1

    def sig_pass(p: int) -> None:
        for _, rows in stripes:
            for x in range(w):
                for r in rows:
                    i = r + x
                    if sig[i] or not nbr[i]:
                        continue
                    visited[i] = 1
                    if decode(cx, zc[nbr[i]]):
                        set_sig(i, p)

    def ref_pass(p: int) -> None:
        half = 1 << p
        for _, rows in stripes:
            for x in range(w):
                for r in rows:
                    i = r + x
                    if not sig[i] or visited[i]:
                        continue
                    if refined[i]:
                        ctx = 16
                    else:
                        ctx = 15 if nbr[i] else 14
                        refined[i] = 1
                    bit = decode(cx, ctx)
                    if val[i] < 0:
                        val[i] += -half if bit else half
                    else:
                        val[i] += half if bit else -half

    def cln_pass(p: int) -> None:
        for y0, rows in stripes:
            full = len(rows) == 4
            for x in range(w):
                todo = rows
                if full:
                    i0, i1, i2, i3 = rows[0] + x, rows[1] + x, rows[2] + x, rows[3] + x
                    if not (sig[i0] or visited[i0] or nbr[i0] or sig[i1] or visited[i1] or nbr[i1]
                            or sig[i2] or visited[i2] or nbr[i2] or sig[i3] or visited[i3]
                            or nbr[i3]):
                        if not decode(cx, CTX_RL):
                            continue
                        k = decode(cx, CTX_UNI) << 1
                        k |= decode(cx, CTX_UNI)
                        set_sig(rows[k] + x, p)
                        todo = rows[k + 1:]
                for r in todo:
                    i = r + x
                    if sig[i] or visited[i]:
                        continue
                    if decode(cx, zc[nbr[i]]):
                        set_sig(i, p)
        visited[:] = [0] * n

    p = first_plane
    kind = 2
    start = 0
    for npasses, length in segments:
        decode = PyMQDecoder(data[start:start + length]).decode
        start += length
        for _ in range(npasses):
            if p < 0:
                break
            if kind == 0:
                sig_pass(p)
            elif kind == 1:
                ref_pass(p)
            else:
                cln_pass(p)
            kind += 1
            if kind == 3:
                kind = 0
                p -= 1
    for y in range(h):
        out[y] = val[(y + 1) * W + 1:(y + 1) * W + 1 + w]
    return out
