"""JBIG2 (ITU-T T.88) decoder for the PDF embedded profile.

The reference decodes JBIG2Decode image streams through pdfium's JBig2
codec (reference: rapid_doc/utils/pdf_image_tools.py renders via
pypdfium2); scanned-document corpora — the OCR target market — use
JBIG2 heavily. This module implements the subset every PDF encoder in
the wild emits through `/JBIG2Decode` (jbig2enc, Acrobat, scanner
firmwares using arithmetic coding):

- segment headers + embedded-stream organization (7.2), incl. the
  separate `/JBIG2Globals` stream;
- page information (7.4.8) and region composition ops (OR/AND/XOR/
  XNOR/REPLACE);
- generic regions (6.2): arithmetic templates 0-3 with AT pixels and
  TPGDON, plus MMR regions through ``pdfio.ccitt``'s T.6 decoder, as the
  JAX package decodes them through PIL's libtiff (photometric from
  ``BlackIs1`` true, then ``< 128`` is foreground);
- symbol dictionaries (6.5) and text regions (6.4) in both arithmetic
  and Huffman coding (standard tables B.1-B.15, custom table segments,
  runcode symbol-ID codes, uncompressed/MMR collective bitmaps),
  refinement of text-region instances in both modes (6.3/6.4.11),
  refinement/aggregate symbol coding incl. REFAGGNINST>1 text-region
  aggregation (6.5.8.2) in both modes;
- pattern dictionaries (6.7) and halftone regions (6.6) incl.
  HENABLESKIP skip bitmaps;
- standalone generic refinement regions refining the page (7.4.7);
- integer (A.2) and symbol-ID (A.3) arithmetic decoding.

Port of ``rapiddoc_tpu/pdfio/jbig2.py``. The per-pixel loops (MQ
decoding, integer and symbol-ID decoding, generic and refinement
regions) and the T.6 decoder of MMR regions have two versions: the
Python mirror, kept as the plain version, and a compiled copy in
``csrc/bilevel.cu`` (host code, built by nvcc through ``ops/build.py``
and loaded with ctypes), the JAX package's ``native/hostops.cpp`` loops.
With a card present ``decode`` uses the compiled ones, with no fallback;
without one the plain ones (``ops.build.host_compiled``);
``decode(..., compiled=...)`` picks. The choice is made once per call and
handed down to every region decoder, so calls on two threads never see
each other's. ``decode(..., max_rows=n)`` gives the page's first n rows,
for holding the compiled loops against the plain ones on a band.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("rapiddoc_tpu_torch.pdfio.jbig2")

class Jbig2Error(Exception):
    pass


# --------------------------------------------------------------- MQ coder

# (Qe, NMPS, NLPS, SWITCH) — T.88 Table E.1
QE_TABLE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]

# Coding templates sans AT (T.88 6.2.5.3); AT pixels append then the
# whole list sorts by (y, x) — the spec layout under nominal AT, which
# the TPGDON pseudo-contexts below assume.
CODING_TEMPLATES = [
    [(-1, -2), (0, -2), (1, -2), (-2, -1), (-1, -1), (0, -1), (1, -1),
     (2, -1), (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
    [(-1, -2), (0, -2), (1, -2), (2, -2), (-2, -1), (-1, -1), (0, -1),
     (1, -1), (2, -1), (-3, 0), (-2, 0), (-1, 0)],
    [(-1, -2), (0, -2), (1, -2), (-2, -1), (-1, -1), (0, -1), (1, -1),
     (-2, 0), (-1, 0)],
    [(-3, -1), (-2, -1), (-1, -1), (0, -1), (1, -1), (-4, 0), (-3, 0),
     (-2, 0), (-1, 0)],
]
TPGDON_CTX = [0x9B25, 0x0795, 0x00E5, 0x0195]

REFINE_CODING = [
    [(0, -1), (1, -1), (-1, 0)],
    [(-1, -1), (0, -1), (1, -1), (-1, 0)],
]
REFINE_REFERENCE = [
    [(0, -1), (1, -1), (-1, 0), (0, 0), (1, 0), (-1, 1), (0, 1), (1, 1)],
    [(0, -1), (-1, 0), (0, 0), (1, 0), (0, 1), (1, 1)],
]
TPGRON_CTX = [0x0020, 0x0008]


def _sorted_template(template: int, at: list[tuple[int, int]]):
    pts = list(CODING_TEMPLATES[template]) + list(at)
    pts.sort(key=lambda p: (p[1], p[0]))
    return pts


class PyMQDecoder:
    """Software-conventions MQ decoder (T.88 E.3.2)."""

    def __init__(self, data: bytes):
        self.data = data
        self.bp = 0
        self.chigh = data[0] if data else 0xFF
        self.clow = 0
        self.ct = 0
        self._bytein()
        self.chigh = ((self.chigh << 7) & 0xFFFF) | ((self.clow >> 9) & 0x7F)
        self.clow = (self.clow << 7) & 0xFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        data, bp = self.data, self.bp
        if bp < len(data) and data[bp] == 0xFF:
            if bp + 1 >= len(data) or data[bp + 1] > 0x8F:
                self.clow += 0xFF00
                self.ct = 8
            else:
                self.bp = bp = bp + 1
                self.clow += data[bp] << 9
                self.ct = 7
        else:
            self.bp = bp = bp + 1
            self.clow += data[bp] << 8 if bp < len(data) else 0xFF00
            self.ct = 8
        if self.clow > 0xFFFF:
            self.chigh += self.clow >> 16
            self.clow &= 0xFFFF

    def decode(self, cx: np.ndarray, idx: int) -> int:
        state = int(cx[idx])
        icx = state >> 1
        mps = state & 1
        qe, nmps, nlps, switch = QE_TABLE[icx]
        self.a -= qe
        if self.chigh < qe:
            if self.a < qe:
                self.a = qe
                d = mps
                icx = nmps
            else:
                self.a = qe
                d = 1 ^ mps
                if switch:
                    mps = d
                icx = nlps
        else:
            self.chigh -= qe
            if self.a & 0x8000:
                return mps
            if self.a < qe:
                d = 1 ^ mps
                if switch:
                    mps = d
                icx = nlps
            else:
                d = mps
                icx = nmps
        while True:
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.chigh = ((self.chigh << 1) & 0xFFFF) | ((self.clow >> 15) & 1)
            self.clow = (self.clow << 1) & 0xFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        cx[idx] = (icx << 1) | mps
        return d


def _library():
    """``csrc/bilevel.cu`` built and loaded once, its C signatures
    declared."""
    from ..ops import build

    lib = build.load("bilevel")
    if lib.jbig2_mq_new.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name, res, args in (
                ("jbig2_mq_new", vp, [ctypes.c_char_p, i64]),
                ("jbig2_mq_free", None, [vp]),
                ("jbig2_mq_decode_bit", i32, [vp, vp, i64]),
                ("jbig2_decode_int", i32, [vp, vp, vp]),
                ("jbig2_decode_iaid", i32, [vp, vp, i32]),
                ("jbig2_generic_decode", None, [vp, vp, i32, i32, vp, vp, i32, i32]),
                ("jbig2_refine_decode", None,
                 [vp, vp, i32, i32, vp, vp, i32, i32, i32, i32, vp, i32, i32])):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
    return lib


class ArithDecoder:
    """One segment's arithmetic decoder: MQ state + typed helpers.

    Runs the compiled loops of ``csrc/bilevel.cu`` when `compiled`, the
    Python mirror otherwise."""

    def __init__(self, data: bytes, compiled: bool):
        self._native = None
        self._keep = data  # native side borrows the buffer
        if compiled:
            self._native = _library()
            self._h = self._native.jbig2_mq_new(data, len(data))
        if self._native is None:
            self._py = PyMQDecoder(data)

    def __del__(self):
        if getattr(self, "_native", None) is not None:
            self._native.jbig2_mq_free(self._h)

    def bit(self, cx: np.ndarray, idx: int) -> int:
        if self._native is not None:
            return self._native.jbig2_mq_decode_bit(
                self._h, cx.ctypes.data_as(ctypes.c_void_p), idx
            )
        return self._py.decode(cx, idx)

    def integer(self, cx: np.ndarray) -> int | None:
        """A.2 integer decoding; None = OOB."""
        if self._native is not None:
            out = ctypes.c_int32()
            ok = self._native.jbig2_decode_int(
                self._h, cx.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(out),
            )
            return int(out.value) if ok else None
        prev = 1

        def bit():
            nonlocal prev
            b = self._py.decode(cx, prev)
            prev = (
                (prev << 1) | b
                if prev < 256
                else ((((prev << 1) | b) & 511) | 256)
            )
            return b

        def bits(n):
            v = 0
            for _ in range(n):
                v = (v << 1) | bit()
            return v

        s = bit()
        if not bit():
            v = bits(2)
        elif not bit():
            v = bits(4) + 4
        elif not bit():
            v = bits(6) + 20
        elif not bit():
            v = bits(8) + 84
        elif not bit():
            v = bits(12) + 340
        else:
            v = bits(32) + 4436
        if s and v == 0:
            return None
        return -v if s else v

    def iaid(self, cx: np.ndarray, code_len: int) -> int:
        """A.3 symbol-ID decoding."""
        if self._native is not None:
            return self._native.jbig2_decode_iaid(
                self._h, cx.ctypes.data_as(ctypes.c_void_p), code_len
            )
        prev = 1
        for _ in range(code_len):
            prev = (prev << 1) | self._py.decode(cx, prev)
        return prev - (1 << code_len)

    def generic(
        self, cx: np.ndarray, template: int, tpgdon: bool,
        at: list[tuple[int, int]], w: int, h: int,
        skip: np.ndarray | None = None,
    ) -> np.ndarray:
        """6.2 generic bitmap decoding -> uint8 (h, w) of 0/1.

        `skip` (6.6.5.1 HSKIP): pixels where skip!=0 are not decoded
        and stay 0. Skip forces the Python path (grids are small)."""
        out = np.zeros((h, w), np.uint8)
        if w == 0 or h == 0:
            return out
        if self._native is not None and skip is None:
            at_full = list(at) + [(0, 0)] * (4 - len(at))
            at_arr = np.asarray(at_full, np.int32).reshape(-1)
            self._native.jbig2_generic_decode(
                self._h, cx.ctypes.data_as(ctypes.c_void_p), template,
                int(tpgdon), at_arr.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p), w, h,
            )
            return out
        # per-bit loop: self.bit() routes through whichever MQ state
        # (native handle or Python mirror) this decoder carries, so the
        # skip path stays in sync with native-decoded segments
        tpl = _sorted_template(template, at)
        ltp = 0
        for y in range(h):
            if tpgdon:
                ltp ^= self.bit(cx, TPGDON_CTX[template])
                if ltp:
                    if y > 0:
                        out[y] = out[y - 1]
                    continue
            for x in range(w):
                if skip is not None and skip[y, x]:
                    continue
                ctx = 0
                for dx, dy in tpl:
                    xx, yy = x + dx, y + dy
                    v = (
                        int(out[yy, xx])
                        if 0 <= xx < w and 0 <= yy < h
                        else 0
                    )
                    ctx = (ctx << 1) | v
                out[y, x] = self.bit(cx, ctx)
        return out

    def refine(
        self, cx: np.ndarray, template: int, tpgron: bool,
        at: list[tuple[int, int]], ref: np.ndarray, dx: int, dy: int,
        w: int, h: int,
    ) -> np.ndarray:
        """6.3 generic refinement decoding."""
        out = np.zeros((h, w), np.uint8)
        if w == 0 or h == 0:
            return out
        ref = np.ascontiguousarray(ref, np.uint8)
        rh, rw = ref.shape
        if self._native is not None:
            at_full = (list(at) + [(0, 0)] * 2)[:2]
            at_arr = np.asarray(at_full, np.int32).reshape(-1)
            self._native.jbig2_refine_decode(
                self._h, cx.ctypes.data_as(ctypes.c_void_p), template,
                int(tpgron), at_arr.ctypes.data_as(ctypes.c_void_p),
                ref.ctypes.data_as(ctypes.c_void_p), rw, rh, dx, dy,
                out.ctypes.data_as(ctypes.c_void_p), w, h,
            )
            return out
        coding = list(REFINE_CODING[template])
        reference = list(REFINE_REFERENCE[template])
        if template == 0:
            coding.append(tuple(at[0]))
            reference.append(tuple(at[1]))

        def rpx(x, y):
            return int(ref[y, x]) if 0 <= x < rw and 0 <= y < rh else 0

        ltp = 0
        for y in range(h):
            if tpgron:
                ltp ^= self._py.decode(cx, TPGRON_CTX[template])
            for x in range(w):
                rx, ry = x - dx, y - dy
                if ltp:
                    s = sum(
                        rpx(rx + xx, ry + yy)
                        for yy in (-1, 0, 1)
                        for xx in (-1, 0, 1)
                    )
                    if s == 0 or s == 9:
                        out[y, x] = 1 if s else 0
                        continue
                ctx = 0
                for cdx, cdy in coding:
                    xx, yy = x + cdx, y + cdy
                    v = (
                        int(out[yy, xx])
                        if 0 <= xx < w and 0 <= yy < h
                        else 0
                    )
                    ctx = (ctx << 1) | v
                for rdx, rdy in reference:
                    ctx = (ctx << 1) | rpx(rx + rdx, ry + rdy)
                out[y, x] = self._py.decode(cx, ctx)
        return out


def new_context(bits: int) -> np.ndarray:
    return np.zeros(1 << bits, np.uint8)


# ------------------------------------------------------------- segments


class Segment:
    __slots__ = ("number", "type", "referred", "page", "data")

    def __init__(self, number, type_, referred, page, data):
        self.number = number
        self.type = type_
        self.referred = referred
        self.page = page
        self.data = data


def parse_segments(buf: bytes) -> list[Segment]:
    """Embedded-stream segment sequence (T.88 7.2; no file header)."""
    out: list[Segment] = []
    pos = 0
    n = len(buf)
    while pos + 11 <= n:
        number, flags = struct.unpack_from(">IB", buf, pos)
        pos += 5
        seg_type = flags & 0x3F
        page_assoc_4 = bool(flags & 0x40)
        rts = buf[pos]
        if (rts >> 5) == 7:
            count = struct.unpack_from(">I", buf, pos)[0] & 0x1FFFFFFF
            pos += 4 + (count + 8) // 8  # retain bits
        else:
            count = rts >> 5
            pos += 1
        if number <= 256:
            ref_size = 1
        elif number <= 65536:
            ref_size = 2
        else:
            ref_size = 4
        referred = []
        for _ in range(count):
            if ref_size == 1:
                referred.append(buf[pos])
            elif ref_size == 2:
                referred.append(struct.unpack_from(">H", buf, pos)[0])
            else:
                referred.append(struct.unpack_from(">I", buf, pos)[0])
            pos += ref_size
        if page_assoc_4:
            page = struct.unpack_from(">I", buf, pos)[0]
            pos += 4
        else:
            page = buf[pos]
            pos += 1
        length = struct.unpack_from(">I", buf, pos)[0]
        pos += 4
        if length == 0xFFFFFFFF:
            raise Jbig2Error("unknown segment data length")
        data = buf[pos : pos + length]
        pos += length
        out.append(Segment(number, seg_type, referred, page, data))
    return out


def _region_info(data: bytes):
    w, h, x, y = struct.unpack_from(">IIII", data, 0)
    comb_op = data[16] & 7
    return w, h, x, y, comb_op, 17


def _read_at(data: bytes, pos: int, count: int):
    at = []
    for _ in range(count):
        ax = struct.unpack_from(">b", data, pos)[0]
        ay = struct.unpack_from(">b", data, pos + 1)[0]
        at.append((ax, ay))
        pos += 2
    return at, pos


def _compose(dst: np.ndarray, src: np.ndarray, x: int, y: int, op: int):
    """Region composition (T.88 Table 10 ops) with clipping."""
    h, w = src.shape
    H, W = dst.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x1 <= x0 or y1 <= y0:
        return
    s = src[y0 - y : y1 - y, x0 - x : x1 - x]
    d = dst[y0:y1, x0:x1]
    if op == 0:
        d |= s
    elif op == 1:
        d &= s
    elif op == 2:
        d ^= s
    elif op == 3:
        d[:] = 1 - (d ^ s)
    else:
        d[:] = s


# ------------------------------------------------------------ decoding


class SymbolDictionary:
    def __init__(self, symbols: list[np.ndarray]):
        self.symbols = symbols


def _pick_table(sel: int, std: list[int], customs: list, used: list[int]):
    """Huffman table selector: 0..len(std)-1 -> standard table id,
    3 -> next custom table from the referred table segments."""
    if sel == 3:
        idx = used[0]
        used[0] += 1
        if idx >= len(customs):
            raise Jbig2Error("missing custom Huffman table")
        return customs[idx]
    if sel >= len(std):
        raise Jbig2Error(f"bad Huffman table selector {sel}")
    return standard_table(std[sel])


def _decode_symbol_dict(
    seg: Segment, referred_dicts: list, referred_tables: list | None,
    compiled: bool,
) -> SymbolDictionary:
    data = seg.data
    flags = struct.unpack_from(">H", data, 0)[0]
    pos = 2
    sdhuff = flags & 1
    sdrefagg = (flags >> 1) & 1
    huff_dh_sel = (flags >> 2) & 3
    huff_dw_sel = (flags >> 4) & 3
    huff_bmsize_sel = (flags >> 6) & 1
    huff_agginst_sel = (flags >> 7) & 1
    ctx_used = (flags >> 8) & 1
    template = (flags >> 10) & 3
    rtemplate = (flags >> 12) & 1
    if ctx_used:
        raise Jbig2Error("retained contexts not supported")
    at: list[tuple[int, int]] = []
    if not sdhuff:
        at, pos = _read_at(data, pos, 4 if template == 0 else 1)
    rat: list[tuple[int, int]] = []
    if sdrefagg and rtemplate == 0:
        rat, pos = _read_at(data, pos, 2)
    num_ex, num_new = struct.unpack_from(">II", data, pos)
    pos += 8

    input_symbols: list[np.ndarray] = []
    for d in referred_dicts:
        input_symbols.extend(d.symbols)

    if sdhuff:
        used = [0]
        customs = referred_tables or []
        t_dh = _pick_table(huff_dh_sel, [4, 5], customs, used)
        t_dw = _pick_table(huff_dw_sel, [2, 3], customs, used)
        t_bmsize = (
            standard_table(1)
            if huff_bmsize_sel == 0
            else _pick_table(3, [], customs, used)
        )
        t_agg = (
            standard_table(1)
            if huff_agginst_sel == 0
            else _pick_table(3, [], customs, used)
        )
        t_ex = standard_table(1)
        if sdrefagg:
            return _decode_symbol_dict_huffman_refagg(
                data, pos, input_symbols, num_ex, num_new, t_dh, t_dw,
                t_agg, t_ex, rtemplate, rat, compiled,
            )
        br = BitReader(bytes(data[pos:]))
        new_symbols = []
        height = 0
        while len(new_symbols) < num_new:
            dh = t_dh.decode(br)
            if dh is None:
                raise Jbig2Error("unexpected OOB in DH")
            height += dh
            width = 0
            widths: list[int] = []
            while True:
                dw = t_dw.decode(br)
                if dw is None:
                    break
                width += dw
                widths.append(width)
                if len(new_symbols) + len(widths) > num_new:
                    raise Jbig2Error("too many symbols")
            # collective bitmap for the height class (6.5.9)
            bmsize = t_bmsize.decode(br)
            br.align()
            tot_w = sum(widths)
            start = pos + br.byte_pos()
            if bmsize == 0:  # uncompressed, byte-aligned rows
                stride = (tot_w + 7) // 8
                raw = bytes(data[start : start + stride * height])
                rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
                coll = np.unpackbits(rows, axis=1, count=tot_w)
                br.pos += stride * height * 8
            else:
                coll = _mmr_decode(
                    bytes(data[start : start + bmsize]), tot_w, height,
                    compiled,
                )
                br.pos += bmsize * 8
            x0 = 0
            for sw in widths:
                new_symbols.append(
                    np.ascontiguousarray(coll[:, x0 : x0 + sw])
                )
                x0 += sw

        all_syms = input_symbols + new_symbols
        exported: list[np.ndarray] = []
        ex_flag = False
        i = 0
        while i < len(all_syms):
            run = t_ex.decode(br)
            if run is None:
                raise Jbig2Error("unexpected OOB in EX")
            if ex_flag:
                exported.extend(all_syms[i : i + run])
            i += run
            ex_flag = not ex_flag
        if len(exported) != num_ex:
            logger.warning(
                "jbig2: exported %d symbols, header says %d",
                len(exported), num_ex,
            )
        return SymbolDictionary(exported)

    dec = ArithDecoder(bytes(data[pos:]), compiled)
    iadh = new_context(9)
    iadw = new_context(9)
    iaex = new_context(9)
    iaai = new_context(9)
    iardx = new_context(9)
    iardy = new_context(9)
    gb_cx = new_context(16)
    gr_cx = new_context(13)
    total = len(input_symbols) + num_new
    code_len = max(1, (max(total - 1, 1)).bit_length())
    if total <= 1:
        code_len = 1
    iaid_cx = new_context(code_len + 1)
    # 6.5.8.2.1: aggregate text regions share these contexts across all
    # symbols of the dictionary
    iadt = new_context(9)
    iafs = new_context(9)
    iads = new_context(9)
    iait = new_context(9)
    iari = new_context(9)
    iardw = new_context(9)
    iardh = new_context(9)

    new_symbols: list[np.ndarray] = []

    def _aggregate(n_inst: int, width: int, height: int) -> np.ndarray:
        """6.5.8.2 REFAGGNINST>1: the symbol bitmap is a text region of
        n_inst refined instances over the symbols decoded so far."""
        pool = input_symbols + new_symbols

        def maybe_refine(sym):
            if not dec.integer(iari):
                return sym
            rdw = dec.integer(iardw)
            rdh = dec.integer(iardh)
            rdx = dec.integer(iardx)
            rdy = dec.integer(iardy)
            return dec.refine(
                gr_cx, rtemplate, False, rat, sym,
                (rdw >> 1) + rdx, (rdh >> 1) + rdy,
                sym.shape[1] + rdw, sym.shape[0] + rdh,
            )

        return _run_text_region(
            pool, width, height, 0, n_inst, 1, 1, 0, 0, 0,
            lambda: dec.integer(iadt), lambda: dec.integer(iafs),
            lambda: dec.integer(iads), lambda: dec.integer(iait),
            lambda: dec.iaid(iaid_cx, code_len), maybe_refine,
        )

    height = 0
    while len(new_symbols) < num_new:
        dh = dec.integer(iadh)
        if dh is None:
            raise Jbig2Error("unexpected OOB in IADH")
        height += dh
        width = 0
        while True:
            dw = dec.integer(iadw)
            if dw is None:
                break  # end of height class
            width += dw
            if len(new_symbols) >= num_new:
                raise Jbig2Error("too many symbols")
            if not sdrefagg:
                bmp = dec.generic(gb_cx, template, False, at, width, height)
            else:
                n_inst = dec.integer(iaai)
                if n_inst == 1:
                    sym_id = dec.iaid(iaid_cx, code_len)
                    rdx = dec.integer(iardx)
                    rdy = dec.integer(iardy)
                    pool = input_symbols + new_symbols
                    ref = pool[sym_id]
                    bmp = dec.refine(
                        gr_cx, rtemplate, False, rat, ref, rdx, rdy,
                        width, height,
                    )
                else:
                    bmp = _aggregate(n_inst, width, height)
            new_symbols.append(bmp)

    # export flags (6.5.10)
    all_syms = input_symbols + new_symbols
    exported = []
    ex_flag = False
    i = 0
    while i < len(all_syms):
        run = dec.integer(iaex)
        if run is None:
            raise Jbig2Error("unexpected OOB in IAEX")
        if ex_flag:
            exported.extend(all_syms[i : i + run])
        i += run
        ex_flag = not ex_flag
    if len(exported) != num_ex:
        logger.warning(
            "jbig2: exported %d symbols, header says %d",
            len(exported), num_ex,
        )
    return SymbolDictionary(exported)


def _decode_symbol_dict_huffman_refagg(
    data: bytes, pos: int, input_symbols: list[np.ndarray], num_ex: int,
    num_new: int, t_dh, t_dw, t_agg, t_ex, rtemplate: int,
    rat: list[tuple[int, int]], compiled: bool,
) -> "SymbolDictionary":
    """6.5.8.2 with SDHUFF=1: each symbol decodes individually (no
    collective bitmap) — a single arithmetic refinement when
    REFAGGNINST is 1, else a Huffman text region over the symbols so
    far. Refinement data is byte-aligned and arithmetic (6.4.11)."""
    body = bytes(data[pos:])
    br = BitReader(body)
    t_rdx = standard_table(15)
    t_rdy = standard_table(15)
    t_rsize = standard_table(1)
    gr_cx = new_context(13)
    total = len(input_symbols) + num_new
    code_len = max(1, (max(total - 1, 1)).bit_length())
    if total <= 1:
        code_len = 1
    new_symbols: list[np.ndarray] = []

    def _arith_refine(ref, rdx, rdy, width, height):
        bmsize = t_rsize.decode(br)
        if not bmsize:
            raise Jbig2Error("refagg: zero-size refinement bitmap")
        br.align()
        start = br.byte_pos()
        rdec = ArithDecoder(body[start : start + bmsize], compiled)
        out = rdec.refine(
            gr_cx, rtemplate, False, rat, ref, rdx, rdy, width, height
        )
        br.pos = (start + bmsize) * 8
        return out

    height = 0
    while len(new_symbols) < num_new:
        dh = t_dh.decode(br)
        if dh is None:
            raise Jbig2Error("unexpected OOB in DH")
        height += dh
        width = 0
        while True:
            dw = t_dw.decode(br)
            if dw is None:
                break
            width += dw
            if len(new_symbols) >= num_new:
                raise Jbig2Error("too many symbols")
            n_inst = t_agg.decode(br)
            pool = input_symbols + new_symbols
            if n_inst == 1:
                sym_id = br.bits(code_len)
                rdx = t_rdx.decode(br)
                rdy = t_rdy.decode(br)
                bmp = _arith_refine(
                    pool[sym_id], rdx, rdy, width, height
                )
            else:
                # text region parameters per 6.5.8.2 (fixed tables)
                t_fs = standard_table(6)
                t_ds = standard_table(8)
                t_dt = standard_table(11)
                t_rdwh = standard_table(15)

                def maybe_refine(sym):
                    if not br.bit():
                        return sym
                    rdw = t_rdwh.decode(br)
                    rdh = t_rdwh.decode(br)
                    rdx = t_rdx.decode(br)
                    rdy = t_rdy.decode(br)
                    return _arith_refine(
                        sym, (rdw >> 1) + rdx, (rdh >> 1) + rdy,
                        sym.shape[1] + rdw, sym.shape[0] + rdh,
                    )

                bmp = _run_text_region(
                    pool, width, height, 0, n_inst, 1, 1, 0, 0, 0,
                    lambda: t_dt.decode(br), lambda: t_fs.decode(br),
                    lambda: t_ds.decode(br), lambda: 0,
                    lambda: br.bits(code_len), maybe_refine,
                )
            new_symbols.append(bmp)

    all_syms = input_symbols + new_symbols
    exported: list[np.ndarray] = []
    ex_flag = False
    i = 0
    while i < len(all_syms):
        run = t_ex.decode(br)
        if run is None:
            raise Jbig2Error("unexpected OOB in EX")
        if ex_flag:
            exported.extend(all_syms[i : i + run])
        i += run
        ex_flag = not ex_flag
    if len(exported) != num_ex:
        logger.warning(
            "jbig2: exported %d symbols, header says %d",
            len(exported), num_ex,
        )
    return SymbolDictionary(exported)


def _run_text_region(
    symbols: list[np.ndarray], w: int, h: int, def_pixel: int,
    num_instances: int, strips: int, ref_corner: int, transposed: int,
    comb_op: int, ds_offset: int, read_dt, read_fs, read_ds, read_it,
    read_id, maybe_refine,
) -> np.ndarray:
    """6.4.5 text-region instance placement loop, reader-agnostic.

    The readers come from either a Huffman BitReader or an arithmetic
    decoder; the symbol-dictionary aggregate path (6.5.8.2) reuses this
    with its own shared contexts."""
    bitmap = np.full((h, w), def_pixel, np.uint8)
    dt = read_dt()
    strip_t = -dt * strips
    first_s = 0
    inst = 0
    while inst < num_instances:
        dt = read_dt()
        strip_t += dt * strips
        dfs = read_fs()
        first_s += dfs
        cur_s = first_s
        first = True
        while True:
            if not first:
                ids = read_ds()
                if ids is None:
                    break
                cur_s += ids + ds_offset
            first = False
            if inst >= num_instances:
                break
            cur_t = 0 if strips == 1 else read_it()
            t = strip_t + cur_t
            sym_id = read_id()
            sym = maybe_refine(symbols[sym_id])
            sh, sw = sym.shape
            if not transposed:
                if ref_corner in (2, 3):  # right corners advance first
                    cur_s += sw - 1
                x0 = cur_s - (sw - 1) if ref_corner in (2, 3) else cur_s
                y0 = t if ref_corner in (1, 3) else t - sh + 1
                _compose(bitmap, sym, x0, y0, comb_op)
                if ref_corner in (0, 1):
                    cur_s += sw - 1
            else:
                if ref_corner in (0, 2):  # bottom corners advance first
                    cur_s += sh - 1
                y0 = cur_s - (sh - 1) if ref_corner in (0, 2) else cur_s
                x0 = t if ref_corner in (0, 1) else t - sw + 1
                _compose(bitmap, sym, x0, y0, comb_op)
                if ref_corner in (1, 3):
                    cur_s += sh - 1
            inst += 1
    return bitmap


def _decode_text_region(
    seg: Segment, symbols: list[np.ndarray], referred_tables: list | None,
    compiled: bool,
):
    data = seg.data
    w, h, x, y, ext_op, pos = _region_info(data)
    flags = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    sbhuff = flags & 1
    refine = (flags >> 1) & 1
    log_strips = (flags >> 2) & 3
    strips = 1 << log_strips
    ref_corner = (flags >> 4) & 3  # 0 BL, 1 TL, 2 BR, 3 TR
    transposed = (flags >> 6) & 1
    comb_op = (flags >> 7) & 3
    def_pixel = (flags >> 9) & 1
    ds_offset = (flags >> 10) & 0x1F
    if ds_offset > 15:
        ds_offset -= 32
    rtemplate = (flags >> 15) & 1
    huff_tables = None
    if sbhuff:
        hflags = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        used = [0]
        customs = referred_tables or []
        huff_tables = {
            "fs": _pick_table(hflags & 3, [6, 7], customs, used),
            "ds": _pick_table((hflags >> 2) & 3, [8, 9, 10], customs, used),
            "dt": _pick_table((hflags >> 4) & 3, [11, 12, 13], customs,
                              used),
        }
        if refine:
            # 7.4.3.1.2 selectors for the refinement size/offset fields
            huff_tables["rdw"] = _pick_table(
                (hflags >> 6) & 3, [14, 15], customs, used)
            huff_tables["rdh"] = _pick_table(
                (hflags >> 8) & 3, [14, 15], customs, used)
            huff_tables["rdx"] = _pick_table(
                (hflags >> 10) & 3, [14, 15], customs, used)
            huff_tables["rdy"] = _pick_table(
                (hflags >> 12) & 3, [14, 15], customs, used)
            huff_tables["rsize"] = (
                standard_table(1)
                if ((hflags >> 14) & 1) == 0
                else _pick_table(3, [], customs, used)
            )
    rat: list[tuple[int, int]] = []
    if refine and rtemplate == 0:
        rat, pos = _read_at(data, pos, 2)
    num_instances = struct.unpack_from(">I", data, pos)[0]
    pos += 4

    n_syms = len(symbols)
    if n_syms == 0:
        raise Jbig2Error("text region without symbols")
    code_len = max(1, (max(n_syms - 1, 1)).bit_length())
    if n_syms <= 1:
        code_len = 1

    if sbhuff:
        body = bytes(data[pos:])
        br = BitReader(body)
        sym_table = decode_symbol_id_codes(br, n_syms)
        br.align()
        read_dt = lambda: huff_tables["dt"].decode(br)  # noqa: E731
        read_fs = lambda: huff_tables["fs"].decode(br)  # noqa: E731
        read_ds = lambda: huff_tables["ds"].decode(br)  # noqa: E731
        read_it = lambda: br.bits(log_strips)  # noqa: E731
        read_id = lambda: sym_table.decode(br)  # noqa: E731
        if refine:
            gr_cx = new_context(13)

            def maybe_refine(sym):
                if not br.bit():  # RI (6.4.11: one bit when SBHUFF)
                    return sym
                rdw = huff_tables["rdw"].decode(br)
                rdh = huff_tables["rdh"].decode(br)
                rdx = huff_tables["rdx"].decode(br)
                rdy = huff_tables["rdy"].decode(br)
                bmsize = huff_tables["rsize"].decode(br)
                br.align()
                start = br.byte_pos()
                rdec = ArithDecoder(body[start : start + bmsize], compiled)
                out = rdec.refine(
                    gr_cx, rtemplate, False, rat, sym,
                    (rdw >> 1) + rdx, (rdh >> 1) + rdy,
                    sym.shape[1] + rdw, sym.shape[0] + rdh,
                )
                br.pos = (start + bmsize) * 8
                return out
        else:
            maybe_refine = lambda sym: sym  # noqa: E731
    else:
        dec = ArithDecoder(bytes(data[pos:]), compiled)
        iadt = new_context(9)
        iafs = new_context(9)
        iads = new_context(9)
        iait = new_context(9)
        iari = new_context(9)
        iardw = new_context(9)
        iardh = new_context(9)
        iardx = new_context(9)
        iardy = new_context(9)
        iaid_cx = new_context(code_len + 1)
        gr_cx = new_context(13)
        read_dt = lambda: dec.integer(iadt)  # noqa: E731
        read_fs = lambda: dec.integer(iafs)  # noqa: E731
        read_ds = lambda: dec.integer(iads)  # noqa: E731
        read_it = lambda: dec.integer(iait)  # noqa: E731
        read_id = lambda: dec.iaid(iaid_cx, code_len)  # noqa: E731
        if refine:

            def maybe_refine(sym):
                if not dec.integer(iari):
                    return sym
                rdw = dec.integer(iardw)
                rdh = dec.integer(iardh)
                rdx = dec.integer(iardx)
                rdy = dec.integer(iardy)
                return dec.refine(
                    gr_cx, rtemplate, False, rat, sym,
                    (rdw >> 1) + rdx, (rdh >> 1) + rdy,
                    sym.shape[1] + rdw, sym.shape[0] + rdh,
                )
        else:
            maybe_refine = lambda sym: sym  # noqa: E731

    bitmap = _run_text_region(
        symbols, w, h, def_pixel, num_instances, strips, ref_corner,
        transposed, comb_op, ds_offset, read_dt, read_fs, read_ds,
        read_it, read_id, maybe_refine,
    )
    return bitmap, x, y, ext_op


def _decode_pattern_dict(seg: Segment, compiled: bool) -> list[np.ndarray]:
    """Pattern dictionary (6.7): one collective generic bitmap sliced
    into GRAYMAX+1 patterns of HDPW x HDPH."""
    data = seg.data
    flags = data[0]
    hdmmr = flags & 1
    template = (flags >> 1) & 3
    hdpw = data[1]
    hdph = data[2]
    graymax = struct.unpack_from(">I", data, 3)[0]
    pos = 7
    tot_w = (graymax + 1) * hdpw
    if hdmmr:
        coll = _mmr_decode(bytes(data[pos:]), tot_w, hdph, compiled)
    else:
        at = [(-hdpw, 0), (-3, -1), (2, -2), (-2, -2)]
        if template != 0:
            at = at[:1]
        dec = ArithDecoder(bytes(data[pos:]), compiled)
        coll = dec.generic(new_context(16), template, False, at, tot_w,
                           hdph)
    return [
        np.ascontiguousarray(coll[:, i * hdpw : (i + 1) * hdpw])
        for i in range(graymax + 1)
    ]


def _decode_halftone_region(seg: Segment, patterns: list[np.ndarray],
                            compiled: bool):
    """Halftone region (6.6): gray-coded bitplanes index the pattern
    dictionary onto the halftone grid."""
    data = seg.data
    w, h, x, y, ext_op, pos = _region_info(data)
    flags = data[pos]
    pos += 1
    hmmr = flags & 1
    template = (flags >> 1) & 3
    enable_skip = (flags >> 3) & 1
    comb_op = (flags >> 4) & 7
    def_pixel = (flags >> 7) & 1
    if not patterns:
        raise Jbig2Error("halftone region without pattern dictionary")
    hgw, hgh = struct.unpack_from(">II", data, pos)
    hgx, hgy = struct.unpack_from(">ii", data, pos + 8)
    hrx, hry = struct.unpack_from(">HH", data, pos + 16)
    pos += 20

    n_pats = len(patterns)
    ph, pw = patterns[0].shape
    skip = None
    if enable_skip and not hmmr:  # HSKIP (6.6.5.1); MMR has no skip
        skip = np.zeros((hgh, hgw), np.uint8)
        for mg in range(hgh):
            for ng in range(hgw):
                px = (hgx + mg * hry + ng * hrx) >> 8
                py = (hgy + mg * hrx - ng * hry) >> 8
                if px + pw <= 0 or px >= w or py + ph <= 0 or py >= h:
                    skip[mg, ng] = 1
    bits = max(1, (n_pats - 1).bit_length()) if n_pats > 1 else 1
    planes: list[np.ndarray] = []
    if hmmr:
        # all bitplanes in one MMR stream, stacked vertically
        stack = _mmr_decode(bytes(data[pos:]), hgw, hgh * bits, compiled)
        planes = [
            stack[i * hgh : (i + 1) * hgh] for i in range(bits)
        ]
    else:
        at = [(template <= 1 and 3 or 2, -1), (-3, -1), (2, -2),
              (-2, -2)]
        if template != 0:
            at = at[:1]
        dec = ArithDecoder(bytes(data[pos:]), compiled)
        cx = new_context(16)  # shared stats across planes (C.5)
        for _ in range(bits):
            planes.append(
                dec.generic(cx, template, False, at, hgw, hgh, skip=skip)
            )
    # gray decode, MSB plane first (C.5)
    value = planes[0].astype(np.int32)
    prev = planes[0]
    for plane in planes[1:]:
        bit = plane ^ prev
        value = (value << 1) | bit
        prev = bit
    value = np.clip(value, 0, n_pats - 1)

    bitmap = np.full((h, w), def_pixel, np.uint8)
    for mg in range(hgh):
        for ng in range(hgw):
            px = (hgx + mg * hry + ng * hrx) >> 8
            py = (hgy + mg * hrx - ng * hry) >> 8
            _compose(
                bitmap, patterns[int(value[mg, ng])], px, py, comb_op
            )
    return bitmap, x, y, ext_op


def _decode_refinement_region(seg: Segment, page: np.ndarray | None,
                              compiled: bool):
    """Generic refinement region (7.4.7): refines the page buffer in
    place (the embedded profile never routes through intermediate
    region buffers — 8.2 step 6 c)."""
    data = seg.data
    w, h, x, y, ext_op, pos = _region_info(data)
    flags = data[pos]
    pos += 1
    template = flags & 1
    tpgron = (flags >> 1) & 1
    at: list[tuple[int, int]] = []
    if template == 0:
        at, pos = _read_at(data, pos, 2)
    if page is None:
        raise Jbig2Error("refinement region before page info")
    ref = np.zeros((h, w), np.uint8)
    y1, x1 = min(y + h, page.shape[0]), min(x + w, page.shape[1])
    if y1 > y and x1 > x:
        ref[: y1 - y, : x1 - x] = page[y:y1, x:x1]
    dec = ArithDecoder(bytes(data[pos:]), compiled)
    bmp = dec.refine(
        new_context(13), template, bool(tpgron), at, ref, 0, 0, w, h
    )
    return bmp, x, y, ext_op


def _rows_above(h: int, y: int, max_rows: int | None) -> int:
    """The rows of a region at page row `y` that lie above page row
    `max_rows` (all `h` when None): the region's decode stops there, and
    its first rows are exact, since each row depends on the rows above."""
    return h if max_rows is None else max(0, min(h, max_rows - y))


def _decode_generic_region(seg: Segment, compiled: bool,
                           max_rows: int | None):
    """Generic region (7.4.6); stops at page row `max_rows`."""
    data = seg.data
    w, h, x, y, ext_op, pos = _region_info(data)
    rows = _rows_above(h, y, max_rows)
    flags = data[pos]
    pos += 1
    mmr = flags & 1
    template = (flags >> 1) & 3
    tpgdon = (flags >> 3) & 1
    if mmr and rows == 0 < h:  # below max_rows: nothing to decode
        bmp = np.zeros((0, w), np.uint8)
    elif mmr:
        bmp = _mmr_decode(bytes(data[pos:]), w, rows, compiled)
    else:
        at, pos = _read_at(data, pos, 4 if template == 0 else 1)
        dec = ArithDecoder(bytes(data[pos:]), compiled)
        bmp = dec.generic(new_context(16), template, bool(tpgdon), at, w, rows)
    return bmp, x, y, ext_op


def _mmr_decode(data: bytes, w: int, h: int, compiled: bool) -> np.ndarray:
    """MMR (T.6/G4) generic region as the JAX package reads it through
    PIL's libtiff with ``BlackIs1`` true: foreground where the L image is
    below 128, i.e. where a run was coded white."""
    from . import ccitt

    if w <= 0 or h <= 0 or not data:
        raise Jbig2Error("empty MMR region")
    if compiled:
        bits, _ = ccitt.decode_bits_compiled(data, w, h, -1)
    else:
        bits, _ = ccitt.decode_bits_plain(data, w, h, -1)
    return (ccitt.to_l(bits, True) < 128).astype(np.uint8)


def decode(data: bytes, globals_data: bytes | None = None,
           width: int | None = None, height: int | None = None,
           compiled: bool | None = None,
           max_rows: int | None = None) -> np.ndarray:
    """PDF JBIG2Decode stream -> uint8 (H, W) bitmap, 1 = black.

    `globals_data` is the optional /JBIG2Globals stream. width/height
    from the image dict bound the page when the page info segment
    carries an unknown height. `compiled` picks the loops: the compiled
    ones of ``csrc/bilevel.cu`` or the plain ones (None:
    ``ops.build.host_compiled()``). `max_rows` keeps the page's first
    rows only: generic regions stop decoding there, the other regions are
    decoded whole and clipped (all of them where a refinement region
    follows, since it reads the page below its own rows).
    """
    if compiled is None:
        from ..ops import build

        compiled = build.host_compiled()
    page = _decode(data, globals_data, width, height, bool(compiled), max_rows)
    return page if max_rows is None else page[:max_rows]


def _decode(data: bytes, globals_data: bytes | None, width: int | None,
            height: int | None, compiled: bool,
            max_rows: int | None) -> np.ndarray:
    segments: list[Segment] = []
    if globals_data:
        segments.extend(parse_segments(globals_data))
    segments.extend(parse_segments(data))
    if any(seg.type in (40, 42, 43) for seg in segments):
        max_rows = None  # a refinement region reads the rows below its own

    dicts: dict[int, SymbolDictionary] = {}
    tables: dict[int, HuffmanTable] = {}
    pattern_dicts: dict[int, list[np.ndarray]] = {}
    page: np.ndarray | None = None
    page_default = 0

    def ensure_page(min_h: int, min_w: int):
        nonlocal page
        if page is None:
            ph = height or min_h
            pw = width or min_w
            page = np.full(
                (max(ph, min_h), max(pw, min_w)), page_default, np.uint8
            )
        elif page.shape[0] < min_h or page.shape[1] < min_w:
            grown = np.full(
                (max(page.shape[0], min_h), max(page.shape[1], min_w)),
                page_default, np.uint8,
            )
            grown[: page.shape[0], : page.shape[1]] = page
            page = grown

    for seg in segments:
        if seg.type == 48:  # page info
            pw, ph = struct.unpack_from(">II", seg.data, 0)
            flags = seg.data[16]
            page_default = (flags >> 2) & 1
            if ph == 0xFFFFFFFF:
                ph = height or 0
            page = np.full(
                (ph or (height or 1), pw or (width or 1)),
                page_default, np.uint8,
            )
        elif seg.type == 0:  # symbol dictionary
            refs = [dicts[r] for r in seg.referred if r in dicts]
            seg_tables = [tables[r] for r in seg.referred if r in tables]
            dicts[seg.number] = _decode_symbol_dict(seg, refs, seg_tables, compiled)
        elif seg.type in (4, 6, 7):  # text region
            symbols: list[np.ndarray] = []
            for r in seg.referred:
                if r in dicts:
                    symbols.extend(dicts[r].symbols)
            seg_tables = [tables[r] for r in seg.referred if r in tables]
            bmp, x, y, op = _decode_text_region(seg, symbols, seg_tables, compiled)
            ensure_page(y + bmp.shape[0], x + bmp.shape[1])
            _compose(page, bmp, x, y, op)
        elif seg.type in (36, 38, 39):  # generic region
            bmp, x, y, op = _decode_generic_region(seg, compiled, max_rows)
            ensure_page(y + bmp.shape[0], x + bmp.shape[1])
            _compose(page, bmp, x, y, op)
        elif seg.type == 16:  # pattern dictionary
            pattern_dicts[seg.number] = _decode_pattern_dict(seg, compiled)
        elif seg.type in (20, 22, 23):  # halftone region
            pats: list[np.ndarray] = []
            for r in seg.referred:
                if r in pattern_dicts:
                    pats.extend(pattern_dicts[r])
            bmp, x, y, op = _decode_halftone_region(seg, pats, compiled)
            ensure_page(y + bmp.shape[0], x + bmp.shape[1])
            _compose(page, bmp, x, y, op)
        elif seg.type in (40, 42, 43):  # generic refinement region
            bmp, x, y, op = _decode_refinement_region(seg, page, compiled)
            ensure_page(y + bmp.shape[0], x + bmp.shape[1])
            _compose(page, bmp, x, y, op)
        elif seg.type == 53:  # custom code table
            tables[seg.number] = parse_table_segment(bytes(seg.data))
        elif seg.type in (49, 50, 51, 62):  # end-of-*, extension
            continue
        else:
            logger.warning("jbig2: skipping segment type %d", seg.type)

    if page is None:
        raise Jbig2Error("no page produced")
    if height and page.shape[0] != height or width and page.shape[1] != width:
        out = np.zeros(
            (height or page.shape[0], width or page.shape[1]), np.uint8
        )
        h0 = min(out.shape[0], page.shape[0])
        w0 = min(out.shape[1], page.shape[1])
        out[:h0, :w0] = page[:h0, :w0]
        page = out
    return page


# ------------------------------------------------------- Huffman (B.*)


class BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def bit(self) -> int:
        byte = self.pos >> 3
        if byte >= len(self.data):
            raise Jbig2Error("huffman: out of data")
        b = (self.data[byte] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return (self.pos + 7) >> 3


class HuffmanTable:
    """Prefix-code table per T.88 B.3 code assignment.

    lines: (prefix_len, range_len, range_low, kind) where kind is
    'normal' | 'lower' | 'upper' | 'oob'. range_len 32 on lower/upper.
    """

    def __init__(self, lines):
        coded = [ln for ln in lines if ln[0] > 0]
        max_len = max((ln[0] for ln in coded), default=0)
        count = [0] * (max_len + 1)
        for ln in coded:
            count[ln[0]] += 1
        next_code = [0] * (max_len + 1)
        code = 0
        for length in range(1, max_len + 1):
            code = (code + count[length - 1]) << 1 if length > 1 else 0
            next_code[length] = code
        # assign codes in table order within each length (B.3)
        self.codes = {}  # (length, code) -> line
        for ln in lines:
            plen = ln[0]
            if plen == 0:
                continue
            c = next_code[plen]
            next_code[plen] += 1
            self.codes[(plen, c)] = ln

    def decode(self, br: BitReader):
        """-> int value or None (OOB)."""
        length = 0
        code = 0
        while length <= 32:
            code = (code << 1) | br.bit()
            length += 1
            ln = self.codes.get((length, code))
            if ln is None:
                continue
            plen, rlen, rlow, kind = ln
            if kind == "oob":
                return None
            if kind == "lower":
                return rlow - br.bits(32)
            v = br.bits(rlen) if rlen else 0
            return rlow + v
        raise Jbig2Error("huffman: no code matched")


def _std_lines(spec, oob_len=None):
    lines = []
    for entry in spec:
        if len(entry) == 4:
            lines.append(entry)
        else:
            lines.append((entry[0], entry[1], entry[2], "normal"))
    if oob_len:
        lines.append((oob_len, 0, 0, "oob"))
    return lines


# T.88 Annex B standard tables. Entries: (prefix len, range len, low).
STANDARD_TABLES = {
    1: _std_lines([(1, 4, 0), (2, 8, 16), (3, 16, 272),
                   (3, 32, 65808, "upper")]),
    2: _std_lines([(1, 0, 0), (2, 0, 1), (3, 0, 2), (4, 3, 3),
                   (5, 6, 11), (6, 32, 75, "upper")], oob_len=6),
    3: _std_lines([(8, 8, -256), (1, 0, 0), (2, 0, 1), (3, 0, 2),
                   (4, 3, 3), (5, 6, 11), (8, 32, -257, "lower"),
                   (7, 32, 75, "upper")], oob_len=6),
    4: _std_lines([(1, 0, 1), (2, 0, 2), (3, 0, 3), (4, 3, 4),
                   (5, 6, 12), (5, 32, 76, "upper")]),
    5: _std_lines([(7, 8, -255), (1, 0, 1), (2, 0, 2), (3, 0, 3),
                   (4, 3, 4), (5, 6, 12), (7, 32, -256, "lower"),
                   (6, 32, 76, "upper")]),
    6: _std_lines([(5, 10, -2048), (4, 9, -1024), (4, 8, -512),
                   (4, 7, -256), (5, 6, -128), (5, 5, -64), (4, 5, -32),
                   (2, 7, 0), (3, 7, 128), (3, 8, 256), (4, 9, 512),
                   (4, 10, 1024), (6, 32, -2049, "lower"),
                   (6, 32, 2048, "upper")]),
    7: _std_lines([(4, 9, -1024), (3, 8, -512), (4, 7, -256),
                   (5, 6, -128), (5, 5, -64), (4, 5, -32), (4, 5, 0),
                   (5, 5, 32), (5, 6, 64), (4, 7, 128), (3, 8, 256),
                   (3, 9, 512), (3, 10, 1024), (5, 32, -1025, "lower"),
                   (5, 32, 2048, "upper")]),
    8: _std_lines([(8, 3, -15), (9, 1, -7), (8, 1, -5), (9, 0, -3),
                   (7, 0, -2), (4, 0, -1), (2, 1, 0), (5, 0, 2),
                   (6, 0, 3), (3, 4, 4), (6, 1, 20), (4, 4, 22),
                   (4, 5, 38), (5, 6, 70), (5, 7, 134), (6, 7, 262),
                   (7, 8, 390), (6, 10, 646), (9, 32, -16, "lower"),
                   (9, 32, 1670, "upper")], oob_len=2),
    9: _std_lines([(8, 4, -31), (9, 2, -15), (8, 2, -11), (9, 1, -7),
                   (7, 1, -5), (4, 1, -3), (3, 1, -1), (3, 1, 1),
                   (5, 1, 3), (6, 1, 5), (3, 5, 7), (6, 2, 39),
                   (4, 5, 43), (4, 6, 75), (5, 7, 139), (5, 8, 267),
                   (6, 8, 523), (7, 9, 779), (6, 11, 1291),
                   (9, 32, -32, "lower"), (9, 32, 3339, "upper")],
                  oob_len=2),
    10: _std_lines([(7, 4, -21), (8, 0, -5), (7, 0, -4), (5, 0, -3),
                    (2, 2, -2), (5, 0, 2), (6, 0, 3), (7, 0, 4),
                    (8, 0, 5), (2, 6, 6), (5, 5, 70), (6, 5, 102),
                    (6, 6, 134), (6, 7, 198), (6, 8, 326), (6, 9, 582),
                    (6, 10, 1094), (7, 11, 2118),
                    (8, 32, -22, "lower"), (8, 32, 4166, "upper")],
                   oob_len=2),
    11: _std_lines([(1, 0, 1), (2, 1, 2), (4, 0, 4), (4, 1, 5),
                    (5, 1, 7), (5, 2, 9), (6, 2, 13), (7, 2, 17),
                    (7, 3, 21), (7, 4, 29), (7, 5, 45), (7, 6, 77),
                    (7, 32, 141, "upper")]),
    12: _std_lines([(1, 0, 1), (2, 0, 2), (3, 1, 3), (5, 0, 5),
                    (5, 1, 6), (6, 1, 8), (7, 0, 10), (7, 1, 11),
                    (7, 2, 13), (7, 3, 17), (7, 4, 25), (8, 5, 41),
                    (8, 32, 73, "upper")]),
    13: _std_lines([(1, 0, 1), (3, 0, 2), (4, 0, 3), (5, 0, 4),
                    (4, 1, 5), (3, 3, 7), (6, 1, 15), (6, 2, 17),
                    (6, 3, 21), (6, 4, 29), (6, 5, 45), (7, 6, 77),
                    (7, 32, 141, "upper")]),
    14: _std_lines([(3, 0, -2), (3, 0, -1), (1, 0, 0), (3, 0, 1),
                    (3, 0, 2)]),
    15: _std_lines([(7, 4, -24), (6, 2, -8), (5, 1, -4), (4, 0, -2),
                    (3, 0, -1), (1, 0, 0), (3, 0, 1), (4, 0, 2),
                    (5, 1, 3), (6, 2, 5), (7, 4, 9),
                    (7, 32, -25, "lower"), (7, 32, 25, "upper")]),
}


def standard_table(n: int) -> HuffmanTable:
    return HuffmanTable(STANDARD_TABLES[n])


def parse_table_segment(data: bytes) -> HuffmanTable:
    """Custom code table segment (7.4.13 / B.2)."""
    flags = data[0]
    htoob = flags & 1
    htps = ((flags >> 1) & 7) + 1
    htrs = ((flags >> 4) & 7) + 1
    low, high = struct.unpack_from(">ii", data, 1)
    br = BitReader(data[9:])
    lines = []
    cur = low
    while cur < high:
        plen = br.bits(htps)
        rlen = br.bits(htrs)
        lines.append((plen, rlen, cur, "normal"))
        cur += 1 << rlen
    lines.append((br.bits(htps), 32, low - 1, "lower"))
    lines.append((br.bits(htps), 32, high, "upper"))
    if htoob:
        lines.append((br.bits(htps), 0, 0, "oob"))
    return HuffmanTable(lines)


def decode_symbol_id_codes(br: BitReader, n_syms: int) -> HuffmanTable:
    """Text region symbol-ID code table via runcodes (7.4.4.4.1)."""
    runcode_lens = [br.bits(4) for _ in range(35)]
    runcode_table = HuffmanTable(
        [(l, 0, i, "normal") for i, l in enumerate(runcode_lens)]
    )
    lengths: list[int] = []
    prev = 0
    while len(lengths) < n_syms:
        code = runcode_table.decode(br)
        if code is None:
            raise Jbig2Error("runcode OOB")
        if code < 32:
            lengths.append(code)
            prev = code
        elif code == 32:
            rep = br.bits(2) + 3
            lengths.extend([prev] * rep)
        elif code == 33:
            rep = br.bits(3) + 3
            lengths.extend([0] * rep)
        else:  # 34
            rep = br.bits(7) + 11
            lengths.extend([0] * rep)
    lengths = lengths[:n_syms]
    return HuffmanTable(
        [(l, 0, i, "normal") for i, l in enumerate(lengths)]
    )
