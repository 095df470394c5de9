"""CCITT G3 and G4 fax decoding, as libtiff decodes the JAX package's TIFF.

The JAX package wraps a ``/CCITTFaxDecode`` stream in a one-strip TIFF
(``rapiddoc_tpu/pdfio/images.py`` ``_ccitt_to_tiff``) and lets PIL's
libtiff decode it. This module replays what comes out:

- the TIFF's fields: ``/K`` < 0 is T.6 (G4), 0 is T.4 one-dimensional,
  > 0 is T.4 two-dimensional (T4Options 1); the width is ``/Columns``
  (falling back to ``/Width``), the height the image's ``/Height``;
  ``/BlackIs1`` picks the photometric tag. ``EncodedByteAlign``,
  ``EndOfLine``, ``EndOfBlock``, ``Rows`` and ``DamagedRowsBeforeError``
  are not in the TIFF, so they change nothing.
- libtiff 4.7's decoder (``tif_fax3.c``, ``tif_fax3.h``): the lookahead
  tables of ``mkg3states`` (an end of line is any 11 zero bits), the bit
  accumulator that pads the end of the data with zero bits once, the run
  bookkeeping with its repairs of rows of the wrong length
  (``CLEANUP_RUNS``), and the reference line kept in a fixed array of
  runs. The end-of-line handling of T.4 rows was found by experiment
  against PIL 12.1's libtiff 4.7.1 (``tests/test_torch_ccitt.py``): a
  strip whose first row starts without an EOL is read without EOL codes
  (PDF's default ``/EndOfLine false``), one that starts with an EOL
  searches for one before every row; a T.6 strip or a one-dimensional
  T.4 strip that ends early keeps the rows decoded so far, a
  two-dimensional T.4 strip that ends inside a row raises. Not replayed
  (``ROADMAP.md`` Queue 3): EOL-less T.4 rows padded to bytes, or a
  damaged first EOL, where libtiff picks its next row by a rule not
  found; and the two-dimensional T.4 strips that end inside a row which
  PIL keeps.
- Rows libtiff does not reach are white here; in PIL they hold whatever
  its buffer held (not reproducible), so nothing compares them.
- PIL's ``convert("L")`` of the bilevel result: libtiff sets a bit for
  every run coded black; with ``/BlackIs1`` false (photometric 0) a set
  bit is 0 and a clear bit 255, with ``/BlackIs1`` true the reverse.

``decode_bits_plain`` runs in Python; ``csrc/bilevel.cu`` holds the
same decoder compiled (host code, built by nvcc through ``ops/build.py``
and loaded with ctypes). ``decode_ccitt`` takes the compiled one where a
card is present, with no fallback, and the plain one where none is.
Where PIL raises (libtiff returns an error), both raise CcittError.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .pil_modes import check_size


class CcittError(ValueError):
    """A stream PIL's libtiff refuses."""


# lookahead table states (mkg3states)
S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB, \
    S_MAKEUP, S_EOL = range(13)

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_COMMON_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111").split()


def _fill(table: np.ndarray, width: int, code: str, state: int, param: int) -> None:
    """Every ``width``-bit lookahead whose first bits (least significant
    first, as libtiff's accumulator holds them) are ``code``."""
    n = len(code)
    value = sum(int(b) << i for i, b in enumerate(code))
    idx = np.arange(value, 1 << width, 1 << n)
    table[idx, 0] = state
    table[idx, 1] = n
    table[idx, 2] = param


def _tables():
    """libtiff's TIFFFaxMainTable (7 bits), TIFFFaxWhiteTable (12) and
    TIFFFaxBlackTable (13): rows of (state, width, param)."""
    main = np.zeros((1 << 7, 3), np.int32)
    for code, state, param in (("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0),
                               ("011", S_VR, 1), ("000011", S_VR, 2), ("0000011", S_VR, 3),
                               ("010", S_VL, 1), ("000010", S_VL, 2), ("0000010", S_VL, 3),
                               ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)):
        _fill(main, 7, code, state, param)
    white = np.zeros((1 << 12, 3), np.int32)
    black = np.zeros((1 << 13, 3), np.int32)
    for table, width, term, makeup, s_term, s_makeup in (
            (white, 12, _WHITE_TERM, _WHITE_MAKEUP, S_TERMW, S_MAKEUPW),
            (black, 13, _BLACK_TERM, _BLACK_MAKEUP, S_TERMB, S_MAKEUPB)):
        for run, code in enumerate(term):
            _fill(table, width, code, s_term, run)
        for i, code in enumerate(makeup):
            _fill(table, width, code, s_makeup, 64 * (i + 1))
        for i, code in enumerate(_COMMON_MAKEUP):
            _fill(table, width, code, S_MAKEUP, 1792 + 64 * i)
        _fill(table, width, "0" * 11, S_EOL, 0)
    return main, white, black


MAIN, WHITE, BLACK = _tables()
_MAIN_L, _WHITE_L, _BLACK_L = (t.tolist() for t in (MAIN, WHITE, BLACK))
# bytes with their bits reversed (libtiff's accumulator is LSB-first)
_REV = [int(f"{b:08b}"[::-1], 2) for b in range(256)]


# errors the compiled decoder returns
_ERRORS = {-1: "buffer overflow", -2: "no row decoded", -3: "premature end of data",
           -4: "lookahead tables not set"}


class _Eof(Exception):
    pass


class _Fail(Exception):
    pass


class _Decoder:
    """libtiff's Fax3 decoder state over one strip."""

    def __init__(self, data: bytes, width: int, two_d: bool):
        self.data = data
        self.cp = 0
        self.acc = 0
        self.avail = 0
        self.lastx = width
        self.nruns = -(-(width + 1) // 32) * 32 * (2 if two_d else 1)
        # one array of 2 * nruns runs, as libtiff allocates it; curruns
        # and refruns are offsets into it and swap after each 2-D row
        self.runs = [0] * (2 * self.nruns)
        self.cur = 0
        self.ref = self.nruns if two_d else None
        if two_d:
            self.runs[self.ref] = width
            self.runs[self.ref + 1] = 0
        self.eol = 0
        self.first = True
        self.noeol = False

    # --------------------------------------------------- bit accumulator
    def need8(self, n: int) -> None:
        if self.avail < n:
            if self.cp >= len(self.data):
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= _REV[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8

    def need16(self, n: int) -> None:
        if self.avail < n:
            if self.cp >= len(self.data):
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= _REV[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8
                if self.avail < n:
                    if self.cp >= len(self.data):
                        self.avail = n
                    else:
                        self.acc |= _REV[self.data[self.cp]] << self.avail
                        self.cp += 1
                        self.avail += 8

    def clr(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n

    def lookup(self, table, width: int, wide: bool):
        (self.need16 if wide else self.need8)(width)
        ent = table[self.acc & ((1 << width) - 1)]
        self.clr(ent[1])
        return ent


def _row_runs(dec: _Decoder, two_d_row: bool):
    """Decode one row into dec.runs[dec.cur:]: (end index pa, eof).
    ``eof`` is None, or the kind of premature end ("eof" inside a row's
    codes after CLEANUP_RUNS)."""
    runs = dec.runs
    thisrun = dec.cur
    lastx = dec.lastx
    nruns = dec.nruns
    st = {"a0": 0, "rl": 0, "pa": thisrun}

    def setvalue(x: int) -> None:
        if st["pa"] >= thisrun + nruns:
            raise _Fail("buffer overflow")
        runs[st["pa"]] = (st["rl"] + x) & 0xFFFFFFFF
        st["pa"] += 1
        st["a0"] += x
        st["rl"] = 0

    def cleanup() -> None:
        if st["rl"]:
            setvalue(0)
        if st["a0"] != lastx:
            while st["a0"] > lastx and st["pa"] > thisrun:
                st["pa"] -= 1
                st["a0"] -= _s32(runs[st["pa"]])
            if st["a0"] < lastx:
                if st["a0"] < 0:
                    st["a0"] = 0
                if (st["pa"] - thisrun) & 1:
                    setvalue(0)
                setvalue(lastx - st["a0"])
            elif st["a0"] > lastx:
                setvalue(lastx)
                setvalue(0)

    if not two_d_row:
        # EXPAND1D
        try:
            while True:
                done = False
                while True:
                    ent = dec.lookup(_WHITE_L, 12, True)
                    s = ent[0]
                    if s == S_EOL:
                        dec.eol = 1
                        done = True
                        break
                    if s == S_TERMW:
                        setvalue(ent[2])
                        break
                    if s in (S_MAKEUPW, S_MAKEUP):
                        st["a0"] += ent[2]
                        st["rl"] += ent[2]
                        continue
                    done = True  # unexpected
                    break
                if done or st["a0"] >= lastx:
                    break
                while True:
                    ent = dec.lookup(_BLACK_L, 13, True)
                    s = ent[0]
                    if s == S_EOL:
                        dec.eol = 1
                        done = True
                        break
                    if s == S_TERMB:
                        setvalue(ent[2])
                        break
                    if s in (S_MAKEUPB, S_MAKEUP):
                        st["a0"] += ent[2]
                        st["rl"] += ent[2]
                        continue
                    done = True
                    break
                if done or st["a0"] >= lastx:
                    break
                pa = st["pa"]
                if runs[pa - 1] == 0 and runs[pa - 2] == 0:
                    st["pa"] = pa - 2
        except _Eof:
            cleanup()
            return st["pa"], "eof"
        cleanup()
        return st["pa"], None

    # EXPAND2D
    ref = dec.ref
    pb = ref
    b1 = _s32(runs[pb])
    pb += 1

    def check_b1():
        nonlocal b1, pb
        if st["pa"] != thisrun:
            while b1 <= st["a0"] and b1 < lastx:
                if pb + 1 >= ref + nruns:
                    raise _Fail("buffer overflow")
                b1 = _s32(b1 + runs[pb] + runs[pb + 1])
                pb += 2

    def horiz_run(table, width, s_term, s_makeup):
        while True:
            ent = dec.lookup(table, width, True)
            s = ent[0]
            if s == s_term:
                setvalue(ent[2])
                return True
            if s in (s_makeup, S_MAKEUP):
                st["a0"] += ent[2]
                st["rl"] += ent[2]
                continue
            return False

    try:
        bad = False
        while st["a0"] < lastx:
            if st["pa"] >= thisrun + nruns:
                raise _Fail("buffer overflow")
            ent = dec.lookup(_MAIN_L, 7, False)
            s = ent[0]
            if s == S_PASS:
                check_b1()
                if pb + 1 >= ref + nruns:
                    raise _Fail("buffer overflow")
                b1 = _s32(b1 + runs[pb])
                pb += 1
                st["rl"] += b1 - st["a0"]
                st["a0"] = b1
                b1 = _s32(b1 + runs[pb])
                pb += 1
            elif s == S_HORIZ:
                if (st["pa"] - thisrun) & 1:
                    ok = (horiz_run(_BLACK_L, 13, S_TERMB, S_MAKEUPB)
                          and horiz_run(_WHITE_L, 12, S_TERMW, S_MAKEUPW))
                else:
                    ok = (horiz_run(_WHITE_L, 12, S_TERMW, S_MAKEUPW)
                          and horiz_run(_BLACK_L, 13, S_TERMB, S_MAKEUPB))
                if not ok:
                    bad = True
                    break
                check_b1()
            elif s == S_V0 or s == S_VR:
                check_b1()
                setvalue(b1 - st["a0"] + (ent[2] if s == S_VR else 0))
                if pb >= ref + nruns:
                    raise _Fail("buffer overflow")
                b1 = _s32(b1 + runs[pb])
                pb += 1
            elif s == S_VL:
                check_b1()
                if b1 < st["a0"] + ent[2]:
                    bad = True
                    break
                setvalue(b1 - st["a0"] - ent[2])
                pb -= 1
                b1 = _s32(b1 - runs[pb])
            elif s == S_EXT:
                runs[st["pa"]] = (lastx - st["a0"]) & 0xFFFFFFFF
                st["pa"] += 1
                bad = True
                break
            elif s == S_EOL:
                runs[st["pa"]] = (lastx - st["a0"]) & 0xFFFFFFFF
                st["pa"] += 1
                dec.need8(4)
                dec.clr(4)
                dec.eol = 1
                bad = True
                break
            else:
                bad = True
                break
        if not bad and st["rl"]:
            if st["rl"] + st["a0"] < lastx:
                dec.need8(1)
                if not dec.acc & 1:
                    bad = True  # badMain2d
                else:
                    dec.clr(1)
            if not bad:
                setvalue(0)
    except _Eof:
        cleanup()
        return st["pa"], "eof"
    cleanup()
    return st["pa"], None


def _s32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _fill_row(bits: np.ndarray, runs: list, start: int, end: int, lastx: int) -> None:
    """_TIFFFax3fillruns: runs from ``start`` to ``end`` alternate clear
    (white) and set (black) bits; each run is cut to the row, and the cut
    is written back (the next row's reference)."""
    if (end - start) & 1:
        runs[end] = 0
        end += 1
    x = 0
    for i in range(start, end, 2):
        run = runs[i]
        if x + run > lastx or run > lastx:
            run = runs[i] = lastx - x
        x += run
        run = runs[i + 1]
        if x + run > lastx or run > lastx:
            run = runs[i + 1] = lastx - x
        if run:
            bits[x:x + run] = 1
        x += run


def _sync_eol(dec: _Decoder) -> None:
    """SYNC_EOL: a strip whose first row starts without an EOL is read
    without EOL codes from then on (nothing is skipped). Otherwise,
    unless the last row ended on an EOL code, search for 11 zero bits;
    then skip whole zero bytes, and the zero bits up to and past a one.
    When the data ends inside that skip of a 2-D strip, the bits are left
    as they were before it and the row is decoded from there."""
    if dec.noeol:
        return
    if dec.eol == 0:
        if dec.first:
            dec.need16(11)
            if dec.acc & 0x7FF:
                dec.noeol = True
                return
        while True:
            dec.need16(11)
            if dec.acc & 0x7FF == 0:
                break
            dec.clr(1)
    saved = (dec.acc, dec.avail, dec.cp)
    try:
        while True:
            dec.need8(8)
            if dec.acc & 0xFF:
                break
            dec.clr(8)
    except _Eof:
        if dec.ref is None:
            raise
        dec.acc, dec.avail, dec.cp = saved
        return
    while dec.acc & 1 == 0:
        dec.clr(1)
    dec.clr(1)
    dec.eol = 0


def decode_bits_plain(data: bytes, width: int, height: int, k: int) -> tuple[np.ndarray, int]:
    """libtiff's decode of one strip: (height, width) uint8, 1 for the
    bits libtiff sets (runs coded black), and the number of rows it
    wrote. Rows past those are white here; in PIL they are whatever its
    buffer held. Raises CcittError where libtiff returns an error."""
    g4 = k < 0
    two_d = g4 or k > 0
    dec = _Decoder(bytes(data), width, two_d)
    bits = np.zeros((height, width), np.uint8)
    try:
        for y in range(height):
            if g4:
                pa, eof = _row_runs(dec, True)
                if eof is None and not dec.eol:
                    _fill_row(bits[y], dec.runs, dec.cur, pa, width)
                    if pa >= dec.cur + dec.nruns:
                        raise _Fail("buffer overflow")
                    dec.runs[pa] = 0  # imaginary change for the reference
                    dec.cur, dec.ref = dec.ref, dec.cur
                    continue
                try:  # EOFG4: skip the EOFB
                    dec.need16(13)
                except _Eof:
                    pass
                dec.clr(13)
                _fill_row(bits[y], dec.runs, dec.cur, pa, width)
                if y == 0:
                    raise CcittError("no row decoded")
                return bits, y + 1
            try:
                _sync_eol(dec)
                dec.first = False
                row_1d = True
                if two_d:
                    dec.need8(1)
                    row_1d = bool(dec.acc & 1)
                    dec.clr(1)
            except _Eof:
                _fill_row(bits[y], dec.runs, dec.cur, dec.cur, width)
                if two_d:
                    raise CcittError("premature end of data") from None
                return bits, y + 1
            pa, eof = _row_runs(dec, not row_1d)
            _fill_row(bits[y], dec.runs, dec.cur, pa, width)
            if eof is not None:
                if two_d:
                    raise CcittError("premature end of data")
                return bits, y + 1
            if two_d:
                if pa < dec.cur + dec.nruns:
                    dec.runs[pa] = 0
                dec.cur, dec.ref = dec.ref, dec.cur
    except _Fail as exc:
        raise CcittError(str(exc)) from None
    return bits, height


def to_l(bits: np.ndarray, black_is_1: bool) -> np.ndarray:
    """PIL's ``convert("L")`` of the bilevel image under the photometric
    tag ``/BlackIs1`` picks."""
    if black_is_1:
        return bits * np.uint8(255)
    return (1 - bits) * np.uint8(255)


def _compiled():
    """``ccitt_decode`` of ``csrc/bilevel.cu``, built and loaded once, its
    lookahead tables handed over on first use."""
    from ..ops import build

    lib = build.load("bilevel")
    fn = lib.ccitt_decode
    if fn.argtypes is None:
        tables = np.ascontiguousarray(np.concatenate([MAIN, WHITE, BLACK]).astype(np.int32))
        lib.ccitt_set_tables.argtypes = [ctypes.c_void_p]
        lib.ccitt_set_tables.restype = None
        lib.ccitt_set_tables(tables.ctypes.data)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_bits_compiled(data: bytes, width: int, height: int, k: int) -> tuple[np.ndarray, int]:
    """The same decode through ``csrc/bilevel.cu``."""
    bits = np.zeros((height, width), np.uint8)
    rc = _compiled()(bytes(data), len(data), width, height, k, bits.ctypes.data)
    if rc < 0:
        raise CcittError(_ERRORS.get(rc, f"ccitt_decode returned {rc}"))
    return bits, rc


def decode_bits(data: bytes, width: int, height: int, k: int) -> tuple[np.ndarray, int]:
    """``decode_bits_compiled`` where a card is present
    (``ops.build.host_compiled``), with no fallback, else
    ``decode_bits_plain``."""
    from ..ops import build

    if build.host_compiled():
        return decode_bits_compiled(data, width, height, k)
    return decode_bits_plain(data, width, height, k)


def decode_ccitt(data: bytes, width: int, height: int, parms: dict) -> np.ndarray:
    """A /CCITTFaxDecode stream as the JAX package's PIL image in mode L:
    (height, width) uint8 of 0 and 255."""
    k = int(parms.get("K", 0) or 0)
    if width <= 0 or height <= 0 or not data:
        raise CcittError("empty strip")
    check_size(width, height)  # PIL opens the strip as a TIFF
    bits, _ = decode_bits(data, width, height, k)
    return to_l(bits, bool(parms.get("BlackIs1", False)))
