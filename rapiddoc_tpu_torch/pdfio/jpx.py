"""JPEG 2000 (JPXDecode, ``.jp2``, ``.j2k``) as Pillow 12.1 opens it over
OpenJPEG 2.5.4 (``Jpeg2KDecode``: reduce 0, every layer, tile by tile).

``jpx_mode`` returns PIL's mode and samples. Read from OpenJPEG and
Pillow and checked by experiment (``tests/test_torch_jpx.py``):

- Input: a JP2 file (signature, ``ftyp``, ``jp2h`` with ``ihdr`` and
  ``colr``, then ``jp2c``) or a raw codestream. PIL's mode comes from
  ``ihdr`` (JP2) or SIZ: one component ``L``, or ``I;16`` above 8 bits;
  two ``LA``; three ``RGB``; four ``RGBA``. The ``colr`` box's
  enumerated space (16 sRGB, 17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK; any
  other value or an ICC profile counts as unspecified, grey for one or
  two components and sRGB for three or four) must have a Pillow unpacker
  for the component count: grey with 1-2, sRGB or sYCC with 3-4, grey
  with 4 read as sRGB; anything else fails, as in Pillow. sYCC goes
  through Pillow's ``ImagingConvertYCbCr2RGB`` (``pdfio.pil_ycc``).
- Codestream: SIZ (image and tile offsets, signed and unsigned samples
  of 1-16 bits), COD/COC (all five progression orders, layers,
  resolutions, code-block sizes, precincts), QCD/QCC (none, scalar
  derived and expounded; segments of exactly their length), tiles'
  parts interleaved, PLT/TLM/PLM/COM/CAP read and skipped; unknown
  markers stepped over as OpenJPEG steps over them, known ones out of
  place failing, COD and QCD required. Each tile's parts come numbered
  in order, EOC must follow the last one, a JP2 header's size must be
  the codestream's, and a tile-part past the end of the data fails
  (OpenJPEG in strict mode).
- Tier 2: tag trees, packet headers (inclusion, zero bit-planes, passes,
  length indicators), each code-block's segments of at most 109 passes
  gathered across layers, under OpenJPEG's progression iterators; a
  segment past the tile's data fails.
- Tier 1: ``pdfio.jpx_t1`` per code-block, compiled from
  ``csrc/jpx.cu`` where a card is present (``ops.build.host_compiled``),
  with no fallback.
- Dequantisation: reversible values halved with truncation; irreversible
  ones ``float32(2q) * float32(stepsize / 2)`` with OpenJPEG's step size
  (no band gain: its 9/7 synthesis scales the high band by 2/K).
- Inverse DWT per level, rows then columns: 5/3 in integers, 9/7 in
  float32 as OpenJPEG's lifting (scale by K and 2/K, then delta, gamma,
  beta, alpha, each ``x + (left + right) * c``, mirrored at the ends; a
  signal of one sample is left alone, and a 5/3 one at an odd
  coordinate is halved). Odd image and tile origins set each level's
  parity.
- Inverse RCT/ICT on the first three components when COD's MCT is set,
  DC level shift, ``lrintf`` (half to even) and the clamp to the
  component's range; then Pillow's unpackers (``j2ku_*``), which shift
  each component to 8 bits (16 for ``I;16``) with rounding.

Features OpenJPEG decodes but Pillow's writer never produces raise
NotImplementedError naming ROADMAP item 12f: code-block styles other
than 0, SOP/EPH markers, ROI, POC, PPM/PPT, subsampled components, more
than four components, palettes and CMYK JP2 files.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from ..utils.unported import not_ported
from .jpx_t1 import decode_cblock
from .pil_modes import check_size
from .pil_ycc import B_CB, G_CB, G_CR, R_CR

J2K_SIG = b"\xff\x4f\xff\x51"
JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
K_97 = np.float32(1.230174105)
TWO_INV_K = np.float32(1.625732422)
LIFT_97 = (np.float32(-0.443506852), np.float32(-0.882911075), np.float32(0.052980118),
           np.float32(1.586134342))
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _ceildiv_pow2(a: int, b: int) -> int:
    return -((-a) >> b)


def _ceildiv(a: int, b: int) -> int:
    return -((-a) // b)


# ------------------------------------------------------------ containers

def jp2_codestream(data: bytes) -> tuple[bytes, dict]:
    """The codestream of a JP2 file and its header (``_jp2_header``), as
    OpenJPEG reads them: the signature box, then ``ftyp`` (8 bytes and
    whole compatibility entries), boxes OpenJPEG does not know skipped,
    ``jp2h`` before ``jp2c``, whose codestream runs to the end of the
    data whatever the box's length says."""
    if data[:12] != JP2_SIG:
        raise ValueError("not a JP2 file")
    pos, end = 12, len(data)
    header = None
    first = True
    while pos + 8 <= end:
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > end:
                raise ValueError("JP2 box header cut short")
            lbox = struct.unpack_from(">Q", data, pos + 8)[0]
            hlen = 16
        elif lbox == 0:
            lbox = end - pos
        if first and (tbox != b"ftyp" or lbox < 16 or (lbox - 16) % 4):
            raise ValueError("the ftyp box must be the second box of a JP2 file")
        first = False
        if tbox == b"jp2c":
            if header is None:
                raise ValueError("JP2 codestream before its header")
            return data[pos + hlen:], header
        if lbox < hlen or pos + lbox > end:
            raise ValueError("JP2 box past the end of the file")
        if tbox == b"jp2h" and header is None:
            header = _jp2_header(data[pos + hlen:pos + lbox])
        pos += lbox
    raise ValueError("JP2 file without a codestream")


def _jp2_header(body: bytes) -> dict:
    """What Pillow's and OpenJPEG's readers take from a ``jp2h`` box:
    ``ihdr``'s size, components and depth, the first ``colr`` box's
    enumerated space (None for a profile), and whether a palette is
    there."""
    pos = 0
    out: dict = {}
    while pos + 8 <= len(body):
        lbox, tbox = struct.unpack_from(">I4s", body, pos)
        if lbox < 8 or pos + lbox > len(body):
            raise ValueError("malformed JP2 header box")
        sub = body[pos + 8:pos + lbox]
        if tbox == b"ihdr" and "nc" not in out:  # OpenJPEG keeps the first
            if len(sub) != 14:
                raise ValueError("JP2 ihdr box of a wrong size")
            h, w, nc, bpc = struct.unpack_from(">IIHB", sub)
            if not (h and w and nc):
                raise ValueError("JP2 ihdr box with a zero size or no component")
            out.update(width=w, height=h, nc=nc, bpc=bpc)
        elif tbox == b"colr" and "enumcs" not in out:
            if len(sub) < 3 or (sub[0] == 1 and len(sub) < 7):
                raise ValueError("JP2 colr box too short")
            out["enumcs"] = struct.unpack_from(">I", sub, 3)[0] if sub[0] == 1 else None
        elif tbox == b"cdef":
            n = struct.unpack_from(">H", sub)[0] if len(sub) >= 2 else 0
            if "cdef" in out or not n or len(sub) < 2 + 6 * n:
                raise ValueError("bad JP2 cdef box")
            out["cdef"] = True  # read, not applied (Pillow decodes tile by tile)
        elif tbox in (b"pclr", b"cmap"):
            out["palette"] = True
        pos += lbox
    if pos != len(body):  # Pillow's box reader wants whole boxes to the end
        raise ValueError("malformed JP2 header box")
    if "nc" not in out:
        raise ValueError("Malformed JP2 header")
    return out


# ------------------------------------------------------------ codestream

class Comp:
    """Coding style and quantisation of one component."""

    def __init__(self):
        self.levels = 5
        self.cbw = self.cbh = 6
        self.cblksty = 0
        self.reversible = True
        self.precincts: list[tuple[int, int]] | None = None
        self.qntsty = 0
        self.guard = 2
        self.steps: list[tuple[int, int]] = []
        self.coc = self.qcc = False  # set by COC/QCC in the header being read

    def copy(self) -> "Comp":
        c = Comp()
        c.__dict__.update({k: (list(v) if isinstance(v, list) else v)
                           for k, v in self.__dict__.items()})
        return c


class Coding:
    """COD/QCD state of the main header or of one tile."""

    def __init__(self, ncomp: int):
        self.order = 0
        self.layers = 1
        self.mct = 0
        self.comps = [Comp() for _ in range(ncomp)]

    def copy(self) -> "Coding":
        c = Coding(0)
        c.order, c.layers, c.mct = self.order, self.layers, self.mct
        c.comps = [x.copy() for x in self.comps]
        return c


def _read_spcod(seg: bytes, pos: int, comp: Comp, with_precincts: bool) -> None:
    if pos + 5 > len(seg):
        raise ValueError("COD/COC segment too short")
    comp.levels = seg[pos]
    comp.cbw = seg[pos + 1] + 2
    comp.cbh = seg[pos + 2] + 2
    comp.cblksty = seg[pos + 3]
    comp.reversible = seg[pos + 4] == 1
    if (comp.levels > 32 or comp.cbw > 10 or comp.cbh > 10 or comp.cbw + comp.cbh > 12
            or seg[pos + 4] > 1):
        raise ValueError("bad COD/COC parameters")
    if comp.cblksty:
        raise not_ported(f"JPEG 2000 code-block style {comp.cblksty:#x}", "pdfio")
    if with_precincts:
        pp = seg[pos + 5:pos + 5 + comp.levels + 1]
        comp.precincts = [(b & 0xF, b >> 4) for b in pp]
    else:
        comp.precincts = None
    if len(seg) != pos + 5 + (comp.levels + 1 if with_precincts else 0):
        raise ValueError("COD/COC segment of a wrong length")  # as OpenJPEG checks it


def _read_sqcd(seg: bytes, pos: int, comp: Comp) -> None:
    """Sqcd and the step sizes as OpenJPEG reads them: style 0 one byte a
    band, 1 one 16-bit value, any other style 16-bit values; the segment
    must end with them."""
    if pos >= len(seg):
        raise ValueError("QCD/QCC segment too short")
    sq = seg[pos]
    comp.qntsty = sq & 0x1F
    comp.guard = sq >> 5
    body = seg[pos + 1:]
    if comp.qntsty == 0:
        comp.steps = [(b >> 3, 0) for b in body]
        used = len(body)
    else:
        used = 2 if comp.qntsty == 1 else len(body) // 2 * 2
        vals = [struct.unpack_from(">H", body, i)[0] for i in range(0, used, 2)]
        comp.steps = [(v >> 11, v & 0x7FF) for v in vals]
    if used != len(body) or not comp.steps:
        raise ValueError("QCD/QCC segment of a wrong length")


class Codestream:
    """The main header and the tile-parts of a codestream."""

    def __init__(self, data: bytes):
        if data[:4] != J2K_SIG:
            raise ValueError("not a JPEG 2000 codestream")
        self.data = data
        pos = 2
        seg, pos = self._segment(pos, 0xFF51)
        if len(seg) < 36:
            raise ValueError("SIZ segment too short")
        (rsiz, self.xsiz, self.ysiz, self.x0, self.y0, self.tw_, self.th_, self.tx0, self.ty0,
         ncomp) = struct.unpack_from(">HIIIIIIIIH", seg)
        if rsiz & 0x8000:
            raise not_ported("JPEG 2000 Part 2 codestreams", "pdfio")
        if ncomp < 1 or len(seg) < 36 + 3 * ncomp:
            raise ValueError("bad SIZ component count")
        if ncomp > 4:
            raise not_ported(f"JPEG 2000 images of {ncomp} components", "pdfio")
        self.prec, self.sgnd = [], []
        for c in range(ncomp):
            ssiz, dx, dy = seg[36 + 3 * c:39 + 3 * c]
            if dx == 0 or dy == 0:
                raise ValueError("bad SIZ sub-sampling")
            if dx != 1 or dy != 1:
                raise not_ported("sub-sampled JPEG 2000 components", "pdfio")
            self.prec.append((ssiz & 0x7F) + 1)
            self.sgnd.append(bool(ssiz & 0x80))
        if max(self.prec) > 16:
            raise not_ported("JPEG 2000 samples above 16 bits", "pdfio")
        if (self.xsiz <= self.x0 or self.ysiz <= self.y0 or not self.tw_ or not self.th_
                or self.tx0 > self.x0 or self.ty0 > self.y0
                or self.tx0 + self.tw_ <= self.x0 or self.ty0 + self.th_ <= self.y0):
            raise ValueError("bad SIZ geometry")
        self.ncomp = ncomp
        self.ntx = _ceildiv(self.xsiz - self.tx0, self.tw_)
        self.nty = _ceildiv(self.ysiz - self.ty0, self.th_)
        self.main = Coding(ncomp)
        first_sot = self._read_header_markers(pos, self.main, True)
        self.tiles: dict[int, dict] = {}
        self._read_tile_parts(first_sot)

    def _segment(self, pos: int, want: int | None) -> tuple[bytes, int]:
        if pos + 4 > len(self.data):
            raise ValueError("JPEG 2000 marker segment cut short")
        marker, length = struct.unpack_from(">HH", self.data, pos)
        if want is not None and marker != want:
            raise ValueError(f"expected marker {want:#06x}, found {marker:#06x}")
        if length < 2 or pos + 2 + length > len(self.data):
            raise ValueError("JPEG 2000 marker segment past the end")
        return self.data[pos + 4:pos + 2 + length], pos + 2 + length

    def _next_known(self, pos: int, main: bool) -> int:
        """OpenJPEG's ``opj_j2k_read_unk``: after an unknown marker at
        ``pos``, the next 16-bit word at an even step that is a known
        marker; it must be allowed where it stands."""
        pos += 2
        while pos + 2 <= len(self.data):
            word = struct.unpack_from(">H", self.data, pos)[0]
            if word >= 0xFF00 and word in _KNOWN:
                if word not in (_MAIN_MARKERS if main else _TILE_MARKERS):
                    raise ValueError(f"JPEG 2000 marker {word:#06x} out of place")
                return pos
            pos += 2
        raise ValueError("JPEG 2000 header cut short")

    def _read_header_markers(self, pos: int, coding: Coding, main: bool) -> int:
        """Marker segments up to SOT (main) or SOD (tile-part); returns
        the position of that marker. Unknown markers are stepped over as
        OpenJPEG does (``_next_known``); a known one out of its place and
        a word below 0xFF00 where a marker should be fail, and so does a
        main header without COD or QCD."""
        seen: set[int] = set()
        while True:
            if pos + 2 > len(self.data):
                raise ValueError("JPEG 2000 header cut short")
            marker = struct.unpack_from(">H", self.data, pos)[0]
            if marker == (0xFF90 if main else 0xFF93):
                if main and not {0xFF52, 0xFF5C} <= seen:
                    raise ValueError("JPEG 2000 main header without COD or QCD")
                return pos
            if marker < 0xFF00:
                raise ValueError(f"a JPEG 2000 marker was expected, found {marker:#06x}")
            if marker not in _KNOWN:
                pos = self._next_known(pos, main)
                continue
            if marker not in (_MAIN_MARKERS if main else _TILE_MARKERS):
                raise ValueError(f"JPEG 2000 marker {marker:#06x} out of place")
            seg, pos = self._segment(pos, None)
            seen.add(marker)
            if marker == 0xFF52:  # COD
                if len(seg) < 5:
                    raise ValueError("COD segment too short")
                scod = seg[0]
                if scod & ~7:
                    raise ValueError("unknown Scod value in COD marker")
                if scod & 6:
                    raise not_ported("JPEG 2000 SOP/EPH markers", "pdfio")
                coding.order = seg[1]
                coding.layers = struct.unpack_from(">H", seg, 2)[0]
                coding.mct = seg[4]
                if coding.order > 4 or coding.layers == 0 or coding.mct > 1:
                    raise ValueError("bad COD progression, layers or MCT")
                for comp in coding.comps:
                    if not comp.coc:
                        _read_spcod(seg, 5, comp, bool(scod & 1))
            elif marker == 0xFF53:  # COC
                n = 1 if self.ncomp < 257 else 2
                c = seg[0] if n == 1 else struct.unpack_from(">H", seg)[0]
                if c >= self.ncomp or len(seg) < n + 1:
                    raise ValueError("bad COC component")
                _read_spcod(seg, n + 1, coding.comps[c], bool(seg[n] & 1))
                coding.comps[c].coc = True
            elif marker == 0xFF5C:  # QCD
                for comp in coding.comps:
                    if not comp.qcc:
                        _read_sqcd(seg, 0, comp)
            elif marker == 0xFF5D:  # QCC
                n = 1 if self.ncomp < 257 else 2
                c = seg[0] if n == 1 else struct.unpack_from(">H", seg)[0]
                if c >= self.ncomp:
                    raise ValueError("bad QCC component")
                _read_sqcd(seg, n, coding.comps[c])
                coding.comps[c].qcc = True
            elif marker in _NOT_PORTED:
                raise not_ported("JPEG 2000 RGN, POC, PPM, PPT and Part 2 markers", "pdfio")
            # TLM, PLM, PLT, CRG, COM, CAP, CPF: read and skipped

    def _read_tile_parts(self, pos: int) -> None:
        """Tile-parts in order up to EOC, which must follow the last one:
        each tile's parts numbered from 0 (and below TNsot where it is
        set); a Psot of 0 runs to the EOC at the end of the data."""
        data = self.data
        ntiles = self.ntx * self.nty
        while True:
            if pos + 2 > len(data):
                raise ValueError("JPEG 2000 codestream without EOC")
            marker = struct.unpack_from(">H", data, pos)[0]
            if marker == 0xFFD9:
                return
            if marker != 0xFF90:
                raise ValueError(f"expected SOT, found {marker:#06x}")
            seg, after = self._segment(pos, 0xFF90)
            if len(seg) < 8:
                raise ValueError("SOT segment too short")
            isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", seg)
            if isot >= ntiles:
                raise ValueError("SOT tile index past the tile count")
            end = len(data) - 2 if psot == 0 else pos + psot
            if end > len(data) or (psot and psot < 14):
                raise ValueError("JPEG 2000 tile-part past the end of the data")
            tile = self.tiles.get(isot)
            if tile is None:
                tile = self.tiles[isot] = {"coding": self.main.copy(), "data": []}
                for comp in tile["coding"].comps:
                    comp.coc = comp.qcc = False
            if tpsot != len(tile["data"]) or (tnsot and tpsot >= tnsot):
                raise ValueError("JPEG 2000 tile-part index out of order")
            sod = self._read_header_markers(after, tile["coding"], False)
            if sod + 2 > end:
                raise ValueError("JPEG 2000 tile-part header past its length")
            tile["data"].append(data[sod + 2:end])
            pos = end


# markers OpenJPEG 2.5 knows, and where each may stand (main header or
# tile-part header); SOP's place is inside packets
_MAIN_MARKERS = {0xFF90, 0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF55, 0xFF57,
                 0xFF60, 0xFF63, 0xFF64, 0xFF74, 0xFF78, 0xFF50, 0xFF59, 0xFF75, 0xFF77}
_TILE_MARKERS = {0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF58, 0xFF61, 0xFF64,
                 0xFF74, 0xFF75, 0xFF77}
_KNOWN = _MAIN_MARKERS | _TILE_MARKERS | {0xFF51, 0xFF91}
_NOT_PORTED = {0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF74, 0xFF75, 0xFF77, 0xFF78}


# ---------------------------------------------------------------- tier 2

class Bio:
    """OpenJPEG's packet-header bit reader: a byte after 0xFF holds seven
    bits; past the end it reads zeros."""

    __slots__ = ("data", "pos", "end", "buf", "ct")

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = self.ct = 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            v |= self.bit() << i
        return v

    def inalign(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0


class TagTree:
    """A tag tree over (w, h) leaves (OpenJPEG's ``opj_tgt``)."""

    def __init__(self, w: int, h: int):
        self.parent: list[int] = []
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            pw, ph = sizes[-1]
            sizes.append(((pw + 1) // 2, (ph + 1) // 2))
        base = 0
        for lvl, (lw, lh) in enumerate(sizes):
            nbase = base + lw * lh
            for y in range(lh):
                for x in range(lw):
                    if lvl + 1 < len(sizes):
                        self.parent.append(nbase + (y // 2) * sizes[lvl + 1][0] + x // 2)
                    else:
                        self.parent.append(-1)
            base = nbase
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio: Bio, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


class CodeBlock:
    """A code-block's tier-2 state: its segments ([passes, bytes], at most
    MAX_SEG_PASSES passes each, as code-block style 0 terminates them),
    their data, and what the current packet adds."""

    __slots__ = ("x0", "y0", "x1", "y1", "zbp", "lenbits", "segs", "chunks", "pending")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.zbp = 0
        self.lenbits = 3
        self.segs: list[list[int]] = []
        self.chunks: list[bytes] = []
        self.pending: list[tuple[int, int, int]] = []  # (segment, passes, bytes)

    @property
    def passes(self) -> int:
        return sum(seg[0] for seg in self.segs)


MAX_SEG_PASSES = 109


class Band:
    def __init__(self, bandno, x0, y0, x1, y1, step, guard, prec, reversible):
        self.bandno = bandno
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        expn, mant = step
        self.mb = expn + guard - 1
        rb = prec if not reversible else prec + (0, 1, 1, 2)[bandno]
        self.stepsize = np.float32((1.0 + mant / 2048.0) * 2.0 ** (rb - expn))
        self.precincts: list[dict] = []

    def empty(self) -> bool:
        return self.x1 - self.x0 == 0 or self.y1 - self.y0 == 0


class Resolution:
    def __init__(self, tc: tuple, comp: Comp, resno: int, prec: int):
        numres = comp.levels + 1
        level = numres - 1 - resno
        tcx0, tcy0, tcx1, tcy1 = tc
        self.level = level
        self.x0, self.y0 = _ceildiv_pow2(tcx0, level), _ceildiv_pow2(tcy0, level)
        self.x1, self.y1 = _ceildiv_pow2(tcx1, level), _ceildiv_pow2(tcy1, level)
        self.pdx, self.pdy = comp.precincts[resno] if comp.precincts else (15, 15)
        px0 = (self.x0 >> self.pdx) << self.pdx
        py0 = (self.y0 >> self.pdy) << self.pdy
        px1 = _ceildiv_pow2(self.x1, self.pdx) << self.pdx
        py1 = _ceildiv_pow2(self.y1, self.pdy) << self.pdy
        self.pw = 0 if self.x0 == self.x1 else (px1 - px0) >> self.pdx
        self.ph = 0 if self.y0 == self.y1 else (py1 - py0) >> self.pdy
        if resno == 0:
            cbgx0, cbgy0, cbgw, cbgh = px0, py0, self.pdx, self.pdy
        else:
            cbgx0, cbgy0 = _ceildiv_pow2(px0, 1), _ceildiv_pow2(py0, 1)
            cbgw, cbgh = self.pdx - 1, self.pdy - 1
        cbw, cbh = min(comp.cbw, cbgw), min(comp.cbh, cbgh)
        self.bands: list[Band] = []
        for b in ((0,) if resno == 0 else (1, 2, 3)):
            if resno == 0:
                bx0, by0 = _ceildiv_pow2(tcx0, level), _ceildiv_pow2(tcy0, level)
                bx1, by1 = _ceildiv_pow2(tcx1, level), _ceildiv_pow2(tcy1, level)
                step_i = 0
            else:
                xob, yob = b & 1, b >> 1
                bx0 = _ceildiv_pow2(tcx0 - (xob << level), level + 1)
                by0 = _ceildiv_pow2(tcy0 - (yob << level), level + 1)
                bx1 = _ceildiv_pow2(tcx1 - (xob << level), level + 1)
                by1 = _ceildiv_pow2(tcy1 - (yob << level), level + 1)
                step_i = 3 * (resno - 1) + b
            band = Band(b, bx0, by0, bx1, by1, _step(comp, step_i), comp.guard, prec,
                        comp.reversible)
            for precno in range(self.pw * self.ph):
                gx0 = cbgx0 + (precno % self.pw) * (1 << cbgw)
                gy0 = cbgy0 + (precno // self.pw) * (1 << cbgh)
                x0, y0 = max(gx0, bx0), max(gy0, by0)
                x1, y1 = min(gx0 + (1 << cbgw), bx1), min(gy0 + (1 << cbgh), by1)
                tx = (x0 >> cbw) << cbw
                ty = (y0 >> cbh) << cbh
                cw = max(0, (_ceildiv_pow2(x1, cbw) << cbw) - tx) >> cbw if x1 > x0 else 0
                ch = max(0, (_ceildiv_pow2(y1, cbh) << cbh) - ty) >> cbh if y1 > y0 else 0
                blocks = []
                for k in range(cw * ch):
                    cx0 = tx + (k % cw) * (1 << cbw)
                    cy0 = ty + (k // cw) * (1 << cbh)
                    blocks.append(CodeBlock(max(cx0, x0), max(cy0, y0), min(cx0 + (1 << cbw), x1),
                                            min(cy0 + (1 << cbh), y1)))
                band.precincts.append({"cw": cw, "ch": ch, "blocks": blocks,
                                       "incl": TagTree(cw, ch) if cw * ch else None,
                                       "imsb": TagTree(cw, ch) if cw * ch else None})
            self.bands.append(band)


def _step(comp: Comp, i: int) -> tuple[int, int]:
    """Band ``i``'s (exponent, mantissa): derived from the first for
    scalar-derived quantisation; a band the segment does not reach has
    (0, 0), as OpenJPEG's zeroed table gives it."""
    if comp.qntsty == 1:  # scalar derived
        expn, mant = comp.steps[0]
        return (max(expn - (i - 1) // 3, 0) if i else expn), mant
    return comp.steps[i] if i < len(comp.steps) else (0, 0)


def _packets(cs: Codestream, coding: Coding, tile_box: tuple, res_by_comp: list) -> list:
    """(layer, resno, compno, precno) in the tile's progression order
    (OpenJPEG's ``opj_pi_next_*``, no POC)."""
    order = PROGRESSIONS[coding.order]
    layers = coding.layers
    ncomp = cs.ncomp
    maxres = max(len(r) for r in res_by_comp)
    out = []
    seen = set()

    def emit(l, r, c, p):
        key = (l, r, c, p)
        if key not in seen:
            seen.add(key)
            out.append(key)

    if order in ("LRCP", "RLCP"):
        loops = ((l, r) for l in range(layers) for r in range(maxres)) if order == "LRCP" else \
            ((l, r) for r in range(maxres) for l in range(layers))
        for l, r in loops:
            for c in range(ncomp):
                if r >= len(res_by_comp[c]):
                    continue
                res = res_by_comp[c][r]
                for p in range(res.pw * res.ph):
                    emit(l, r, c, p)
        return out
    tx0, ty0, tx1, ty1 = tile_box

    def steps(comps):
        dx = dy = 0
        for c in comps:
            n = len(res_by_comp[c])
            for r, res in enumerate(res_by_comp[c]):
                ddx = 1 << (res.pdx + n - 1 - r)
                ddy = 1 << (res.pdy + n - 1 - r)
                dx = ddx if not dx else min(dx, ddx)
                dy = ddy if not dy else min(dy, ddy)
        return dx, dy

    def precinct(c, r, x, y):
        res = res_by_comp[c][r]
        level = len(res_by_comp[c]) - 1 - r
        trx0, try0 = _ceildiv(tx0, 1 << level), _ceildiv(ty0, 1 << level)
        trx1, try1 = _ceildiv(tx1, 1 << level), _ceildiv(ty1, 1 << level)
        rpx, rpy = res.pdx + level, res.pdy + level
        if not (y % (1 << rpy) == 0 or (y == ty0 and ((try0 << level) % (1 << rpy)))):
            return None
        if not (x % (1 << rpx) == 0 or (x == tx0 and ((trx0 << level) % (1 << rpx)))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceildiv(x, 1 << level) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_ceildiv(y, 1 << level) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - (x % dx)
            y += dy - (y % dy)

    if order == "RPCL":
        dx, dy = steps(range(ncomp))
        for r in range(maxres):
            for x, y in positions(dx, dy):
                for c in range(ncomp):
                    if r >= len(res_by_comp[c]):
                        continue
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for l in range(layers):
                            emit(l, r, c, p)
    elif order == "PCRL":
        dx, dy = steps(range(ncomp))
        for x, y in positions(dx, dy):
            for c in range(ncomp):
                for r in range(len(res_by_comp[c])):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for l in range(layers):
                            emit(l, r, c, p)
    else:  # CPRL
        for c in range(ncomp):
            dx, dy = steps([c])
            for x, y in positions(dx, dy):
                for r in range(len(res_by_comp[c])):
                    p = precinct(c, r, x, y)
                    if p is not None:
                        for l in range(layers):
                            emit(l, r, c, p)
    return out


def _numpasses(bio: Bio) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _read_packets(data: bytes, packets: list, res_by_comp: list) -> None:
    """Tier 2 over one tile's data: fills each code-block's passes, zero
    bit-planes and data chunks."""
    pos = 0
    end = len(data)
    for layer, r, c, p in packets:
        res = res_by_comp[c][r]
        if layer == 0:
            for band in res.bands:
                if not band.empty():
                    prc = band.precincts[p]
                    if prc["incl"] is not None:
                        for tree in (prc["incl"], prc["imsb"]):
                            tree.value = [999] * len(tree.value)
                            tree.low = [0] * len(tree.low)
                    for blk in prc["blocks"]:
                        blk.segs = []
                        blk.chunks = []
        bio = Bio(data, pos, end)
        if not bio.bit():
            bio.inalign()
            pos = bio.pos
            continue
        for band in res.bands:
            if band.empty():
                continue
            prc = band.precincts[p]
            for k, blk in enumerate(prc["blocks"]):
                if not blk.segs:
                    included = prc["incl"].decode(bio, k, layer + 1)
                else:
                    included = bio.bit()
                if not included:
                    blk.pending = []
                    continue
                if not blk.segs:
                    i = 0
                    while not prc["imsb"].decode(bio, k, i):
                        i += 1
                    blk.zbp = i - 1  # the tree's value: missing bit-planes
                    blk.lenbits = 3
                n = _numpasses(bio)
                inc = 0
                while bio.bit():
                    inc += 1
                blk.lenbits += inc
                segno = len(blk.segs) - 1
                if segno < 0 or blk.segs[segno][0] == MAX_SEG_PASSES:
                    segno += 1
                done = blk.segs[segno][0] if segno < len(blk.segs) else 0
                blk.pending = []
                while n > 0:
                    take = min(MAX_SEG_PASSES - done, n)
                    nbits = blk.lenbits + take.bit_length() - 1
                    if nbits > 32:
                        raise ValueError("invalid JPEG 2000 length bits")
                    blk.pending.append((segno, take, bio.read(nbits)))
                    n -= take
                    segno, done = segno + 1, 0
        bio.inalign()
        pos = bio.pos
        for band in res.bands:
            if band.empty():
                continue
            for blk in band.precincts[p]["blocks"]:
                for segno, take, length in blk.pending:
                    if pos + length > end:
                        raise ValueError("JPEG 2000 code-block segment past the tile's data")
                    if segno == len(blk.segs):
                        blk.segs.append([0, 0])
                    blk.segs[segno][0] += take
                    blk.segs[segno][1] += length
                    blk.chunks.append(data[pos:pos + length])
                    pos += length
                blk.pending = []


# ------------------------------------------------------------------ DWT

def _interleave(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Signals along axis 0 from [low (sn) | high] to interleaved order."""
    out = np.empty_like(a)
    out[cas::2] = a[:sn]
    out[1 - cas::2] = a[sn:]
    return out


def _neighbours(x: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The samples at parity ``p`` along axis 0 (a view) and their left and
    right neighbours, mirrored at both ends."""
    t, o = x[p::2], x[1 - p::2]
    nt, no = len(t), len(o)
    if p == 0:
        left = np.concatenate([o[:1], o[:nt - 1]])
        right = o[:nt] if no >= nt else np.concatenate([o, o[no - 1:]])
    else:
        left = o[:nt]
        right = o[1:nt + 1] if no > nt else np.concatenate([o[1:], o[no - 1:]])
    return t, left, right


def _idwt53(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The 5/3 synthesis of signals along axis 0 (int32)."""
    n = a.shape[0]
    if n == 1:
        return (np.sign(a) * (np.abs(a) // 2)).astype(np.int32) if cas else a
    x = _interleave(a.astype(np.int64), sn, cas)
    t, left, right = _neighbours(x, cas)  # low-pass samples
    t -= (left + right + 2) >> 2
    t, left, right = _neighbours(x, 1 - cas)
    t += (left + right) >> 1
    return x.astype(np.int32)


def _idwt97(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The 9/7 synthesis of signals along axis 0 (float32), OpenJPEG's
    ``opj_v8dwt_decode``."""
    n = a.shape[0]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return a
    x = _interleave(a, sn, cas)
    x[cas::2] *= K_97
    x[1 - cas::2] *= TWO_INV_K
    for parity, c in ((cas, LIFT_97[0]), (1 - cas, LIFT_97[1]), (cas, LIFT_97[2]),
                      (1 - cas, LIFT_97[3])):
        t, left, right = _neighbours(x, parity)
        if len(t):
            t[...] = t + (left + right) * c
    return x


def _idwt(buf: np.ndarray, res_list: list, reversible: bool) -> np.ndarray:
    """Inverse DWT of one tile component in the deinterleaved layout:
    each level's rows, then its columns."""
    f = _idwt53 if reversible else _idwt97
    for r in range(1, len(res_list)):
        prev, cur = res_list[r - 1], res_list[r]
        rw, rh = cur.x1 - cur.x0, cur.y1 - cur.y0
        if rw == 0 or rh == 0:
            continue
        sn_h, sn_v = prev.x1 - prev.x0, prev.y1 - prev.y0
        buf[:rh, :rw] = f(np.ascontiguousarray(buf[:rh, :rw].T), sn_h, cur.x0 % 2).T
        buf[:rh, :rw] = f(buf[:rh, :rw], sn_v, cur.y0 % 2)
    return buf


# ----------------------------------------------------------- tile decode

def _compiled_t1():
    """``csrc/jpx.cu``, its entry point typed on first use."""
    from ..ops import build

    lib = build.load("jpx")
    fn = lib.jpx_t1_decode
    if fn.argtypes is None:
        i32 = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, i32, i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int32),
                       ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        fn.restype = None
    return lib


def decode_block(data: bytes, w: int, h: int, orient: int, first_plane: int,
                 segments: list[tuple[int, int]], compiled: bool) -> np.ndarray:
    """``jpx_t1.decode_cblock``, compiled or plain."""
    if not compiled:
        return decode_cblock(data, w, h, orient, first_plane, segments)
    out = np.zeros((h, w), np.int32)
    if not segments or first_plane < 0 or w <= 0 or h <= 0:
        return out
    passes = (ctypes.c_int32 * len(segments))(*[p for p, _ in segments])
    lengths = (ctypes.c_int64 * len(segments))(*[n for _, n in segments])
    buf = bytes(data)
    _compiled_t1().jpx_t1_decode(buf, w, h, orient, first_plane, len(segments), passes,
                                 lengths, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def tile_blocks(cs: Codestream, tileno: int):
    """The tile's geometry and, per component, its resolutions after tier
    2: (tile box, [(comp, tile-component box, resolutions)])."""
    tile = cs.tiles.get(tileno)
    if tile is None:
        raise ValueError(f"JPEG 2000 tile {tileno} has no data")
    coding = tile["coding"]
    p, q = tileno % cs.ntx, tileno // cs.ntx
    tx0 = max(cs.tx0 + p * cs.tw_, cs.x0)
    ty0 = max(cs.ty0 + q * cs.th_, cs.y0)
    tx1 = min(cs.tx0 + (p + 1) * cs.tw_, cs.xsiz)
    ty1 = min(cs.ty0 + (q + 1) * cs.th_, cs.ysiz)
    box = (tx0, ty0, tx1, ty1)
    res_by_comp = []
    for c, comp in enumerate(coding.comps):
        if not comp.steps:
            raise ValueError("JPEG 2000 component without quantisation")
        res_by_comp.append([Resolution(box, comp, r, cs.prec[c]) for r in range(comp.levels + 1)])
    data = b"".join(tile["data"])
    _read_packets(data, _packets(cs, coding, box, res_by_comp), res_by_comp)
    return box, coding, res_by_comp


def block_jobs(res_list: list):
    """(resno, band, code-block, tier-1 arguments) of every code-block of
    one tile component that the packets brought passes to: the arguments
    are ``decode_block``'s (data, w, h, orientation, first bit-plane,
    segments as (passes, bytes))."""
    for r, res in enumerate(res_list):
        for band in res.bands:
            if band.empty():
                continue
            for prc in band.precincts:
                for blk in prc["blocks"]:
                    w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
                    if blk.passes and w > 0 and h > 0:
                        yield r, band, blk, (b"".join(blk.chunks), w, h, band.bandno,
                                             band.mb - 1 - blk.zbp,
                                             [tuple(seg) for seg in blk.segs])


def decode_tile(cs: Codestream, tileno: int, compiled: bool) -> tuple[tuple, list[np.ndarray]]:
    """One tile: its box and each component's samples after the inverse
    DWT, MCT, DC shift and clamp (int32)."""
    box, coding, res_by_comp = tile_blocks(cs, tileno)
    tx0, ty0, tx1, ty1 = box
    comps = []
    for c, comp in enumerate(coding.comps):
        res_list = res_by_comp[c]
        buf = np.zeros((ty1 - ty0, tx1 - tx0), np.int32 if comp.reversible else np.float32)
        for r, band, blk, args in block_jobs(res_list):
            vals = decode_block(*args, compiled)
            w, h = args[1], args[2]
            x = blk.x0 - band.x0
            y = blk.y0 - band.y0
            if band.bandno & 1:
                x += res_list[r - 1].x1 - res_list[r - 1].x0
            if band.bandno & 2:
                y += res_list[r - 1].y1 - res_list[r - 1].y0
            if comp.reversible:
                buf[y:y + h, x:x + w] = np.sign(vals) * (np.abs(vals) // 2)
            else:
                half = np.float32(np.float32(0.5) * band.stepsize)
                buf[y:y + h, x:x + w] = vals.astype(np.float32) * half
        comps.append(_idwt(buf, res_list, comp.reversible))
    if coding.mct and cs.ncomp >= 3:
        c0, c1, c2 = comps[:3]
        if coding.comps[0].reversible:
            g = c0 - ((c1 + c2) >> 2)
            comps[:3] = [c2 + g, g, c1 + g]
        else:
            y, u, v = c0, c1, c2
            r = y + v * np.float32(1.402)
            g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
            b = y + u * np.float32(1.772)
            comps[:3] = [r, g, b]
    out = []
    for c, comp in enumerate(coding.comps):
        prec, sgnd = cs.prec[c], cs.sgnd[c]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
        shift = 0 if sgnd else 1 << (prec - 1)
        a = comps[c]
        if not comp.reversible:
            a = np.rint(a.astype(np.float32)).astype(np.int64)
        out.append(np.clip(a.astype(np.int64) + shift, lo, hi).astype(np.int32))
    return box, out


# -------------------------------------------------------- Pillow's output

def _unpack8(v: np.ndarray, prec: int, sgnd: bool, bits: int = 8) -> np.ndarray:
    """Pillow's ``j2ku_shift(offset + word, shift)`` of one component, the
    word as OpenJPEG stores it (1, 2 or 4 bytes)."""
    csiz = (prec + 7) >> 3
    mask = {1: 0xFF, 2: 0xFFFF}.get(csiz, 0xFFFFFFFF)
    word = v.astype(np.int64) & mask
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        r = (offset + word) >> -shift
    else:
        r = (offset + word) << shift
    return (r & ((1 << bits) - 1)).astype(np.uint16 if bits == 16 else np.uint8)


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Pillow's ``ImagingConvertYCbCr2RGB`` (its tables at scale 6)."""
    r_cr, g_cb, g_cr, b_cb = (np.asarray(t, np.int32) for t in (R_CR, G_CB, G_CR, B_CB))
    y = y.astype(np.int32)
    r = y + (r_cr[cr] >> 6)
    g = y + ((g_cb[cb] + g_cr[cr]) >> 6)
    b = y + (b_cb[cb] >> 6)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def jpx_mode(data: bytes, compiled: bool | None = None) -> tuple[str, np.ndarray]:
    """JPEG 2000 bytes (JP2 or a codestream) -> (PIL's mode, its samples):
    ``L`` (H, W), ``I;16`` (H, W) uint16, ``LA`` (H, W, 2), ``RGB`` (H, W,
    3) or ``RGBA`` (H, W, 4)."""
    if compiled is None:
        from ..ops import build

        compiled = build.host_compiled()
    data = bytes(data)
    if data[:4] == J2K_SIG:
        codestream, header = data, None
    elif data[:12] == JP2_SIG:
        codestream, header = jp2_codestream(data)
    else:
        raise ValueError("not a JPEG 2000 file")
    cs = Codestream(codestream)
    if header is None:
        nc, width, height = cs.ncomp, cs.xsiz - cs.x0, cs.ysiz - cs.y0
        mode = ("I;16" if cs.prec[0] > 8 else "L") if nc == 1 else ("LA", "RGB", "RGBA")[nc - 2]
        space = "unspecified"
    else:
        if header.get("palette"):
            raise not_ported("JPEG 2000 palette images", "pdfio")
        nc, width, height = header["nc"], header["width"], header["height"]
        if nc == 1:
            mode = "I;16" if (header["bpc"] & 0x7F) > 8 else "L"
        elif 2 <= nc <= 4:
            mode = ("LA", "RGB", "RGBA")[nc - 2]
        else:
            raise ValueError("unable to determine JP2 image mode")
        space = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}.get(
            header.get("enumcs"), "unspecified")
        if (width, height) != (cs.xsiz - cs.x0, cs.ysiz - cs.y0):
            raise ValueError("JP2 header and codestream disagree on the size")
    n = cs.ncomp
    if space == "unspecified" or (space == "gray" and n == 4):
        space = "gray" if n <= 2 else "srgb"
    if space == "cmyk" and n == 4:
        raise not_ported("CMYK JPEG 2000 images", "pdfio")
    check_size(width, height)
    # Pillow's j2k_unpackers: (mode, OpenJPEG's colour space, components)
    if not ((mode in ("L", "I;16") and (space, n) == ("gray", 1))
            or (mode == "LA" and (space, n) == ("gray", 2))
            or (mode in ("RGB", "RGBA") and ((space == "gray" and n <= 2)
                                             or (space in ("srgb", "sycc") and n >= 3)))):
        raise ValueError(f"no Pillow unpacker for {mode} from {n} components in {space}")
    channels = {"L": 1, "I;16": 1, "LA": 4, "RGB": 4, "RGBA": 4}[mode]
    img = np.zeros((height, width, channels), np.uint16 if mode == "I;16" else np.uint8)
    for tileno in sorted(cs.tiles):
        (tx0, ty0, tx1, ty1), comps = decode_tile(cs, tileno, compiled)
        x0, y0 = tx0 - cs.x0, ty0 - cs.y0
        if tx1 - cs.x0 > width or ty1 - cs.y0 > height:
            raise ValueError("JPEG 2000 tile outside the image")
        u = [_unpack8(v, cs.prec[c], cs.sgnd[c], 16 if mode == "I;16" else 8)
             for c, v in enumerate(comps)]
        region = img[y0:y0 + (ty1 - ty0), x0:x0 + (tx1 - tx0)]
        if mode in ("L", "I;16"):
            region[..., 0] = u[0]
            continue
        if space == "gray":  # j2ku_gray_rgb and j2ku_graya_la
            region[..., 0] = region[..., 1] = region[..., 2] = u[0]
        elif space == "sycc":  # j2ku_sycc_rgb and j2ku_sycca_rgba
            region[..., :3] = _ycbcr_to_rgb(u[0], u[1], u[2])
        else:  # j2ku_srgb_rgb and j2ku_srgba_rgba
            region[..., 0], region[..., 1], region[..., 2] = u[0], u[1], u[2]
        # alpha: the second of two components, the fourth of four
        region[..., 3] = u[n - 1] if mode in ("LA", "RGBA") and n in (2, 4) else 255
    if mode in ("L", "I;16"):
        return mode, img[..., 0]
    if mode == "LA":
        return mode, img[..., [0, 3]]
    if mode == "RGB":
        return mode, img[..., :3]
    return mode, img


def decode_jpx(data: bytes) -> np.ndarray:
    """JPEG 2000 bytes -> what ``images_to_pdf`` embeds."""
    from .pil_modes import embed_pixels

    return embed_pixels(*jpx_mode(data))
