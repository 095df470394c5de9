"""JPEG decoder, equal on every pixel to PIL's libjpeg-turbo decode.

The JAX package decodes a PDF's DCTDecode streams with PIL
(``rapiddoc_tpu/pdfio/images.py``), which runs libjpeg-turbo with its
defaults. The card's machine has no PIL, and the OCR models flip near-tie
characters on a change of one LSB, so this decoder replays libjpeg-turbo's
arithmetic exactly:

1. the entropy decode into int16 coefficient blocks: sequential Huffman
   scans (symbols, DC prediction, restart intervals) and progressive
   ones as ``jdphuff.c`` decodes them (DC first and refinement scans, AC
   first scans with end-of-band runs and AC refinement scans with their
   correction bits). ``decode_coefficients_plain`` runs it in Python, one
   symbol at a time. ``csrc/jpeg_entropy.cu`` is the same decode
   compiled: host code only, built by nvcc like the kernels
   (``ops/build.py``) and loaded with ctypes. With a card present
   ``decode_jpeg`` uses the compiled one, with no fallback; without one
   it uses the plain one.
2. dequantisation and the ISLOW integer IDCT of ``jidctint.c``
   (CONST_BITS 13, PASS1_BITS 2, the IDCT range limit), on all blocks at
   once in numpy;
3. the upsampling of ``jdsample.c`` as libjpeg-turbo 3 picks it: fancy
   (triangle-filter) h2v1 with its +1/+2 biases, h2v2 with +8/+7 and h1v2
   with +1/+2, the first and last columns and the context rows at the
   top and bottom of the image as libjpeg makes them; plain replication
   (``int_upsample``) for every other integral factor and where an h2
   component is at most 2 samples wide;
4. the colour conversion of ``jdcolor.c``: fixed-point YCbCr->RGB
   (SCALEBITS 16), RGB-coded and CMYK samples as they are, YCCK->CMYK
   (``ycck_cmyk_convert``); the colour space is libjpeg's guess from the
   JFIF and Adobe markers and the component ids. PIL reads every
   four-component JPEG with its ``CMYK;I`` rawmode, so CMYK comes out
   inverted (255 - value), as in PIL's image.

Steps 2-4 are shared by both entropy decoders. libjpeg-turbo's block
smoothing of progressive images (``jdcoefct.c`` decompress_smooth_data)
applies only where a component's scans leave low AC coefficients
unrefined; the progressive streams encoders write (PIL's among them)
end every coefficient at Al = 0 and never reach it, and a stream that
would raises NotImplementedError. So do arithmetic-coded, lossless,
hierarchical and 12-bit JPEGs. Corrupt entropy data raises JpegError
where libjpeg would warn and carry on, and so does what PIL refuses (two
components, fractional sampling factors, a bad progression, a frame past
its decompression bomb limit, ``pil_modes.check_size``).
"""
from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass, field

import numpy as np

from ..utils.unported import not_ported
from .pil_modes import check_size


class JpegError(ValueError):
    """Corrupt or truncated JPEG data."""


# jpeg_natural_order: zigzag index -> row-major position in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
_ZZ = ZIGZAG.tolist()

# the terminating marker of a scan (not stuffing, not a restart marker),
# after any fill bytes
_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+([\xd0-\xd7])")

_SOF_NOT_PORTED = {
    0xC3: "lossless JPEG",
    0xC5: "hierarchical JPEG", 0xC6: "hierarchical JPEG", 0xC7: "hierarchical JPEG",
    0xC9: "arithmetic-coded JPEG", 0xCA: "arithmetic-coded JPEG",
    0xCB: "arithmetic-coded JPEG", 0xCD: "arithmetic-coded JPEG",
    0xCE: "arithmetic-coded JPEG", 0xCF: "arithmetic-coded JPEG",
}

# errors the compiled decoder returns
_ERRORS = {
    -1: "bad Huffman code",
    -2: "coefficient index past 63",
    -3: "premature end of entropy-coded data",
    -4: "missing or misplaced restart marker",
    -5: "bad number of components in a scan",
}

# jpeg_natural_order with libjpeg's 16 guard entries: a corrupt run past
# coefficient 63 lands on 63
_NATURAL = _ZZ + [63] * 16
# libjpeg-turbo's smoothing_ok: coefficients 0-9 (SAVED_COEFS) and the
# quantisers it requires nonzero, as natural-order positions
_SMOOTH_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
_NO_TABLE = np.zeros(1 << 16, np.uint16)


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    # latched at the component's first scan, natural order
    qtable: np.ndarray | None = None
    blocks_h: int = 0  # block grid allocated: MCU rows x v
    blocks_w: int = 0  # MCU columns x h
    offset: int = 0  # first block in the coefficient buffer


@dataclass
class Scan:
    comps: list[int]  # indices into JpegStream.components
    luts: list[np.ndarray]  # dc, ac Huffman lookup for each scan component
    begin: int  # entropy-coded bytes data[begin:end]
    end: int
    restart_interval: int
    # spectral selection and successive approximation (progressive scans)
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0


@dataclass
class JpegStream:
    data: bytes
    width: int
    height: int
    components: list[Component]
    scans: list[Scan] = field(default_factory=list)
    hmax: int = 1
    vmax: int = 1
    progressive: bool = False
    # libjpeg's jpeg_color_space: grey, ycc, rgb, cmyk or ycck
    colorspace: str = "grey"

    @property
    def mcus_x(self) -> int:
        return -(-self.width // (8 * self.hmax))

    @property
    def mcus_y(self) -> int:
        return -(-self.height // (8 * self.vmax))

    @property
    def n_blocks(self) -> int:
        return sum(c.blocks_h * c.blocks_w for c in self.components)

    def comp_size(self, c: Component) -> tuple[int, int]:
        """downsampled_width, downsampled_height of libjpeg."""
        return (-(-self.width * c.h // self.hmax), -(-self.height * c.v // self.vmax))


def huffman_lut(counts: bytes, values: bytes) -> np.ndarray:
    """16-bit lookahead table of a Huffman table: entry (length << 8) |
    symbol for every 16-bit window that starts with a code, 0 where none
    does."""
    lut = np.zeros(1 << 16, np.uint16)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length or k >= len(values):
                raise JpegError("bad Huffman table")
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = (length << 8) | values[k]
            code += 1
            k += 1
        code <<= 1
    return lut


def parse_jpeg(data: bytes) -> JpegStream:
    """Markers of a JPEG stream: the frame, its tables and each scan's
    place in ``data``. Raises NotImplementedError for what the decoder
    does not take and JpegError for a malformed stream."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG stream (no SOI marker)")
    qtables: dict[int, np.ndarray] = {}
    htables: dict[tuple[int, int], np.ndarray] = {}
    restart = 0
    jfif = False
    adobe_transform: int | None = None
    frame: JpegStream | None = None
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise JpegError(f"expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise JpegError("truncated marker segment")
        length = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            raise JpegError("truncated marker segment")
        pos += length
        if marker in (0xC0, 0xC1, 0xC2):  # sequential, progressive Huffman
            if frame is not None:
                raise JpegError("two frames in one stream")
            if seg[0] != 8:
                raise not_ported(f"{seg[0]}-bit JPEG", "pdfio")
            height = int.from_bytes(seg[1:3], "big")
            width = int.from_bytes(seg[3:5], "big")
            if height == 0:
                raise not_ported("a JPEG whose height is set by a DNL marker", "pdfio")
            comps = [Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                               seg[8 + 3 * i]) for i in range(seg[5])]
            if width == 0 or not comps or any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in comps):
                raise JpegError("bad frame header")
            check_size(width, height)
            frame = JpegStream(data, width, height, comps,
                               hmax=max(c.h for c in comps), vmax=max(c.v for c in comps),
                               progressive=marker == 0xC2)
            frame.colorspace = _colorspace(frame, jfif, adobe_transform)
            coef_bits = [[-1] * 64 for _ in comps]
            for c in comps:
                c.blocks_h, c.blocks_w = frame.mcus_y * c.v, frame.mcus_x * c.h
            for c, prev in zip(comps[1:], comps):
                c.offset = prev.offset + prev.blocks_h * prev.blocks_w
        elif marker in _SOF_NOT_PORTED:
            raise not_ported(_SOF_NOT_PORTED[marker], "pdfio")
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                values = seg[i + 17:i + 17 + total]
                if tc > 1 or len(counts) != 16 or len(values) != total:
                    raise JpegError("bad DHT segment")
                if tc == 0 and any(v > 15 for v in values):
                    raise JpegError("bad DC Huffman table")
                htables[(tc, th)] = huffman_lut(counts, values)
                i += 17 + total
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = seg[i + 1:i + 1 + size]
                if len(raw) != size:
                    raise JpegError("bad DQT segment")
                zz = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int64)
                q = np.empty(64, np.int64)
                q[ZIGZAG] = zz
                qtables[tq] = q
                i += 1 + size
        elif marker == 0xDD:  # DRI
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xE0 and length >= 16 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and length >= 14 and seg[:5] == b"Adobe":
            adobe_transform = seg[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JpegError("scan before frame")
            ns = seg[0]
            if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:  # as get_sos
                raise JpegError(_ERRORS[-5])
            idxs, tables = [], []
            comps = frame.components
            for k in range(ns):
                cid, sel = seg[1 + 2 * k], seg[2 + 2 * k]
                # get_sos: the first frame component at or after scan slot
                # k whose id matches (so the scan keeps the frame's order)
                ci = next((i for i in range(k, min(len(comps), 4)) if comps[i].cid == cid),
                          None)
                if ci is None:
                    raise JpegError("scan names an unknown component")
                if ci in idxs:  # libjpeg decodes it twice; no encoder writes it
                    raise JpegError("scan names one component twice")
                comp = frame.components[ci]
                if comp.qtable is None:  # libjpeg latches at the first scan
                    if comp.tq not in qtables:
                        raise JpegError("component uses an undefined quantisation table")
                    comp.qtable = qtables[comp.tq]
                idxs.append(ci)
                tables.append(sel)
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if frame.progressive:
                _check_progression(ss, se, ah, al, ns)
                for ci in idxs:  # coef_bits: the Al each coefficient was last coded at
                    coef_bits[ci][ss:se + 1] = [al] * (se - ss + 1)
                need_dc, need_ac = ss == 0 and ah == 0, ss > 0
            else:
                if (ss, se, ahal) != (0, 63, 0):
                    raise not_ported("a JPEG scan with spectral selection", "pdfio")
                need_dc = need_ac = True
            luts = []
            try:
                for sel in tables:
                    luts += [htables[(0, sel >> 4)] if need_dc else _NO_TABLE,
                             htables[(1, sel & 15)] if need_ac else _NO_TABLE]
            except KeyError:
                raise JpegError("scan uses an undefined Huffman table") from None
            if ns > 1 and sum(frame.components[i].h * frame.components[i].v for i in idxs) > 10:
                raise JpegError("too many blocks in an MCU")
            m = _SCAN_END.search(data, pos)
            end = m.start() if m else n
            frame.scans.append(Scan(idxs, luts, pos, end, restart, ss, se, ah, al))
            pos = end
    if frame is None or not frame.scans:
        raise JpegError("no frame or no scan")
    if any(c.qtable is None for c in frame.components):
        raise JpegError("a component is in no scan")
    if frame.progressive and _smoothing_ok(frame, coef_bits):
        raise not_ported("a progressive JPEG that libjpeg block-smooths", "pdfio")
    return frame


def _colorspace(frame: JpegStream, jfif: bool, adobe_transform: int | None) -> str:
    """libjpeg's default_decompress_parms guess of the colour space, and
    what PIL refuses: other component counts, and sampling factors that
    do not divide the largest (jdsample.c's JERR_FRACT_SAMPLE_NOTIMPL)."""
    comps = frame.components
    for c in comps:
        if frame.hmax % c.h or frame.vmax % c.v:
            raise JpegError(f"fractional sampling {c.h}x{c.v} of {frame.hmax}x{frame.vmax}")
    if len(comps) == 1:
        return "grey"
    if len(comps) == 3:
        ids = tuple(c.cid for c in comps)
        rgb = (not jfif) and (adobe_transform == 0 if adobe_transform is not None
                              else ids == (82, 71, 66))
        return "rgb" if rgb else "ycc"
    if len(comps) == 4:
        return "ycck" if adobe_transform not in (None, 0) else "cmyk"
    raise JpegError(f"a {len(comps)}-component JPEG (PIL reads 1, 3 or 4)")


def _check_progression(ss: int, se: int, ah: int, al: int, ns: int) -> None:
    """start_pass_phuff_decoder's checks of a progressive scan."""
    bad = se != 0 if ss == 0 else (ss > se or se >= 64 or ns != 1)
    if ah != 0 and al != ah - 1:
        bad = True
    if bad or al > 13:
        raise JpegError(f"bad progression Ss={ss} Se={se} Ah={ah} Al={al}")


def _smoothing_ok(frame: JpegStream, coef_bits: list) -> bool:
    """libjpeg-turbo 3's smoothing_ok after the last scan: every
    component's DC coded and its first quantisers nonzero, and some
    coefficient 1-9 of some component not refined to Al = 0."""
    useful = False
    for c, bits in zip(frame.components, coef_bits):
        if any(c.qtable[i] == 0 for i in _SMOOTH_Q) or bits[0] < 0:
            return False
        if any(b != 0 for b in bits[1:10]):
            useful = True
    return useful


def scan_units(jpeg: JpegStream, scan: Scan):
    """(MCU columns, MCU rows, per scan component (h, v, blocks_w,
    offset)): a scan of one component has one block an MCU over that
    component's own block grid (jdinput.c per_scan_setup)."""
    if len(scan.comps) == 1:
        c = jpeg.components[scan.comps[0]]
        w, h = jpeg.comp_size(c)
        return -(-w // 8), -(-h // 8), [(1, 1, c.blocks_w, c.offset)]
    return jpeg.mcus_x, jpeg.mcus_y, [
        (jpeg.components[i].h, jpeg.components[i].v, jpeg.components[i].blocks_w,
         jpeg.components[i].offset) for i in scan.comps
    ]


def _segments(data: bytes, begin: int, end: int, count: int):
    """The scan's ``count`` restart segments, unstuffed, one at a time.
    Each restart marker is checked against the RST0-7 cycle only when the
    decode reaches it, and a marker after the last segment at the end, so
    that a stream with more than one fault raises what the compiled
    decoder returns: the first fault in the order of decoding. A 0xFF
    that ends the data (a cut) ends the segment, as a marker does."""
    markers = list(_RESTART.finditer(data, begin, end))
    start = begin
    for i in range(count):
        if i:
            if i > len(markers) or markers[i - 1].group(1)[0] != 0xD0 + (i - 1) % 8:
                raise JpegError(_ERRORS[-4])
            start = markers[i - 1].end()
        stop = markers[i].start() if i < len(markers) else end
        yield data[start:stop].rstrip(b"\xff").replace(b"\xff\x00", b"\xff")
    if len(markers) >= count:
        raise JpegError(_ERRORS[-4])


def decode_coefficients_plain(jpeg: JpegStream) -> np.ndarray:
    """The entropy decode in Python: (n_blocks, 64) int16 coefficients in
    natural order, the components one after another (Component.offset)."""
    out = np.zeros((jpeg.n_blocks, 64), np.int16)
    flat = out.reshape(-1)
    for scan in jpeg.scans:
        mcus_x, mcus_y, units = scan_units(jpeg, scan)
        total = mcus_x * mcus_y
        ri = scan.restart_interval or total
        segs = _segments(jpeg.data, scan.begin, scan.end, -(-total // ri))
        blocks = [
            (k, by, bx, bw, off, scan.luts[2 * k].tolist(), scan.luts[2 * k + 1].tolist())
            for k, (h, v, bw, off) in enumerate(units)
            for by in range(v) for bx in range(h)
        ]
        hv = [(h, v) for h, v, _, _ in units]
        if jpeg.progressive:
            _decode_scan_progressive(scan, segs, ri, total, mcus_x, blocks, hv, flat)
            continue
        idx: list[int] = []
        val: list[int] = []
        for si, seg in enumerate(segs):
            _decode_segment(seg, range(si * ri, min((si + 1) * ri, total)), mcus_x,
                            blocks, hv, idx, val)
        if idx:
            flat[np.asarray(idx, np.int64)] = np.asarray(val, np.int64).astype(np.int16)
    return out


def _i16(v: int) -> int:
    """A value stored in a JCOEF (int16), wrapped as C does."""
    return ((v + 32768) & 0xFFFF) - 32768


def _decode_scan_progressive(scan, segs, ri, total, mcus_x, blocks, hv, flat) -> None:
    """One progressive scan, segment by segment, over the coefficients in
    ``flat``: the blocks it touches are read into Python ints (the DC
    values for a DC scan, whole blocks for an AC scan), refined and
    written back."""
    bases = []
    for mcu in range(total):
        my, mx = divmod(mcu, mcus_x)
        for k, by, bx, bw, off, _, _ in blocks:
            h, v = hv[k]
            bases.append((off + (my * v + by) * bw + mx * h + bx) * 64)
    cols = np.asarray(bases, np.int64)
    if scan.ss:
        cols = cols[:, None] + np.arange(64)
    coef = flat[cols].astype(np.int64).tolist()
    per_mcu = len(blocks)
    for si, seg in enumerate(segs):
        start, stop = si * ri, min((si + 1) * ri, total)
        _progressive_segment(seg, scan, blocks, coef, start * per_mcu, (stop - start) * per_mcu,
                             per_mcu)
    flat[cols] = np.asarray(coef, np.int64).astype(np.int16)


def _progressive_segment(seg: bytes, scan: Scan, units, coef, first: int, count: int,
                         per_mcu: int) -> None:
    """One restart segment of a progressive scan (jdphuff.c): ``count``
    blocks from block ``first`` of ``coef`` (DC values for a DC scan,
    64-entry natural-order rows for an AC scan, which has one block an
    MCU); ``units`` are the MCU's blocks (component, ..., DC and AC
    lookahead tables); predictions and the end-of-band run start from
    0."""
    n_real = len(seg) * 8
    b = np.frombuffer(seg + bytes(8), np.uint8).astype(np.uint32)
    win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    preds = [0] * per_mcu
    p = 0
    eobrun = 0
    nat = _NATURAL
    p1, m1 = 1 << al, -(1 << al)

    def bad(code):
        return JpegError(_ERRORS[-3 if p > n_real else code])

    try:
        for i in range(first, first + count):
            if ss == 0:
                unit = units[(i - first) % per_mcu]
                comp, dclut = unit[0], unit[5]
                if ah == 0:  # DC first
                    e = dclut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise bad(-1)
                    p += e >> 8
                    s = e & 255
                    if s:
                        r = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                        p += s
                        if r < 1 << (s - 1):
                            r -= (1 << s) - 1
                        preds[comp] += r
                    coef[i] = _i16(preds[comp] * p1)
                else:  # DC refinement: one bit
                    if (win[p >> 3] >> (31 - (p & 7))) & 1:
                        coef[i] = _i16(coef[i] | p1)
                    p += 1
            elif ah == 0:  # AC first
                if eobrun:
                    eobrun -= 1
                else:
                    row = coef[i]
                    lut = units[0][6]
                    k = ss
                    while k <= se:
                        e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise bad(-1)
                        p += e >> 8
                        rs = e & 255
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            v = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                            p += s
                            if v < 1 << (s - 1):
                                v -= (1 << s) - 1
                            row[nat[k]] = _i16(v * p1)
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - r)
                                p += r
                            eobrun -= 1
                            break
                        k += 1
            else:  # AC refinement
                row = coef[i]
                lut = units[0][6]
                k = ss
                if eobrun == 0:
                    while k <= se:
                        e = lut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise bad(-1)
                        p += e >> 8
                        rs = e & 255
                        r, s = rs >> 4, rs & 15
                        if s:
                            bit = (win[p >> 3] >> (31 - (p & 7))) & 1
                            p += 1
                            s = p1 if bit else m1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - r)
                                p += r
                            break
                        while True:  # skip r zero coefficients, correcting the nonzero
                            pos = nat[k]
                            if row[pos] != 0:
                                if (win[p >> 3] >> (31 - (p & 7))) & 1:
                                    if row[pos] & p1 == 0:
                                        row[pos] = _i16(row[pos] + (p1 if row[pos] >= 0 else m1))
                                p += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                            if k > se:
                                break
                        if s:
                            row[nat[k]] = s
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        pos = nat[k]
                        if row[pos] != 0:
                            if (win[p >> 3] >> (31 - (p & 7))) & 1:
                                if row[pos] & p1 == 0:
                                    row[pos] = _i16(row[pos] + (p1 if row[pos] >= 0 else m1))
                            p += 1
                        k += 1
                    eobrun -= 1
            if p > n_real:
                raise JpegError(_ERRORS[-3])
    except IndexError:
        raise JpegError(_ERRORS[-3]) from None


def _decode_segment(seg: bytes, mcus: range, mcus_x: int, blocks, hv, idx, val) -> None:
    """One restart segment: the MCUs in ``mcus``, DC predictors from 0.
    Appends each nonzero coefficient's flat position and value."""
    n_real = len(seg) * 8
    b = np.frombuffer(seg + bytes(8), np.uint8).astype(np.uint32)
    # the 32 bits from each byte on, so that any 16-bit peek or receive
    # of up to 16 bits at bit p is one shift of win[p >> 3]
    win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    preds = [0] * len(hv)
    zz = _ZZ
    push_i, push_v = idx.append, val.append
    p = 0
    try:
        for mcu in mcus:
            my, mx = divmod(mcu, mcus_x)
            for k, by, bx, bw, off, dclut, aclut in blocks:
                h, v = hv[k]
                base = (off + (my * v + by) * bw + mx * h + bx) * 64
                e = dclut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise JpegError(_ERRORS[-3 if p > n_real else -1])
                p += e >> 8
                s = e & 255
                if s:
                    r = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                    p += s
                    if r < 1 << (s - 1):
                        r -= (1 << s) - 1
                    preds[k] += r
                if preds[k]:
                    push_i(base)
                    push_v(preds[k])
                z = 1
                while z < 64:
                    e = aclut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise JpegError(_ERRORS[-3 if p > n_real else -1])
                    p += e >> 8
                    rs = e & 255
                    s = rs & 15
                    if s:
                        z += rs >> 4
                        if z > 63:
                            raise JpegError(_ERRORS[-3 if p > n_real else -2])
                        r = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                        p += s
                        if r < 1 << (s - 1):
                            r -= (1 << s) - 1
                        push_i(base + zz[z])
                        push_v(r)
                        z += 1
                    elif rs == 0xF0:
                        z += 16
                    else:
                        break
                if p > n_real:
                    raise JpegError(_ERRORS[-3])
    except IndexError:
        raise JpegError(_ERRORS[-3]) from None


def _entropy_decoder(progressive: bool = False):
    """``jpeg_entropy_decode`` (or ``jpeg_progressive_decode``) of
    ``csrc/jpeg_entropy.cu``, built and loaded once per process
    (ops/build.py), its C signature declared."""
    from ..ops import build

    lib = build.load("jpeg_entropy")
    fn = lib.jpeg_progressive_decode if progressive else lib.jpeg_entropy_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_int] * (4 if progressive else 0) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_coefficients_compiled(jpeg: JpegStream) -> np.ndarray:
    """The same entropy decode through ``csrc/jpeg_entropy.cu``; raises
    JpegError where the plain version does."""
    fn = _entropy_decoder(jpeg.progressive)
    out = np.zeros((jpeg.n_blocks, 64), np.int16)
    for scan in jpeg.scans:
        mcus_x, mcus_y, units = scan_units(jpeg, scan)
        luts = np.ascontiguousarray(np.stack(scan.luts))
        comp = np.ascontiguousarray(np.asarray(units, np.int32))
        args = [jpeg.data, scan.begin, scan.end, luts.ctypes.data, len(units),
                comp.ctypes.data, mcus_x, mcus_y, scan.restart_interval]
        if jpeg.progressive:
            args += [scan.ss, scan.se, scan.ah, scan.al]
        rc = fn(*args, out.ctypes.data)
        if rc != 0:
            raise JpegError(_ERRORS.get(rc, f"the entropy decoder returned {rc}"))
    return out


# ------------------------------------------------------------- after entropy

def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _islow_1d(d: list[np.ndarray], shift: int) -> list[np.ndarray]:
    """One pass of jpeg_idct_islow over the 8 inputs ``d`` (int64 arrays),
    descaled by ``shift``."""
    z1 = (d[2] + d[6]) * 4433  # FIX_0_541196100
    tmp2 = z1 + d[6] * -15137  # FIX_1_847759065
    tmp3 = z1 + d[2] * 6270  # FIX_0_765366865
    tmp0 = (d[0] + d[4]) << 13
    tmp1 = (d[0] - d[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633  # FIX_1_175875602
    t0 = t0 * 2446  # FIX_0_298631336
    t1 = t1 * 16819  # FIX_2_053119869
    t2 = t2 * 25172  # FIX_3_072711026
    t3 = t3 * 12299  # FIX_1_501321110
    z1 = z1 * -7373  # FIX_0_899976223
    z2 = z2 * -20995  # FIX_2_562915447
    z3 = z3 * -16069 + z5  # FIX_1_961570560
    z4 = z4 * -3196 + z5  # FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(x, shift) for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


# One pass of _islow_1d keeps every intermediate within 120 000 x the
# largest input (the sum of the constants' magnitudes along its longest
# chain), so inputs up to this bound run in int32 with libjpeg's 64-bit
# results; larger ones (corrupt data) run in int64.
_INT32_SAFE = (2**31 - 1) // 120_000


def _narrow(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int32) if int(np.abs(x).max(initial=0)) <= _INT32_SAFE else x


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow on (N, 64) natural-order coefficients: (N, 8, 8)
    uint8 samples, range-limited as libjpeg's table does (the 10-bit wrap
    of ``& RANGE_MASK``, then the clamp)."""
    z = _narrow((coef.astype(np.int64) * qtable).reshape(-1, 8, 8))
    cols = _islow_1d([z[:, k, :] for k in range(8)], 11)  # CONST_BITS - PASS1_BITS
    ws = _narrow(np.stack(cols, axis=1).astype(np.int64))
    rows = _islow_1d([ws[:, :, k] for k in range(8)], 18)  # CONST_BITS + PASS1_BITS + 3
    x = np.stack(rows, axis=2)
    x = ((x & 1023) ^ 512) - 512
    return np.clip(x + 128, 0, 255).astype(np.uint8)


def component_planes(jpeg: JpegStream, coefs: np.ndarray) -> list[np.ndarray]:
    """Each component's samples over its whole block grid (uint8)."""
    planes = []
    for c in jpeg.components:
        n = c.blocks_h * c.blocks_w
        blocks = idct_islow(coefs[c.offset:c.offset + n], c.qtable)
        planes.append(blocks.reshape(c.blocks_h, c.blocks_w, 8, 8)
                      .transpose(0, 2, 1, 3).reshape(c.blocks_h * 8, c.blocks_w * 8))
    return planes


def _fancy_h2(c: np.ndarray, bias_left: int, bias_right: int, shift: int) -> np.ndarray:
    """Horizontal triangle filter: out[2i] = (3c[i] + c[i-1] + bias_left)
    >> shift, out[2i+1] = (3c[i] + c[i+1] + bias_right) >> shift, with the
    edge samples repeated (which gives libjpeg's special first and last
    columns)."""
    left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    out = np.empty((c.shape[0], 2 * c.shape[1]), np.int32)
    out[:, 0::2] = (3 * c + left + bias_left) >> shift
    out[:, 1::2] = (3 * c + right + bias_right) >> shift
    return out


def upsample(plane: np.ndarray, dw: int, dh: int, fh: int, fv: int) -> np.ndarray:
    """A component of dw x dh real samples to full size, as libjpeg-turbo
    3's jdsample.c picks the method: h2v1_fancy_upsample,
    h2v2_fancy_upsample (context rows: the first row above the top, the
    last real row below the bottom) and h1v2_fancy_upsample; replication
    (h2v1_upsample, h2v2_upsample, int_upsample) for every other integral
    factor and where an h2 component is at most 2 samples wide."""
    s = plane[:dh, :dw].astype(np.int32)
    if (fh, fv) == (1, 1):
        return s
    if (fh, fv) == (1, 2):
        above = np.concatenate([s[:1], s[:-1]], axis=0)
        below = np.concatenate([s[1:], s[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * s + above + 1) >> 2
        out[1::2] = (3 * s + below + 2) >> 2
        return out
    if fh != 2 or fv > 2 or dw <= 2:
        return np.repeat(np.repeat(s, fh, axis=1), fv, axis=0)
    if fv == 1:
        return _fancy_h2(s, 1, 2, 2)
    above = np.concatenate([s[:1], s[:-1]], axis=0)
    below = np.concatenate([s[1:], s[-1:]], axis=0)
    out = np.empty((2 * dh, 2 * dw), np.int32)
    out[0::2] = _fancy_h2(3 * s + above, 8, 7, 4)
    out[1::2] = _fancy_h2(3 * s + below, 8, 7, 4)
    return out


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v: float) -> int:
        return int(v * (1 << 16) + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16,  # Cr_r_tab
            (fix(1.77200) * x + one_half) >> 16,  # Cb_b_tab
            -fix(0.71414) * x,  # Cr_g_tab
            -fix(0.34414) * x + one_half)  # Cb_g_tab


_CR_R, _CB_B, _CR_G, _CB_G = (t.astype(np.int32) for t in _ycc_tables())


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on int arrays of samples."""
    out = np.empty(y.shape + (3,), np.uint8)
    for ch, v in enumerate((y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb])):
        np.clip(v, 0, 255, out=v)
        out[..., ch] = v
    return out


def reconstruct(jpeg: JpegStream, coefs: np.ndarray) -> np.ndarray:
    """Coefficients to pixels as PIL's image holds them: (H, W) uint8 for
    grey, (H, W, 3) RGB, (H, W, 4) CMYK inverted (PIL's ``CMYK;I``)."""
    planes = component_planes(jpeg, coefs)
    full = []
    for c, plane in zip(jpeg.components, planes):
        dw, dh = jpeg.comp_size(c)
        up = upsample(plane, dw, dh, jpeg.hmax // c.h, jpeg.vmax // c.v)
        full.append(up[:jpeg.height, :jpeg.width])
    cs = jpeg.colorspace
    if cs == "grey":
        return full[0].astype(np.uint8)
    if cs == "ycc":
        return ycc_to_rgb(*full)
    if cs == "rgb":
        return np.stack(full, axis=-1).astype(np.uint8)
    if cs == "ycck":
        full[:3] = [255 - ycc_to_rgb(*full[:3])[..., i].astype(np.int32) for i in range(3)]
    return 255 - np.stack(full, axis=-1).astype(np.uint8)


def cmyk_to_rgb_pil(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of a CMYK image (``cmyk2rgb``): each
    channel ``255 - k - c * (255 - k) / 255`` with Pillow's rounded
    division, clipped."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG stream to its pixels as PIL's ``Image.open(...)`` gives them
    (mode L as (H, W), RGB as (H, W, 3), CMYK as PIL's inverted (H, W,
    4)), through the compiled entropy decoder where a card is present and
    the plain one where none is (``ops.build.host_compiled``)."""
    from ..ops import build

    jpeg = parse_jpeg(data)
    if build.host_compiled():
        return reconstruct(jpeg, decode_coefficients_compiled(jpeg))
    return reconstruct(jpeg, decode_coefficients_plain(jpeg))
