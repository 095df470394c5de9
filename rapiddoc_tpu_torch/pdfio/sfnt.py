"""A TrueType/OpenType (sfnt) reader: the tables FreeType and HarfBuzz
read when PIL draws text with such a face.

Outlines (``glyf`` simple and composite glyphs, or a ``CFF `` table read
by ``cff``), metrics (``head``, ``hhea``, ``hmtx``, ``OS/2``), the
character map FreeType selects (``cmap`` formats 0, 4, 6 and 12), glyph
names (``post``), pair kerning (``kern`` format 0 and GPOS lookup type 2,
formats 1 and 2) and ligatures (GSUB lookup type 4). ``tests/
test_torch_fonts.py`` holds the outlines, metrics and maps to fontTools'
reading of the same bytes.

FreeType selects a Unicode charmap when it opens a face: a UCS-4 one
((3, 10) or (0, 4|6)) if there is one, else the last Unicode subtable in
the table's order ((0, *) or (3, 1)). A face with only a symbol (3, 0) or
a Macintosh (1, 0) subtable has no charmap at all, so every character is
glyph 0, and HarfBuzz's ``0xF000 + code`` symbol lookup never runs (it
needs a symbol charmap to be selected).
"""
from __future__ import annotations

import struct

import numpy as np

# composite glyph flags
ARG_1_AND_2_ARE_WORDS = 0x0001
ARGS_ARE_XY_VALUES = 0x0002
ROUND_XY_TO_GRID = 0x0004
WE_HAVE_A_SCALE = 0x0008
MORE_COMPONENTS = 0x0020
WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
WE_HAVE_A_TWO_BY_TWO = 0x0080
USE_MY_METRICS = 0x0200
OVERLAP_COMPOUND = 0x0400
SCALED_COMPONENT_OFFSET = 0x0800

# the GSUB/GPOS features applied by default (horizontal text)
GSUB_FEATURES = ("ccmp", "locl", "rlig", "liga", "clig", "calt")
GPOS_FEATURES = ("kern",)

# bitmap strike tables: faces with them are not drawn here
BITMAP_TABLES = (b"EBDT", b"CBDT", b"sbix", b"bdat")


def _u16(b, o):
    return (b[o] << 8) | b[o + 1]


def _s16(b, o):
    v = (b[o] << 8) | b[o + 1]
    return v - 0x10000 if v & 0x8000 else v


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


def _f2dot14(v: int) -> int:
    """A 2.14 value as 16.16 (FreeType shifts it left by 2)."""
    return v * 4


class Glyph:
    """One glyph outline in font units: points (N, 2) int64, on-curve
    flags (1 on, 0 conic control), contour ends, and whether the glyph
    asks for overlap-safe rendering."""

    __slots__ = ("points", "tags", "ends", "overlap", "xmin", "components")

    def __init__(self, points, tags, ends, overlap=False, xmin=0, components=None):
        self.points = points
        self.tags = tags
        self.ends = ends
        self.overlap = overlap
        self.xmin = xmin
        self.components = components


class Sfnt:
    """The tables of one sfnt font program (collections: the first face)."""

    def __init__(self, data: bytes) -> None:
        data = bytes(data)
        if len(data) < 12:
            raise ValueError("not an sfnt font: too short")
        tag = data[:4]
        if tag == b"ttcf":
            off = _u32(data, 12)
        else:
            off = 0
        version = data[off:off + 4]
        if version not in (b"\x00\x01\x00\x00", b"true", b"OTTO", b"typ1"):
            raise ValueError("not an sfnt font: unknown version %r" % version)
        self.data = data
        n = _u16(data, off + 4)
        self.tables: dict[bytes, tuple[int, int]] = {}
        for i in range(n):
            rec = off + 12 + 16 * i
            t = data[rec:rec + 4]
            to, tl = _u32(data, rec + 8), _u32(data, rec + 12)
            if to + tl > len(data):
                raise ValueError("sfnt table %r runs past the end" % t)
            self.tables[t] = (to, tl)
        for req in (b"head", b"maxp", b"hhea", b"hmtx"):
            if req not in self.tables:
                raise ValueError("sfnt font without %r" % req)
        head = self.table(b"head")
        self.units_per_em = _u16(head, 18)
        if not 16 <= self.units_per_em <= 16384:
            raise ValueError("bad unitsPerEm %d" % self.units_per_em)
        self.index_to_loc = _s16(head, 50)
        self.num_glyphs = _u16(self.table(b"maxp"), 4)
        hhea = self.table(b"hhea")
        self.hhea_ascender = _s16(hhea, 4)
        self.hhea_descender = _s16(hhea, 6)
        self.num_hmetrics = _u16(hhea, 34)
        self._parse_hmtx()
        self._parse_os2()
        self.ascender, self.descender = self._face_ascender()
        self.is_cff = b"CFF " in self.tables or b"CFF2" in self.tables
        self.cff = None
        if b"CFF2" in self.tables:
            raise ValueError("CFF2 outlines are not read")
        if self.is_cff:
            from .cff import CFFFont

            self.cff = CFFFont(self.table(b"CFF "))
        elif b"glyf" not in self.tables or b"loca" not in self.tables:
            if not any(t in self.tables for t in BITMAP_TABLES):
                raise ValueError("sfnt font without outlines")
        else:
            self._parse_loca()
        self.has_bitmaps = any(t in self.tables for t in BITMAP_TABLES)
        # TrueType bytecode: FreeType's native hinter runs when the face has
        # an fpgm or a prep; without them it autohints
        self.has_bytecode = (not self.is_cff) and (
            self.tables.get(b"fpgm", (0, 0))[1] > 0 or self.tables.get(b"prep", (0, 0))[1] > 0)
        self.cmap = self._parse_cmap()
        self._glyph_cache: dict[int, Glyph] = {}
        self._gsub = self._gpos = None
        self._kern: dict | None = None

    def table(self, tag: bytes) -> bytes:
        o, n = self.tables[tag]
        return self.data[o:o + n]

    # ---------------------------------------------------------------- metrics

    def _parse_hmtx(self) -> None:
        b = self.table(b"hmtx")
        n = max(1, min(self.num_hmetrics, len(b) // 4))
        adv = np.frombuffer(b, ">u2", n * 2)[0::2].astype(np.int64)
        lsb = np.frombuffer(b, ">i2", n * 2)[1::2].astype(np.int64)
        rest = max(0, min(self.num_glyphs - n, (len(b) - 4 * n) // 2))
        extra = np.frombuffer(b, ">i2", rest, 4 * n).astype(np.int64)
        self.advances = np.concatenate([adv, np.full(max(0, self.num_glyphs - n), adv[-1])])
        self.lsbs = np.concatenate([lsb, extra, np.zeros(max(0, self.num_glyphs - n - rest), np.int64)])

    def _parse_os2(self) -> None:
        self.os2 = None
        if b"OS/2" in self.tables:
            b = self.table(b"OS/2")
            if len(b) >= 78:
                self.os2 = {
                    "typo_ascender": _s16(b, 68), "typo_descender": _s16(b, 70),
                    "win_ascent": _u16(b, 74), "win_descent": _u16(b, 76),
                }

    def _face_ascender(self) -> tuple[int, int]:
        """FreeType's face ascender/descender: hhea, else OS/2 typo, else
        OS/2 win."""
        a, d = self.hhea_ascender, self.hhea_descender
        if a == 0 and d == 0 and self.os2 is not None:
            a, d = self.os2["typo_ascender"], self.os2["typo_descender"]
            if a == 0 and d == 0:
                a, d = self.os2["win_ascent"], -self.os2["win_descent"]
        return a, d

    def advance(self, gid: int) -> int:
        if 0 <= gid < len(self.advances):
            return int(self.advances[gid])
        return 0

    # ------------------------------------------------------------------ cmap

    def _parse_cmap(self) -> dict[int, int]:
        """The charmap FreeType selects by default, as {code point: glyph}."""
        if b"cmap" not in self.tables:
            return {}
        b = self.table(b"cmap")
        n = _u16(b, 2)
        subs = []
        for i in range(n):
            pid, eid, off = _u16(b, 4 + 8 * i), _u16(b, 6 + 8 * i), _u32(b, 8 + 8 * i)
            if off < len(b):
                subs.append((pid, eid, off))
        choice = None
        for pid, eid, off in reversed(subs):
            fmt = _u16(b, off)
            if ((pid == 3 and eid == 10) or (pid == 0 and eid in (4, 6))) and fmt in (12, 13):
                choice = off
                break
        if choice is None:
            for pid, eid, off in reversed(subs):
                fmt = _u16(b, off)
                if (pid == 0 and fmt != 14) or (pid == 3 and eid in (1, 10)):
                    choice = off
                    break
        if choice is None:
            return {}
        return _read_cmap_subtable(b, choice)

    def char_index(self, cp: int) -> int:
        return self.cmap.get(cp, 0)

    # ------------------------------------------------------------------ glyf

    def _parse_loca(self) -> None:
        b = self.table(b"loca")
        n = self.num_glyphs + 1
        if self.index_to_loc == 0:
            cnt = min(n, len(b) // 2)
            loc = np.frombuffer(b, ">u2", cnt).astype(np.int64) * 2
        else:
            cnt = min(n, len(b) // 4)
            loc = np.frombuffer(b, ">u4", cnt).astype(np.int64)
        self.loca = loc
        self._glyf = self.table(b"glyf")

    def glyph(self, gid: int, depth: int = 0) -> Glyph:
        """The glyph's outline in font units (composites resolved, in
        points of 16.16 scale when a component is transformed: see
        ``Glyph.components``)."""
        g = self._glyph_cache.get(gid)
        if g is not None:
            return g
        g = self._load_glyph(gid, depth)
        self._glyph_cache[gid] = g
        return g

    def _load_glyph(self, gid: int, depth: int) -> Glyph:
        empty = Glyph(np.zeros((0, 2), np.int64), np.zeros(0, np.int8), [], False, 0)
        if gid < 0 or gid + 1 >= len(self.loca) or depth > 8:
            return empty
        start, end = int(self.loca[gid]), int(self.loca[gid + 1])
        if end <= start or start + 10 > len(self._glyf):
            return empty
        b = self._glyf
        nc = _s16(b, start)
        xmin = _s16(b, start + 2)
        if nc >= 0:
            return self._simple(b, start, nc, xmin)
        return self._composite(b, start, xmin)

    def _simple(self, b: bytes, start: int, nc: int, xmin: int) -> Glyph:
        p = start + 10
        ends = list(struct.unpack_from(">%dH" % nc, b, p))
        p += 2 * nc
        n_pts = (ends[-1] + 1) if nc else 0
        ilen = _u16(b, p)
        p += 2 + ilen
        flags = bytearray()
        while len(flags) < n_pts:
            f = b[p]
            p += 1
            flags.append(f)
            if f & 8:
                r = b[p]
                p += 1
                flags.extend([f] * r)
        flags = flags[:n_pts]
        xs = np.zeros(n_pts, np.int64)
        ys = np.zeros(n_pts, np.int64)
        for arr, short, same in ((xs, 2, 16), (ys, 4, 32)):
            v = 0
            for i, f in enumerate(flags):
                if f & short:
                    d = b[p]
                    p += 1
                    v += d if f & same else -d
                elif not f & same:
                    v += _s16(b, p)
                    p += 2
                arr[i] = v
        tags = np.array([f & 1 for f in flags], np.int8)
        overlap = bool(flags) and bool(flags[0] & 0x40)
        return Glyph(np.stack([xs, ys], 1), tags, ends, overlap, xmin)

    def _composite(self, b: bytes, start: int, xmin: int) -> Glyph:
        """Components as (glyph id, flags, arg1, arg2, 16.16 matrix or
        None); the face resolves them at its scale, as FreeType does."""
        p = start + 10
        comps = []
        while True:
            flags = _u16(b, p)
            sub = _u16(b, p + 2)
            p += 4
            if flags & ARG_1_AND_2_ARE_WORDS:
                if flags & ARGS_ARE_XY_VALUES:
                    a1, a2 = _s16(b, p), _s16(b, p + 2)
                else:
                    a1, a2 = _u16(b, p), _u16(b, p + 2)
                p += 4
            else:
                if flags & ARGS_ARE_XY_VALUES:
                    a1 = b[p] - 256 if b[p] > 127 else b[p]
                    a2 = b[p + 1] - 256 if b[p + 1] > 127 else b[p + 1]
                else:
                    a1, a2 = b[p], b[p + 1]
                p += 2
            m = None
            if flags & WE_HAVE_A_SCALE:
                s = _f2dot14(_s16(b, p))
                m = (s, 0, 0, s)
                p += 2
            elif flags & WE_HAVE_AN_X_AND_Y_SCALE:
                m = (_f2dot14(_s16(b, p)), 0, 0, _f2dot14(_s16(b, p + 2)))
                p += 4
            elif flags & WE_HAVE_A_TWO_BY_TWO:
                # xx, yx, xy, yy in the file
                xx, yx, xy, yy = (_f2dot14(_s16(b, p + 2 * k)) for k in range(4))
                m = (xx, xy, yx, yy)
                p += 8
            comps.append((sub, flags, a1, a2, m))
            if not flags & MORE_COMPONENTS:
                break
        overlap = bool(comps[0][1] & OVERLAP_COMPOUND)
        return Glyph(np.zeros((0, 2), np.int64), np.zeros(0, np.int8), [], overlap, xmin, comps)

    # ------------------------------------------------------------------ post

    def glyph_names(self) -> list[str] | None:
        """``post`` format 2 glyph names (None for other formats)."""
        if b"post" not in self.tables:
            return None
        b = self.table(b"post")
        if _u32(b, 0) != 0x00020000:
            return None
        from .glyph_names import MAC_GLYPHS

        n = _u16(b, 32)
        idx = struct.unpack_from(">%dH" % n, b, 34)
        p = 34 + 2 * n
        extra = []
        while p < len(b):
            ln = b[p]
            extra.append(b[p + 1:p + 1 + ln].decode("latin-1"))
            p += 1 + ln
        out = []
        for i in idx:
            if i < 258:
                out.append(MAC_GLYPHS[i])
            elif i - 258 < len(extra):
                out.append(extra[i - 258])
            else:
                out.append(".notdef")
        return out

    # --------------------------------------------------------------- shaping

    def kern_pairs(self) -> dict:
        """``kern`` format 0 pairs {(left, right): value}."""
        if self._kern is None:
            self._kern = {}
            if b"kern" in self.tables:
                b = self.table(b"kern")
                if _u16(b, 0) == 0:
                    n = _u16(b, 2)
                    p = 4
                    for _ in range(n):
                        length, cov = _u16(b, p + 2), _u16(b, p + 4)
                        if (cov >> 8) == 0 and (cov & 1) and not cov & 4:
                            npairs = _u16(b, p + 6)
                            q = p + 14
                            for _k in range(npairs):
                                self._kern[(_u16(b, q), _u16(b, q + 2))] = _s16(b, q + 4)
                                q += 6
                        p += length
        return self._kern

    def gsub_ligatures(self) -> list[dict]:
        """Default-feature GSUB ligature lookups in lookup order: each
        {first glyph: [(component glyphs, ligature glyph), ...]}."""
        if self._gsub is None:
            self._gsub = []
            if b"GSUB" in self.tables:
                for ltype, b, sub in _lookups(self.table(b"GSUB"), GSUB_FEATURES, 7):
                    if ltype == 4:
                        self._gsub.append(_ligature_subtables(b, sub))
        return self._gsub

    def gpos_pairs(self) -> list:
        """Default-feature GPOS pair-adjustment subtables in lookup order."""
        if self._gpos is None:
            self._gpos = []
            if b"GPOS" in self.tables:
                for ltype, b, sub in _lookups(self.table(b"GPOS"), GPOS_FEATURES, 9):
                    if ltype == 2:
                        self._gpos.append([_pair_subtable(b, s) for s in sub])
        return self._gpos


def _read_cmap_subtable(b: bytes, off: int) -> dict[int, int]:
    fmt = _u16(b, off)
    out: dict[int, int] = {}
    if fmt == 0:
        for c in range(256):
            g = b[off + 6 + c]
            if g:
                out[c] = g
    elif fmt == 4:
        segx2 = _u16(b, off + 6)
        n = segx2 // 2
        ends = off + 14
        starts = ends + segx2 + 2
        deltas = starts + segx2
        ranges = deltas + segx2
        for i in range(n):
            e, s = _u16(b, ends + 2 * i), _u16(b, starts + 2 * i)
            d, r = _s16(b, deltas + 2 * i), _u16(b, ranges + 2 * i)
            if s > e or s == 0xFFFF:
                continue
            for c in range(s, e + 1):
                if r == 0:
                    g = (c + d) & 0xFFFF
                else:
                    q = ranges + 2 * i + r + 2 * (c - s)
                    if q + 2 > len(b):
                        continue
                    g = _u16(b, q)
                    if g:
                        g = (g + d) & 0xFFFF
                if g:
                    out[c] = g
    elif fmt == 6:
        first, cnt = _u16(b, off + 6), _u16(b, off + 8)
        for i in range(cnt):
            g = _u16(b, off + 10 + 2 * i)
            if g:
                out[first + i] = g
    elif fmt in (12, 13):
        n = _u32(b, off + 12)
        for i in range(n):
            s, e, g = struct.unpack_from(">III", b, off + 16 + 12 * i)
            for c in range(s, min(e, 0x10FFFF) + 1):
                gg = g + (c - s) if fmt == 12 else g
                if gg:
                    out[c] = gg
    return out


def _coverage(b: bytes, off: int) -> dict[int, int]:
    fmt = _u16(b, off)
    out = {}
    if fmt == 1:
        n = _u16(b, off + 2)
        for i in range(n):
            out[_u16(b, off + 4 + 2 * i)] = i
    elif fmt == 2:
        n = _u16(b, off + 2)
        for i in range(n):
            s, e, idx = _u16(b, off + 4 + 6 * i), _u16(b, off + 6 + 6 * i), _u16(b, off + 8 + 6 * i)
            for g in range(s, e + 1):
                out[g] = idx + g - s
    return out


def _class_def(b: bytes, off: int) -> dict[int, int]:
    fmt = _u16(b, off)
    out = {}
    if fmt == 1:
        start, n = _u16(b, off + 2), _u16(b, off + 4)
        for i in range(n):
            out[start + i] = _u16(b, off + 6 + 2 * i)
    elif fmt == 2:
        n = _u16(b, off + 2)
        for i in range(n):
            s, e, c = _u16(b, off + 4 + 6 * i), _u16(b, off + 6 + 6 * i), _u16(b, off + 8 + 6 * i)
            for g in range(s, e + 1):
                out[g] = c
    return out


def _lookups(b: bytes, features: tuple, ext_type: int):
    """(lookup type, table bytes, [subtable offsets]) of the lookups that
    the default language system of latn (else DFLT) enables for
    ``features``, in lookup-list order."""
    script_list, feature_list, lookup_list = _u16(b, 4), _u16(b, 6), _u16(b, 8)
    scripts = {}
    for i in range(_u16(b, script_list)):
        rec = script_list + 2 + 6 * i
        scripts[b[rec:rec + 4]] = script_list + _u16(b, rec + 4)
    sc = scripts.get(b"latn") or scripts.get(b"DFLT")
    if sc is None:
        return []
    dl = _u16(b, sc)
    if dl == 0:
        return []
    ls = sc + dl
    req = _u16(b, ls + 2)
    idxs = [_u16(b, ls + 6 + 2 * k) for k in range(_u16(b, ls + 4))]
    if req != 0xFFFF:
        idxs.append(req)
    chosen = set()
    for fi in idxs:
        rec = feature_list + 2 + 6 * fi
        tag = b[rec:rec + 4].decode("latin-1")
        if tag not in features:
            continue
        fo = feature_list + _u16(b, rec + 4)
        for k in range(_u16(b, fo + 2)):
            chosen.add(_u16(b, fo + 4 + 2 * k))
    out = []
    n_lookups = _u16(b, lookup_list)
    for li in sorted(chosen):
        if li >= n_lookups:
            continue
        lo = lookup_list + _u16(b, lookup_list + 2 + 2 * li)
        ltype = _u16(b, lo)
        subs = [lo + _u16(b, lo + 6 + 2 * k) for k in range(_u16(b, lo + 4))]
        if ltype == ext_type:
            real = []
            for s in subs:
                ltype = _u16(b, s + 2)
                real.append(s + _u32(b, s + 4))
            subs = real
        out.append((ltype, b, subs))
    return out


def _ligature_subtables(b: bytes, subs: list) -> dict:
    out: dict[int, list] = {}
    for s in subs:
        cov = _coverage(b, s + _u16(b, s + 2))
        n = _u16(b, s + 4)
        firsts = sorted(cov, key=cov.get)
        for i in range(min(n, len(firsts))):
            ls = s + _u16(b, s + 6 + 2 * i)
            for k in range(_u16(b, ls)):
                lig = ls + _u16(b, ls + 2 + 2 * k)
                glyph, cc = _u16(b, lig), _u16(b, lig + 2)
                comps = tuple(_u16(b, lig + 4 + 2 * j) for j in range(cc - 1))
                out.setdefault(firsts[i], []).append((comps, glyph))
    return out


def _value_size(fmt: int) -> int:
    return 2 * bin(fmt & 0xFF).count("1")


def _x_advance(b: bytes, off: int, fmt: int) -> int:
    """The XAdvance of a ValueRecord (0 when absent)."""
    if not fmt & 4:
        return 0
    k = bin(fmt & 3).count("1")
    return _s16(b, off + 2 * k)


def _pair_subtable(b: bytes, s: int):
    fmt = _u16(b, s)
    cov = _coverage(b, s + _u16(b, s + 2))
    vf1, vf2 = _u16(b, s + 4), _u16(b, s + 6)
    sz1, sz2 = _value_size(vf1), _value_size(vf2)
    if fmt == 1:
        pairs = {}
        n = _u16(b, s + 8)
        for first, ci in cov.items():
            if ci >= n:
                continue
            ps = s + _u16(b, s + 10 + 2 * ci)
            for k in range(_u16(b, ps)):
                rec = ps + 2 + k * (2 + sz1 + sz2)
                pairs[(first, _u16(b, rec))] = (_x_advance(b, rec + 2, vf1), sz2 > 0)
        return ("pairs", pairs)
    if fmt == 2:
        c1 = _class_def(b, s + _u16(b, s + 8))
        c2 = _class_def(b, s + _u16(b, s + 10))
        n1, n2 = _u16(b, s + 12), _u16(b, s + 14)
        vals = {}
        for i in range(n1):
            for j in range(n2):
                rec = s + 16 + (i * n2 + j) * (sz1 + sz2)
                v = _x_advance(b, rec, vf1)
                if v:
                    vals[(i, j)] = v
        return ("classes", cov, c1, c2, vals, sz2 > 0)
    return ("none",)


def pair_value(sub, left: int, right: int):
    """(x advance adjustment of ``left``, whether the pair consumed the
    right glyph's value) or None when the subtable does not hold the
    pair."""
    if sub[0] == "pairs":
        v = sub[1].get((left, right))
        return v
    if sub[0] == "classes":
        _, cov, c1, c2, vals, has2 = sub
        if left not in cov:
            return None
        return vals.get((c1.get(left, 0), c2.get(right, 0)), 0), has2
    return None
