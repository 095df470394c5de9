"""PDF font model: code iteration, widths, unicode mapping, embedded programs.

Handles simple fonts (Type1/TrueType/Type3) and composite Type0/CID fonts
(Identity-H/V). Unicode comes from, in priority order: ToUnicode CMap,
encoding differences (glyph names), the byte codec implied by the base
encoding (WinAnsi=cp1252, MacRoman=mac_roman).
"""
from __future__ import annotations

import re
from typing import Any, Iterator

from .cos import Name, Ref, Stream

# --- Adobe Glyph List (common subset) + programmatic names ---

_AGL: dict[str, str] = {
    "space": " ", "exclam": "!", "quotedbl": '"', "numbersign": "#",
    "dollar": "$", "percent": "%", "ampersand": "&", "quotesingle": "'",
    "parenleft": "(", "parenright": ")", "asterisk": "*", "plus": "+",
    "comma": ",", "hyphen": "-", "period": ".", "slash": "/",
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "colon": ":", "semicolon": ";", "less": "<", "equal": "=",
    "greater": ">", "question": "?", "at": "@", "bracketleft": "[",
    "backslash": "\\", "bracketright": "]", "asciicircum": "^",
    "underscore": "_", "grave": "`", "braceleft": "{", "bar": "|",
    "braceright": "}", "asciitilde": "~",
    "quoteleft": "‘", "quoteright": "’",
    "quotedblleft": "“", "quotedblright": "”",
    "endash": "–", "emdash": "—", "bullet": "•",
    "ellipsis": "…", "fi": "ﬁ", "fl": "ﬂ",
    "dagger": "†", "daggerdbl": "‡", "periodcentered": "·",
    "degree": "°", "plusminus": "±", "multiply": "×",
    "divide": "÷", "minus": "−", "registered": "®",
    "copyright": "©", "trademark": "™", "section": "§",
    "paragraph": "¶", "sterling": "£", "yen": "¥",
    "cent": "¢", "currency": "¤", "Euro": "€",
    "florin": "ƒ", "fraction": "⁄", "percent": "%",
    "perthousand": "‰", "exclamdown": "¡", "questiondown": "¿",
    "guillemotleft": "«", "guillemotright": "»",
    "guilsinglleft": "‹", "guilsinglright": "›",
    "quotesinglbase": "‚", "quotedblbase": "„",
    "dotlessi": "ı", "OE": "Œ", "oe": "œ",
    "AE": "Æ", "ae": "æ", "Oslash": "Ø", "oslash": "ø",
    "germandbls": "ß", "Lslash": "Ł", "lslash": "ł",
    "Scaron": "Š", "scaron": "š", "Zcaron": "Ž",
    "zcaron": "ž", "Ydieresis": "Ÿ", "mu": "µ",
    "circumflex": "ˆ", "caron": "ˇ", "tilde": "˜",
    "macron": "¯", "breve": "˘", "dotaccent": "˙",
    "ring": "˚", "cedilla": "¸", "hungarumlaut": "˝",
    "ogonek": "˛", "acute": "´", "dieresis": "¨",
    "brokenbar": "¦", "logicalnot": "¬", "ordfeminine": "ª",
    "ordmasculine": "º", "onequarter": "¼", "onehalf": "½",
    "threequarters": "¾", "onesuperior": "¹",
    "twosuperior": "²", "threesuperior": "³", "middot": "·",
}

_ACCENTED_RE = re.compile(
    r"^([A-Za-z])(grave|acute|circumflex|tilde|dieresis|ring|cedilla|caron|"
    r"breve|macron|hungarumlaut|ogonek|dotaccent|slash)$"
)
_ACCENT_COMBINING = {
    "grave": "̀", "acute": "́", "circumflex": "̂",
    "tilde": "̃", "macron": "̄", "breve": "̆",
    "dotaccent": "̇", "dieresis": "̈", "ring": "̊",
    "hungarumlaut": "̋", "caron": "̌", "cedilla": "̧",
    "ogonek": "̨", "slash": "̸",
}


def glyphname_to_unicode(name: str) -> str | None:
    if not name:
        return None
    if len(name) == 1:
        return name
    if name in _AGL:
        return _AGL[name]
    m = re.match(r"^uni([0-9A-Fa-f]{4,6})$", name)
    if m:
        try:
            return chr(int(m.group(1)[:6], 16))
        except ValueError:
            return None
    m = re.match(r"^u([0-9A-Fa-f]{4,6})$", name)
    if m:
        try:
            return chr(int(m.group(1), 16))
        except ValueError:
            return None
    m = _ACCENTED_RE.match(name)
    if m:
        import unicodedata

        combined = unicodedata.normalize(
            "NFC", m.group(1) + _ACCENT_COMBINING[m.group(2)]
        )
        return combined
    # gXX / cidXX subset glyphs carry no unicode
    return None


# --- ToUnicode CMap parsing ---

_HEX_RE = re.compile(rb"<([0-9A-Fa-f]+)>")


def parse_cmap(data: bytes) -> tuple[dict[int, str], list[tuple[int, int]]]:
    """Parse a CMap (ToUnicode or encoding). Returns (code->text, codespace
    ranges as (nbytes, count) pairs used to infer code byte lengths)."""
    mapping: dict[int, str] = {}
    codespace: list[tuple[int, int]] = []

    def hex_to_text(h: bytes) -> str:
        try:
            raw = bytes.fromhex(h.decode("ascii"))
            if len(raw) % 2:
                raw = b"\x00" + raw
            return raw.decode("utf-16-be", errors="ignore")
        except ValueError:
            return ""

    for m in re.finditer(
        rb"begincodespacerange(.*?)endcodespacerange", data, re.S
    ):
        hexes = _HEX_RE.findall(m.group(1))
        for i in range(0, len(hexes) - 1, 2):
            nbytes = len(hexes[i]) // 2
            codespace.append((nbytes, 0))

    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", data, re.S):
        items = _HEX_RE.findall(m.group(1))
        for i in range(0, len(items) - 1, 2):
            code = int(items[i], 16)
            mapping[code] = hex_to_text(items[i + 1])

    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", data, re.S):
        body = m.group(1)
        # form: <lo> <hi> <dst>  |  <lo> <hi> [<dst1> <dst2> ...]
        token_re = re.compile(rb"<([0-9A-Fa-f]+)>|\[((?:[^\]])*)\]", re.S)
        tokens: list[tuple[str, Any]] = []
        for t in token_re.finditer(body):
            if t.group(1) is not None:
                tokens.append(("hex", t.group(1)))
            else:
                tokens.append(("arr", _HEX_RE.findall(t.group(2))))
        i = 0
        while i + 2 < len(tokens):
            k_lo, v_lo = tokens[i]
            k_hi, v_hi = tokens[i + 1]
            k_dst, v_dst = tokens[i + 2]
            if k_lo != "hex" or k_hi != "hex":
                i += 1
                continue
            lo, hi = int(v_lo, 16), int(v_hi, 16)
            if k_dst == "arr":
                for j, dst in enumerate(v_dst):
                    if lo + j <= hi:
                        mapping[lo + j] = hex_to_text(dst)
                i += 3
            else:
                base_raw = v_dst
                try:
                    base = int(base_raw, 16)
                except ValueError:
                    i += 3
                    continue
                nhex = len(base_raw)
                span = min(hi - lo, 65535)
                for j in range(span + 1):
                    # increment only the last UTF-16 code unit
                    val = base + j
                    mapping[lo + j] = hex_to_text(
                        (b"%0*x" % (nhex, val))
                    )
                i += 3
    return mapping, codespace


# --- width defaults for non-embedded standard fonts (approximate) ---

def _builtin_width(ch: str, base_font: str) -> float:
    bf = base_font.lower()
    if "courier" in bf or "mono" in bf:
        return 600.0
    if ch == " ":
        return 278.0
    if ch in "iIl.,;:'|!()[]{}\"`":
        return 280.0
    if ch in "mwMW@":
        return 880.0
    if ch.isupper():
        return 700.0
    if ch.isdigit():
        return 556.0
    if ord(ch) > 0x2E80:  # CJK
        return 1000.0
    return 520.0


class Font:
    """Runtime view of a PDF font for layout & extraction."""

    def __init__(self, doc, font_dict: dict):
        self.doc = doc
        self.dict = font_dict
        r = doc.resolve
        self.subtype = str(r(font_dict.get("Subtype")) or "")
        self.base_font = str(r(font_dict.get("BaseFont")) or "")
        self.is_cid = self.subtype == "Type0"
        self.code_bytes = 2 if self.is_cid else 1
        self.to_unicode: dict[int, str] = {}
        self.widths: dict[int, float] = {}
        self.default_width = 500.0
        self.ascent = 0.88
        self.descent = -0.12
        self.font_program: bytes | None = None
        self.font_program_kind: str | None = None  # ttf | cff | type1
        self.vertical = False
        self._byte_codec: str | None = None
        self._differences: dict[int, str] = {}
        self.cid_to_gid_identity = True

        tu = r(font_dict.get("ToUnicode"))
        if isinstance(tu, Stream):
            try:
                self.to_unicode, _ = parse_cmap(doc.stream_bytes(tu))
            except Exception:
                pass
        self.has_to_unicode = bool(self.to_unicode)

        if self.is_cid:
            self._init_type0(r)
        else:
            self._init_simple(r)

    # ------------------------------------------------------------ initifiers

    def _init_simple(self, r) -> None:
        fd = r(self.dict.get("FontDescriptor"))
        self._load_descriptor(fd, r)
        first = r(self.dict.get("FirstChar"))
        widths = r(self.dict.get("Widths"))
        if isinstance(first, int) and isinstance(widths, list):
            for i, w in enumerate(widths):
                w = r(w)
                if isinstance(w, (int, float)):
                    self.widths[first + i] = float(w)
        if self.subtype == "Type3":
            mtx = r(self.dict.get("FontMatrix")) or [0.001, 0, 0, 0.001, 0, 0]
            try:
                t3 = tuple(float(r(v)) for v in mtx[:6])
                self.t3_matrix = (
                    t3 if len(t3) == 6
                    else (0.001, 0.0, 0.0, 0.001, 0.0, 0.0)
                )
            except (TypeError, ValueError):
                self.t3_matrix = (0.001, 0.0, 0.0, 0.001, 0.0, 0.0)
            # glyph programs + their resources, for the rasterizer
            # (reference fidelity via pdfium; our renderer executes the
            # CharProc content streams directly, render.py _draw_type3)
            cp = r(self.dict.get("CharProcs"))
            self.t3_charprocs = cp if isinstance(cp, dict) else {}
            res = r(self.dict.get("Resources"))
            self.t3_resources = res if isinstance(res, dict) else {}
            try:
                scale = float(r(mtx[0])) * 1000.0
            except (TypeError, ValueError, IndexError):
                scale = 1.0
            if scale and abs(scale - 1.0) > 1e-6:
                self.widths = {k: v * scale for k, v in self.widths.items()}

        enc = r(self.dict.get("Encoding"))
        base_enc = None
        if isinstance(enc, (Name, str)):
            base_enc = str(enc)
        elif isinstance(enc, dict):
            base_enc = str(r(enc.get("BaseEncoding")) or "") or None
            diffs = r(enc.get("Differences"))
            if isinstance(diffs, list):
                code = 0
                for item in diffs:
                    item = r(item)
                    if isinstance(item, (int, float)):
                        code = int(item)
                    elif isinstance(item, (Name, str)):
                        self._differences[code] = str(item)
                        code += 1
        symbolic = False
        fd = r(self.dict.get("FontDescriptor"))
        if isinstance(fd, dict):
            flags = r(fd.get("Flags")) or 0
            symbolic = bool(int(flags) & 4) and not bool(int(flags) & 32)
        if base_enc == "WinAnsiEncoding":
            self._byte_codec = "cp1252"
        elif base_enc == "MacRomanEncoding":
            self._byte_codec = "mac_roman"
        elif base_enc in ("StandardEncoding", "PDFDocEncoding", "MacExpertEncoding"):
            self._byte_codec = "latin-1"
        elif not symbolic:
            self._byte_codec = "cp1252"

    def _init_type0(self, r) -> None:
        enc = r(self.dict.get("Encoding"))
        enc_name = str(enc) if isinstance(enc, (Name, str)) else ""
        self.vertical = enc_name.endswith("-V")
        desc_list = r(self.dict.get("DescendantFonts")) or []
        desc = r(desc_list[0]) if desc_list else None
        if not isinstance(desc, dict):
            return
        self.default_width = float(r(desc.get("DW")) or 1000.0)
        w_arr = r(desc.get("W"))
        if isinstance(w_arr, list):
            self._parse_cid_widths([r(x) for x in w_arr], r)
        fd = r(desc.get("FontDescriptor"))
        self._load_descriptor(fd, r)
        c2g = r(desc.get("CIDToGIDMap"))
        if isinstance(c2g, Stream):
            self.cid_to_gid_identity = False
            try:
                self._cid_to_gid = self.doc.stream_bytes(c2g)
            except Exception:
                self._cid_to_gid = b""
        else:
            self._cid_to_gid = None

    def _parse_cid_widths(self, w: list, r) -> None:
        i = 0
        while i < len(w):
            c = w[i]
            if i + 1 < len(w) and isinstance(w[i + 1], list):
                for j, width in enumerate(w[i + 1]):
                    width = r(width)
                    if isinstance(width, (int, float)):
                        self.widths[int(c) + j] = float(width)
                i += 2
            elif i + 2 < len(w):
                c2, width = w[i + 1], r(w[i + 2])
                if isinstance(width, (int, float)) and isinstance(c, (int, float)):
                    span = min(int(c2) - int(c), 65535)
                    for cid in range(int(c), int(c) + span + 1):
                        self.widths[cid] = float(width)
                i += 3
            else:
                break

    def _load_descriptor(self, fd: Any, r) -> None:
        if not isinstance(fd, dict):
            return
        try:
            if fd.get("Ascent") is not None:
                a = float(r(fd["Ascent"]))
                if a:
                    self.ascent = a / 1000.0
            if fd.get("Descent") is not None:
                d = float(r(fd["Descent"]))
                if d:
                    self.descent = d / 1000.0
        except (TypeError, ValueError):
            pass
        if self.ascent <= 0:
            self.ascent = 0.88
        if self.descent > 0:
            self.descent = -self.descent
        for key, kind in (
            ("FontFile2", "ttf"),
            ("FontFile3", "cff"),
            ("FontFile", "type1"),
        ):
            ff = r(fd.get(key))
            if isinstance(ff, Stream):
                try:
                    self.font_program = self.doc.stream_bytes(ff)
                    self.font_program_kind = kind
                    subtype = r(ff.dict.get("Subtype"))
                    if kind == "cff" and str(subtype or "") == "OpenType":
                        self.font_program_kind = "ttf"
                except Exception:
                    pass
                break

    # -------------------------------------------------------------- runtime

    def iter_codes(self, raw: bytes) -> Iterator[tuple[int, str, float]]:
        """Yield (code, unicode_text, width_in_1000_units) per glyph.
        (text, width) memoizes per code — Fonts persist doc-scope, so
        the lookup chain (ToUnicode/differences/codec + width table)
        runs once per distinct glyph per document."""
        cache = self.__dict__.get("_code_cache")
        if cache is None:
            cache = self._code_cache = {}
        get = cache.get
        if self.code_bytes == 2:
            n2 = len(raw) - 1
            for i in range(0, n2, 2):
                code = (raw[i] << 8) | raw[i + 1]
                hit = get(code)
                if hit is None:
                    hit = cache[code] = (
                        self._unicode_for(code),
                        self.widths.get(code, self.default_width),
                    )
                yield code, hit[0], hit[1]
            if len(raw) % 2:
                code = raw[-1]
                hit = get(code)
                if hit is None:
                    hit = cache[code] = (
                        self._unicode_for(code),
                        self.widths.get(code, self.default_width),
                    )
                yield code, hit[0], hit[1]
        else:
            for b in raw:
                hit = get(b)
                if hit is None:
                    hit = cache[b] = (self._unicode_for(b), self._width_for(b))
                yield b, hit[0], hit[1]

    def _width_for(self, code: int) -> float:
        if code in self.widths:
            w = self.widths[code]
            if w > 0:
                return w
        text = self._unicode_for(code)
        ch = text[0] if text else "x"
        return _builtin_width(ch, self.base_font)

    def _unicode_for(self, code: int) -> str:
        if code in self.to_unicode:
            t = self.to_unicode[code]
            if t:
                return t
        if not self.is_cid:
            if code in self._differences:
                u = glyphname_to_unicode(self._differences[code])
                if u:
                    return u
            codec = self._byte_codec
            if codec:
                try:
                    ch = bytes([code]).decode(codec)
                    if ch.isprintable() or ch == " ":
                        return ch
                except (UnicodeDecodeError, ValueError):
                    pass
            if 32 <= code < 127:
                return chr(code)
        return ""

    def is_space_code(self, code: int) -> bool:
        # Word spacing applies to single-byte code 32 only (PDF 1.7 §9.3.3)
        return code == 32 and self.code_bytes == 1

    def glyph_id(self, code: int) -> int:
        """Glyph index in the embedded program for a character code/CID."""
        if self.is_cid:
            if self._cid_to_gid:
                idx = code * 2
                if idx + 1 < len(self._cid_to_gid):
                    return (self._cid_to_gid[idx] << 8) | self._cid_to_gid[idx + 1]
                return 0
            return code
        return code


def load_font(doc, font_dict: dict) -> Font:
    return Font(doc, font_dict)
