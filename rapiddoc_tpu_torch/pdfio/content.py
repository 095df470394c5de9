"""Content-stream tokenizer and graphics-state interpreter.

The interpreter walks a page's content stream maintaining the full PDF
graphics/text state machine and calls overridable hooks; text extraction
(pdfio.text) and rasterization (pdfio.render) are subclasses.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

from .cos import Name, ObjectParser, Stream
from .document import PdfDocument, PdfPage
from .fonts import Font, load_font

Matrix = tuple[float, float, float, float, float, float]
IDENTITY: Matrix = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def mat_mul(m1: Matrix, m2: Matrix) -> Matrix:
    """m1 then m2 (i.e. result = m1 · m2 in PDF row-vector convention)."""
    a1, b1, c1, d1, e1, f1 = m1
    a2, b2, c2, d2, e2, f2 = m2
    return (
        a1 * a2 + b1 * c2,
        a1 * b2 + b1 * d2,
        c1 * a2 + d1 * c2,
        c1 * b2 + d1 * d2,
        e1 * a2 + f1 * c2 + e2,
        e1 * b2 + f1 * d2 + f2,
    )


def mat_apply(m: Matrix, x: float, y: float) -> tuple[float, float]:
    a, b, c, d, e, f = m
    return (a * x + c * y + e, b * x + d * y + f)


def mat_scale_of(m: Matrix) -> float:
    """Approximate uniform scale factor of a matrix."""
    a, b, c, d, _, _ = m
    sx = (a * a + b * b) ** 0.5
    sy = (c * c + d * d) ** 0.5
    return (sx * sy) ** 0.5 or 1.0


@dataclass
class GraphicsState:
    ctm: Matrix = IDENTITY
    stroke_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    fill_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    line_width: float = 1.0
    clip_bbox: tuple[float, float, float, float] | None = None  # device space
    # non-rectangular clip stack: tuple of (subpaths, even_odd) entries,
    # device space; empty when every active clip is axis-aligned rect
    clip_paths: tuple = ()
    # shading/tiling pattern fill: (kind, payload) set by scn with a
    # pattern name; None for plain color fills
    fill_pattern: Any = None
    stroke_alpha: float = 1.0
    fill_alpha: float = 1.0
    # text state (persists across BT/ET per spec)
    char_spacing: float = 0.0
    word_spacing: float = 0.0
    h_scale: float = 1.0
    leading: float = 0.0
    font: Font | None = None
    font_size: float = 0.0
    render_mode: int = 0
    rise: float = 0.0


def tokenize_content(data: bytes):
    """Yield (operands, operator, inline_image_or_None) triples."""
    parser = ObjectParser(data, 0, allow_refs=False)
    operands: list[Any] = []
    n = len(data)
    while True:
        parser.skip_ws()
        if parser.pos >= n:
            break
        c = data[parser.pos]
        if (0x30 <= c <= 0x39) or c in (0x2B, 0x2D, 0x2E):
            # fast number path: operand streams are number-dense
            tok = parser.read_regular_token()
            try:
                operands.append(
                    float(tok) if (b"." in tok or b"e" in tok or b"E" in tok)
                    else int(tok)
                )
            except ValueError:
                pass
            continue
        if c == 0x2F or c == 0x28 or c == 0x3C or c == 0x5B:
            try:
                operands.append(parser.parse_object())
            except (ValueError, EOFError):
                parser.pos += 1
            continue
        if c == 0x5D or c == 0x29 or c == 0x3E or c == 0x7B or c == 0x7D:
            parser.pos += 1  # stray delimiter
            continue
        op = parser.read_regular_token()
        if not op:
            parser.pos += 1
            continue
        if op == b"BI":
            img_dict, img_data, parser.pos = _parse_inline_image(data, parser.pos)
            yield ([], "EI", (img_dict, img_data))
            operands = []
            continue
        if op in (b"true", b"false", b"null"):
            operands.append(op == b"true")
            continue
        yield (operands, op.decode("latin-1"), None)
        operands = []


def _parse_inline_image(data: bytes, pos: int) -> tuple[dict, bytes, int]:
    parser = ObjectParser(data, pos)
    d: dict = {}
    while True:
        parser.skip_ws()
        if data[parser.pos : parser.pos + 2] == b"ID":
            parser.pos += 2
            break
        if parser.pos >= len(data):
            return d, b"", parser.pos
        if data[parser.pos] == 0x2F:
            key = parser.read_name()
            d[key] = parser.parse_object()
        else:
            parser.pos += 1
    # one whitespace byte after ID
    if parser.pos < len(data) and data[parser.pos] in b"\x00\t\n\x0c\r ":
        parser.pos += 1
    start = parser.pos
    # find EI delimited by whitespace
    idx = start
    while True:
        idx = data.find(b"EI", idx)
        if idx < 0:
            idx = len(data)
            break
        before_ok = idx == 0 or data[idx - 1] in b"\x00\t\n\x0c\r >"
        after = data[idx + 2 : idx + 3]
        after_ok = after == b"" or after[0] in b"\x00\t\n\x0c\r /[(<"
        if before_ok and after_ok:
            break
        idx += 2
    return d, data[start:idx], min(idx + 2, len(data))


_INLINE_KEY_MAP = {
    "BPC": "BitsPerComponent", "CS": "ColorSpace", "D": "Decode",
    "DP": "DecodeParms", "F": "Filter", "H": "Height", "W": "Width",
    "IM": "ImageMask", "I": "Interpolate",
}


class ContentInterpreter:
    """Walks content streams; subclasses override on_* hooks."""

    MAX_FORM_DEPTH = 12

    def __init__(self, page: PdfPage):
        self.page = page
        self.doc: PdfDocument = page.doc
        self.gs = GraphicsState()
        self.gs_stack: list[GraphicsState] = []
        self.text_matrix: Matrix = IDENTITY
        self.text_line_matrix: Matrix = IDENTITY
        self._path: list[list[tuple[float, float]]] = []
        self._cur: list[tuple[float, float]] = []
        self._pending_clip: str | None = None
        self._form_depth = 0

    # ------------------------------------------------------------------ main

    def run(self, base_ctm: Matrix = IDENTITY) -> None:
        self.gs.ctm = base_ctm
        # a page's content tokenizes twice per parse (txt/ocr classify
        # pass, then the raster+text pass): keep a small doc-scope token
        # cache. Bounded to ~32 pages so giant documents stream.
        cache = getattr(self.doc, "_page_tokens_cache", None)
        if cache is None:
            cache = {}
            self.doc._page_tokens_cache = cache
        toks = cache.get(self.page.index)
        if toks is None:
            toks = list(tokenize_content(self.page.content_bytes()))
            if len(cache) >= 32:
                cache.clear()
            cache[self.page.index] = toks
        self.execute(b"", self.page.resources, tokens=toks)

    def execute(
        self, data: bytes, resources: dict, tokens: list | None = None
    ) -> None:
        """`tokens` replays a pre-tokenized stream (operand lists are
        never mutated by _dispatch, so cached token lists are reusable)."""
        for operands, op, inline in (
            tokens if tokens is not None else tokenize_content(data)
        ):
            try:
                if inline is not None:
                    self._op_inline_image(*inline, resources)
                else:
                    self._dispatch(operands, op, resources)
            except Exception:
                continue

    # -------------------------------------------------------------- dispatch

    def _dispatch(self, ops: list, op: str, res: dict) -> None:
        gs = self.gs
        if op == "q":
            self.gs_stack.append(replace(gs))
        elif op == "Q":
            if self.gs_stack:
                self.gs = self.gs_stack.pop()
        elif op == "cm":
            if len(ops) >= 6:
                gs.ctm = mat_mul(tuple(float(v) for v in ops[:6]), gs.ctm)
        elif op == "w":
            if ops:
                gs.line_width = float(ops[0])
        elif op == "gs":
            self._op_ext_gstate(ops, res)
        # --- path construction ---
        elif op == "m":
            self._flush_subpath()
            self._cur = [mat_apply(gs.ctm, float(ops[0]), float(ops[1]))]
        elif op == "l":
            self._cur.append(mat_apply(gs.ctm, float(ops[0]), float(ops[1])))
        elif op in ("c", "v", "y"):
            self._op_curve(ops, op)
        elif op == "h":
            if self._cur and self._cur[0] != self._cur[-1]:
                self._cur.append(self._cur[0])
        elif op == "re":
            self._op_rect(ops)
        # --- path painting ---
        elif op in ("S", "s", "f", "F", "f*", "B", "B*", "b", "b*", "n"):
            self._op_paint(op)
        elif op in ("W", "W*"):
            self._pending_clip = op
        # --- color (approximate: track RGB) ---
        elif op in ("g", "G"):
            v = float(ops[0]) if ops else 0.0
            self._set_color(op.islower(), (v, v, v))
        elif op in ("rg", "RG"):
            if len(ops) >= 3:
                self._set_color(op.islower(), tuple(float(v) for v in ops[:3]))
        elif op in ("k", "K"):
            if len(ops) >= 4:
                c, m, y, k = (float(v) for v in ops[:4])
                rgb = ((1 - c) * (1 - k), (1 - m) * (1 - k), (1 - y) * (1 - k))
                self._set_color(op.islower(), rgb)
        elif op in ("sc", "scn", "SC", "SCN"):
            if ops and isinstance(ops[-1], str):
                self._op_set_pattern(op.islower(), ops[-1], res)
                return
            nums = [float(v) for v in ops if isinstance(v, (int, float))]
            if len(nums) == 1:
                self._set_color(op.islower(), (nums[0],) * 3)
            elif len(nums) == 3:
                self._set_color(op.islower(), tuple(nums))
            elif len(nums) == 4:
                c, m, y, k = nums
                self._set_color(
                    op.islower(), ((1 - c) * (1 - k), (1 - m) * (1 - k), (1 - y) * (1 - k))
                )
        # --- text ---
        elif op == "BT":
            self.text_matrix = self.text_line_matrix = IDENTITY
        elif op == "ET":
            pass
        elif op == "Tc":
            gs.char_spacing = float(ops[0])
        elif op == "Tw":
            gs.word_spacing = float(ops[0])
        elif op == "Tz":
            gs.h_scale = float(ops[0]) / 100.0
        elif op == "TL":
            gs.leading = float(ops[0])
        elif op == "Ts":
            gs.rise = float(ops[0])
        elif op == "Tr":
            gs.render_mode = int(ops[0])
        elif op == "Tf":
            self._op_set_font(ops, res)
        elif op == "Td":
            self._op_td(float(ops[0]), float(ops[1]))
        elif op == "TD":
            gs.leading = -float(ops[1])
            self._op_td(float(ops[0]), float(ops[1]))
        elif op == "Tm":
            m = tuple(float(v) for v in ops[:6])
            self.text_matrix = self.text_line_matrix = m
        elif op == "T*":
            self._op_td(0.0, -gs.leading)
        elif op == "Tj":
            if ops and isinstance(ops[0], bytes):
                self._show_text(ops[0])
        elif op == "'":
            self._op_td(0.0, -gs.leading)
            if ops and isinstance(ops[-1], bytes):
                self._show_text(ops[-1])
        elif op == '"':
            if len(ops) >= 3:
                gs.word_spacing = float(ops[0])
                gs.char_spacing = float(ops[1])
                self._op_td(0.0, -gs.leading)
                if isinstance(ops[2], bytes):
                    self._show_text(ops[2])
        elif op == "TJ":
            self._op_tj_array(ops)
        # --- xobjects ---
        elif op == "Do":
            self._op_do(ops, res)
        elif op == "sh":
            self.on_shading(ops, res)
        # BMC/BDC/EMC/BX/EX/MP/DP/d0/d1/ri/i/j/J/M/d/CS/cs: no-ops here

    # ------------------------------------------------------------- operators

    def _op_ext_gstate(self, ops: list, res: dict) -> None:
        if not ops or not isinstance(ops[0], str):
            return
        egs_res = self.doc.resolve(res.get("ExtGState"))
        if not isinstance(egs_res, dict):
            return
        egs = self.doc.resolve(egs_res.get(ops[0]))
        if not isinstance(egs, dict):
            return
        if "CA" in egs:
            try:
                self.gs.stroke_alpha = float(self.doc.resolve(egs["CA"]))
            except (TypeError, ValueError):
                pass
        if "ca" in egs:
            try:
                self.gs.fill_alpha = float(self.doc.resolve(egs["ca"]))
            except (TypeError, ValueError):
                pass
        font_entry = self.doc.resolve(egs.get("Font"))
        if isinstance(font_entry, list) and len(font_entry) == 2:
            font_dict = self.doc.resolve(font_entry[0])
            if isinstance(font_dict, dict):
                self.gs.font = self._load_font_cached(font_entry[0], font_dict)
                self.gs.font_size = float(self.doc.resolve(font_entry[1]) or 0)

    def _op_curve(self, ops: list, op: str) -> None:
        """Flatten béziers: endpoint plus midpoint samples."""
        if not self._cur:
            return
        x0, y0 = self._cur[-1]
        pts_page = [(float(ops[i]), float(ops[i + 1])) for i in range(0, len(ops) - 1, 2)]
        if op == "c" and len(pts_page) >= 3:
            p1, p2, p3 = pts_page[:3]
        elif op == "v" and len(pts_page) >= 2:
            p1 = None  # current point doubles as first control point
            p2, p3 = pts_page[:2]
        elif op == "y" and len(pts_page) >= 2:
            p1, p3 = pts_page[:2]
            p2 = p3
        else:
            return
        ctm = self.gs.ctm
        d1 = mat_apply(ctm, *p1) if op != "v" else (x0, y0)
        d2 = mat_apply(ctm, *p2)
        d3 = mat_apply(ctm, *p3)
        # cubic bezier from (x0,y0) with ctrl d1,d2 to d3; sample 8 segments
        for i in range(1, 9):
            t = i / 8.0
            mt = 1 - t
            x = (
                mt**3 * x0 + 3 * mt**2 * t * d1[0] + 3 * mt * t**2 * d2[0] + t**3 * d3[0]
            )
            y = (
                mt**3 * y0 + 3 * mt**2 * t * d1[1] + 3 * mt * t**2 * d2[1] + t**3 * d3[1]
            )
            self._cur.append((x, y))

    def _op_rect(self, ops: list) -> None:
        if len(ops) < 4:
            return
        x, y, w, h = (float(v) for v in ops[:4])
        ctm = self.gs.ctm
        self._flush_subpath()
        self._cur = [
            mat_apply(ctm, x, y),
            mat_apply(ctm, x + w, y),
            mat_apply(ctm, x + w, y + h),
            mat_apply(ctm, x, y + h),
            mat_apply(ctm, x, y),
        ]
        self._flush_subpath()

    def _flush_subpath(self) -> None:
        if len(self._cur) >= 2:
            self._path.append(self._cur)
        self._cur = []

    def _op_paint(self, op: str) -> None:
        self._flush_subpath()
        path = self._path
        self._path = []
        if self._pending_clip:
            self._apply_clip(path)
            self._pending_clip = None
        if op == "n" or not path:
            return
        stroke = op in ("S", "s", "B", "B*", "b", "b*")
        fill = op in ("f", "F", "f*", "B", "B*", "b", "b*")
        even_odd = "*" in op
        self.on_paint_path(path, stroke=stroke, fill=fill, even_odd=even_odd)

    def _apply_clip(self, path: list[list[tuple[float, float]]]) -> None:
        xs = [p[0] for sub in path for p in sub]
        ys = [p[1] for sub in path for p in sub]
        if not xs:
            return
        bbox = (min(xs), min(ys), max(xs), max(ys))
        old = self.gs.clip_bbox
        if old:
            bbox = (
                max(bbox[0], old[0]), max(bbox[1], old[1]),
                min(bbox[2], old[2]), min(bbox[3], old[3]),
            )
        self.gs.clip_bbox = bbox
        if not self._path_is_rect(path):
            # keep the actual polygon so the rasterizer can clip through
            # a mask instead of degrading to the bbox (reference fidelity
            # comes from pdfium; see render.py _clip_mask)
            frozen = tuple(tuple(sub) for sub in path if len(sub) >= 3)
            if frozen:
                self.gs.clip_paths = self.gs.clip_paths + (
                    (frozen, self._pending_clip == "W*"),
                )

    @staticmethod
    def _path_is_rect(path: list[list[tuple[float, float]]]) -> bool:
        """One axis-aligned rectangle (possibly closed) — the common case
        the bbox intersection already represents exactly."""
        if len(path) != 1:
            return False
        pts = path[0]
        if pts and pts[0] == pts[-1]:
            pts = pts[:-1]
        if len(pts) != 4:
            return False
        xs = {round(p[0], 4) for p in pts}
        ys = {round(p[1], 4) for p in pts}
        return len(xs) == 2 and len(ys) == 2

    def _set_color(self, is_fill: bool, rgb: tuple) -> None:
        rgb = tuple(min(1.0, max(0.0, float(v))) for v in rgb)
        if is_fill:
            self.gs.fill_color = rgb
            self.gs.fill_pattern = None
        else:
            self.gs.stroke_color = rgb

    def _op_set_pattern(self, is_fill: bool, name: str, res: dict) -> None:
        """scn/SCN with a pattern name: shading patterns (PatternType 2)
        carry their shading dict + matrix for the rasterizer; tiling
        patterns (PatternType 1) degrade to a mid-gray fill here and are
        painted properly by the rasterizer subclass when it overrides
        on_paint_path."""
        pats = self.doc.resolve(res.get("Pattern"))
        pat = self.doc.resolve(pats.get(name)) if isinstance(pats, dict) else None
        pd = pat.dict if hasattr(pat, "dict") else pat
        if not isinstance(pd, dict):
            return
        ptype = int(self.doc.resolve(pd.get("PatternType", 0)) or 0)
        mtx = self.doc.resolve(pd.get("Matrix"))
        matrix = (
            tuple(float(self.doc.resolve(v)) for v in mtx)
            if isinstance(mtx, list) and len(mtx) == 6
            else IDENTITY
        )
        entry = None
        if ptype == 2:
            entry = ("shading", self.doc.resolve(pd.get("Shading")), matrix)
        elif ptype == 1:
            entry = ("tiling", pat, matrix)
        if entry is None:
            return
        if is_fill:
            self.gs.fill_pattern = entry
            self.gs.fill_color = (0.5, 0.5, 0.5)  # non-raster consumers
        else:
            self.gs.stroke_color = (0.5, 0.5, 0.5)

    def _op_set_font(self, ops: list, res: dict) -> None:
        if len(ops) < 2 or not isinstance(ops[0], str):
            return
        fonts = self.doc.resolve(res.get("Font"))
        self.gs.font_size = float(ops[1])
        if not isinstance(fonts, dict):
            self.gs.font = None
            return
        font_ref = fonts.get(ops[0])
        font_dict = self.doc.resolve(font_ref)
        if isinstance(font_dict, dict):
            self.gs.font = self._load_font_cached(font_ref, font_dict)
        else:
            self.gs.font = None

    def _load_font_cached(self, font_ref: Any, font_dict: dict) -> Font:
        # DOC-scope: Font identity must be stable across renders of the
        # same document, or every id(font)-keyed downstream cache (faces,
        # glyph tiles, coverage) misses on each new interpreter. The
        # resolved font dict comes from the doc's object cache, so
        # id(font_dict) is stable for the doc's life.
        cache = getattr(self.doc, "_font_obj_cache", None)
        if cache is None:
            cache = {}
            self.doc._font_obj_cache = cache
        key = id(font_dict)
        font = cache.get(key)
        if font is None:
            font = load_font(self.doc, font_dict)
            cache[key] = font
        return font

    def _op_td(self, tx: float, ty: float) -> None:
        self.text_line_matrix = mat_mul((1, 0, 0, 1, tx, ty), self.text_line_matrix)
        self.text_matrix = self.text_line_matrix

    def _op_tj_array(self, ops: list) -> None:
        if not ops or not isinstance(ops[0], list):
            return
        gs = self.gs
        for item in ops[0]:
            if isinstance(item, bytes):
                self._show_text(item)
            elif isinstance(item, (int, float)):
                shift = -float(item) / 1000.0 * gs.font_size * gs.h_scale
                self.text_matrix = mat_mul((1, 0, 0, 1, shift, 0), self.text_matrix)

    # ------------------------------------------------------------- text core

    def _show_text(self, raw: bytes) -> None:
        gs = self.gs
        font = gs.font
        if font is None:
            return
        fs, h_scale = gs.font_size, gs.h_scale
        # Within one show-text run only the text-matrix translation moves
        # (along the baseline), so trm's linear part and the per-advance
        # displacement direction are loop invariants — hoisting the two
        # mat_muls per char costs ~0 and text runs are the hot path of
        # page rendering.
        ta, tb, tc, td, te, tf = self.text_matrix
        ca, cb, cc, cd, ce, cf = gs.ctm
        # M = text_matrix @ ctm (linear part; translation tracked per char)
        ma = ta * ca + tb * cc
        mb = ta * cb + tb * cd
        mc = tc * ca + td * cc
        md = tc * cb + td * cd
        # trm = (fs*h, 0, 0, fs, 0, rise) @ M : linear part constant.
        # Operation order below matches the original mat_mul chain
        # bit-for-bit so char bboxes (and the word-gap decisions built on
        # them) are unchanged.
        fsh = fs * h_scale
        rise = gs.rise
        A, B = fsh * ma, fsh * mb
        C, D = fs * mc, fs * md
        rise_mc, rise_md = rise * mc, rise * md
        char_spacing, word_spacing = gs.char_spacing, gs.word_spacing
        on_show_char = self.on_show_char
        is_space = font.is_space_code
        tm_e, tm_f = te, tf
        for code, unicode_text, width1000 in font.iter_codes(raw):
            adv = width1000 / 1000.0 * fs + char_spacing
            if is_space(code):
                adv += word_spacing
            adv *= h_scale
            e = rise_mc + ((tm_e * ca + tm_f * cc) + ce)
            f = rise_md + ((tm_e * cb + tm_f * cd) + cf)
            on_show_char(code, unicode_text, (A, B, C, D, e, f), adv, font)
            tm_e = adv * ta + tm_e
            tm_f = adv * tb + tm_f
        self.text_matrix = (ta, tb, tc, td, tm_e, tm_f)

    # -------------------------------------------------------------- xobjects

    def _op_do(self, ops: list, res: dict) -> None:
        if not ops or not isinstance(ops[0], str):
            return
        xobjs = self.doc.resolve(res.get("XObject"))
        if not isinstance(xobjs, dict):
            return
        xobj = self.doc.resolve(xobjs.get(ops[0]))
        if not isinstance(xobj, Stream):
            return
        subtype = self.doc.resolve(xobj.dict.get("Subtype"))
        if subtype == "Image":
            self.on_draw_image(xobj, ops[0])
        elif subtype == "Form":
            if self._form_depth >= self.MAX_FORM_DEPTH:
                return
            self._form_depth += 1
            saved_gs = replace(self.gs)
            saved_stack_len = len(self.gs_stack)
            try:
                mtx = self.doc.resolve(xobj.dict.get("Matrix"))
                if isinstance(mtx, list) and len(mtx) == 6:
                    self.gs.ctm = mat_mul(
                        tuple(float(self.doc.resolve(v)) for v in mtx), self.gs.ctm
                    )
                form_res = self.doc.resolve(xobj.dict.get("Resources")) or res
                # forms repeat across pages (headers, watermarks, logos):
                # inflate + tokenize once per document. get_object caches
                # by objnum, so id(xobj) is stable for the doc's life.
                cache = getattr(self.doc, "_form_tokens_cache", None)
                if cache is None:
                    cache = {}
                    self.doc._form_tokens_cache = cache
                toks = cache.get(id(xobj))
                if toks is None:
                    toks = list(
                        tokenize_content(self.doc.stream_bytes(xobj))
                    )
                    if len(cache) > 512:
                        cache.clear()
                    cache[id(xobj)] = toks
                self.execute(b"", form_res, tokens=toks)
            finally:
                self.gs = saved_gs
                del self.gs_stack[saved_stack_len:]
                self._form_depth -= 1

    def _op_inline_image(self, img_dict: dict, img_data: bytes, res: dict) -> None:
        d = {Name(_INLINE_KEY_MAP.get(str(k), str(k))): v for k, v in img_dict.items()}
        self.on_draw_inline_image(Stream(d, img_data), res)

    # ----------------------------------------------------------------- hooks

    def on_show_char(
        self, code: int, text: str, trm: Matrix, advance: float, font: Font
    ) -> None:
        """Called per character. trm = text rendering matrix (device space);
        advance = displacement along the text baseline in text space * fs."""

    def on_paint_path(
        self, path: list[list[tuple[float, float]]], *, stroke: bool, fill: bool,
        even_odd: bool,
    ) -> None:
        """Called with device-space polyline subpaths."""

    def on_draw_image(self, stream: Stream, name: str) -> None:
        """Image XObject drawn under current CTM (unit square mapping)."""

    def on_draw_inline_image(self, stream: Stream, res: dict) -> None:
        self.on_draw_image(stream, "__inline__")

    def on_shading(self, ops: list, res: dict) -> None:
        pass
