"""PDF shading (gradient) rasterization + function evaluation.

Fidelity-tail of page rendering: the reference gets axial/radial
gradients, shading patterns and PostScript-calculator color functions
for free from pdfium (reference: rapid_doc/utils/pdf_image_tools.py:26-48
renders via pypdfium2); here they are evaluated directly.

Scope: function types 0 (sampled) / 2 (exponential) / 3 (stitching) /
4 (PostScript calculator); shading types 1 (function-based), 2 (axial),
3 (radial); mesh types 4-7 degrade to their average color (documented —
meshes are rare in document PDFs and OCR only needs plausible pixels).

Everything evaluates vectorized over numpy pixel grids through a
256-entry color LUT, so a full-page gradient costs one LUT build plus
one fancy-index.

Port of ``rapiddoc_tpu/pdfio/shading.py``, unchanged: it runs on numpy
alone, so the port keeps its own copy. Two behaviours ``ADVICE.md``
records are kept as the JAX package has them, since the port is held to
its bytes: the radial solve takes the larger root whose radius is not
negative even where that root lies outside [0, 1] and Extend is off
(``_radial``), and an Indexed shading colour space is read as RGB
(``components_to_rgb``).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np

Matrix = tuple[float, float, float, float, float, float]


def mat_invert(m: Matrix) -> Matrix:
    a, b, c, d, e, f = m
    det = a * d - b * c
    if abs(det) < 1e-12:
        det = 1e-12 if det >= 0 else -1e-12
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    ie = -(e * ia + f * ic)
    if_ = -(e * ib + f * id_)
    return (ia, ib, ic, id_, ie, if_)


# ------------------------------------------------------------- functions


class PdfFunction:
    """Evaluates a PDF function object (or array of them, one per output
    component) on scalar inputs. Shadings sample through a LUT, so the
    scalar path is never hot."""

    def __init__(self, doc, fn_obj: Any):
        self.doc = doc
        fn_obj = doc.resolve(fn_obj)
        if isinstance(fn_obj, list):
            self.parts = [PdfFunction(doc, f) for f in fn_obj]
            self.kind = -1
            self.domain = self.parts[0].domain if self.parts else (0.0, 1.0)
            return
        self.parts = None
        d = fn_obj.dict if hasattr(fn_obj, "dict") else fn_obj
        self.kind = int(doc.resolve(d.get("FunctionType", 2)))
        dom = [float(doc.resolve(v)) for v in doc.resolve(d.get("Domain", [0, 1]))]
        self.domain = (dom[0], dom[1]) if len(dom) >= 2 else (0.0, 1.0)
        rng = doc.resolve(d.get("Range"))
        self.range = (
            [float(doc.resolve(v)) for v in rng] if isinstance(rng, list) else None
        )
        if self.kind == 2:
            self.c0 = [float(doc.resolve(v)) for v in doc.resolve(d.get("C0", [0.0]))]
            self.c1 = [float(doc.resolve(v)) for v in doc.resolve(d.get("C1", [1.0]))]
            self.n = float(doc.resolve(d.get("N", 1)))
        elif self.kind == 3:
            self.funcs = [PdfFunction(doc, f) for f in doc.resolve(d.get("Functions", []))]
            self.bounds = [float(doc.resolve(v)) for v in doc.resolve(d.get("Bounds", []))]
            enc = doc.resolve(d.get("Encode"))
            self.encode = (
                [float(doc.resolve(v)) for v in enc] if isinstance(enc, list) else None
            )
        elif self.kind == 0:
            self._init_sampled(fn_obj, d)
        elif self.kind == 4:
            data = doc.stream_bytes(fn_obj)
            self.program = _ps_parse(data.decode("latin-1"))

    # -- type 0
    def _init_sampled(self, stream_obj, d) -> None:
        doc = self.doc
        self.size = [int(doc.resolve(v)) for v in doc.resolve(d.get("Size", [2]))]
        self.bps = int(doc.resolve(d.get("BitsPerSample", 8)))
        n_in = len(self.size)
        dom = [float(doc.resolve(v)) for v in doc.resolve(d.get("Domain", [0, 1] * n_in))]
        self.domains = [(dom[2 * i], dom[2 * i + 1]) for i in range(n_in)]
        enc = doc.resolve(d.get("Encode"))
        self.encode0 = (
            [float(doc.resolve(v)) for v in enc]
            if isinstance(enc, list)
            else [v for s in self.size for v in (0, s - 1)]
        )
        rng = self.range or [0.0, 1.0]
        self.n_out = len(rng) // 2
        dec = doc.resolve(d.get("Decode"))
        self.decode0 = (
            [float(doc.resolve(v)) for v in dec] if isinstance(dec, list) else list(rng)
        )
        raw = doc.stream_bytes(stream_obj)
        total = self.n_out
        for s in self.size:
            total *= s
        self.samples = _unpack_bits(raw, self.bps, total).astype(np.float64) / (
            (1 << self.bps) - 1
        )

    def __call__(self, t: float) -> list[float]:
        if self.parts is not None:
            out: list[float] = []
            for p in self.parts:
                out.extend(p(t))
            return out
        d0, d1 = self.domain
        t = min(max(t, d0), d1)
        if self.kind == 2:
            try:
                # negative base ** fractional exponent returns COMPLEX in
                # py3 (no exception) — guard explicitly
                if t >= 0 or float(self.n).is_integer():
                    tt = t ** self.n
                else:
                    tt = 0.0
            except (ValueError, OverflowError, ZeroDivisionError):
                tt = 0.0  # e.g. 0 ** negative-integer N
            vals = [a + tt * (b - a) for a, b in zip(self.c0, self.c1)]
        elif self.kind == 3:
            vals = self._eval_stitch(t)
        elif self.kind == 0:
            vals = self._eval_sampled(t)
        elif self.kind == 4:
            vals = _ps_exec(self.program, [t])
            if self.range:
                n_out = len(self.range) // 2
                vals = vals[-n_out:] if len(vals) >= n_out else vals
        else:
            vals = [t]
        if self.range:
            vals = [
                min(max(v, self.range[2 * i]), self.range[2 * i + 1])
                if 2 * i + 1 < len(self.range)
                else v
                for i, v in enumerate(vals)
            ]
        return vals

    def _eval_stitch(self, t: float) -> list[float]:
        d0, d1 = self.domain
        k = 0
        while k < len(self.bounds) and t >= self.bounds[k]:
            k += 1
        lo = d0 if k == 0 else self.bounds[k - 1]
        hi = d1 if k >= len(self.bounds) else self.bounds[k]
        if not self.funcs:
            return [t]
        k = min(k, len(self.funcs) - 1)
        if self.encode and 2 * k + 1 < len(self.encode):
            e0, e1 = self.encode[2 * k], self.encode[2 * k + 1]
        else:
            e0, e1 = 0.0, 1.0
        u = e0 if hi <= lo else e0 + (t - lo) / (hi - lo) * (e1 - e0)
        return self.funcs[k](u)

    def _eval_sampled(self, t: float) -> list[float]:
        # 1-D linear interpolation (the shading case); >1-D inputs take
        # the nearest sample
        if len(self.size) == 1:
            d0, d1 = self.domains[0]
            e0, e1 = self.encode0[0], self.encode0[1]
            u = e0 if d1 <= d0 else e0 + (t - d0) / (d1 - d0) * (e1 - e0)
            u = min(max(u, 0.0), self.size[0] - 1)
            i0 = int(math.floor(u))
            i1 = min(i0 + 1, self.size[0] - 1)
            frac = u - i0
            out = []
            for j in range(self.n_out):
                s0 = self.samples[i0 * self.n_out + j]
                s1 = self.samples[i1 * self.n_out + j]
                v = s0 + (s1 - s0) * frac
                dd0, dd1 = self.decode0[2 * j], self.decode0[2 * j + 1]
                out.append(dd0 + v * (dd1 - dd0))
            return out
        idx = 0
        stride = 1
        for dim in range(len(self.size)):
            d0, d1 = self.domains[dim]
            e0, e1 = self.encode0[2 * dim], self.encode0[2 * dim + 1]
            u = e0 if d1 <= d0 else e0 + (t - d0) / (d1 - d0) * (e1 - e0)
            i = int(round(min(max(u, 0), self.size[dim] - 1)))
            idx += i * stride
            stride *= self.size[dim]
        out = []
        for j in range(self.n_out):
            v = self.samples[idx * self.n_out + j]
            dd0, dd1 = self.decode0[2 * j], self.decode0[2 * j + 1]
            out.append(dd0 + v * (dd1 - dd0))
        return out


def _unpack_bits(raw: bytes, bps: int, count: int) -> np.ndarray:
    if bps == 8:
        return np.frombuffer(raw[:count], dtype=np.uint8).astype(np.uint32)
    if bps == 16:
        return np.frombuffer(raw[: 2 * count], dtype=">u2").astype(np.uint32)
    if bps == 32:
        return np.frombuffer(raw[: 4 * count], dtype=">u4").astype(np.uint32)
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    usable = (len(bits) // bps) * bps
    groups = bits[:usable].reshape(-1, bps)
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.uint32)
    vals = (groups * weights).sum(axis=1)
    return vals[:count]


# -------------------------------------------------- PostScript calculator


def _ps_parse(src: str) -> list:
    """Parse a type-4 function program into a nested op list."""
    toks = src.replace("{", " { ").replace("}", " } ").split()

    def block(i: int) -> tuple[list, int]:
        out: list = []
        while i < len(toks):
            tk = toks[i]
            if tk == "{":
                sub, i = block(i + 1)
                out.append(sub)
            elif tk == "}":
                return out, i + 1
            else:
                try:
                    out.append(float(tk) if ("." in tk or "e" in tk.lower()) else int(tk))
                except ValueError:
                    out.append(tk)
                i += 1
        return out, i

    prog, _ = block(0)
    # outermost braces wrap the whole program
    if len(prog) == 1 and isinstance(prog[0], list):
        return prog[0]
    return prog


def _ps_exec(prog: list, stack: list[float], depth: int = 0) -> list[float]:
    """Execute a parsed calculator program on a value stack."""
    if depth > 32:
        return stack
    st = stack
    i = 0
    n = len(prog)
    while i < n:
        op = prog[i]
        i += 1
        if isinstance(op, (int, float)):
            st.append(float(op))
            continue
        if isinstance(op, list):
            st.append(op)  # deferred block for if/ifelse
            continue
        try:
            if op == "add":
                b, a = st.pop(), st.pop(); st.append(a + b)
            elif op == "sub":
                b, a = st.pop(), st.pop(); st.append(a - b)
            elif op == "mul":
                b, a = st.pop(), st.pop(); st.append(a * b)
            elif op == "div":
                b, a = st.pop(), st.pop(); st.append(a / b if b else 0.0)
            elif op == "idiv":
                b, a = st.pop(), st.pop(); st.append(float(int(a) // int(b)) if b else 0.0)
            elif op == "mod":
                b, a = st.pop(), st.pop(); st.append(float(int(a) % int(b)) if b else 0.0)
            elif op == "neg":
                st.append(-st.pop())
            elif op == "abs":
                st.append(abs(st.pop()))
            elif op == "sqrt":
                st.append(math.sqrt(max(st.pop(), 0.0)))
            elif op == "sin":
                st.append(math.sin(math.radians(st.pop())))
            elif op == "cos":
                st.append(math.cos(math.radians(st.pop())))
            elif op == "atan":
                b, a = st.pop(), st.pop()
                st.append(math.degrees(math.atan2(a, b)) % 360.0)
            elif op == "exp":
                b, a = st.pop(), st.pop()
                # complex-result guard (neg base, fractional exponent)
                st.append(
                    a ** b if a >= 0 or float(b).is_integer() else 0.0
                )
            elif op == "ln":
                st.append(math.log(max(st.pop(), 1e-300)))
            elif op == "log":
                st.append(math.log10(max(st.pop(), 1e-300)))
            elif op in ("ceiling",):
                st.append(float(math.ceil(st.pop())))
            elif op == "floor":
                st.append(float(math.floor(st.pop())))
            elif op == "round":
                st.append(float(round(st.pop())))
            elif op == "truncate":
                st.append(float(int(st.pop())))
            elif op == "cvi":
                st.append(float(int(st.pop())))
            elif op == "cvr":
                st.append(float(st.pop()))
            elif op == "dup":
                st.append(st[-1])
            elif op == "pop":
                st.pop()
            elif op == "exch":
                st[-1], st[-2] = st[-2], st[-1]
            elif op == "copy":
                k = int(st.pop())
                if k > 0:
                    st.extend(st[-k:])
            elif op == "index":
                k = int(st.pop())
                st.append(st[-1 - k])
            elif op == "roll":
                j = int(st.pop()); k = int(st.pop())
                if k > 0:
                    j %= k
                    part = st[-k:]
                    del st[-k:]
                    st.extend(part[-j:] + part[:-j])
            elif op in ("eq", "ne", "gt", "ge", "lt", "le"):
                b, a = st.pop(), st.pop()
                res = {
                    "eq": a == b, "ne": a != b, "gt": a > b,
                    "ge": a >= b, "lt": a < b, "le": a <= b,
                }[op]
                st.append(1.0 if res else 0.0)
            elif op in ("and", "or", "xor"):
                b, a = int(st.pop()), int(st.pop())
                st.append(float({"and": a & b, "or": a | b, "xor": a ^ b}[op]))
            elif op == "not":
                v = st.pop()
                st.append(0.0 if v else 1.0)
            elif op == "bitshift":
                b, a = int(st.pop()), int(st.pop())
                st.append(float(a << b if b >= 0 else a >> -b))
            elif op == "true":
                st.append(1.0)
            elif op == "false":
                st.append(0.0)
            elif op == "if":
                blk = st.pop()
                cond = st.pop()
                if cond and isinstance(blk, list):
                    _ps_exec(blk, st, depth + 1)
            elif op == "ifelse":
                blk2, blk1 = st.pop(), st.pop()
                cond = st.pop()
                blk = blk1 if cond else blk2
                if isinstance(blk, list):
                    _ps_exec(blk, st, depth + 1)
            # unknown operators are skipped
        except (IndexError, ValueError, OverflowError, ZeroDivisionError):
            break
    return [v for v in st if isinstance(v, float)]


# ----------------------------------------------------------- color spaces


def components_to_rgb(doc, cs_obj: Any, comps: list[float]) -> tuple[float, float, float]:
    """Map color components in an arbitrary space to RGB floats."""
    cs = doc.resolve(cs_obj)
    name = cs if isinstance(cs, str) else None
    if isinstance(cs, list) and cs:
        head = doc.resolve(cs[0])
        if head in ("ICCBased",):
            stream = doc.resolve(cs[1]) if len(cs) > 1 else None
            n = 3
            if stream is not None and hasattr(stream, "dict"):
                n = int(doc.resolve(stream.dict.get("N", 3)))
            name = {1: "DeviceGray", 3: "DeviceRGB", 4: "DeviceCMYK"}.get(n, "DeviceRGB")
        elif head in ("CalRGB", "Lab"):
            name = "DeviceRGB" if head == "CalRGB" else "Lab"
        elif head == "CalGray":
            name = "DeviceGray"
        elif head in ("Separation", "DeviceN") and len(cs) >= 4:
            alt = cs[2]
            try:
                tint = PdfFunction(doc, cs[3])
                out = tint(comps[0] if comps else 0.0)
                return components_to_rgb(doc, alt, out)
            except Exception:
                v = 1.0 - (comps[0] if comps else 0.0)
                return (v, v, v)
        elif head == "Indexed":
            name = "DeviceRGB"
    n = len(comps)
    if name == "DeviceGray" or (name is None and n == 1):
        v = comps[0] if comps else 0.0
        return (v, v, v)
    if name == "DeviceCMYK" or (name is None and n == 4):
        c, m, y, k = (comps + [0, 0, 0, 0])[:4]
        return ((1 - c) * (1 - k), (1 - m) * (1 - k), (1 - y) * (1 - k))
    if name == "Lab" and n >= 3:
        L, a_, b_ = comps[:3]
        # quick CIELab->sRGB approximation (document shadings rarely Lab)
        y = (L + 16.0) / 116.0
        x = y + a_ / 500.0
        z = y - b_ / 200.0

        def pivot(v: float) -> float:
            return v ** 3 if v ** 3 > 0.008856 else (v - 16.0 / 116.0) / 7.787

        X, Y, Z = pivot(x) * 0.95047, pivot(y), pivot(z) * 1.08883
        r = X * 3.2406 - Y * 1.5372 - Z * 0.4986
        g = -X * 0.9689 + Y * 1.8758 + Z * 0.0415
        b = X * 0.0557 - Y * 0.2040 + Z * 1.0570
        return tuple(min(max(v, 0.0), 1.0) for v in (r, g, b))
    r, g, b = (comps + [0, 0, 0])[:3]
    return (r, g, b)


# ---------------------------------------------------------------- shading


def _color_lut(doc, sh: dict, n: int = 256) -> tuple[np.ndarray, float, float]:
    """(n,3) uint8 LUT over the shading function's domain. Cached PER
    DOCUMENT by shading-dict identity (ids are stable for the doc's
    life via its object cache; a module-global id-keyed cache could
    collide across documents after gc): a page that fills many paths
    with one pattern would otherwise re-evaluate the (possibly
    Separation-tinted or sampled) function stack 256 times per fill."""
    cache = getattr(doc, "_shading_lut_cache", None)
    if cache is None:
        cache = {}
        try:
            doc._shading_lut_cache = cache
        except AttributeError:  # stub docs in tests
            pass
    key = (id(sh), n)
    hit = cache.get(key)
    if hit is not None:
        return hit
    fn = PdfFunction(doc, sh.get("Function"))
    d0, d1 = 0.0, 1.0
    dom = doc.resolve(sh.get("Domain"))
    if isinstance(dom, list) and len(dom) >= 2:
        d0, d1 = float(doc.resolve(dom[0])), float(doc.resolve(dom[1]))
    cs = sh.get("ColorSpace", "DeviceRGB")
    lut = np.empty((n, 3), dtype=np.uint8)
    for i in range(n):
        t = d0 + (d1 - d0) * i / (n - 1)
        comps = fn(t)
        r, g, b = components_to_rgb(doc, cs, comps)
        lut[i] = (
            int(min(max(r, 0.0), 1.0) * 255),
            int(min(max(g, 0.0), 1.0) * 255),
            int(min(max(b, 0.0), 1.0) * 255),
        )
    if len(cache) > 256:
        cache.clear()
    cache[key] = (lut, d0, d1)
    return lut, d0, d1


def render_shading(
    doc,
    sh: dict,
    ctm: Matrix,
    region: tuple[int, int, int, int],
) -> tuple[np.ndarray, np.ndarray] | None:
    """Rasterize a shading dict over device-pixel `region` (x0,y0,x1,y1).

    Returns (rgb uint8 [H,W,3], alpha float [H,W] in 0..1) or None when
    the shading type is unsupported and nothing should be painted.
    `ctm` maps shading space -> device pixels.
    """
    sh = doc.resolve(sh)
    if hasattr(sh, "dict"):  # stream-based shading (mesh types)
        sh_dict = sh.dict
    else:
        sh_dict = sh
    if not isinstance(sh_dict, dict):
        return None
    stype = int(doc.resolve(sh_dict.get("ShadingType", 0)))
    x0, y0, x1, y1 = region
    w, h = x1 - x0, y1 - y0
    if w <= 0 or h <= 0:
        return None

    # device pixel centers -> shading space
    inv = mat_invert(ctm)
    xs = np.arange(x0, x1, dtype=np.float64) + 0.5
    ys = np.arange(y0, y1, dtype=np.float64) + 0.5
    gx, gy = np.meshgrid(xs, ys)
    ia, ib, ic, id_, ie, if_ = inv
    sx = gx * ia + gy * ic + ie
    sy = gx * ib + gy * id_ + if_

    if stype == 2:
        return _axial(doc, sh_dict, sx, sy)
    if stype == 3:
        return _radial(doc, sh_dict, sx, sy)
    if stype == 1:
        return _function_based(doc, sh_dict, sx, sy)
    if stype in (4, 5, 6, 7):
        # mesh shading: degrade to the average color of the function
        # range (or Background) over the full region
        try:
            lut, _, _ = _color_lut(doc, sh_dict, 32)
            avg = lut.mean(axis=0).astype(np.uint8)
        except Exception:
            bg = doc.resolve(sh_dict.get("Background"))
            if not isinstance(bg, list):
                return None
            r, g, b = components_to_rgb(
                doc, sh_dict.get("ColorSpace", "DeviceRGB"),
                [float(doc.resolve(v)) for v in bg],
            )
            avg = np.array([r * 255, g * 255, b * 255], dtype=np.uint8)
        rgb = np.broadcast_to(avg, (h, w, 3)).copy()
        return rgb, np.ones((h, w), dtype=np.float64)
    return None


def _lut_colors(lut: np.ndarray, t: np.ndarray) -> np.ndarray:
    idx = np.clip((t * (len(lut) - 1)).round().astype(np.int32), 0, len(lut) - 1)
    return lut[idx]


def _axial(doc, sh: dict, sx: np.ndarray, sy: np.ndarray):
    coords = [float(doc.resolve(v)) for v in doc.resolve(sh.get("Coords", [0, 0, 1, 0]))]
    if len(coords) < 4:
        return None
    ax0, ay0, ax1, ay1 = coords[:4]
    dx, dy = ax1 - ax0, ay1 - ay0
    denom = dx * dx + dy * dy
    if denom <= 0:
        denom = 1e-12
    t = ((sx - ax0) * dx + (sy - ay0) * dy) / denom
    ext = doc.resolve(sh.get("Extend", [False, False]))
    e0 = bool(doc.resolve(ext[0])) if isinstance(ext, list) and ext else False
    e1 = bool(doc.resolve(ext[1])) if isinstance(ext, list) and len(ext) > 1 else False
    alpha = np.ones_like(t)
    if not e0:
        alpha[t < 0] = 0.0
    if not e1:
        alpha[t > 1] = 0.0
    t = np.clip(t, 0.0, 1.0)
    lut, _, _ = _color_lut(doc, sh)
    return _lut_colors(lut, t), alpha


def _radial(doc, sh: dict, sx: np.ndarray, sy: np.ndarray):
    coords = [float(doc.resolve(v)) for v in doc.resolve(sh.get("Coords", [0, 0, 0, 0, 0, 1]))]
    if len(coords) < 6:
        return None
    cx0, cy0, r0, cx1, cy1, r1 = coords[:6]
    ext = doc.resolve(sh.get("Extend", [False, False]))
    e0 = bool(doc.resolve(ext[0])) if isinstance(ext, list) and ext else False
    e1 = bool(doc.resolve(ext[1])) if isinstance(ext, list) and len(ext) > 1 else False
    # solve |p - c(s)| = r(s), c(s)=c0+s*dc, r(s)=r0+s*dr for the
    # largest s where r(s) >= 0 (PDF 32000 8.7.4.5.4)
    dcx, dcy, dr = cx1 - cx0, cy1 - cy0, r1 - r0
    pdx = sx - cx0
    pdy = sy - cy0
    a = dcx * dcx + dcy * dcy - dr * dr
    b = 2.0 * (pdx * dcx + pdy * dcy + r0 * dr)
    c = pdx * pdx + pdy * pdy - r0 * r0
    s = np.full(sx.shape, np.nan)
    with np.errstate(invalid="ignore", divide="ignore"):
        lin = np.abs(a) < 1e-9
        # linear case: b*s = c
        s_lin = np.where(np.abs(b) > 1e-12, c / b, np.nan)
        disc = b * b - 4.0 * a * c
        sq = np.sqrt(np.maximum(disc, 0.0))
        s1 = (b + sq) / (2.0 * a)
        s2 = (b - sq) / (2.0 * a)
        # prefer the larger root with r(s) >= 0
        big = np.maximum(s1, s2)
        small = np.minimum(s1, s2)
        r_big = r0 + big * dr
        r_small = r0 + small * dr
        cand = np.where(r_big >= 0, big, np.where(r_small >= 0, small, np.nan))
        cand = np.where(disc >= 0, cand, np.nan)
        s = np.where(lin, s_lin, cand)
    alpha = np.isfinite(s).astype(np.float64)
    s = np.nan_to_num(s, nan=0.0)
    if not e0:
        alpha[s < 0] = 0.0
    if not e1:
        alpha[s > 1] = 0.0
    # extension keeps radius non-negative
    r_at = r0 + s * dr
    alpha[r_at < 0] = 0.0
    s = np.clip(s, 0.0, 1.0)
    lut, _, _ = _color_lut(doc, sh)
    return _lut_colors(lut, s), alpha


def _function_based(doc, sh: dict, sx: np.ndarray, sy: np.ndarray):
    """Type 1: color = f(x, y) over Domain; sampled on a 64x64 grid then
    bilinearly upsampled (exact per-pixel eval would run the scalar
    function per pixel)."""
    dom = doc.resolve(sh.get("Domain", [0, 1, 0, 1]))
    dom = [float(doc.resolve(v)) for v in dom] if isinstance(dom, list) else [0, 1, 0, 1]
    dx0, dx1, dy0, dy1 = (dom + [0, 1, 0, 1])[:4]
    mtx = doc.resolve(sh.get("Matrix"))
    if isinstance(mtx, list) and len(mtx) == 6:
        inv = mat_invert(tuple(float(doc.resolve(v)) for v in mtx))
        ia, ib, ic, id_, ie, if_ = inv
        ux = sx * ia + sy * ic + ie
        uy = sx * ib + sy * id_ + if_
    else:
        ux, uy = sx, sy
    try:
        fn = PdfFunction(doc, sh.get("Function"))
    except Exception:
        return None
    cs = sh.get("ColorSpace", "DeviceRGB")
    G = 48
    grid = np.zeros((G, G, 3), dtype=np.float64)
    for j in range(G):
        for i in range(G):
            x = dx0 + (dx1 - dx0) * i / (G - 1)
            y = dy0 + (dy1 - dy0) * j / (G - 1)
            try:
                comps = list(_ps_exec(fn.program, [x, y])) if fn.kind == 4 else fn(x)
            except Exception:
                comps = [0.5]
            r, g, b = components_to_rgb(doc, cs, comps)
            grid[j, i] = (r, g, b)
    # map pixel coords into grid indices
    with np.errstate(invalid="ignore", divide="ignore"):
        gi = (ux - dx0) / max(dx1 - dx0, 1e-12) * (G - 1)
        gj = (uy - dy0) / max(dy1 - dy0, 1e-12) * (G - 1)
    inside = (gi >= 0) & (gi <= G - 1) & (gj >= 0) & (gj <= G - 1)
    gi = np.clip(np.nan_to_num(gi), 0, G - 1)
    gj = np.clip(np.nan_to_num(gj), 0, G - 1)
    i0 = np.floor(gi).astype(np.int32)
    j0 = np.floor(gj).astype(np.int32)
    i1 = np.minimum(i0 + 1, G - 1)
    j1 = np.minimum(j0 + 1, G - 1)
    fi = (gi - i0)[..., None]
    fj = (gj - j0)[..., None]
    col = (
        grid[j0, i0] * (1 - fi) * (1 - fj)
        + grid[j0, i1] * fi * (1 - fj)
        + grid[j1, i0] * (1 - fi) * fj
        + grid[j1, i1] * fi * fj
    )
    rgb = (np.clip(col, 0, 1) * 255).astype(np.uint8)
    return rgb, inside.astype(np.float64)
