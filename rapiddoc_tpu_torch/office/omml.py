"""OMML (Office Math Markup) -> LaTeX conversion.

A copy of ``rapiddoc_tpu/office/omml.py`` (standard library only), kept in the port so
that it imports nothing of the JAX package.

Behavioral counterpart of the reference converter
(reference: rapid_doc/model/docx/tools/math/omml.py): recursive walk over
m:* elements mapping to LaTeX constructs. Covers the structures that occur
in practice: fractions, scripts, radicals, n-ary operators, delimiters,
functions, matrices, bars and accents.
"""
from __future__ import annotations

from .common import NS, q

M = NS["m"]


def _mq(local: str) -> str:
    return f"{{{M}}}{local}"


_CHAR_MAP = {
    "∞": r"\infty", "±": r"\pm", "∓": r"\mp", "×": r"\times",
    "÷": r"\div", "≤": r"\leq", "≥": r"\geq", "≠": r"\neq",
    "≈": r"\approx", "≡": r"\equiv", "∂": r"\partial", "∇": r"\nabla",
    "∑": r"\sum", "∏": r"\prod", "∫": r"\int", "∈": r"\in",
    "∉": r"\notin", "⊂": r"\subset", "⊆": r"\subseteq", "∪": r"\cup",
    "∩": r"\cap", "→": r"\rightarrow", "←": r"\leftarrow",
    "⇒": r"\Rightarrow", "⇔": r"\Leftrightarrow", "∀": r"\forall",
    "∃": r"\exists", "√": r"\sqrt{}", "°": r"^\circ", "…": r"\ldots",
    "⋅": r"\cdot", "α": r"\alpha", "β": r"\beta", "γ": r"\gamma",
    "δ": r"\delta", "ε": r"\varepsilon", "ζ": r"\zeta", "η": r"\eta",
    "θ": r"\theta", "ι": r"\iota", "κ": r"\kappa", "λ": r"\lambda",
    "μ": r"\mu", "ν": r"\nu", "ξ": r"\xi", "π": r"\pi", "ρ": r"\rho",
    "σ": r"\sigma", "τ": r"\tau", "υ": r"\upsilon", "φ": r"\varphi",
    "χ": r"\chi", "ψ": r"\psi", "ω": r"\omega", "Γ": r"\Gamma",
    "Δ": r"\Delta", "Θ": r"\Theta", "Λ": r"\Lambda", "Ξ": r"\Xi",
    "Π": r"\Pi", "Σ": r"\Sigma", "Φ": r"\Phi", "Ψ": r"\Psi",
    "Ω": r"\Omega",
}


# letterlike symbols carry semantics NFKC would erase (ℝ→R loses
# \mathbb{R}); superscript/subscript literals would fold to plain digits
# (x²→x2), silently changing the equation — map them explicitly instead
# (reference uses an explicit T2L/latex_dict table for the same reason)
_LETTERLIKE = {
    "ℝ": r"\mathbb{R}", "ℂ": r"\mathbb{C}", "ℕ": r"\mathbb{N}",
    "ℤ": r"\mathbb{Z}", "ℚ": r"\mathbb{Q}", "ℍ": r"\mathbb{H}",
    "ℙ": r"\mathbb{P}", "ℓ": r"\ell", "ℏ": r"\hbar", "ℑ": r"\Im",
    "ℜ": r"\Re", "ℵ": r"\aleph", "℘": r"\wp", "ℒ": r"\mathcal{L}",
    "ℱ": r"\mathcal{F}", "ℋ": r"\mathcal{H}", "ℬ": r"\mathcal{B}",
    "ℯ": "e", "ℊ": "g", "ℴ": "o",
}
_SUPERSCRIPTS = {
    "⁰": "0", "¹": "1", "²": "2", "³": "3", "⁴": "4", "⁵": "5",
    "⁶": "6", "⁷": "7", "⁸": "8", "⁹": "9", "⁺": "+", "⁻": "-",
    "⁼": "=", "⁽": "(", "⁾": ")", "ⁿ": "n", "ⁱ": "i",
}
_SUBSCRIPTS = {
    "₀": "0", "₁": "1", "₂": "2", "₃": "3", "₄": "4", "₅": "5",
    "₆": "6", "₇": "7", "₈": "8", "₉": "9", "₊": "+", "₋": "-",
    "₌": "=", "₍": "(", "₎": ")",
}


def _fold_char(ch: str) -> str:
    """NFKC-fold ONLY the Mathematical Alphanumeric Symbols block
    (U+1D400–U+1D7FF, e.g. 𝑓 𝜋 → f π) — the one block where folding is
    lossless for LaTeX; everything else maps through explicit tables."""
    import unicodedata

    cp = ord(ch)
    if 0x1D400 <= cp <= 0x1D7FF:
        return unicodedata.normalize("NFKC", ch)
    return ch


def _map_text(text: str) -> str:
    out: list[str] = []
    for ch in text:
        ch = _fold_char(ch)
        if ch in _LETTERLIKE:
            rep = _LETTERLIKE[ch]
        elif ch in _SUPERSCRIPTS:
            rep = "^{" + _SUPERSCRIPTS[ch] + "}"
        elif ch in _SUBSCRIPTS:
            rep = "_{" + _SUBSCRIPTS[ch] + "}"
        else:
            rep = _CHAR_MAP.get(ch, ch)
        # a control word (\pi) followed by a letter would fuse into an
        # undefined macro (\pix); keep the boundary with a space
        if out and "\\" in out[-1] and out[-1][-1].isalpha() and rep[:1].isalpha():
            out.append(" ")
        out.append(rep)
    return "".join(out)


def _children(el, local: str):
    return el.findall(_mq(local))


def _child(el, local: str):
    return el.find(_mq(local))


def _val(el, local: str, attr: str = f"{{{M}}}val") -> str | None:
    sub = _child(el, local) if local else el
    if sub is None:
        return None
    return sub.get(attr)


def omml_to_latex(el) -> str:
    """Convert an m:oMath / m:oMathPara element (lxml/ElementTree) to LaTeX."""
    return _walk(el).strip()


_CTRL_TAIL = __import__("re").compile(r"\\[a-zA-Z]+$")


def _walk(el) -> str:
    out = []
    for child in el:
        tag = child.tag
        if not isinstance(tag, str) or not tag.startswith(f"{{{M}}}"):
            continue
        local = tag[len(M) + 2 :]
        handler = _HANDLERS.get(local, _walk)
        piece = handler(child)
        # adjacent runs may join a control word to a letter (\pi + x
        # -> \pix, an undefined macro); keep the boundary
        if out and piece[:1].isalpha() and _CTRL_TAIL.search(out[-1]):
            out.append(" ")
        out.append(piece)
    return "".join(out)


def _h_r(el) -> str:
    text = "".join(t.text or "" for t in el.findall(_mq("t")))
    return _map_text(text)


def _h_f(el) -> str:
    num = _child(el, "num")
    den = _child(el, "den")
    fpr = _child(el, "fPr")
    bar = _val(fpr if fpr is not None else el, "type") if fpr is not None else None
    n = _walk(num) if num is not None else ""
    d = _walk(den) if den is not None else ""
    if bar == "lin":
        return f"{n}/{d}"
    return rf"\frac{{{n}}}{{{d}}}"


def _h_sup(el) -> str:
    base = _child(el, "e")
    sup = _child(el, "sup")
    return f"{{{_walk(base) if base is not None else ''}}}^{{{_walk(sup) if sup is not None else ''}}}"


def _h_sub(el) -> str:
    base = _child(el, "e")
    sub = _child(el, "sub")
    return f"{{{_walk(base) if base is not None else ''}}}_{{{_walk(sub) if sub is not None else ''}}}"


def _h_subsup(el) -> str:
    base = _child(el, "e")
    sub = _child(el, "sub")
    sup = _child(el, "sup")
    return (
        f"{{{_walk(base) if base is not None else ''}}}"
        f"_{{{_walk(sub) if sub is not None else ''}}}"
        f"^{{{_walk(sup) if sup is not None else ''}}}"
    )


def _h_rad(el) -> str:
    deg = _child(el, "deg")
    e = _child(el, "e")
    body = _walk(e) if e is not None else ""
    deg_txt = _walk(deg) if deg is not None else ""
    if deg_txt:
        return rf"\sqrt[{deg_txt}]{{{body}}}"
    return rf"\sqrt{{{body}}}"


def _h_nary(el) -> str:
    pr = _child(el, "naryPr")
    chr_ = None
    if pr is not None:
        chr_ = _val(pr, "chr")
    op = {_c: l for _c, l in (("∑", r"\sum"), ("∏", r"\prod"), ("∫", r"\int"),
                              ("∬", r"\iint"), ("∭", r"\iiint"), ("∮", r"\oint"),
                              ("⋃", r"\bigcup"), ("⋂", r"\bigcap"))}.get(
        chr_ or "∫", _CHAR_MAP.get(chr_ or "", r"\int")
    )
    sub = _child(el, "sub")
    sup = _child(el, "sup")
    e = _child(el, "e")
    out = op
    if sub is not None and len(sub):
        out += f"_{{{_walk(sub)}}}"
    if sup is not None and len(sup):
        out += f"^{{{_walk(sup)}}}"
    out += f" {_walk(e) if e is not None else ''}"
    return out


def _h_d(el) -> str:
    pr = _child(el, "dPr")
    left = (_val(pr, "begChr") if pr is not None else None)
    right = (_val(pr, "endChr") if pr is not None else None)
    left = left if left is not None else "("
    right = right if right is not None else ")"
    body = ", ".join(_walk(e) for e in _children(el, "e"))
    lmap = {"(": "(", "[": "[", "{": r"\{", "|": "|", "‖": r"\|", "⟨": r"\langle", "": "."}
    rmap = {")": ")", "]": "]", "}": r"\}", "|": "|", "‖": r"\|", "⟩": r"\rangle", "": "."}
    return rf"\left{lmap.get(left, left)}{body}\right{rmap.get(right, right)}"


_FUNC_NAMES = {
    "sin", "cos", "tan", "cot", "sec", "csc", "sinh", "cosh", "tanh",
    "coth", "arcsin", "arccos", "arctan", "log", "ln", "exp", "lim",
    "min", "max", "det", "gcd", "inf", "sup", "arg", "deg", "dim",
    "hom", "ker", "Pr",
}


def _h_func(el) -> str:
    name = _child(el, "fName")
    e = _child(el, "e")
    fname = _walk(name) if name is not None else ""
    # bare function names become their LaTeX operator form (\cos, \lim)
    if fname in _FUNC_NAMES:
        fname = "\\" + fname
    return f"{fname}{{{_walk(e) if e is not None else ''}}}"


def _h_m(el) -> str:
    rows = []
    for mr in _children(el, "mr"):
        rows.append(" & ".join(_walk(e) for e in _children(mr, "e")))
    return r"\begin{matrix}" + r" \\ ".join(rows) + r"\end{matrix}"


def _h_acc(el) -> str:
    pr = _child(el, "accPr")
    chr_ = _val(pr, "chr") if pr is not None else None
    e = _child(el, "e")
    body = _walk(e) if e is not None else ""
    accents = {
        "́": r"\acute", "̀": r"\grave", "̂": r"\hat", "̃": r"\tilde",
        "̄": r"\bar", "̇": r"\dot", "̈": r"\ddot", "⃗": r"\vec",
        "̆": r"\breve", "̌": r"\check",
    }
    macro = accents.get(chr_ or "̂", r"\hat")
    return rf"{macro}{{{body}}}"


def _h_bar(el) -> str:
    pr = _child(el, "barPr")
    pos = _val(pr, "pos") if pr is not None else None
    e = _child(el, "e")
    body = _walk(e) if e is not None else ""
    if pos == "top":
        return rf"\overline{{{body}}}"
    return rf"\underline{{{body}}}"


def _h_limlow(el) -> str:
    e = _child(el, "e")
    lim = _child(el, "lim")
    return rf"{_walk(e) if e is not None else ''}_{{{_walk(lim) if lim is not None else ''}}}"


def _h_limupp(el) -> str:
    e = _child(el, "e")
    lim = _child(el, "lim")
    return rf"{_walk(e) if e is not None else ''}^{{{_walk(lim) if lim is not None else ''}}}"


def _h_eqarr(el) -> str:
    rows = [_walk(e) for e in _children(el, "e")]
    return r"\begin{aligned}" + r" \\ ".join(rows) + r"\end{aligned}"


def _h_groupchr(el) -> str:
    pr = _child(el, "groupChrPr")
    chr_ = _val(pr, "chr") if pr is not None else None
    e = _child(el, "e")
    body = _walk(e) if e is not None else ""
    if chr_ == "⏟":
        return rf"\underbrace{{{body}}}"
    if chr_ == "⏞":
        return rf"\overbrace{{{body}}}"
    return body


_HANDLERS = {
    "r": _h_r,
    "f": _h_f,
    "sSup": _h_sup,
    "sSub": _h_sub,
    "sSubSup": _h_subsup,
    "rad": _h_rad,
    "nary": _h_nary,
    "d": _h_d,
    "func": _h_func,
    "m": _h_m,
    "acc": _h_acc,
    "bar": _h_bar,
    "limLow": _h_limlow,
    "limUpp": _h_limupp,
    "eqArr": _h_eqarr,
    "groupChr": _h_groupchr,
    "e": _walk,
    "num": _walk,
    "den": _walk,
    "oMath": _walk,
    "oMathPara": _walk,
    "fName": _walk,
    "lim": _walk,
    "sub": _walk,
    "sup": _walk,
}
