"""RAG chunker: markdown-structure-aware splitting + bbox back-mapping.

Role parity with the reference chunker (reference:
chunker/text_splitters.py:43-564 — AST-based chunks with heading
context, HTML-table integrity with row/cell-preserving oversize splits,
tiktoken budgets; chunker/get_bbox_page_fast.py:8-144 — chunk->bbox
attribution by similarity anchor + contiguous block expansion).

Design differences from the reference (re-derived, not translated):

- the block parser here is a from-scratch line scanner that records the
  SOURCE CHAR RANGE of every block, so chunks know exactly which
  markdown slices they contain — back-mapping tries exact normalized
  char-offset lookup against the middle-json span stream first and only
  falls back to the reference's fuzzy anchor+expand walk;
- when given a middle_json the mapping is SPAN-level (every text span's
  own bbox), not just block-level;
- token counting uses tiktoken when importable with a CJK-aware
  heuristic fallback, so the package works without it.

Copy of the JAX package's module.
"""
from __future__ import annotations

import re
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$")
_TABLE_OPEN_RE = re.compile(r"<table\b", re.I)
_TABLE_CLOSE_RE = re.compile(r"</table\s*>", re.I)
_TR_RE = re.compile(r"<tr\b.*?</tr>\s*", re.S | re.I)
_CELL_RE = re.compile(r"<t[hd]\b.*?</t[hd]>\s*", re.S | re.I)
_TAG_RE = re.compile(r"<[^>]+>")
_FENCE_RE = re.compile(r"^(```|~~~)")
_LIST_RE = re.compile(r"^(\s*)([-*+]|\d+[.)])\s+")
_HR_RE = re.compile(r"^\s*(-{3,}|\*{3,}|_{3,})\s*$")

# ------------------------------------------------------------------ tokens


def _heuristic_tokens(s: str) -> int:
    """tiktoken-free approximation: CJK chars are ~1 token each, the
    rest ~1 per 4 chars (cl100k's long-run average on latin text)."""
    cjk = sum(1 for ch in s if "一" <= ch <= "鿿" or
              "぀" <= ch <= "ヿ" or "가" <= ch <= "힯")
    return cjk + max(0, (len(s) - cjk) + 3) // 4


_ENCODER = None


def num_tokens_from_string(s: str) -> int:
    """Token budget counter (reference: text_splitters.py:36-41)."""
    global _ENCODER
    if _ENCODER is None:
        try:
            import tiktoken

            _ENCODER = tiktoken.get_encoding("cl100k_base")
        except Exception:
            _ENCODER = False
    if _ENCODER:
        try:
            return len(_ENCODER.encode(s))
        except Exception:
            return _heuristic_tokens(s)
    return _heuristic_tokens(s)


# ------------------------------------------------------------- block parse


@dataclass
class MdBlock:
    """One block-level markdown element with its source char range."""

    kind: str  # heading | table | code | quote | list | hr | paragraph
    start: int
    end: int
    text: str
    level: int = 0  # heading level


def parse_blocks(md: str) -> list[MdBlock]:
    """Line-scanning block parser. HTML tables are kept whole across
    blank lines by tag-balance counting (reference merges fragmented
    html_blocks the same way, text_splitters.py:135-172)."""
    blocks: list[MdBlock] = []
    # line start offsets
    lines = md.split("\n")
    offs = [0]
    for ln in lines:
        offs.append(offs[-1] + len(ln) + 1)

    def emit(kind: str, lo: int, hi: int, level: int = 0) -> None:
        """Lines [lo, hi) -> block, trimmed of blank edges."""
        while lo < hi and not lines[lo].strip():
            lo += 1
        while hi > lo and not lines[hi - 1].strip():
            hi -= 1
        if lo >= hi:
            return
        start = offs[lo]
        end = min(offs[hi] - 1, len(md))
        text = md[start:end]
        if text.strip():
            blocks.append(MdBlock(kind, start, end, text, level))

    i, n = 0, len(lines)
    while i < n:
        line = lines[i]
        s = line.strip()
        if not s:
            i += 1
            continue
        m = _HEADING_RE.match(s)
        if m:
            emit("heading", i, i + 1, level=len(m.group(1)))
            i += 1
            continue
        if _FENCE_RE.match(s):
            j = i + 1
            while j < n and not _FENCE_RE.match(lines[j].strip()):
                j += 1
            emit("code", i, min(j + 1, n))
            i = j + 1
            continue
        if _TABLE_OPEN_RE.search(s):
            depth = 0
            j = i
            while j < n:
                depth += len(_TABLE_OPEN_RE.findall(lines[j]))
                depth -= len(_TABLE_CLOSE_RE.findall(lines[j]))
                j += 1
                if depth <= 0:
                    break
            emit("table", i, j)
            i = j
            continue
        if _HR_RE.match(s) and len(set(s.replace(" ", ""))) == 1:
            emit("hr", i, i + 1)
            i += 1
            continue
        if s.startswith(">"):
            j = i
            while j < n and lines[j].strip().startswith(">"):
                j += 1
            emit("quote", i, j)
            i = j
            continue
        if _LIST_RE.match(line):
            j = i
            while j < n and (
                _LIST_RE.match(lines[j])
                or (lines[j].strip() and lines[j][:1].isspace())
            ):
                j += 1
            emit("list", i, j)
            i = j
            continue
        # paragraph: until blank line or a structural opener
        j = i
        while j < n:
            nxt = lines[j].strip()
            if not nxt:
                break
            if j > i and (
                _HEADING_RE.match(nxt)
                or _FENCE_RE.match(nxt)
                or _TABLE_OPEN_RE.search(nxt)
                or nxt.startswith(">")
                or _LIST_RE.match(lines[j])
            ):
                break
            j += 1
        emit("paragraph", i, j)
        i = max(j, i + 1)
    return blocks


# ---------------------------------------------------------------- splitter


@dataclass
class Chunk:
    """One produced chunk; `spans` are source char ranges in the input
    markdown (exactly which slices this chunk's text came from)."""

    text: str
    headings: list[str] = field(default_factory=list)
    start_line: int = 0
    end_line: int = 0
    spans: list[tuple[int, int]] = field(default_factory=list)

    def with_context(self) -> str:
        if not self.headings:
            return self.text
        return " > ".join(self.headings) + "\n\n" + self.text


class MarkdownTextSplitter:
    """AST-style token-budgeted splitter (reference API:
    text_splitters.py:44-52 MarkdownTextSplitter.__init__/split_text).

    - headings break chunks and maintain the context stack;
    - HTML tables are kept whole up to max_table_tokens, then split by
      full <tr> groups repeating the header row; a single oversize row
      splits by cells; plain text splits by lines;
    - chunks are force-split at 2x the chunk budget / char_max_length.
    """

    def __init__(
        self,
        chunk_token_num: int = 512,
        min_chunk_tokens: int = 50,
        max_table_tokens: int = 8000,
        char_max_length: int = 60000,
        max_tokens: int | None = None,
        token_len: Callable[[str], int] | None = None,
    ) -> None:
        self.chunk_token_num = chunk_token_num
        self.min_chunk_tokens = min_chunk_tokens
        self.max_table_tokens = max_table_tokens
        self.char_max_length = char_max_length
        self.max_tokens = (
            chunk_token_num * 2 if max_tokens is None else max_tokens
        )
        self._tok = token_len or num_tokens_from_string

    # -------------------------------------------------------------- public

    def split_text(self, md: str) -> list[str]:
        return [c.text for c in self.split_chunks(md)]

    def split_chunks(self, md: str) -> list[Chunk]:
        if not md or not md.strip():
            return []
        blocks = parse_blocks(md)
        chunks: list[Chunk] = []
        ctx: list[tuple[int, str]] = []  # heading stack (level, title)
        cur: list[tuple[str, tuple[int, int]]] = []
        cur_tokens = 0

        def flush() -> None:
            nonlocal cur, cur_tokens
            if not cur:
                return
            text = "\n\n".join(p for p, _ in cur).strip()
            spans = [sp for _, sp in cur]
            if text:
                for piece, psp in self._force_split(text, spans):
                    chunks.append(
                        Chunk(piece, [h for _, h in ctx], spans=psp)
                    )
            cur, cur_tokens = [], 0

        for b in blocks:
            if b.kind == "heading":
                if cur_tokens >= self.min_chunk_tokens:
                    flush()
                title = _HEADING_RE.match(b.text.strip()).group(2).strip()
                while ctx and ctx[-1][0] >= b.level:
                    ctx.pop()
                # the heading line itself opens the next chunk
                cur.append((b.text.strip(), (b.start, b.end)))
                cur_tokens += self._tok(b.text)
                ctx.append((b.level, title))
                continue
            if b.kind == "hr":
                if cur_tokens >= self.min_chunk_tokens:
                    flush()
                continue
            if b.kind == "table":
                pieces = self._split_table(b.text)
                if len(pieces) > 1:
                    # oversize table: each segment becomes its own chunk
                    flush()
                    for seg in pieces:
                        chunks.append(
                            Chunk(seg, [h for _, h in ctx],
                                  spans=[(b.start, b.end)])
                        )
                    continue
                btoks = self._tok(b.text)
                if (cur and cur_tokens + btoks > self.chunk_token_num
                        and cur_tokens >= self.min_chunk_tokens):
                    flush()
                cur.append((b.text, (b.start, b.end)))
                cur_tokens += btoks
                continue
            btoks = self._tok(b.text)
            if (cur and cur_tokens + btoks > self.chunk_token_num
                    and cur_tokens >= self.min_chunk_tokens):
                flush()
            cur.append((b.text, (b.start, b.end)))
            cur_tokens += btoks
        flush()
        return [c for c in chunks if c.text.strip()]

    # -------------------------------------------------------------- tables

    def _split_table(self, table_html: str) -> list[str]:
        """Row-group split that repeats the header row; only applied past
        max_table_tokens (reference: _split_html_table_if_needed,
        text_splitters.py:359-408)."""
        if (self._tok(table_html) <= self.max_table_tokens
                and len(table_html) <= self.char_max_length):
            return [table_html]
        rows = _TR_RE.findall(table_html)
        if not rows:
            return [table_html]
        header = ""
        body = rows
        if re.search(r"<th\b", rows[0], re.I):
            header, body = rows[0], rows[1:]
        m = _TR_RE.search(table_html)
        prefix = table_html[: m.start()] if m else "<table>"
        tail = table_html[table_html.rfind("</tr>") + 5:] if "</tr>" in (
            table_html
        ) else "</table>"

        def build(rs: list[str]) -> str:
            return prefix + header + "".join(rs) + tail

        out: list[str] = []
        curr: list[str] = []
        curr_toks = self._tok(header)
        for row in body:
            rtoks = self._tok(row)
            if curr_toks + rtoks > self.max_table_tokens and curr:
                out.append(build(curr))
                curr, curr_toks = [], self._tok(header)
            if rtoks > self.max_table_tokens:
                out.extend(self._split_row(prefix + header, row, tail))
                continue
            curr.append(row)
            curr_toks += rtoks
        if curr:
            out.append(build(curr))
        return out or [table_html]

    def _split_row(self, pre: str, row_html: str, post: str) -> list[str]:
        """A single oversize <tr> splits by cells (reference:
        _split_oversize_table_row, text_splitters.py:528-556)."""
        cells = _CELL_RE.findall(row_html)
        if not cells:
            return [pre + row_html + post]
        out: list[str] = []
        curr: list[str] = []
        toks = 0
        for cell in cells:
            ct = self._tok(cell)
            if curr and toks + ct > self.max_table_tokens:
                out.append(pre + "<tr>" + "".join(curr) + "</tr>" + post)
                curr, toks = [], 0
            curr.append(cell)
            toks += ct
        if curr:
            out.append(pre + "<tr>" + "".join(curr) + "</tr>" + post)
        return out

    # --------------------------------------------------------- force split

    def _force_split(
        self, text: str, spans: list[tuple[int, int]]
    ) -> list[tuple[str, list[tuple[int, int]]]]:
        """Hard cap at max_tokens / char_max_length, splitting on lines
        (tables never reach here whole — handled upstream)."""
        if (self._tok(text) <= self.max_tokens
                and len(text) <= self.char_max_length):
            return [(text, spans)]
        out: list[tuple[str, list[tuple[int, int]]]] = []
        curr: list[str] = []
        toks = 0
        pieces: list[str] = []
        for line in text.splitlines(keepends=True):
            if self._tok(line) > self.max_tokens:
                # one oversize line: split at sentence, then word bounds
                # (the reference stops at line granularity,
                # _split_plain_text_by_lines — a wall-of-text paragraph
                # would blow the budget there)
                sent = re.split(r"(?<=[.!?。！？；;])\s*", line)
                buf = ""
                for s in sent:
                    while self._tok(s) > self.max_tokens:
                        # budget-sized word-boundary slice; chars-per-
                        # token measured on the string itself so this
                        # works for any token counter (len or tiktoken)
                        cap = max(
                            8,
                            int(len(s) * self.max_tokens
                                / max(self._tok(s), 1) * 0.9),
                        )
                        cut = s.rfind(" ", 0, cap)
                        cut = cut if cut > 0 else cap
                        pieces.append(s[:cut] + "\n")
                        s = s[cut:].lstrip()
                    if buf and self._tok(buf + s) > self.max_tokens:
                        pieces.append(buf + "\n")
                        buf = ""
                    buf += s
                if buf:
                    pieces.append(buf if buf.endswith("\n") else buf + "\n")
            else:
                pieces.append(line)
        for line in pieces:
            lt = self._tok(line)
            if curr and (toks + lt > self.max_tokens
                         or sum(map(len, curr)) + len(line)
                         > self.char_max_length):
                out.append(("".join(curr).strip(), spans))
                curr, toks = [], 0
            curr.append(line)
            toks += lt
        if curr and "".join(curr).strip():
            out.append(("".join(curr).strip(), spans))
        return out


# -------------------------------------------------------- compat wrappers


def split_markdown(
    markdown: str,
    max_chars: int = 1600,
    overlap_chars: int = 200,
) -> list[Chunk]:
    """Char-budgeted convenience wrapper over MarkdownTextSplitter
    (token counter = len, so budgets are plain characters).

    `overlap_chars` is accepted for API compatibility but NO LONGER
    applied: the AST splitter cuts on block boundaries (reference
    MarkdownTextSplitter has no overlap either), which retrieval-chunk
    evaluations favor over mid-sentence character overlap. Chunk
    .start_line/.end_line are superseded by .spans (source char
    ranges)."""
    splitter = MarkdownTextSplitter(
        chunk_token_num=max_chars,
        min_chunk_tokens=1,
        max_table_tokens=max_chars,
        # strict: max_chars is a hard cap here (the class default allows
        # 2x for token-budget callers; char-budget callers size DB
        # columns/embedding contexts to max_chars exactly)
        max_tokens=max_chars,
        token_len=len,
    )
    return splitter.split_chunks(markdown)


# ------------------------------------------------------------ bbox backmap


def _norm(s: str) -> str:
    """Normalization for cross-representation text matching: strip all
    whitespace, markdown decorations and html tags."""
    s = _TAG_RE.sub("", s)
    s = re.sub(r"[#*_`>|$\\\s ]+", "", s)
    return s


@dataclass
class _SourceUnit:
    page_idx: int
    bbox: list[float] | None
    text: str


def _units_from_middle(middle_json: dict) -> list[_SourceUnit]:
    """SPAN-level source units from a middle json (reference maps at
    block level only, get_bbox_page_fast.py:8-37; span granularity gives
    tighter attribution for free since spans carry their own bboxes)."""
    units: list[_SourceUnit] = []
    for page_idx, page in enumerate(middle_json.get("pdf_info", [])):
        for block in page.get("preproc_blocks", []) or page.get(
            "para_blocks", []
        ):
            stack = [block]
            while stack:
                b = stack.pop(0)
                for sub in b.get("blocks", []) or []:
                    stack.append(sub)
                for line in b.get("lines", []) or []:
                    for span in line.get("spans", []) or []:
                        text = span.get("content") or span.get("html") or ""
                        if not text and span.get("type") == "table":
                            text = span.get("html", "")
                        if text and str(text).strip():
                            units.append(_SourceUnit(
                                page_idx,
                                span.get("bbox") or line.get("bbox")
                                or b.get("bbox"),
                                str(text),
                            ))
    return units


def _units_from_content_list(content_list: list[dict]) -> list[_SourceUnit]:
    units = []
    for item in content_list:
        text = (
            item.get("text")
            or item.get("table_body")
            or item.get("html")
            or ""
        )
        if isinstance(item.get("content"), dict):
            # content-list v2 typed items
            c = item["content"]
            text = text or c.get("text") or c.get("html") or ""
        if text and str(text).strip():
            units.append(_SourceUnit(
                item.get("page_idx", 0), item.get("bbox"), str(text)
            ))
    return units


def _similarity(a: str, b: str) -> float:
    try:
        from rapidfuzz import fuzz

        return fuzz.ratio(a, b) / 100.0
    except Exception:
        import difflib

        return difflib.SequenceMatcher(None, a, b).ratio()


def chunk_with_bboxes(
    markdown: str,
    source: list[dict] | dict,
    max_chars: int = 1600,
    chunk_token_num: int | None = None,
) -> list[dict]:
    """Chunks + the source bboxes/pages whose text they contain.

    `source` is a middle_json dict (span-level attribution) or a
    content_list (block-level). Two-tier matching per chunk:

    1. EXACT: each chunk knows its markdown char ranges; the chunk's
       normalized text is located in the concatenated normalized source
       stream by substring search, and the covered char range maps back
       to source units through a cumulative-offset index.
    2. FUZZY fallback (reference algorithm,
       get_bbox_page_fast.py:40-117): best-similarity anchor unit, then
       expand to contiguous units whose text is contained in the chunk;
       matched units are excluded from later chunks.

    Returns [{"text", "headings", "refs": [{"page_idx", "bbox"}...],
    "positions": [[page, x0, x1, y0, y1]...]}].
    """
    if isinstance(source, dict):
        units = _units_from_middle(source)
    else:
        units = _units_from_content_list(source or [])

    if chunk_token_num is not None:
        splitter = MarkdownTextSplitter(chunk_token_num=chunk_token_num,
                                        min_chunk_tokens=1)
        chunks = splitter.split_chunks(markdown)
    else:
        chunks = split_markdown(markdown, max_chars=max_chars)

    # concatenated normalized stream + offset index
    norm_texts = [_norm(u.text) for u in units]
    cum = [0]
    for t in norm_texts:
        cum.append(cum[-1] + len(t))
    stream = "".join(norm_texts)

    def units_in_range(s: int, e: int) -> list[int]:
        lo = bisect_right(cum, s) - 1
        hi = bisect_right(cum, max(e - 1, s)) - 1
        return [i for i in range(max(lo, 0), min(hi + 1, len(units)))
                if norm_texts[i]]

    matched_global: set[int] = set()
    out = []
    search_from = 0
    for chunk in chunks:
        refs_idx: list[int] = []
        cnorm = _norm(chunk.text)
        if cnorm:
            # 1. exact: whole chunk, then per constituent block
            pos = stream.find(cnorm, search_from)
            if pos < 0:
                pos = stream.find(cnorm)
            if pos >= 0:
                refs_idx = units_in_range(pos, pos + len(cnorm))
                search_from = pos + len(cnorm)
            else:
                seen: set[int] = set()
                for part in chunk.text.split("\n\n"):
                    pnorm = _norm(part)
                    if len(pnorm) < 4:
                        continue
                    ppos = stream.find(pnorm, search_from)
                    if ppos < 0:
                        ppos = stream.find(pnorm)
                    if ppos >= 0:
                        for i in units_in_range(ppos, ppos + len(pnorm)):
                            if i not in seen:
                                seen.add(i)
                                refs_idx.append(i)
                if refs_idx:
                    search_from = cum[max(refs_idx) + 1]
        reattributed = False
        if not refs_idx and cnorm:
            # 2. fuzzy anchor + contiguous expansion. One scoring pass
            # tracks both the best UNMATCHED unit (ordinary attribution,
            # threshold 0.1 per the reference) and the best unit overall
            # (continuation chunks — e.g. segments 2..N of an oversize
            # split table all come from ONE already-matched table unit;
            # re-attribution demands a much stronger 0.3 similarity and
            # is not recorded in matched_global, so ordinary chunks keep
            # first-match-wins and absent text still gets no refs).
            best_u, best_ur = -1, 0.0  # best unmatched
            best_a, best_ar = -1, 0.0  # best overall
            for i, t in enumerate(norm_texts):
                if not t:
                    continue
                r = _similarity(cnorm, t)
                if r > best_ar:
                    best_ar, best_a = r, i
                if i not in matched_global and r > best_ur:
                    best_ur, best_u = r, i
                if best_ur > 0.95:
                    break
            if best_u >= 0 and best_ur >= 0.1:
                anchor, allow_matched = best_u, False
            elif best_a >= 0 and best_ar >= 0.3:
                anchor, allow_matched = best_a, True
            else:
                anchor = -1
            if anchor >= 0:
                refs_idx = [anchor]
                for i in range(anchor - 1, -1, -1):
                    if not allow_matched and i in matched_global:
                        continue
                    if norm_texts[i] and norm_texts[i] in cnorm:
                        refs_idx.insert(0, i)
                    else:
                        break
                for i in range(anchor + 1, len(units)):
                    if not allow_matched and i in matched_global:
                        continue
                    if norm_texts[i] and norm_texts[i] in cnorm:
                        refs_idx.append(i)
                    else:
                        break
                reattributed = allow_matched
        if not reattributed:
            matched_global.update(refs_idx)
        refs = []
        positions = []
        for i in refs_idx:
            u = units[i]
            refs.append({"page_idx": u.page_idx, "bbox": u.bbox})
            if u.bbox is not None:
                positions.append(
                    [u.page_idx, u.bbox[0], u.bbox[2], u.bbox[1], u.bbox[3]]
                )
        out.append({
            "text": chunk.with_context(),
            "headings": chunk.headings,
            "refs": refs,
            "positions": positions,
        })
    return out
