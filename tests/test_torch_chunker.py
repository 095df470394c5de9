"""The port's chunker (``rapiddoc_tpu_torch/chunker/``) against the JAX
package's (``rapiddoc_tpu/chunker/``).

- Every case of ``tests/test_chunker.py`` and the chunker case of
  ``tests/test_longtail.py`` re-run with ``rapiddoc_tpu.chunker`` bound to
  the port's modules, so their own assertions hold the port.
- ``split_markdown``, ``MarkdownTextSplitter`` and ``chunk_with_bboxes``
  equal to the JAX package's on seeded Markdown, content lists and middle
  json.
- The finding at ``text_splitters.py:411`` kept as it is in the JAX
  package: every piece of a force-split chunk carries all of the chunk's
  source spans.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest

import rapiddoc_tpu.chunker.text_splitters as jax_ts
import rapiddoc_tpu_torch.chunker.text_splitters as port_ts

CHUNKER_CASES = [
    ("test_chunker", "test_split_markdown_heading_context"),
    ("test_chunker", "test_oversized_table_splits_by_rows"),
    ("test_chunker", "test_chunk_bbox_backmap"),
    ("test_chunker", "test_chunk_bbox_backmap_span_level_middle_json"),
    ("test_chunker", "test_chunk_bbox_backmap_fuzzy_fallback"),
    ("test_chunker", "test_markdown_text_splitter_token_api"),
    ("test_chunker", "test_parse_blocks_char_offsets"),
    ("test_chunker", "test_oversize_table_continuation_chunks_keep_refs"),
    ("test_longtail", "test_chunker_headings_and_tables"),
]


def _test_module(name):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def test_the_case_list_is_every_chunker_case():
    names = {n for n in vars(_test_module("test_chunker")) if n.startswith("test_")}
    assert names == {n for m, n in CHUNKER_CASES if m == "test_chunker"}


@pytest.mark.parametrize("mod_name,name", CHUNKER_CASES)
def test_chunker_case_on_the_port(mod_name, name, monkeypatch):
    """The JAX test as written; its local imports of
    ``rapiddoc_tpu.chunker`` find the port's modules."""
    monkeypatch.setitem(sys.modules, "rapiddoc_tpu.chunker",
                        importlib.import_module("rapiddoc_tpu_torch.chunker"))
    monkeypatch.setitem(sys.modules, "rapiddoc_tpu.chunker.text_splitters", port_ts)
    getattr(_test_module(mod_name), name)()


# ------------------------------------------------------- seeded inputs

WORDS = ["alpha", "beta", "gamma", "delta", "表格", "数据", "x" * 30, "end.", "why?", "是；"]


def _text(rng, n: int) -> str:
    return " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), n))


def _table(rng, rows: int, header: bool) -> str:
    head = "<tr><th>h</th><th>k</th></tr>" if header else ""
    body = "".join(f"<tr><td>{_text(rng, 3)}</td><td>{_text(rng, int(rng.integers(1, 40)))}</td></tr>"
                   for _ in range(rows))
    return f"<table>{head}{body}</table>"


def seeded_markdown(seed: int) -> tuple[str, list[dict]]:
    """A document of headings, paragraphs (some a wall of text), lists,
    formulas, images and tables, and its content list."""
    rng = np.random.default_rng(seed)
    parts, content = [], []
    for i in range(int(rng.integers(6, 18))):
        kind = int(rng.integers(0, 7))
        if kind == 0:
            text = "#" * int(rng.integers(1, 4)) + " " + _text(rng, 3)
            item = {"type": "text", "text": text.lstrip("# "), "text_level": 1}
        elif kind == 1:
            text = _table(rng, int(rng.integers(1, 60)), bool(rng.integers(0, 2)))
            item = {"type": "table", "table_body": text}
        elif kind == 2:
            text = "$$\n" + _text(rng, 4) + "\n$$"
            item = {"type": "equation", "text": text}
        elif kind == 3:
            text = f"![](images/{i}.jpg)"
            item = {"type": "image", "img_path": f"images/{i}.jpg"}
        elif kind == 4:
            text = "\n".join("- " + _text(rng, int(rng.integers(2, 12))) for _ in range(4))
            item = {"type": "text", "text": text}
        else:
            text = _text(rng, int(rng.integers(5, 400 if kind == 6 else 60)))
            item = {"type": "text", "text": text}
        parts.append(text)
        item.update(bbox=[int(v) for v in rng.integers(0, 900, 4)], page_idx=i // 5)
        content.append(item)
    return "\n\n".join(parts), content


def seeded_middle(seed: int) -> tuple[str, dict]:
    """Span-level middle json over two pages and the Markdown of its
    blocks, with a typo here and there (the fuzzy path)."""
    rng = np.random.default_rng(seed)
    pages, md = [], []
    for _ in range(2):
        blocks = []
        for b in range(int(rng.integers(2, 6))):
            texts = [_text(rng, int(rng.integers(2, 30))) for _ in range(int(rng.integers(1, 4)))]
            y0 = 40 * b
            blocks.append({"type": "text", "bbox": [10, y0, 500, y0 + 30], "lines": [{
                "bbox": [10, y0, 500, y0 + 30],
                "spans": [{"type": "text", "content": t,
                           "bbox": [10 + 100 * i, y0, 100 + 100 * i, y0 + 30]}
                          for i, t in enumerate(texts)]}]})
            line = " ".join(texts)
            md.append(line.replace("a", "aa", 1) if rng.integers(0, 4) == 0 else line)
        pages.append({"preproc_blocks": blocks})
    return "\n\n".join(md), {"pdf_info": pages}


def _chunks(mod, md, **kw):
    return [dataclasses.asdict(c) for c in mod.split_markdown(md, **kw)]


@pytest.mark.parametrize("seed", range(8))
def test_split_markdown_equals_jax(seed):
    md, _ = seeded_markdown(seed)
    for max_chars in (120, 400, 1600):
        got = _chunks(port_ts, md, max_chars=max_chars)
        assert got == _chunks(jax_ts, md, max_chars=max_chars)
        assert got


@pytest.mark.parametrize("seed", range(6))
def test_markdown_text_splitter_equals_jax(seed):
    md, _ = seeded_markdown(seed)
    for kw in ({}, {"chunk_token_num": 40, "min_chunk_tokens": 5},
               {"chunk_token_num": 64, "max_table_tokens": 100, "char_max_length": 300}):
        got = [dataclasses.asdict(c) for c in port_ts.MarkdownTextSplitter(**kw).split_chunks(md)]
        want = [dataclasses.asdict(c) for c in jax_ts.MarkdownTextSplitter(**kw).split_chunks(md)]
        assert got == want
    assert port_ts.parse_blocks(md) == [port_ts.MdBlock(**dataclasses.asdict(b))
                                        for b in jax_ts.parse_blocks(md)]
    assert port_ts.num_tokens_from_string(md) == jax_ts.num_tokens_from_string(md)


@pytest.mark.parametrize("seed", range(6))
def test_chunk_with_bboxes_equals_jax(seed):
    md, content = seeded_markdown(seed)
    for kw in ({"max_chars": 200}, {"max_chars": 1600}, {"chunk_token_num": 50}):
        got = port_ts.chunk_with_bboxes(md, content, **kw)
        assert got == jax_ts.chunk_with_bboxes(md, content, **kw)
        assert any(c["refs"] for c in got)
    md, middle = seeded_middle(seed)
    for max_chars in (60, 300):
        got = port_ts.chunk_with_bboxes(md, middle, max_chars=max_chars)
        assert got == jax_ts.chunk_with_bboxes(md, middle, max_chars=max_chars)


def test_force_split_pieces_keep_every_span_as_in_jax():
    """``_force_split`` (text_splitters.py:411 in both packages) hands the
    whole span list to every forced piece, so each piece claims all of
    the chunk's source ranges. The port keeps that, equal to the JAX
    package."""
    text = "\n".join(f"line {i} " + "word " * 30 for i in range(12))
    spans = [(0, 100), (200, 300), (400, 500)]
    kw = {"chunk_token_num": 20, "max_tokens": 40, "char_max_length": 300}
    got = port_ts.MarkdownTextSplitter(**kw)._force_split(text, spans)
    assert got == jax_ts.MarkdownTextSplitter(**kw)._force_split(text, spans)
    assert len(got) > 2 and all(piece_spans == spans for _, piece_spans in got)
