"""TEDS — Tree-Edit-Distance-based Similarity for table HTML.

Port of ``rapiddoc_tpu/utils/teds.py``; the cell texts' edit distance
goes through ``utils.native.levenshtein`` (compiled where a card is
present), whose plain version is ``levenshtein`` here.

Evaluation counterpart of the reference's table metric driver
(reference: tests/table_recognition_metric_test.py, which scores
predicted table HTML against ground truth with TEDS). Implemented from
the published definition (IBM PubTabNet: TEDS(Ta, Tb) = 1 -
EditDist(Ta, Tb) / max(|Ta|, |Tb|)) with Zhang-Shasha ordered tree edit
distance; node substitution cost blends tag mismatch with normalized
Levenshtein over cell text. `structure_only=True` gives TEDS-S.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from html.parser import HTMLParser

_TABLE_TAGS = {"table", "thead", "tbody", "tfoot", "tr", "td", "th",
               "caption"}


@dataclass
class _Node:
    tag: str
    text: str = ""
    colspan: int = 1
    rowspan: int = 1
    children: list = field(default_factory=list)

    def size(self) -> int:
        return 1 + sum(c.size() for c in self.children)


class _TableTreeParser(HTMLParser):
    def __init__(self) -> None:
        super().__init__()
        self.root = _Node("table")
        self.stack = [self.root]
        self._started = False

    def handle_starttag(self, tag, attrs):
        if tag == "table":
            self._started = True
            return
        if tag not in _TABLE_TAGS or not self.stack:
            return
        node = _Node(tag)
        for k, v in attrs:
            if k == "colspan":
                try:
                    node.colspan = int(v)
                except ValueError:
                    pass
            elif k == "rowspan":
                try:
                    node.rowspan = int(v)
                except ValueError:
                    pass
        self.stack[-1].children.append(node)
        if tag in ("thead", "tbody", "tfoot", "tr", "td", "th"):
            self.stack.append(node)

    def handle_endtag(self, tag):
        if tag in ("thead", "tbody", "tfoot", "tr", "td", "th") and len(
            self.stack
        ) > 1:
            # pop to the matching open tag if present
            for i in range(len(self.stack) - 1, 0, -1):
                if self.stack[i].tag == tag:
                    del self.stack[i:]
                    break

    def handle_data(self, data):
        if self.stack and self.stack[-1].tag in ("td", "th", "caption"):
            self.stack[-1].text += data


def parse_table(html: str) -> _Node:
    p = _TableTreeParser()
    try:
        p.feed(html or "")
    except Exception:
        pass
    return p.root


def levenshtein(a: str, b: str) -> int:
    """The edit distance of two strings (unit insert, delete, substitute):
    the plain version of ``csrc/hostops.cu``'s ``levenshtein_u32``."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _node_sub_cost(a: _Node, b: _Node, structure_only: bool) -> float:
    if a.tag != b.tag or a.colspan != b.colspan or a.rowspan != b.rowspan:
        return 1.0
    if structure_only or a.tag not in ("td", "th", "caption"):
        return 0.0
    ta, tb = a.text.strip(), b.text.strip()
    if not ta and not tb:
        return 0.0
    from . import native

    return native.levenshtein(ta, tb) / max(len(ta), len(tb))


def _postorder(root: _Node):
    """Zhang-Shasha prep: postorder nodes + leftmost-leaf indices."""
    nodes: list[_Node] = []
    lmld: list[int] = []

    def walk(n: _Node) -> int:
        if not n.children:
            nodes.append(n)
            lmld.append(len(nodes) - 1)
            return len(nodes) - 1
        first = walk(n.children[0])
        for c in n.children[1:]:
            walk(c)
        nodes.append(n)
        lmld.append(lmld[first])
        return lmld[first]

    walk(root)
    return nodes, lmld


def _keyroots(lmld: list[int]) -> list[int]:
    seen: dict[int, int] = {}
    for i, l in enumerate(lmld):
        seen[l] = i
    return sorted(seen.values())


def tree_edit_distance(
    ra: _Node, rb: _Node, structure_only: bool = False
) -> float:
    """Zhang-Shasha ordered TED with unit insert/delete cost."""
    an, al = _postorder(ra)
    bn, bl = _postorder(rb)
    ka, kb = _keyroots(al), _keyroots(bl)
    td = [[0.0] * len(bn) for _ in an]

    for i in ka:
        for j in kb:
            li, lj = al[i], bl[j]
            m, n = i - li + 2, j - lj + 2
            fd = [[0.0] * n for _ in range(m)]
            for x in range(1, m):
                fd[x][0] = fd[x - 1][0] + 1
            for y in range(1, n):
                fd[0][y] = fd[0][y - 1] + 1
            for x in range(1, m):
                for y in range(1, n):
                    ai, bj = li + x - 1, lj + y - 1
                    if al[ai] == li and bl[bj] == lj:
                        cost = _node_sub_cost(an[ai], bn[bj], structure_only)
                        fd[x][y] = min(
                            fd[x - 1][y] + 1, fd[x][y - 1] + 1,
                            fd[x - 1][y - 1] + cost,
                        )
                        td[ai][bj] = fd[x][y]
                    else:
                        fd[x][y] = min(
                            fd[x - 1][y] + 1, fd[x][y - 1] + 1,
                            fd[al[ai] - li][bl[bj] - lj] + td[ai][bj],
                        )
    return td[-1][-1]


def teds(pred_html: str, gt_html: str, structure_only: bool = False) -> float:
    """TEDS in [0, 1]; 1.0 = identical. structure_only=True -> TEDS-S."""
    ta, tb = parse_table(pred_html), parse_table(gt_html)
    if ta.size() <= 1 and tb.size() <= 1:
        return 1.0
    dist = tree_edit_distance(ta, tb, structure_only)
    return max(0.0, 1.0 - dist / max(ta.size(), tb.size()))
