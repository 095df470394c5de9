"""A reader of the YAML that PyYAML's ``dump`` and ``safe_dump`` write.

The formula's inference yml carries its HF tokenizer under
``PostProcess.character_dict.fast_tokenizer_file``; the JAX package reads
it with PyYAML (``rapiddoc_tpu/tools/convert_weights.py:117-135``), which
the port does not depend on. ``safe_load`` returns what ``yaml.safe_load``
returns for the subset PyYAML's emitter writes for plain data (mappings,
sequences, strings, numbers, booleans and nulls):

- block mappings (simple keys, and ``?`` explicit keys, which PyYAML
  writes for an empty, multi-line or long key), block sequences (also the
  indentless ones PyYAML writes as a mapping's value, and compact ones:
  ``- - a``, ``- key: value``);
- flow sequences and flow mappings, over several lines;
- plain, single-quoted and double-quoted scalars, folded over lines as
  PyYAML's scanner folds them, with every escape of YAML 1.1
  (``\\xXX``, ``\\uXXXX``, ``\\UXXXXXXXX``, ``\\N``, ``\\L``, ...);
- plain scalars resolved to null, bool, int and float by PyYAML's own
  patterns and constructors (``yes``/``off`` are bools, ``0o17`` is a
  string, ``017`` is octal, ``1:30`` is 90, ``.inf``);
- comments, a leading ``---`` and a trailing ``...``.

Anything else raises ``ValueError``: anchors, aliases, tags, block
scalars (``|``, ``>``), directives, several documents, merge keys,
timestamps, tabs outside quoted scalars, unhashable keys, and
malformed input.
"""
from __future__ import annotations

import bisect
import re
from typing import Any

# PyYAML's implicit resolvers (yaml/resolver.py), keyed by first character
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_RESOLVERS = (("bool", _BOOL, "yYnNtTfFoO"), ("float", _FLOAT, "-+0123456789."),
              ("int", _INT, "-+0123456789"), ("merge", re.compile(r"^(?:<<)$"), "<"),
              ("null", _NULL, "~nN"), ("timestamp", _TIMESTAMP, "0123456789"),
              ("value", re.compile(r"^(?:=)$"), "="))

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_HEX = set("0123456789abcdefABCDEF")
# line breaks once CR, CRLF and NEL are read as LF, as PyYAML reads them;
# LS and PS break lines too, and a folded LS or PS stays in the scalar
_BREAKS = "\n\u2028\u2029"
_WS = " \t\0" + _BREAKS  # what may follow an indicator
_NOT_PLAIN_START = "\0 \t-?:,[]{}#&*!|>'\"%@`" + _BREAKS
_END = "\0"
# a plain scalar's run of non-space characters, in a block and in a flow
_PLAIN_RUN = {
    False: re.compile("(?:[^ \t\0\n\u2028\u2029:]|:(?![ \t\0\n\u2028\u2029]))*"),
    True: re.compile("(?:[^ \t\0\n\u2028\u2029:,?\\[\\]{}]"
                     "|:(?![ \t\0\n\u2028\u2029,\\[\\]{}]))*"),
}
_QUOTED_RUN = re.compile("[^'\"\\\\\0 \t\n\u2028\u2029]*")
_LINE_START = re.compile("[\n\u2028\u2029]")
# what PyYAML's reader refuses
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                            "\U00010000-\U0010ffff]")


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        total, base = 0, 1
        for digit in reversed([int(part) for part in value.split(":")]):
            total += digit * base
            base *= 60
        return sign * total
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        total, base = 0.0, 1
        for digit in reversed([float(part) for part in value.split(":")]):
            total += digit * base
            base *= 60
        return sign * total
    return sign * float(value)


def resolve_plain(value: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` constructs it."""
    first = value[0] if value else ""
    for kind, pattern, starts in _RESOLVERS:
        if (first in starts if first else kind == "null") and pattern.match(value):
            if kind == "bool":
                return value.lower() in ("yes", "true", "on")
            if kind == "float":
                return _construct_float(value)
            if kind == "int":
                return _construct_int(value)
            if kind == "null":
                return None
            raise ValueError(f"yaml: the plain scalar {value!r} is a {kind}, "
                             "outside the subset")
    return value


class _Parser:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        text = text.replace("\r\n", "\n").replace("\r", "\n").replace("\x85", "\n")
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise ValueError(f"yaml: non-printable character {bad.group()!r}")
        self.s = text + _END
        self.i = 0
        self.line_starts = [0] + [m.end() for m in _LINE_START.finditer(self.s)]

    # -- positions
    def peek(self, k: int = 0) -> str:
        try:
            return self.s[self.i + k]
        except IndexError:
            return _END

    def col(self) -> int:
        return self.i - self.line_starts[bisect.bisect_right(self.line_starts, self.i) - 1]

    def fail(self, what: str) -> ValueError:
        line = bisect.bisect_right(self.line_starts, self.i)
        return ValueError(f"yaml: {what} (line {line}, column {self.col() + 1})")

    def at_end(self) -> bool:
        """The end of the text, or of the document (``---``/``...`` at
        the start of a line)."""
        return self.peek() == _END or (self.document_marker() and self.col() == 0)

    def is_indicator(self, ch: str) -> bool:
        """``ch`` here, followed by whitespace (a block indicator)."""
        return self.peek() == ch and self.peek(1) in _WS

    def skip_inline(self) -> bool:
        """Skip spaces and a comment on this line; True if content
        follows on it."""
        while self.peek() == " ":
            self.i += 1
        if self.peek() == "#":
            while self.peek() not in _BREAKS + _END:
                self.i += 1
        return self.peek() not in _BREAKS + _END

    def skip_lines(self) -> None:
        """Skip spaces, comments and line breaks up to the next content."""
        while True:
            if self.skip_inline() or self.peek() == _END:
                return
            self.i += 1  # the line break

    def end_of_line(self) -> None:
        if self.skip_inline():
            raise self.fail(f"unexpected {self.peek()!r} after a node")

    # -- block structure
    def document(self) -> Any:
        self.skip_lines()
        if self.peek() == "%":
            raise self.fail("directives are outside the subset")
        if self.s.startswith("---", self.i) and self.peek(3) in _WS:
            self.i += 3
            node = self.block_value(-1, compact=False, indentless=False)
        else:
            node = self.block_value(-1, compact=True, indentless=False, line_start=True)
        self.skip_lines()
        if self.s.startswith("...", self.i) and self.col() == 0 and self.peek(3) in _WS:
            self.i += 3
            self.skip_lines()
        if self.peek() != _END:
            raise self.fail("content after the document (several documents are "
                            "outside the subset)")
        return node

    def block_value(self, indent: int, *, compact: bool, indentless: bool,
                    line_start: bool = False) -> Any:
        """The node after an indicator of the block collection at column
        ``indent`` (``-``, ``?``, ``:``; -1 for the document): on this
        line, or on the lines below, indented past ``indent`` (a mapping's
        value may also be a sequence at ``indent``). ``compact``: a block
        collection may start on this line."""
        if not line_start and self.skip_inline():
            if compact:
                col = self.col()
                if self.is_indicator("-"):
                    return self.block_sequence(col)
                if self.is_indicator("?") or self.simple_key_ahead():
                    return self.block_mapping(col)
            return self.flow_node_in_block(indent)
        self.skip_lines()
        if self.at_end():
            return None
        col = self.col()
        if self.is_indicator("-") and (col > indent or (indentless and col == indent)):
            return self.block_sequence(col)
        if col <= indent:
            return None
        if self.is_indicator("?") or self.simple_key_ahead():
            return self.block_mapping(col)
        return self.flow_node_in_block(indent)

    def block_sequence(self, col: int) -> list:
        out = []
        while True:
            self.i += 1  # '-'
            out.append(self.block_value(col, compact=True, indentless=False))
            self.skip_lines()
            if self.at_end() or self.col() < col:
                return out
            if self.col() > col:
                raise self.fail("bad indentation of a sequence entry")
            if not self.is_indicator("-"):
                return out

    def block_mapping(self, col: int) -> dict:
        out: dict = {}
        while True:
            if self.is_indicator("?"):
                self.i += 1
                key = self.block_value(col, compact=True, indentless=False)
                self.skip_lines()
                if not self.at_end() and self.col() == col and self.is_indicator(":"):
                    self.i += 1
                    value = self.block_value(col, compact=True, indentless=True)
                else:
                    value = None
            else:
                key = self.simple_key()
                value = self.block_value(col, compact=False, indentless=True)
            self.put(out, key, value)
            self.skip_lines()
            if self.at_end() or self.col() < col:
                return out
            if self.col() > col:
                raise self.fail("bad indentation of a mapping entry")

    def simple_key_ahead(self) -> bool:
        """A single-line scalar then ``:`` and whitespace, from here."""
        start = self.i
        try:
            self.key_scalar()
            while self.peek() == " ":
                self.i += 1
            return self.is_indicator(":")
        except ValueError:
            return False
        finally:
            self.i = start

    def key_scalar(self) -> Any:
        ch = self.peek()
        start = self.i
        if ch in "'\"":
            value = self.quoted(ch == '"')
        elif self.plain_starts(flow=False):
            value = resolve_plain(self.plain(indent=-1, flow=False, one_line=True))
        else:
            raise self.fail(f"{ch!r} cannot start a key")
        if any(b in self.s[start:self.i] for b in _BREAKS):
            raise self.fail("a simple key spans lines")
        return value

    def simple_key(self) -> Any:
        key = self.key_scalar()
        while self.peek() == " ":
            self.i += 1
        if not self.is_indicator(":"):
            raise self.fail("expected ':' after a key")
        self.i += 1
        return key

    def flow_node_in_block(self, indent: int) -> Any:
        node = self.flow_node(indent, flow=False)
        self.end_of_line()
        return node

    def put(self, mapping: dict, key: Any, value: Any) -> None:
        try:
            mapping[key] = value
        except TypeError:
            raise self.fail("unhashable mapping key") from None

    # -- flow nodes and scalars
    def flow_node(self, indent: int, flow: bool) -> Any:
        ch = self.peek()
        if ch == "[":
            return self.flow_sequence()
        if ch == "{":
            return self.flow_mapping()
        if ch in "'\"":
            return self.quoted(ch == '"')
        if ch in "&*!|>%@`":
            raise self.fail(f"{ch!r} (anchors, aliases, tags, block scalars) is outside "
                            "the subset")
        if not self.plain_starts(flow):
            raise self.fail(f"{ch!r} cannot start a node")
        return resolve_plain(self.plain(indent, flow))

    def skip_flow(self) -> None:
        while True:
            if self.skip_inline():
                if self.peek() == "\t":
                    raise self.fail("tab")
                return
            if self.at_end():
                raise self.fail("unclosed flow collection")
            self.i += 1

    def flow_sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_flow()
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.flow_node(-1, flow=True))
            self.skip_flow()
            if self.peek() == ":":
                raise self.fail("a mapping inside a flow sequence is outside the subset")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.fail("expected ',' or ']'")

    def flow_mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip_flow()
            if self.peek() == "}":
                self.i += 1
                return out
            key = None
            if self.peek() == "?":  # an explicit key
                self.i += 1
                self.skip_flow()
            if self.peek() not in ":,}":
                key = self.flow_node(-1, flow=True)
                self.skip_flow()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.skip_flow()
                if self.peek() not in ",}":
                    value = self.flow_node(-1, flow=True)
                    self.skip_flow()
            self.put(out, key, value)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.fail("expected ',' or '}'")

    def plain_starts(self, flow: bool) -> bool:
        ch, nxt = self.peek(), self.peek(1)
        return ch not in _NOT_PLAIN_START or (
            nxt not in _WS and (ch == "-" or (not flow and ch in "?:")))

    def plain(self, indent: int, flow: bool, one_line: bool = False) -> str:
        """PyYAML's scan_plain: runs of non-space characters up to ``: ``,
        `` #`` (and ``,[]{}?`` in a flow), folded over line breaks while
        the next line is indented past ``indent`` (any line in a flow)."""
        chunks: list[str] = []
        spaces: list[str] = []
        end = self.i
        run = _PLAIN_RUN[flow]
        while True:
            if self.peek() == "#":
                break
            start = self.i
            self.i = run.match(self.s, start).end()
            if self.i == start:
                break
            chunks.extend(spaces)
            chunks.append(self.s[start:self.i])
            end = self.i
            spaces = self.plain_spaces(one_line)
            if not spaces or self.peek() == "#" or (not flow and self.col() < indent + 1):
                break
        if self.peek() == "\t":
            raise self.fail("tab")
        self.i = end  # what follows the scalar is read from its end
        return "".join(chunks)

    def plain_spaces(self, one_line: bool) -> list[str]:
        """PyYAML's scan_plain_spaces: the spaces, or the folded line
        breaks, before the next run (nothing at a document marker)."""
        start = self.i
        while self.peek() == " ":
            self.i += 1
        whitespace = self.s[start:self.i]
        if self.peek() not in _BREAKS or one_line:
            return [whitespace] if whitespace else []
        mark = self.i
        line_break = self.peek()
        self.i += 1
        breaks = []
        while not self.document_marker():
            if self.peek() == " ":
                self.i += 1
            elif self.peek() in _BREAKS:
                breaks.append(self.peek())
                self.i += 1
            else:
                return _fold(line_break, breaks)
        self.i = mark
        return []

    def document_marker(self) -> bool:
        return (self.s.startswith("---", self.i) or self.s.startswith("...", self.i)) \
            and self.peek(3) in _WS

    def quoted(self, double: bool) -> str:
        """PyYAML's scan_flow_scalar."""
        quote = self.peek()
        self.i += 1
        chunks = self.quoted_non_spaces(double)
        while self.peek() != quote:
            chunks += self.quoted_spaces()
            chunks += self.quoted_non_spaces(double)
        self.i += 1
        return "".join(chunks)

    def quoted_non_spaces(self, double: bool) -> list[str]:
        chunks = []
        while True:
            start = self.i
            self.i = _QUOTED_RUN.match(self.s, start).end()
            if self.i > start:
                chunks.append(self.s[start:self.i])
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                self.i += 1
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.i += 1
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    digits = self.s[self.i + 1:self.i + 1 + n]
                    if len(digits) != n or not set(digits) <= _HEX:
                        raise self.fail(f"bad escape \\{ch}{digits}")
                    chunks.append(chr(int(digits, 16)))
                    self.i += 1 + n
                elif ch in _BREAKS:
                    self.i += 1
                    chunks += self.quoted_breaks()
                else:
                    raise self.fail(f"unknown escape \\{ch}")
            else:
                return chunks

    def quoted_spaces(self) -> list[str]:
        start = self.i
        while self.peek() in " \t":
            self.i += 1
        whitespace = self.s[start:self.i]
        ch = self.peek()
        if ch == _END:
            raise self.fail("unclosed quoted scalar")
        if ch in _BREAKS:
            self.i += 1
            return _fold(ch, self.quoted_breaks())
        return [whitespace]

    def quoted_breaks(self) -> list[str]:
        breaks = []
        while True:
            if self.document_marker():
                raise self.fail("document marker inside a quoted scalar")
            while self.peek() in " \t":
                self.i += 1
            if self.peek() not in _BREAKS:
                return breaks
            breaks.append(self.peek())
            self.i += 1


def _fold(line_break: str, breaks: list[str]) -> list[str]:
    """A line break and the empty lines after it, folded: a lone LF is a
    space, an LF before empty lines is dropped, LS and PS stay."""
    if line_break != "\n":
        return [line_break, *breaks]
    return breaks if breaks else [" "]

def safe_load(text: str) -> Any:
    """``yaml.safe_load(text)`` for the subset in this module's docstring;
    ValueError for anything outside it."""
    return _Parser(text).document()
