"""COS (PDF object system) model and syntax parser.

Pure-Python PDF object layer built from the PDF 1.7 spec (ISO 32000-1).
This replaces the role pypdfium2/PDFium plays in the reference
(reference: rapid_doc/utils/pdf_image_tools.py, pdf_text_tool.py) — the
environment ships no PDF library, so the framework carries its own.

Object mapping:
  null          -> None
  boolean       -> bool
  number        -> int | float
  string        -> bytes
  name          -> Name (str subclass)
  array         -> list
  dictionary    -> dict (keys are Name)
  stream        -> Stream
  reference     -> Ref
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any


class Name(str):
    """A PDF name object (/Foo). Subclasses str for easy dict keying."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return f"/{str(self)}"


@dataclass(frozen=True)
class Ref:
    """Indirect object reference (num gen R)."""

    num: int
    gen: int = 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.num} {self.gen} R"


class Stream:
    """A stream object: dict + raw (still encoded) data.

    Decoding is lazy; `pdfio.filters.decode_stream` produces the bytes.
    """

    __slots__ = ("dict", "raw")

    def __init__(self, d: dict, raw: bytes):
        self.dict = d
        self.raw = raw

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Stream {len(self.raw)}B {dict(self.dict)!r}>"


WHITESPACE = b"\x00\t\n\x0c\r "
DELIMITERS = b"()<>[]{}/%"

_NUM_RE = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)")

_ESCAPES = {
    ord("n"): b"\n",
    ord("r"): b"\r",
    ord("t"): b"\t",
    ord("b"): b"\b",
    ord("f"): b"\x0c",
    ord("("): b"(",
    ord(")"): b")",
    ord("\\"): b"\\",
}


class Lexer:
    """Tokenizer over a bytes buffer with a movable position.

    `allow_refs=False` skips the "num gen R" indirect-reference lookahead
    — content streams cannot contain refs (PDF 1.7 §7.8.2) and their TJ
    arrays are integer-dense, so the saved double-lex is a hot-path win.
    """

    def __init__(self, data: bytes, pos: int = 0, allow_refs: bool = True):
        self.data = data
        self.pos = pos
        self.allow_refs = allow_refs

    # --- low-level ---

    def skip_ws(self) -> None:
        data, pos, n = self.data, self.pos, len(self.data)
        while pos < n:
            c = data[pos]
            if c in WHITESPACE:
                pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while pos < n and data[pos] not in b"\r\n":
                    pos += 1
            else:
                break
        self.pos = pos

    def peek_byte(self) -> int | None:
        return self.data[self.pos] if self.pos < len(self.data) else None

    def read_regular_token(self) -> bytes:
        """Read a run of regular (non-delimiter, non-space) characters."""
        data, pos, n = self.data, self.pos, len(self.data)
        start = pos
        while pos < n and data[pos] not in WHITESPACE and data[pos] not in DELIMITERS:
            pos += 1
        self.pos = pos
        return data[start:pos]

    # --- object-level ---

    def read_name(self) -> Name:
        assert self.data[self.pos] == 0x2F  # '/'
        self.pos += 1
        raw = self.read_regular_token()
        if b"#" in raw:
            out = bytearray()
            i = 0
            while i < len(raw):
                if raw[i] == 0x23 and i + 2 < len(raw) + 1:
                    try:
                        out.append(int(raw[i + 1 : i + 3], 16))
                        i += 3
                        continue
                    except ValueError:
                        pass
                out.append(raw[i])
                i += 1
            raw = bytes(out)
        return Name(raw.decode("latin-1"))

    def read_literal_string(self) -> bytes:
        assert self.data[self.pos] == 0x28  # '('
        data, pos, n = self.data, self.pos + 1, len(self.data)
        out = bytearray()
        depth = 1
        while pos < n:
            c = data[pos]
            if c == 0x5C:  # backslash
                pos += 1
                if pos >= n:
                    break
                e = data[pos]
                if e in _ESCAPES:
                    out += _ESCAPES[e]
                    pos += 1
                elif 0x30 <= e <= 0x37:  # octal, up to 3 digits
                    oct_digits = bytearray()
                    while pos < n and len(oct_digits) < 3 and 0x30 <= data[pos] <= 0x37:
                        oct_digits.append(data[pos])
                        pos += 1
                    out.append(int(oct_digits, 8) & 0xFF)
                elif e in b"\r\n":  # line continuation
                    pos += 1
                    if e == 0x0D and pos < n and data[pos] == 0x0A:
                        pos += 1
                else:
                    out.append(e)
                    pos += 1
            elif c == 0x28:
                depth += 1
                out.append(c)
                pos += 1
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    pos += 1
                    break
                out.append(c)
                pos += 1
            else:
                out.append(c)
                pos += 1
        self.pos = pos
        return bytes(out)

    def read_hex_string(self) -> bytes:
        assert self.data[self.pos] == 0x3C  # '<'
        end = self.data.find(b">", self.pos + 1)
        if end < 0:
            end = len(self.data)
        hex_chars = re.sub(rb"[^0-9A-Fa-f]", b"", self.data[self.pos + 1 : end])
        self.pos = end + 1
        if len(hex_chars) % 2:
            hex_chars += b"0"
        return bytes.fromhex(hex_chars.decode("ascii"))


class ObjectParser(Lexer):
    """Parses full COS objects. Indirect refs come back as Ref."""

    def parse_object(self) -> Any:
        self.skip_ws()
        c = self.peek_byte()
        if c is None:
            raise EOFError("unexpected end of PDF data")
        if c == 0x2F:  # /
            return self.read_name()
        if c == 0x28:  # (
            return self.read_literal_string()
        if c == 0x3C:  # < or <<
            if self.data[self.pos : self.pos + 2] == b"<<":
                return self._parse_dict_or_stream()
            return self.read_hex_string()
        if c == 0x5B:  # [
            return self._parse_array()
        if c == 0x5D:  # ] — caller handles
            raise ValueError("unexpected ']'")
        token = self.read_regular_token()
        if not token:
            raise ValueError(f"cannot parse object at {self.pos}: {chr(c)!r}")
        if token == b"true":
            return True
        if token == b"false":
            return False
        if token == b"null":
            return None
        if _NUM_RE.fullmatch(token):
            # Might be the start of "num gen R"
            if b"." not in token and self.allow_refs:
                save = self.pos
                self.skip_ws()
                tok2 = self.read_regular_token()
                if tok2 and _NUM_RE.fullmatch(tok2) and b"." not in tok2:
                    self.skip_ws()
                    if self.read_regular_token() == b"R":
                        return Ref(int(token), int(tok2))
                self.pos = save
            return float(token) if b"." in token else int(token)
        raise ValueError(f"unknown token {token!r} at {self.pos}")

    def _parse_array(self) -> list:
        assert self.data[self.pos] == 0x5B
        self.pos += 1
        out = []
        while True:
            self.skip_ws()
            if self.peek_byte() == 0x5D:
                self.pos += 1
                return out
            if self.peek_byte() is None:
                return out
            out.append(self.parse_object())

    def _parse_dict_or_stream(self) -> dict | Stream:
        d = self._parse_dict()
        save = self.pos
        self.skip_ws()
        tok = self.data[self.pos : self.pos + 6]
        if tok == b"stream":
            self.pos += 6
            # EOL after "stream" keyword: CRLF or LF
            if self.data[self.pos : self.pos + 2] == b"\r\n":
                self.pos += 2
            elif self.pos < len(self.data) and self.data[self.pos] in b"\r\n":
                self.pos += 1
            length = d.get("Length")
            raw = self._read_stream_data(length)
            return Stream(d, raw)
        self.pos = save
        return d

    def _parse_dict(self) -> dict:
        assert self.data[self.pos : self.pos + 2] == b"<<"
        self.pos += 2
        d: dict = {}
        while True:
            self.skip_ws()
            if self.data[self.pos : self.pos + 2] == b">>":
                self.pos += 2
                return d
            if self.peek_byte() is None:
                return d
            if self.peek_byte() != 0x2F:
                # Tolerate junk keys by skipping one object
                try:
                    self.parse_object()
                except (ValueError, EOFError):
                    self.pos += 1
                continue
            key = self.read_name()
            d[key] = self.parse_object()

    def _read_stream_data(self, length: Any) -> bytes:
        start = self.pos
        if isinstance(length, int) and length >= 0:
            end = start + length
            tail = self.data[end : end + 20]
            if b"endstream" in tail or end >= len(self.data):
                self.pos = end
                self._skip_endstream()
                return self.data[start:end]
        # Length wrong/indirect: scan for endstream
        idx = self.data.find(b"endstream", start)
        if idx < 0:
            idx = len(self.data)
        end = idx
        # Strip at most one trailing EOL that belongs to the keyword
        if end > start and self.data[end - 1 : end] == b"\n":
            end -= 1
        if end > start and self.data[end - 1 : end] == b"\r":
            end -= 1
        self.pos = idx
        self._skip_endstream()
        return self.data[start:end]

    def _skip_endstream(self) -> None:
        self.skip_ws()
        if self.data[self.pos : self.pos + 9] == b"endstream":
            self.pos += 9
