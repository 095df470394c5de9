"""PDF document: xref machinery, object access, page tree.

Robustness model follows the reference's pdfium guard philosophy
(reference: rapid_doc/utils/pdfium_guard.py): a corrupt xref falls back to
a full-file object scan, and per-page failures are isolated so one broken
page does not take down the document.
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import Any, Iterator

from .cos import ObjectParser, Ref, Stream
from .filters import decode_stream

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class PdfError(Exception):
    pass


class PdfDocument:
    def __init__(self, data: bytes):
        if not data.lstrip()[:5].startswith(b"%PDF-"):
            # tolerate leading junk if a %PDF- header exists nearby
            idx = data.find(b"%PDF-")
            if idx < 0:
                raise PdfError("not a PDF: missing %PDF- header")
            data = data[idx:]
        self.data = data
        self.xref: dict[int, tuple[str, int, int]] = {}
        # num -> ("n", offset, gen) | ("o", objstm_num, index)
        self.trailer: dict = {}
        self._objstm_cache: dict[int, dict[int, Any]] = {}
        self._obj_cache: dict[int, Any] = {}
        try:
            self._load_xref()
        except Exception:
            self.xref = {}
        if not self.xref or "Root" not in self.trailer:
            self._rebuild_xref_by_scan()
        if "Root" not in self.trailer:
            raise PdfError("no document catalog (corrupt trailer)")
        self._crypt = None
        self._encrypt_num = -1
        if "Encrypt" in self.trailer:
            self._init_crypt()

    def _init_crypt(self) -> None:
        """Empty-user-password standard security handler (crypt.py).
        pdfium opens such documents transparently (reference:
        rapid_doc/utils/pdf_image_tools.py:26-48)."""
        from .crypt import DecryptionError, StandardSecurityHandler

        ref = self.trailer["Encrypt"]
        enc = self.resolve(ref)  # fetched before _crypt is set -> raw
        if isinstance(ref, Ref):
            self._encrypt_num = ref.num
            self._obj_cache.pop(ref.num, None)
        if not isinstance(enc, dict):
            raise PdfError("malformed /Encrypt")
        ids = self.trailer.get("ID")
        first_id = b""
        if isinstance(ids, list) and ids:
            v = ids[0]
            first_id = v if isinstance(v, bytes) else str(v).encode("latin-1")
        filt = str(self.resolve(enc.get("Filter", "Standard")))
        if filt != "Standard":
            raise PdfError(f"unsupported encryption filter {filt!r}")
        enc = {k: self.resolve(v) for k, v in enc.items()}
        if "CF" in enc and isinstance(enc["CF"], dict):
            enc["CF"] = {
                k: self.resolve(v) for k, v in enc["CF"].items()
            }
        try:
            self._crypt = StandardSecurityHandler(enc, first_id)
        except DecryptionError as e:
            raise PdfError(str(e)) from e

    def _decrypt_object(self, obj: Any, num: int, gen: int) -> Any:
        """Recursively decrypt strings + stream payloads of one indirect
        object (xref/encrypt dict and objstm members excluded by callers)."""
        if isinstance(obj, bytes):
            return self._crypt.decrypt(obj, num, gen)
        if isinstance(obj, list):
            return [self._decrypt_object(v, num, gen) for v in obj]
        if isinstance(obj, Stream):
            d = self._decrypt_object(obj.dict, num, gen)
            if str(d.get("Type", "")) == "XRef":
                return Stream(d, obj.raw)  # xref streams are never encrypted
            return Stream(d, self._crypt.decrypt(obj.raw, num, gen))
        if isinstance(obj, dict):
            return {k: self._decrypt_object(v, num, gen) for k, v in obj.items()}
        return obj

    # ------------------------------------------------------------------ xref

    def _load_xref(self) -> None:
        tail = self.data[-2048:]
        m = None
        for m in re.finditer(rb"startxref\s+(\d+)", tail):
            pass
        if m is None:
            raise PdfError("no startxref")
        offset = int(m.group(1))
        seen: set[int] = set()
        while offset and offset not in seen and 0 <= offset < len(self.data):
            seen.add(offset)
            offset = self._load_xref_section(offset)

    def _load_xref_section(self, offset: int) -> int:
        """Parse one xref section (table or stream). Returns Prev offset or 0."""
        parser = ObjectParser(self.data, offset)
        parser.skip_ws()
        if self.data[parser.pos : parser.pos + 4] == b"xref":
            return self._load_xref_table(parser.pos + 4)
        # xref stream: "num gen obj <<...>> stream"
        obj = self._parse_indirect_at(offset)
        if not isinstance(obj, Stream):
            raise PdfError(f"bad xref at {offset}")
        return self._load_xref_stream(obj)

    def _load_xref_table(self, pos: int) -> int:
        parser = ObjectParser(self.data, pos)
        while True:
            parser.skip_ws()
            if self.data[parser.pos : parser.pos + 7] == b"trailer":
                parser.pos += 7
                trailer = parser.parse_object()
                for k, v in trailer.items():
                    self.trailer.setdefault(k, v)
                if "XRefStm" in trailer:
                    try:
                        self._load_xref_section(int(trailer["XRefStm"]))
                    except Exception:
                        pass
                prev = trailer.get("Prev")
                return int(prev) if isinstance(prev, (int, float)) else 0
            tok = parser.read_regular_token()
            if not tok:
                return 0
            start = int(tok)
            parser.skip_ws()
            count = int(parser.read_regular_token())
            parser.skip_ws()
            for i in range(count):
                entry = self.data[parser.pos : parser.pos + 20]
                em = re.match(rb"(\d{10})\s(\d{5})\s([nf])", entry)
                if not em:
                    parser.skip_ws()
                    off = int(parser.read_regular_token())
                    parser.skip_ws()
                    gen = int(parser.read_regular_token())
                    parser.skip_ws()
                    kind = parser.read_regular_token()
                else:
                    off, gen, kind = (
                        int(em.group(1)),
                        int(em.group(2)),
                        em.group(3),
                    )
                    parser.pos += em.end()
                    while (
                        parser.pos < len(self.data)
                        and self.data[parser.pos] in b" \r\n"
                    ):
                        parser.pos += 1
                num = start + i
                if kind in (b"n", "n".encode()) and num not in self.xref:
                    self.xref[num] = ("n", off, gen)

    def _load_xref_stream(self, stream: Stream) -> int:
        d = stream.dict
        data = decode_stream(stream, self.resolve)
        w = [int(self.resolve(x)) for x in self.resolve(d["W"])]
        size = int(self.resolve(d.get("Size", 0)))
        index = self.resolve(d.get("Index")) or [0, size]
        index = [int(self.resolve(x)) for x in index]
        entry_len = sum(w)
        pos = 0

        def field(buf: bytes, start: int, width: int, default: int) -> int:
            if width == 0:
                return default
            return int.from_bytes(buf[start : start + width], "big")

        for j in range(0, len(index), 2):
            first, count = index[j], index[j + 1]
            for i in range(count):
                if pos + entry_len > len(data):
                    break
                buf = data[pos : pos + entry_len]
                pos += entry_len
                num = first + i
                if num in self.xref:
                    continue
                ftype = field(buf, 0, w[0], 1)
                f2 = field(buf, w[0], w[1], 0)
                f3 = field(buf, w[0] + w[1], w[2], 0)
                if ftype == 1:
                    self.xref[num] = ("n", f2, f3)
                elif ftype == 2:
                    self.xref[num] = ("o", f2, f3)
        for k, v in d.items():
            if k not in ("W", "Index", "Filter", "DecodeParms", "Length", "Type"):
                self.trailer.setdefault(k, v)
        prev = d.get("Prev")
        return int(prev) if isinstance(prev, (int, float)) else 0

    def _rebuild_xref_by_scan(self) -> None:
        """Full scan for 'N G obj' patterns — recovery path for broken xrefs."""
        for m in _OBJ_RE.finditer(self.data):
            # Require the match to start at a token boundary
            s = m.start()
            if s > 0 and self.data[s - 1 : s] not in b"\r\n \t\x0c\x00>]":
                continue
            self.xref[int(m.group(1))] = ("n", s, int(m.group(2)))
        if "Root" not in self.trailer:
            for m in re.finditer(rb"/Root\s+(\d+)\s+(\d+)\s+R", self.data):
                self.trailer["Root"] = Ref(int(m.group(1)), int(m.group(2)))
            if "Root" not in self.trailer:
                # Last resort: find a /Type /Catalog object
                for num in self.xref:
                    try:
                        obj = self.get_object(num)
                    except Exception:
                        continue
                    if isinstance(obj, dict) and obj.get("Type") == "Catalog":
                        self.trailer["Root"] = Ref(num)
                        break

    # --------------------------------------------------------------- objects

    def _parse_indirect_at(self, offset: int) -> Any:
        m = _OBJ_RE.match(self.data, offset) or _OBJ_RE.search(
            self.data, offset, offset + 64
        )
        if not m:
            raise PdfError(f"no object at offset {offset}")
        parser = ObjectParser(self.data, m.end())
        obj = parser.parse_object()
        if isinstance(obj, Stream) and not isinstance(obj.dict.get("Length"), int):
            # Length was an indirect ref; re-read stream body with resolved length
            length = self.resolve(obj.dict.get("Length"))
            if isinstance(length, int):
                obj.dict["Length"] = length
        return obj

    def get_object(self, num: int, gen: int = 0) -> Any:
        if num in self._obj_cache:
            return self._obj_cache[num]
        entry = self.xref.get(num)
        if entry is None:
            return None
        obj: Any = None
        try:
            if entry[0] == "n":
                obj = self._parse_indirect_at(entry[1])
                if self._crypt is not None and num != self._encrypt_num:
                    obj = self._decrypt_object(obj, num, entry[2])
            else:
                # objstm members inherit the (already decrypted) container
                obj = self._get_from_objstm(entry[1], entry[2], num)
        except Exception:
            obj = None
        self._obj_cache[num] = obj
        return obj

    def _get_from_objstm(self, stm_num: int, index: int, num: int) -> Any:
        objs = self._objstm_cache.get(stm_num)
        if objs is None:
            stream = self.get_object(stm_num)
            objs = {}
            if isinstance(stream, Stream):
                data = decode_stream(stream, self.resolve)
                n = int(self.resolve(stream.dict.get("N", 0)))
                first = int(self.resolve(stream.dict.get("First", 0)))
                header = ObjectParser(data, 0)
                pairs = []
                for _ in range(n):
                    header.skip_ws()
                    onum = int(header.read_regular_token())
                    header.skip_ws()
                    ooff = int(header.read_regular_token())
                    pairs.append((onum, ooff))
                for onum, ooff in pairs:
                    try:
                        op = ObjectParser(data, first + ooff)
                        objs[onum] = op.parse_object()
                    except Exception:
                        objs[onum] = None
            self._objstm_cache[stm_num] = objs
        if num in objs:
            return objs[num]
        keys = list(objs.keys())
        if 0 <= index < len(keys):
            return objs[keys[index]]
        return None

    def resolve(self, obj: Any, depth: int = 0) -> Any:
        while isinstance(obj, Ref) and depth < 32:
            obj = self.get_object(obj.num, obj.gen)
            depth += 1
        return obj

    def stream_bytes(self, stream: Stream) -> bytes:
        return decode_stream(stream, self.resolve)

    # ----------------------------------------------------------------- pages

    @property
    def catalog(self) -> dict:
        cat = self.resolve(self.trailer.get("Root"))
        return cat if isinstance(cat, dict) else {}

    @lru_cache(maxsize=1)
    def _page_refs(self) -> tuple:
        pages_root = self.resolve(self.catalog.get("Pages"))
        out: list[tuple[Any, dict]] = []
        seen: set[int] = set()

        def walk(node_ref: Any, inherited: dict) -> None:
            node = self.resolve(node_ref)
            if not isinstance(node, dict):
                return
            if isinstance(node_ref, Ref):
                if node_ref.num in seen:
                    return
                seen.add(node_ref.num)
            inh = dict(inherited)
            for key in ("Resources", "MediaBox", "CropBox", "Rotate"):
                if key in node:
                    inh[key] = node[key]
            ntype = node.get("Type")
            kids = self.resolve(node.get("Kids"))
            if ntype == "Page" or (ntype is None and "Contents" in node and kids is None):
                out.append((node_ref, inh))
            elif isinstance(kids, list):
                for kid in kids:
                    walk(kid, inh)

        walk(self.catalog.get("Pages"), {})
        if not out and isinstance(pages_root, dict):
            walk(self.trailer.get("Root"), {})
        return tuple(out)

    def __len__(self) -> int:
        return len(self._page_refs())

    def get_page(self, index: int) -> "PdfPage":
        refs = self._page_refs()
        if not 0 <= index < len(refs):
            raise IndexError(index)
        node_ref, inherited = refs[index]
        return PdfPage(self, index, node_ref, inherited)

    def pages(self) -> Iterator["PdfPage"]:
        for i in range(len(self)):
            yield self.get_page(i)


class PdfPage:
    def __init__(self, doc: PdfDocument, index: int, node_ref: Any, inherited: dict):
        self.doc = doc
        self.index = index
        self.ref = node_ref
        node = doc.resolve(node_ref)
        self.dict: dict = node if isinstance(node, dict) else {}
        self._inherited = inherited

    def _attr(self, key: str) -> Any:
        if key in self.dict:
            return self.doc.resolve(self.dict[key])
        return self.doc.resolve(self._inherited.get(key))

    @property
    def mediabox(self) -> list[float]:
        box = self._attr("MediaBox") or [0, 0, 612, 792]
        box = [float(self.doc.resolve(v)) for v in box]
        x0, y0, x1, y1 = box
        return [min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)]

    @property
    def cropbox(self) -> list[float]:
        box = self._attr("CropBox")
        if not box:
            return self.mediabox
        box = [float(self.doc.resolve(v)) for v in box]
        x0, y0, x1, y1 = box
        mb = self.mediabox
        return [
            max(min(x0, x1), mb[0]),
            max(min(y0, y1), mb[1]),
            min(max(x0, x1), mb[2]),
            min(max(y0, y1), mb[3]),
        ]

    @property
    def rotation(self) -> int:
        rot = self._attr("Rotate") or 0
        try:
            return int(rot) % 360
        except (TypeError, ValueError):
            return 0

    @property
    def size(self) -> tuple[float, float]:
        """Visible page size in PDF units, after /Rotate."""
        box = self.cropbox
        w, h = box[2] - box[0], box[3] - box[1]
        if self.rotation in (90, 270):
            w, h = h, w
        return (w, h)

    @property
    def resources(self) -> dict:
        res = self._attr("Resources")
        return res if isinstance(res, dict) else {}

    def content_bytes(self) -> bytes:
        contents = self.doc.resolve(self.dict.get("Contents"))
        if contents is None:
            return b""
        if isinstance(contents, Stream):
            return self.doc.stream_bytes(contents)
        if isinstance(contents, list):
            parts = []
            for c in contents:
                c = self.doc.resolve(c)
                if isinstance(c, Stream):
                    parts.append(self.doc.stream_bytes(c))
            return b"\n".join(parts)
        return b""


def open_pdf(data: bytes) -> PdfDocument:
    return PdfDocument(data)
