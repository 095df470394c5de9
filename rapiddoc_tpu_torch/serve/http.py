"""HTTP parsing service.

API parity with the reference FastAPI server (reference:
docker/app.py:37-172 — GET /health, POST /file_parse multipart with
per-request config JSON strings, zip or JSON response). Port of
``rapiddoc_tpu/serve/http.py`` (an aiohttp app) on the standard library,
since the card's machine has neither aiohttp nor FastAPI: a
``ThreadingHTTPServer`` (one thread a connection) hands each parse to
two worker threads, as the JAX app's executor does, and the analyzer's
lock serializes the device stages of concurrent requests. The routes,
form fields, status codes, content types, gzip and bodies are the JAX
app's:

- ``GET /health``: ``{"status": "ok", "version": ...}``;
- ``GET /``: the web UI page (``serve/webui.py``);
- ``POST /file_parse``: multipart with one or more ``file``/``files``
  parts and option fields (JSON strings, else taken as text);
  ``return_format=zip`` or ``response_format_zip`` asks for a zip (and
  more than one file always gets one); the JSON response holds the
  ``return_*`` fields with images in base64;
- ``POST /webui_parse``: the first file's Markdown and its preview HTML;
- 400 ``{"error": "no file uploaded"}`` for a form without a file part,
  or a body that is no well-formed multipart form (the JAX app gives
  that for a body that is not multipart at all, and aiohttp answers 500
  in plain text where the form breaks off or names another boundary);
  500 ``{"error": ...}`` where the parse fails; 413 over 256 MiB; 400
  in plain text for a Content-Length that is no count of bytes;
- JSON and HTML bodies compressed where the client accepts gzip: with
  deflate where it accepts that too, as aiohttp chooses, else gzip.

Each request builds its ``RapidDoc`` from its options, and the model
stacks are cached by configuration (``api.ModelStack``), so a request
never reloads weights or rebuilds a kernel. The service runs on the
card, or on the CPU under ``RAPIDDOC_PLATFORM=cpu``; ``make_server``
raises where CUDA is missing otherwise.

    python -m rapiddoc_tpu_torch.serve.http --host 0.0.0.0 --port 8000
"""
from __future__ import annotations

import base64
import gzip
import io
import json
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from email.parser import HeaderParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging import get_logger
from ..version import __version__

logger = get_logger("rapiddoc_tpu_torch.serve")

MAX_BODY = 256 * 1024 * 1024
WORKERS = 2


def _engine_lang(options: dict) -> str:
    # reference accepts lang_list (one per file, docker/app.py:153);
    # single-engine builds use the first entry
    lang_list = options.get("lang_list")
    if isinstance(lang_list, list) and lang_list:
        return str(lang_list[0])
    if isinstance(lang_list, str) and lang_list:
        return lang_list
    return options.get("lang", "ch")


def _page_slice(data: bytes, options: dict) -> bytes:
    """Honor start_page_id/end_page_id for PDF inputs (reference:
    docker/app.py:170-171)."""
    try:
        start = int(options.get("start_page_id", 0))
        end = int(options.get("end_page_id", 99999))
    except (TypeError, ValueError):
        return data
    if (start <= 0 and end >= 99999) or not data.lstrip()[:4] == b"%PDF":
        return data
    from ..pdfio import open_pdf
    from ..pdfio.writer import select_pages

    try:
        n = len(open_pdf(data))
        return select_pages(data, range(start, min(end, n - 1) + 1))
    except Exception:
        return data


def _build_engine(options: dict):
    from ..api import RapidDoc

    return RapidDoc(
        parse_method=options.get("parse_method", "auto"),
        lang=_engine_lang(options),
        formula_enable=options.get("formula_enable", True),
        table_enable=options.get("table_enable", True),
        layout_config=options.get("layout_config") or {},
        ocr_config=options.get("ocr_config") or {},
        formula_config=options.get("formula_config") or {},
        table_config=options.get("table_config") or {},
    )


def _result_dict(out, filename: str, options: dict) -> dict:
    """Shape one document's response by the return_* flags (reference:
    docker/app.py:164-168 defaults: md+images on, the rest off)."""
    result: dict = {"filename": filename}
    if options.get("return_md", True):
        result["markdown"] = out.markdown
    if options.get("return_middle_json", False):
        result["middle_json"] = out.middle_json
    if options.get("return_model_output", False):
        result["model_output"] = out.model_json
    if options.get("return_content_list", False):
        result["content_list"] = out.content_list_json
    if options.get("return_images", True):
        result["images"] = out.images
    else:
        result["images"] = {}
    return result


def _parse_bytes(data: bytes, filename: str, options: dict) -> dict:
    from ..api import NamedBytes

    engine = _build_engine(options)
    out = engine(NamedBytes(_page_slice(data, options), filename))
    return _result_dict(out, filename, options)


def _parse_batch_bytes(files: list[tuple[str, bytes]], options: dict) -> list[dict]:
    """Multi-file request: pages super-batched across documents
    (RapidDoc.parse_batch)."""
    from ..api import NamedBytes

    engine = _build_engine(options)
    outs = engine.parse_batch(
        [NamedBytes(_page_slice(data, options), name) for name, data in files]
    )
    return [_result_dict(out, name, options) for (name, _), out in zip(files, outs)]


def _zip_body(results: list[dict]) -> tuple[bytes, str]:
    """Zip archive: one directory per document (single doc at top level);
    returns the bytes and the archive's name."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for result in results:
            name = result["filename"].rsplit(".", 1)[0]
            prefix = f"{name}/" if len(results) > 1 else ""
            if "markdown" in result:
                z.writestr(f"{prefix}{name}.md", result["markdown"])
            for key, suffix in (
                ("middle_json", "_middle.json"),
                ("content_list", "_content_list.json"),
                ("model_output", "_model.json"),
            ):
                if key in result:
                    z.writestr(
                        f"{prefix}{name}{suffix}",
                        json.dumps(result[key], ensure_ascii=False, default=str),
                    )
            for rel, blob in result.get("images", {}).items():
                z.writestr(prefix + rel, blob)
    archive = results[0]["filename"].rsplit(".", 1)[0] if len(results) == 1 else "results"
    return buf.getvalue(), archive


def read_multipart(content_type: str, body: bytes) -> tuple[list, dict, bool]:
    """-> (files [(name, bytes)...], options, return_zip) of a
    ``multipart/form-data`` body; files is empty when no file part was
    present or the form is malformed. Multiple ``file``/``files`` parts
    are accepted (reference: docker/app.py multi-file /file_parse)."""
    head = HeaderParser(policy=HTTP).parsestr(f"Content-Type: {content_type}\r\n\r\n")
    boundary = head.get_param("boundary")
    if head.get_content_maintype() != "multipart" or not boundary:
        return [], {}, False
    delim = b"\r\n--" + str(boundary).encode("latin-1")
    pieces = (b"\r\n" + body).split(delim)
    # pieces[0] is the preamble; the form ends at a piece that opens "--"
    if len(pieces) < 2 or not any(p.startswith(b"--") for p in pieces[1:]):
        return [], {}, False
    files: list[tuple[str, bytes]] = []
    options: dict = {}
    return_zip = False
    for piece in pieces[1:]:
        if piece.startswith(b"--"):
            break
        headers, sep, content = piece.partition(b"\r\n\r\n")
        if not sep:
            return [], {}, False
        part = HeaderParser(policy=HTTP).parsestr(
            headers.lstrip(b" \t\r\n").decode("utf-8", "replace") + "\r\n\r\n")
        name = part.get_param("name", header="content-disposition")
        if name in ("file", "files"):
            files.append((part.get_filename() or f"document{len(files)}", content))
            continue
        text = content.decode(part.get_content_charset("utf-8"), "replace")
        if name == "return_format":
            return_zip = text == "zip"
        elif name == "response_format_zip":
            # reference flag name (docker/app.py:169)
            return_zip = text.lower() in ("1", "true")
        else:
            try:
                options[name] = json.loads(text)
            except json.JSONDecodeError:
                options[name] = text
    return files, options, return_zip


class ParseServer(ThreadingHTTPServer):
    """The service: routes in ``_Handler``, parses on ``WORKERS`` worker
    threads. ``close()`` stops the workers and the socket."""

    daemon_threads = True

    def __init__(self, address: tuple[str, int]):
        from ..engine.session import resolve_device

        resolve_device(None)  # the card, or RAPIDDOC_PLATFORM=cpu
        self.executor = ThreadPoolExecutor(max_workers=WORKERS)
        super().__init__(address, _Handler)

    def close(self) -> None:
        self.server_close()
        self.executor.shutdown(wait=True)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "rapiddoc-tpu-torch/" + __version__

    def log_message(self, format, *args):  # noqa: A002 - the base class's name
        logger.debug("%s - %s", self.address_string(), format % args)

    # ---------------------------------------------------------- replies

    def _send(self, status: int, body: bytes, content_type: str,
              headers: dict | None = None) -> None:
        headers = dict(headers or {})
        accept = self.headers.get("Accept-Encoding", "")
        if "gzip" in accept and content_type.split(";")[0] in ("application/json", "text/html"):
            # the JAX app's middleware turns compression on where gzip is
            # accepted, and aiohttp then takes deflate before gzip
            if "deflate" in accept.lower():
                body, headers["Content-Encoding"] = zlib.compress(body), "deflate"
            else:
                body, headers["Content-Encoding"] = gzip.compress(body), "gzip"
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, status: int = 200, dumps=json.dumps) -> None:
        self._send(status, dumps(obj).encode("utf-8"), "application/json; charset=utf-8")

    def _text(self, status: int, text: str) -> None:
        self._send(status, text.encode("utf-8"), "text/plain; charset=utf-8")

    # ----------------------------------------------------------- routes

    def do_GET(self):  # noqa: N802 - the base class's name
        if self.path == "/health":
            self._json({"status": "ok", "version": __version__})
        elif self.path == "/":
            from .webui import PAGE

            self._send(200, PAGE.encode("utf-8"), "text/html; charset=utf-8")
        elif self.path in ("/file_parse", "/webui_parse"):
            self._text(405, "405: Method Not Allowed")
        else:
            self._text(404, "404: Not Found")

    def do_POST(self):  # noqa: N802 - the base class's name
        if self.path not in ("/file_parse", "/webui_parse"):
            if self.path in ("/health", "/"):
                self._text(405, "405: Method Not Allowed")
            else:
                self._text(404, "404: Not Found")
            return
        raw_length = (self.headers.get("Content-Length") or "0").strip()
        if not raw_length.isdigit():  # a negative length would read to the end
            self.close_connection = True
            self._text(400, f"400: Bad Request (Content-Length {raw_length!r})")
            return
        length = int(raw_length)
        if length > MAX_BODY:
            self.close_connection = True
            self._text(413, f"Maximum request body size {MAX_BODY} exceeded, "
                            f"actual body size {length}")
            return
        body = self.rfile.read(length)
        files, options, return_zip = read_multipart(
            self.headers.get("Content-Type", ""), body)
        if not files:
            self._json({"error": "no file uploaded"}, status=400)
            return
        if self.path == "/webui_parse":
            self._webui_parse(files[0], options)
        else:
            self._file_parse(files, options, return_zip)

    def _run(self, fn, *args):
        """``fn(*args)`` on a worker thread; None after a 500 reply."""
        try:
            return self.server.executor.submit(fn, *args).result()
        except Exception as e:
            logger.exception("parse failed")
            self._json({"error": str(e)}, status=500)
            return None

    def _webui_parse(self, file: tuple[str, bytes], options: dict) -> None:
        """Webui endpoint: parse + server-rendered markdown preview."""
        from .webui import render_preview_html

        filename, file_bytes = file
        result = self._run(_parse_bytes, file_bytes, filename, options)
        if result is None:
            return
        self._json({
            "markdown": result["markdown"],
            "html": render_preview_html(result["markdown"], result["images"]),
            "filename": filename,
        })

    def _file_parse(self, files: list, options: dict, return_zip: bool) -> None:
        if len(files) > 1:
            results = self._run(_parse_batch_bytes, files, options)
        else:
            one = self._run(_parse_bytes, files[0][1], files[0][0], options)
            results = None if one is None else [one]
        if results is None:
            return
        if len(results) > 1 or return_zip:
            body, archive = _zip_body(results)
            self._send(200, body, "application/zip", {
                "Content-Disposition": f'attachment; filename="{archive}.zip"'})
            return
        result = results[0]
        result["images"] = {k: base64.b64encode(v).decode() for k, v in result["images"].items()}
        self._json(result, dumps=lambda o: json.dumps(o, default=str))


def make_server(host: str = "127.0.0.1", port: int = 8000) -> ParseServer:
    """The service bound to ``(host, port)`` (port 0: any free port, read
    it from ``server.server_address``); run it with ``serve_forever()``."""
    return ParseServer((host, port))


def main(host: str = "0.0.0.0", port: int = 8000) -> None:
    import os

    server = make_server(host, port)
    if os.environ.get("RAPIDDOC_SERVE_WARMUP"):
        # pay the model build at startup, not on the first request
        from ..api import RapidDoc

        logger.info("warmup: building the model stack ...")
        RapidDoc().warmup(precompile=True)
    logger.info("serving on http://%s:%d", *server.server_address[:2])
    try:
        server.serve_forever()
    finally:
        server.close()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(prog="rapiddoc_tpu_torch.serve.http")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args()
    main(host=args.host, port=args.port)
