"""The port's HTTP service (``rapiddoc_tpu_torch/serve/http.py``, the
standard library's ``http.server``) against the JAX package's aiohttp app
(``rapiddoc_tpu/serve/http.py``).

Both run on 127.0.0.1 and get the same raw requests: one table replays
every request ``tests/test_longtail.py`` makes (health, the web UI page
and its parse, JSON with the ``return_*`` flags, zip by ``return_format``
and by ``response_format_zip``, several files, a page slice with
``lang_list``, no file, a corrupt file) and a few more (gzip and deflate,
an unknown route, a wrong method, forms that are no multipart).
Status codes, content types and encodings, JSON bodies, HTML and zip
members must be equal.

Where aiohttp's multipart reader raises past the JAX app's
``_read_multipart`` (a form that names another boundary, breaks off, or
is empty), aiohttp answers its own 500 in plain text; the port gives what
``_read_multipart`` means to give, no files and then 400 "no file
uploaded" (``MALFORMED``).

Two requests at once return what each returns alone; over 256 MiB gets
413; ``RapidDoc`` builds on the port's cached model stack, so the second
request builds no model.
"""
from __future__ import annotations

import asyncio
import gzip
import http.client
import io
import json
import threading
import zipfile
import zlib

import numpy as np
import pytest

BOUNDARY = "rapiddoc-test-boundary"


def _pdf_with_text(text: str) -> bytes:
    from test_torch_data_io import native_text_pdf

    return native_text_pdf(text)


def _image_pdf(texts: list[str]) -> bytes:
    """Pages drawn by PIL and written by the JAX package's writer, as
    test_longtail.py makes them."""
    from PIL import Image, ImageDraw

    from rapiddoc_tpu import pdfio

    imgs = []
    for text in texts:
        img = Image.new("RGB", (300, 200), "white")
        ImageDraw.Draw(img).text((30, 80), text, fill="black")
        imgs.append(img)
    return pdfio.images_to_pdf(imgs)


def form(*parts: tuple) -> bytes:
    """A multipart body: (name, value) fields and (name, filename, bytes)
    files."""
    out = b""
    for part in parts:
        out += f"--{BOUNDARY}\r\n".encode()
        if len(part) == 3:
            out += (f'Content-Disposition: form-data; name="{part[0]}"; filename="{part[1]}"\r\n'
                    "Content-Type: application/pdf\r\n\r\n").encode() + part[2] + b"\r\n"
        else:
            out += (f'Content-Disposition: form-data; name="{part[0]}"\r\n\r\n{part[1]}'
                    "\r\n").encode()
    return out + f"--{BOUNDARY}--\r\n".encode()


MULTIPART = f"multipart/form-data; boundary={BOUNDARY}"


def _requests() -> dict[str, tuple]:
    """name -> (method, path, headers, body)."""
    pdf = _image_pdf(["server test"])
    text = _pdf_with_text("alpha document text")
    three = _image_pdf(["alpha", "beta", "gamma"])
    two = [_image_pdf([f"multi {i}"]) for i in range(2)]
    txt = ("parse_method", '"txt"')
    mp = {"Content-Type": MULTIPART}
    return {
        "health": ("GET", "/health", {}, b""),
        "webui_page": ("GET", "/", {}, b""),
        "webui_page_gzip": ("GET", "/", {"Accept-Encoding": "gzip"}, b""),
        "webui_parse": ("POST", "/webui_parse", mp, form(("file", "t.pdf", pdf), txt)),
        "json": ("POST", "/file_parse", mp, form(("file", "t.pdf", pdf), txt)),
        "json_text_layer": ("POST", "/file_parse", mp, form(("file", "a.pdf", text), txt)),
        "json_flags": ("POST", "/file_parse", mp, form(
            ("file", "t.pdf", pdf), txt, ("return_content_list", "true"),
            ("return_middle_json", "true"), ("return_model_output", "true"),
            ("return_images", "false"))),
        "json_gzip": ("POST", "/file_parse", {**mp, "Accept-Encoding": "gzip"},
                      form(("file", "a.pdf", text), txt, ("return_middle_json", "true"))),
        "json_deflate": ("POST", "/file_parse", {**mp, "Accept-Encoding": "gzip, deflate"},
                         form(("file", "a.pdf", text), txt)),
        "zip": ("POST", "/file_parse", mp, form(
            ("file", "z.pdf", pdf), txt, ("return_format", "zip"),
            ("return_middle_json", "true"), ("return_content_list", "true"))),
        "zip_reference_flag": ("POST", "/file_parse", {**mp, "Accept-Encoding": "gzip"}, form(
            ("file", "z.pdf", pdf), txt, ("response_format_zip", "True"),
            ("return_model_output", "true"))),
        "multi_file": ("POST", "/file_parse", mp, form(
            ("files", "doc0.pdf", two[0]), ("files", "doc1.pdf", two[1]), txt)),
        "page_slice_lang_list": ("POST", "/file_parse", mp, form(
            ("file", "p.pdf", three), txt, ("lang_list", '["en"]'), ("start_page_id", "1"),
            ("end_page_id", "1"), ("return_middle_json", "true"))),
        "no_file": ("POST", "/file_parse", mp, form(txt)),
        "webui_no_file": ("POST", "/webui_parse", mp, form(txt)),
        "corrupt_file": ("POST", "/file_parse", mp, form(("file", "bad.pdf", b"not a pdf"), txt)),
        "corrupt_nameless": ("POST", "/file_parse", mp,
                             f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="file"\r\n\r\n'
                             f"%PDF-1.4 broken\r\n--{BOUNDARY}--\r\n".encode()),
        "json_body": ("POST", "/file_parse", {"Content-Type": "application/json"}, b'{"a": 1}'),
        "urlencoded": ("POST", "/file_parse",
                       {"Content-Type": "application/x-www-form-urlencoded"}, b"parse_method=txt"),
        "no_boundary": ("POST", "/file_parse", {"Content-Type": "multipart/form-data"},
                        form(txt)),
        "preamble": ("POST", "/file_parse", mp, b"junk\r\n" + form(txt)),
        "unknown_route": ("GET", "/nope", {}, b""),
        "wrong_method": ("GET", "/file_parse", {}, b""),
    }


# the forms aiohttp's reader fails on inside the JAX app (its own 500)
MALFORMED = {
    "wrong_boundary": ("POST", "/file_parse", {"Content-Type": "multipart/form-data; boundary=zz"},
                       form(("parse_method", '"txt"'))),
    "broken_off": ("POST", "/file_parse", {"Content-Type": MULTIPART},
                   f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="file"; '
                   f'filename="a.pdf"\r\n\r\n%PDF-1.4 abc'.encode()),
    "empty": ("POST", "/file_parse", {"Content-Type": MULTIPART}, b""),
}
REQUESTS = _requests()


class _JaxApp:
    """The JAX package's aiohttp app on its own event loop and thread."""

    def __init__(self):
        from aiohttp import web

        from rapiddoc_tpu.serve.http import make_app

        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(make_app())
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        self.port = self.runner.addresses[0][1]
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.loop.close()


class _PortServer:
    def __init__(self):
        from rapiddoc_tpu_torch.serve.http import make_server

        self.server = make_server("127.0.0.1", 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def servers():
    """Both services, the port's on the CPU; no model stage runs (the
    text comes from the PDFs' text layer), as in test_longtail.py."""
    from torch_threads import capped_threads

    threads = capped_threads(2)
    next(threads)
    mp = pytest.MonkeyPatch()
    mp.setenv("RAPIDDOC_PLATFORM", "cpu")
    for k in ("OCR", "LAYOUT", "FORMULA", "TABLE"):
        mp.setenv(f"RAPIDDOC_DISABLE_{k}", "1")
    jax_app, port_server = _JaxApp(), _PortServer()
    try:
        yield {"jax": jax_app.port, "port": port_server.port}
    finally:
        jax_app.close()
        port_server.close()
        mp.undo()
        threads.close()


def send(port: int, request: tuple) -> dict:
    """One request on its own connection: status, the headers compared,
    and the body (decompressed) in the form compared."""
    method, path, headers, body = request
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        status, ctype = resp.status, resp.getheader("Content-Type")
        encoding = resp.getheader("Content-Encoding")
        disposition = resp.getheader("Content-Disposition")
    finally:
        conn.close()
    if encoding == "gzip":
        raw = gzip.decompress(raw)
    elif encoding == "deflate":
        raw = zlib.decompress(raw)
    if ctype.startswith("application/json"):
        content = json.loads(raw)
    elif ctype == "application/zip":
        with zipfile.ZipFile(io.BytesIO(raw)) as z:
            content = [(n, z.read(n)) for n in z.namelist()]
    else:
        content = raw.decode()
    return {"status": status, "type": ctype, "encoding": encoding,
            "disposition": disposition, "content": content}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_response_equals_jax_app(servers, name):
    got = send(servers["port"], REQUESTS[name])
    want = send(servers["jax"], REQUESTS[name])
    assert got == want
    assert got["status"] in (200, 400, 404, 405, 500)


def test_responses_say_what_test_longtail_asks(servers):
    port = servers["port"]
    assert send(port, REQUESTS["health"])["content"]["status"] == "ok"
    assert "webui_parse" in send(port, REQUESTS["webui_page"])["content"]
    plain = send(port, REQUESTS["json"])["content"]
    assert "markdown" in plain and "images" in plain and "middle_json" not in plain
    flags = send(port, REQUESTS["json_flags"])["content"]
    assert flags["images"] == {} and "content_list" in flags and "model_output" in flags
    assert "alpha document text" in send(port, REQUESTS["json_text_layer"])["content"]["markdown"]
    names = [n for n, _ in send(port, REQUESTS["zip"])["content"]]
    assert {"z.md", "z_middle.json", "z_content_list.json"} <= set(names)
    names = [n for n, _ in send(port, REQUESTS["multi_file"])["content"]]
    assert "doc0/doc0.md" in names and "doc1/doc1.md" in names
    sliced = send(port, REQUESTS["page_slice_lang_list"])["content"]
    assert len(sliced["middle_json"]["pdf_info"]) == 1
    assert send(port, REQUESTS["no_file"]) == {
        "status": 400, "type": "application/json; charset=utf-8", "encoding": None,
        "disposition": None, "content": {"error": "no file uploaded"}}
    corrupt = send(port, REQUESTS["corrupt_file"])
    assert corrupt["status"] == 500 and corrupt["content"]["error"]


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_form_is_400_no_file(servers, name):
    got = send(servers["port"], MALFORMED[name])
    assert (got["status"], got["content"]) == (400, {"error": "no file uploaded"})
    want = send(servers["jax"], MALFORMED[name])
    assert (want["status"], want["type"]) == (500, "text/plain; charset=utf-8")


def test_concurrent_requests_return_what_each_returns_alone(servers):
    """Two uploads at once (test_longtail.py's) on each service: each
    answer equals the JAX app's and the port's own answer alone."""
    reqs = [("POST", "/file_parse", {"Content-Type": MULTIPART},
             form(("file", f"{n}.pdf", _pdf_with_text(f"{word} document text")),
                  ("parse_method", '"txt"'), ("return_middle_json", "true")))
            for n, word in (("a", "alpha"), ("b", "bravo"))]
    alone = [send(servers["port"], r) for r in reqs]
    for which in ("port", "jax"):
        out: list = [None, None]

        def run(i, which=which):
            out[i] = send(servers[which], reqs[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert out == alone, which
    assert "alpha" in alone[0]["content"]["markdown"]
    assert "bravo" in alone[1]["content"]["markdown"]
    assert "bravo" not in alone[0]["content"]["markdown"]


def test_body_over_the_limit_gets_413(servers):
    from rapiddoc_tpu_torch.serve.http import MAX_BODY

    conn = http.client.HTTPConnection("127.0.0.1", servers["port"], timeout=60)
    try:
        conn.putrequest("POST", "/file_parse")
        conn.putheader("Content-Type", MULTIPART)
        conn.putheader("Content-Length", str(MAX_BODY + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413 and b"Maximum request body size" in resp.read()
    finally:
        conn.close()
    assert MAX_BODY == 256 * 1024 * 1024


@pytest.mark.parametrize("length", ["-5", "abc", "1e3"])
def test_content_length_that_is_no_count_gets_400(servers, length):
    """A Content-Length that is no count of bytes is refused before any
    body is read (a negative one would read to the end of the stream),
    as aiohttp refuses it."""
    import socket

    for which in ("port", "jax"):
        with socket.create_connection(("127.0.0.1", servers[which]), timeout=60) as sock:
            sock.sendall(f"POST /file_parse HTTP/1.1\r\nHost: x\r\nContent-Type: {MULTIPART}"
                         f"\r\nContent-Length: {length}\r\n\r\n".encode())
            head = b""
            while b"\r\n\r\n" not in head:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                head += chunk
        assert head.split(b" ")[1] == b"400" and b"text/plain" in head, (which, head)


def test_requests_reuse_the_model_stack(servers, monkeypatch):
    """A request builds ``RapidDoc`` from its options on the cached model
    stack: the second request with the same options builds nothing."""
    import rapiddoc_tpu_torch.models.registry as registry

    send(servers["port"], REQUESTS["json"])
    built = []
    real = registry.build_analyzer
    monkeypatch.setattr(registry, "build_analyzer",
                        lambda *a, **k: built.append(k) or real(*a, **k))
    assert send(servers["port"], REQUESTS["json"])["status"] == 200
    assert built == []
    other = form(("file", "t.pdf", _pdf_with_text("x")), ("parse_method", '"txt"'),
                 ("formula_enable", "false"))  # other options: a stack of their own
    assert send(servers["port"], ("POST", "/file_parse", {"Content-Type": MULTIPART},
                                  other))["status"] == 200
    assert [k["formula_enable"] for k in built] == [False]


def test_read_multipart_parts():
    from rapiddoc_tpu_torch.serve.http import read_multipart

    body = form(("file", "a.pdf", b"%PDF-1.4\r\n--x"), ("files", "b.docx", b""),
                ("return_format", "zip"), ("table_enable", "false"),
                ("lang", "en"), ("ocr_config", '{"det_db_thresh": 0.3}'))
    files, options, zipped = read_multipart(MULTIPART, body)
    assert files == [("a.pdf", b"%PDF-1.4\r\n--x"), ("b.docx", b"")] and zipped
    assert options == {"table_enable": False, "lang": "en", "ocr_config": {"det_db_thresh": 0.3}}
    assert read_multipart("text/plain", body) == ([], {}, False)
    rng = np.random.default_rng(0)
    for _ in range(50):  # cut anywhere: never raises
        cut = int(rng.integers(0, len(body)))
        read_multipart(MULTIPART, body[:cut])
