"""The port's data layer (``rapiddoc_tpu_torch/data/io.py``) and URL
inputs against the JAX package's.

- Every case of ``tests/test_data_io.py`` re-run with its names bound to
  the port's classes, so its own assertions hold the port.
- ``S3DataReader`` / ``S3DataWriter`` with a stand-in ``boto3`` module:
  the client is made and called as the JAX package makes and calls it;
  without ``boto3`` both raise the same ``RuntimeError``.
- ``HttpReader`` (``urllib`` with a ``Range`` header) against the JAX
  package's (``requests``, whole body sliced) on a local ``http.server``,
  with and without range support on the server's side; a 404 raises with
  ``requests``' message.
- ``RapidDoc`` on an ``http://`` URL: the same output as the JAX
  package's, named by the URL's last part, and the same error for a
  missing document.

Every server here listens on 127.0.0.1 only.
"""
from __future__ import annotations

import importlib
import os
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import rapiddoc_tpu.data.io as jax_io
import rapiddoc_tpu_torch.data as port_data
import rapiddoc_tpu_torch.data.io as port_io

DATA_IO_CASES = ("test_parse_s3path", "test_parse_s3_range",
                 "test_relative_path_uses_default_bucket_and_prefix",
                 "test_absolute_path_routes_by_bucket", "test_range_read_via_query_suffix",
                 "test_writer_routes_and_prefixes", "test_config_validation")


def _test_module(name):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def test_the_case_list_is_every_data_io_case():
    names = {n for n in vars(_test_module("test_data_io")) if n.startswith("test_")}
    assert names == set(DATA_IO_CASES)


def _on_port(fn):
    """``fn`` with every name it reads from ``rapiddoc_tpu.data`` bound to
    the port's object of that name."""
    glb = dict(fn.__globals__)
    for key, value in fn.__globals__.items():
        if (getattr(value, "__module__", "") or "").startswith("rapiddoc_tpu.data"):
            glb[key] = getattr(port_data, value.__name__)
    return type(fn)(fn.__code__, glb, fn.__name__, fn.__defaults__, fn.__closure__)


@pytest.mark.parametrize("name", DATA_IO_CASES)
def test_data_io_case_on_the_port(name, monkeypatch):
    """The case as written, on the port's classes, behind the module's own
    stand-in clients (its autouse fixture, applied to the port)."""
    tmod = _test_module("test_data_io")
    tmod._StubClient.calls = []
    monkeypatch.setattr(port_io.MultiBucketS3DataReader, "_cls", tmod._StubClient)
    monkeypatch.setattr(port_io.MultiBucketS3DataWriter, "_cls", tmod._StubClient)
    _on_port(getattr(tmod, name))()


# ------------------------------------------------------------------ S3


class _FakeS3:
    """What ``boto3.client("s3", ...)`` returns, recording every call."""

    def __init__(self, log, **kwargs):
        self.log = log
        log.append(("client", kwargs["aws_access_key_id"], kwargs["aws_secret_access_key"],
                    kwargs["endpoint_url"], kwargs["config"].kw))

    def get_object(self, **kw):
        self.log.append(("get", kw))
        body = types.SimpleNamespace(read=lambda: f"{kw['Bucket']}/{kw['Key']}".encode())
        return {"Body": body}

    def put_object(self, **kw):
        self.log.append(("put", kw))


def _fake_boto3(monkeypatch, log):
    boto3 = types.ModuleType("boto3")
    boto3.client = lambda service, **kw: _FakeS3(log, **kw)
    botocore = types.ModuleType("botocore")
    config = types.ModuleType("botocore.config")
    config.Config = lambda **kw: types.SimpleNamespace(kw=kw)
    botocore.config = config
    for name, mod in (("boto3", boto3), ("botocore", botocore), ("botocore.config", config)):
        monkeypatch.setitem(sys.modules, name, mod)


def _s3_session(io_mod):
    r = io_mod.S3DataReader("bkt", "ak", "sk", "http://s3.local", parent_dir="in",
                            addressing_style="path")
    w = io_mod.S3DataWriter("out", "ak2", "sk2", "http://s3.local")
    got = [r.read("a.pdf"), r.read_at("b.pdf", 10), r.read_at("c.pdf", 5, 20),
           r.read_at("d.pdf", 0, 7)]
    w.write("x/y.md", b"# hi")
    multi = io_mod.MultiBucketS3DataReader("bkt/pre", [
        io_mod.S3Config("bkt", "k1", "s1", "http://e1"),
        io_mod.S3Config("other", "k2", "s2", "http://e2", "virtual")])
    got += [multi.read("doc.pdf"), multi.read("s3://other/k?3,4")]
    return got


def test_s3_clients_made_and_called_as_jax(monkeypatch):
    jax_log, port_log = [], []
    _fake_boto3(monkeypatch, jax_log)
    jax_out = _s3_session(jax_io)
    _fake_boto3(monkeypatch, port_log)
    assert _s3_session(port_io) == jax_out
    assert port_log == jax_log
    assert ("get", {"Bucket": "bkt", "Key": "in/c.pdf", "Range": "bytes=5-24"}) in port_log


def test_s3_without_boto3_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    for io_mod in (jax_io, port_io):
        with pytest.raises(RuntimeError, match="^boto3 is not available in this environment$"):
            io_mod.S3DataReader("b", "ak", "sk", "http://e")
        with pytest.raises(RuntimeError, match="^boto3 is not available in this environment$"):
            io_mod.MultiBucketS3DataWriter("b", [io_mod.S3Config("b", "a", "s", "e")]).write("k", b"")


# ---------------------------------------------------------------- HTTP


def native_text_pdf(text: str) -> bytes:
    """A one-page PDF with ``text`` in Helvetica (test_longtail.py's)."""
    content = b"BT /F1 18 Tf 20 100 Td (" + text.encode() + b") Tj ET"
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        3: (b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 320 200] "
            b"/Resources << /Font << /F1 5 0 R >> >> /Contents 4 0 R >>"),
        4: (b"<< /Length %d >>\nstream\n" % len(content)) + content + b"\nendstream",
        5: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
    }
    out = bytearray(b"%PDF-1.7\n")
    offs = {}
    for num in sorted(objs):
        offs[num] = len(out)
        out += b"%d 0 obj\n" % num + objs[num] + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (max(objs) + 1)
    for num in range(1, max(objs) + 1):
        out += b"%010d 00000 n \n" % offs[num]
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF"
            % (max(objs) + 1, xref))
    return bytes(out)


BLOB = bytes(range(256)) * 5
FILES = {"/blob.bin": BLOB, "/docs/annual%20report.pdf": native_text_pdf("served over http")}


class _Handler(BaseHTTPRequestHandler):
    """Serves ``FILES``; honours a ``Range`` header under ``/ranged``."""

    def log_message(self, *args):
        pass

    def do_GET(self):  # noqa: N802 - the base class's name
        ranged = self.path.startswith("/ranged/")
        data = FILES.get(self.path[len("/ranged"):] if ranged else self.path)
        if data is None:
            self.send_error(404, "Not Found")
            return
        status, rng = 200, self.headers.get("Range")
        if ranged and rng:
            a, b = rng.removeprefix("bytes=").split("-")
            data = data[int(a):int(b) + 1 if b else None]
            status = 206
        self.send_response(status)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(autouse=True)
def _no_proxy(monkeypatch):
    """Requests to 127.0.0.1 never go through a proxy."""
    for var in ("http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")


@pytest.mark.parametrize("where", ["/blob.bin", "/ranged/blob.bin"])
@pytest.mark.parametrize("offset,limit", [(0, -1), (0, 10), (100, 1), (1000, -1), (37, 300),
                                          (1270, 100)])
def test_http_reader_equals_jax(server, where, offset, limit):
    url = server + where
    got = port_io.HttpReader().read_at(url, offset, limit)
    assert got == jax_io.HttpReader().read_at(url, offset, limit)
    assert got == BLOB[offset:None if limit == -1 else offset + limit]
    if (offset, limit) == (0, -1):
        assert port_io.HttpReader().read(url) == BLOB


def test_http_reader_404_message_equals_requests(server):
    import requests

    url = server + "/missing.pdf"
    with pytest.raises(requests.HTTPError) as jax_err:
        jax_io.HttpReader().read(url)
    with pytest.raises(port_io.HttpStatusError) as port_err:
        port_io.HttpReader().read(url)
    assert str(port_err.value) == str(jax_err.value) == f"404 Client Error: Not Found for url: {url}"
    assert isinstance(port_err.value, OSError)


@pytest.fixture(scope="module")
def facades():
    from rapiddoc_tpu import RapidDoc as JaxRapidDoc
    from rapiddoc_tpu_torch import RapidDoc

    return JaxRapidDoc(parse_method="txt"), RapidDoc(parse_method="txt", device="cpu")


def test_rapiddoc_url_input_equals_jax(server, facades):
    jax_rd, port_rd = facades
    url = server + "/docs/annual%20report.pdf"
    assert port_rd._normalize_input(url)[:2] == jax_rd._normalize_input(url)[:2]
    assert port_rd._normalize_input(url)[1] == "annual report"
    got, want = port_rd(url), jax_rd(url)
    assert "served over http" in got.markdown
    assert (got.markdown, got.content_list_json, got.middle_json) == (
        want.markdown, want.content_list_json, want.middle_json)


def test_rapiddoc_url_input_404_as_jax(server, facades):
    import requests

    jax_rd, port_rd = facades
    url = server + "/nothing/here.pdf"
    with pytest.raises(requests.HTTPError) as jax_err:
        jax_rd(url)
    with pytest.raises(port_io.HttpStatusError) as port_err:
        port_rd(url)
    assert str(port_err.value) == str(jax_err.value)
