"""Custom models in the port (``rapiddoc_tpu_torch/models/{custom,vl}.py``)
against the JAX package's.

- ``tests/test_vl.py``'s cases and ``test_registry_roundtrip.py``'s
  custom-model contract re-run with ``rapiddoc_tpu.models.{custom,vl}``
  bound to the port's modules.
- The VL client's requests: the same JSON bodies as the JAX package's,
  whose crops ``cv2.imencode`` writes at quality 92 (the port's
  ``pdfio/jpeg_encode``, equal bytes).
- ``RapidDoc`` with a custom layout, formula, table and OCR model in each
  stage's config: the same output as the JAX package's, including the JAX
  package's fallbacks for a custom model (rec retried crop by crop, a
  table model called without the formula and image items).
"""
from __future__ import annotations

import base64
import importlib
import json
import os
import sys
import threading
from collections import namedtuple
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from test_vl import vl_server  # noqa: F401 - the fixture test_vl.py's cases take

CASES = [("test_vl", "test_vl_models"), ("test_vl", "test_vl_shorthand_requires_env"),
         ("test_vl", "test_vl_shorthand_builds"),
         ("test_registry_roundtrip", "test_custom_model_contract")]


def _test_module(name):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True)
def _no_proxy(monkeypatch):
    for var in ("http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")


@pytest.mark.parametrize("mod_name,name", CASES)
def test_custom_case_on_the_port(mod_name, name, monkeypatch, request):
    """The JAX test as written; its local imports of
    ``rapiddoc_tpu.models.custom`` and ``.vl`` find the port's modules."""
    for mod in ("custom", "vl"):
        monkeypatch.setitem(sys.modules, f"rapiddoc_tpu.models.{mod}",
                            importlib.import_module(f"rapiddoc_tpu_torch.models.{mod}"))
    fn = getattr(_test_module(mod_name), name)
    kw = {"monkeypatch": monkeypatch, "vl_server": None}
    import inspect

    args = {}
    for p in inspect.signature(fn).parameters:
        args[p] = request.getfixturevalue("vl_server") if p == "vl_server" else kw[p]
    fn(**args)


# ------------------------------------------------------------ VL wire


@pytest.fixture(scope="module")
def recording_server():
    """An OpenAI-style endpoint that records every request body."""
    bodies = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 - the base class's name
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            bodies.append(body)
            prompt = body["messages"][0]["content"][1]["text"]
            text = {"OCR:": "text", "Formula Recognition:": "$$y$$"}.get(
                prompt, "<table><tr><td>1</td></tr></table>")
            data = json.dumps({"choices": [{"message": {"content": text}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}/v1", bodies
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("seed", range(3))
def test_vl_requests_equal_jax(recording_server, seed):
    import cv2

    import rapiddoc_tpu.models.vl as jax_vl
    import rapiddoc_tpu_torch.models.vl as port_vl

    url, bodies = recording_server
    rng = np.random.default_rng(seed)
    crops = [rng.integers(0, 256, (int(rng.integers(1, 90)), int(rng.integers(1, 130)), 3),
                          dtype=np.uint8) for _ in range(3)]
    crops.append(np.full((31, 47, 3), 200, np.uint8))
    outs = {}
    for name, vl in (("jax", jax_vl), ("port", port_vl)):
        bodies.clear()
        client = vl.VLClient(api_base=url, api_key="k", model="m", max_concurrency=1)
        outs[name] = (vl.PaddleOCRVLOCRModel(client).batch_predict(crops),
                      vl.PaddleOCRVLFormulaModel(client).batch_predict(crops),
                      vl.PaddleOCRVLTableModel(client).batch_predict(crops),
                      list(bodies))
    assert outs["port"] == outs["jax"]
    for body, crop in zip(outs["port"][3], crops):
        jpeg = base64.b64decode(body["messages"][0]["content"][0]["image_url"]["url"].split(",")[1])
        ok, want = cv2.imencode(".jpg", cv2.cvtColor(crop, cv2.COLOR_RGB2BGR),
                                [cv2.IMWRITE_JPEG_QUALITY, 92])
        assert ok and jpeg == want.tobytes()


# ------------------------------------------------- custom models in RapidDoc


RecResult = namedtuple("RecResult", "text score")
DetResult = namedtuple("DetResult", "boxes scores")


class Layout:
    def batch_predict(self, images):
        out = []
        for img in images:
            h, w = img.shape[:2]
            out.append([
                {"category_id": 1, "poly": [20, 20, w - 20, 20, w - 20, 60, 20, 60], "score": 0.9},
                {"category_id": 14, "poly": [40, 80, 200, 80, 200, 120, 40, 120], "score": 0.8},
                {"category_id": 5, "poly": [20, 130, w - 20, 130, w - 20, h - 20, 20, h - 20],
                 "score": 0.7},
            ])
        return out


class Formula:
    def batch_predict(self, images):
        return [f"x_{{{i}}}^{{{img.shape[0]}}}" for i, img in enumerate(images)]


class Table:
    """Takes the regions alone: the port, as the JAX package, calls it
    again without the formula and image items."""

    def batch_predict(self, images):
        return [f"<table><tr><td>{img.shape[1]}</td></tr></table>" for img in images]


class Ocr:
    """A TextSystem-shaped custom OCR whose rec fails on a batch and on
    every third crop: rec is retried crop by crop, a failed crop is an
    empty low-score text."""

    drop_score = 0.5

    def __init__(self):
        self.calls = 0

    def batch_predict(self, images):  # the contract resolve_custom checks
        return [[] for _ in images]

    def detector(self, images):
        out = []
        for img in images:
            h, w = img.shape[:2]
            boxes = [np.array([[x, y], [x + 60, y], [x + 60, y + 20], [x, y + 20]], np.float32)
                     for x, y in ((10, 20), (100, 25), (30, 140), (150, 150))
                     if x + 60 < w and y + 20 < h]
            out.append(DetResult(boxes, [0.9] * len(boxes)))
        return out

    def recognizer(self, crops):
        if len(crops) > 1:
            raise RuntimeError("batch too large")
        self.calls += 1
        if self.calls % 3 == 0:
            raise RuntimeError("bad crop")
        return [RecResult(f"word{self.calls}", 0.4 + 0.1 * (self.calls % 4))]


def _configs():
    return dict(layout_config={"custom_model": Layout()},
                formula_config={"custom_model": Formula()},
                table_config={"custom_model": Table()},
                ocr_config={"custom_model": Ocr()})


def test_rapiddoc_with_custom_models_equals_jax(monkeypatch):
    from rapiddoc_tpu import RapidDoc as JaxRapidDoc
    from rapiddoc_tpu_torch import RapidDoc

    for k in ("OCR", "LAYOUT", "FORMULA", "TABLE"):
        monkeypatch.delenv(f"RAPIDDOC_DISABLE_{k}", raising=False)
    from test_torch_serve import _image_pdf

    pdf = _image_pdf(["custom models", "second page"])
    want = JaxRapidDoc(parse_method="ocr", **_configs())(pdf)
    got = RapidDoc(parse_method="ocr", device="cpu", **_configs())(pdf)
    assert (got.markdown, got.middle_json, got.content_list_json, got.model_json) == (
        want.markdown, want.middle_json, want.content_list_json, want.model_json)
    assert "<table>" in got.markdown and "word1" in got.markdown
    assert any(d.get("latex", "").startswith("x_") for p in got.model_json for d in p["layout_dets"])


def test_custom_stage_takes_the_place_of_the_port_model(monkeypatch):
    """A stage with a custom model builds no model of the port's own."""
    import rapiddoc_tpu_torch.models.registry as registry

    for name in ("build_ocr_system", "build_layout_model", "build_formula_model",
                 "build_table_model"):
        monkeypatch.setattr(registry, name, lambda *a, **k: pytest.fail("built"))
    monkeypatch.setattr(registry, "build_orientation_model", lambda **k: None)
    cfg = {k.removesuffix("_config"): v for k, v in _configs().items()}
    analyzer = registry.build_analyzer(configs=cfg, device="cpu")
    assert isinstance(analyzer.layout_model, Layout) and isinstance(analyzer.ocr, Ocr)
    assert isinstance(analyzer.formula_model, Formula) and isinstance(analyzer.table_model, Table)
