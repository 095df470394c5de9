"""The port's downloader (``models/download.py``, urllib), ``tools/bringup.py``,
``utils/teds.py`` and ``tools/eval_quality.py`` against the JAX package's,
with no network: a local ``http.server`` on 127.0.0.1 serves seeded
published-layout checkpoints (``tests/torch_published.py``) and both
packages' registries are pointed at it. Both must give the same files,
the same errors (SHA256 pin, unreachable URL, a transfer cut short, each
leaving no ``.part`` file) and the same exit codes."""
import http.server
import json
import random
import shutil
import socket
import threading

import numpy as np
import pytest

import rapiddoc_tpu.models.download as jax_dl
import rapiddoc_tpu.tools.bringup as jax_bringup
import rapiddoc_tpu_torch.models.download as port_dl
import rapiddoc_tpu_torch.tools.bringup as port_bringup
from rapiddoc_tpu_torch.config import DEMO_ASSETS_DIR

import torch_published as P

PACKAGES = {"jax": (jax_dl, jax_bringup), "port": (port_dl, port_bringup)}
DICT_KEY, DET_KEY, REC_KEY = "ocr_dict_v6_small", "ocr_det_v6_small", "ocr_rec_v6_small"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(4)


class _Handler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        if self.path == "/broken":  # a transfer cut short
            self.send_response(200)
            self.send_header("Content-Length", "1000")
            self.end_headers()
            self.wfile.write(b"x" * 10)
            self.wfile.flush()
            self.close_connection = True
            return
        super().do_GET()


@pytest.fixture()
def server(tmp_path, monkeypatch):
    """Serve tmp_path/serve; each package gets its own models dir (the
    environment variable is set per call by ``in_models``)."""
    serve = tmp_path / "serve"
    serve.mkdir()
    monkeypatch.setenv("RAPIDDOC_PLATFORM", "cpu")
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), lambda *a, **k: _Handler(*a, directory=str(serve), **k))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def repoint(key: str, path: str, sha: str | None = None, url: str | None = None):
        for dl, _ in PACKAGES.values():
            old = dl.REGISTRY[key]
            monkeypatch.setitem(dl.REGISTRY, key, dl.ModelAsset(
                old.name, url or f"{base}/{path}", sha, old.converter))

    def in_models(name: str):
        models = tmp_path / name
        monkeypatch.setenv("RAPIDDOC_MODELS_DIR", str(models))
        return models

    yield serve, repoint, in_models
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:
        return (type(exc).__name__, str(exc).split(":")[0])


def _files(models) -> dict:
    out = {}
    for path in sorted(p for p in models.rglob("*") if p.is_file()):
        rel = str(path.relative_to(models))
        if path.suffix == ".npz":
            with np.load(path) as z:
                out[rel] = {k: z[k].tobytes() for k in z.files}
        else:
            out[rel] = path.read_bytes()
    return out


def _serve_ocr(serve, repoint):
    from safetensors.torch import save_file

    det, _ = P.det_checkpoint(21)
    save_file({k: v.contiguous() for k, v in det.items()}, str(serve / "det.safetensors"))
    # the published rec's width: the vendored dictionary's 18 708 entries
    rec, _ = P.rec_checkpoint(22, num_classes=18710)
    save_file({k: v.contiguous() for k, v in rec.items()}, str(serve / "rec.safetensors"))
    repoint(DET_KEY, "det.safetensors")
    repoint(REC_KEY, "rec.safetensors")


def test_registry_equals_jax():
    assert list(port_dl.REGISTRY) == list(jax_dl.REGISTRY)
    for key, asset in jax_dl.REGISTRY.items():
        mine = port_dl.REGISTRY[key]
        assert (mine.name, mine.url, mine.sha256, mine.converter) == \
            (asset.name, asset.url, asset.sha256, asset.converter), key


def test_download_convert_and_bringup_equal_jax(server):
    """det, rec and the dictionary fetched and converted by both packages
    into the same files. Bring-up of det alone fails the OCR family's
    load (rec missing: exit code 1); of det, rec and the dictionary, det
    fails its load again (rec is converted after it) and the dictionary
    fails in both packages (its ``dict`` converter copies the downloaded
    file onto itself: shutil.SameFileError, ROADMAP Queue 3): 2; of det
    and rec once both are converted, 0."""
    serve, repoint, in_models = server
    _serve_ocr(serve, repoint)
    # the dictionary the rec's 18 710 classes go with
    shutil.copy(DEMO_ASSETS_DIR / "ppocrv6_small_dict.txt", serve / "dict.txt")
    repoint(DICT_KEY, "dict.txt")
    results = {}
    for name, (dl, bringup) in PACKAGES.items():
        models = in_models(f"models_{name}")
        first = bringup.bringup([DET_KEY])
        second = bringup.bringup([DET_KEY, REC_KEY, DICT_KEY])
        third = bringup.bringup([DET_KEY, REC_KEY])
        paths = [dl.download_and_convert(k).relative_to(models) for k in (DET_KEY, REC_KEY)]
        results[name] = (first, second, third, paths, _files(models))
    assert results["port"][:4] == results["jax"][:4] == (1, 2, 0, results["jax"][3])
    jfiles, pfiles = results["jax"][4], results["port"][4]
    assert list(pfiles) == list(jfiles)
    assert pfiles == jfiles


def test_sha_pin_rejects_tampered_asset(server):
    serve, repoint, in_models = server
    (serve / "dict.txt").write_text("a\nb\nc\n")
    repoint(DICT_KEY, "dict.txt", sha="0" * 64)
    for name, (dl, _) in PACKAGES.items():
        models = in_models(f"models_{name}")
        with pytest.raises(RuntimeError, match="SHA256 mismatch"):
            dl.download_asset(DICT_KEY, force=True)
        assert not any(models.rglob("*.txt*"))
        # a file already in place that fails its pin
        (models / "ppocrv6_small_dict.txt").write_text("tampered")
        with pytest.raises(RuntimeError, match="fails SHA256 pin"):
            dl.download_asset(DICT_KEY)


@pytest.mark.parametrize("where", ["closed_port", "not_found", "broken"])
def test_failed_download_leaves_no_part_file(server, where):
    serve, repoint, in_models = server
    if where == "closed_port":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        repoint(DICT_KEY, "", url=f"http://127.0.0.1:{port}/dict.txt")
    else:
        repoint(DICT_KEY, "missing.txt" if where == "not_found" else "broken")
    outcomes = {}
    for name, (dl, _) in PACKAGES.items():
        models = in_models(f"models_{name}")
        outcomes[name] = _outcome(dl.download_asset, DICT_KEY, True)
        assert list(models.rglob("*")) == []
    assert outcomes["port"] == outcomes["jax"] == ("RuntimeError", f"cannot download {DICT_KEY}")


def test_download_main_counts_failures(server):
    serve, repoint, in_models = server
    (serve / "dict.txt").write_text("a\nb\n")
    repoint(DICT_KEY, "dict.txt")
    repoint(DET_KEY, "missing.safetensors")
    codes = {}
    for name, (dl, bringup) in PACKAGES.items():
        in_models(f"models_{name}")
        codes[name] = (dl.main(["nope", DICT_KEY, DET_KEY]), dl.main([DICT_KEY]),
                       bringup.main(["nope", DICT_KEY]))
    # the dictionary fails in both packages (its converter copies the file
    # onto itself), so each call counts it
    assert codes["port"] == codes["jax"] == (3, 1, 2)


# ---------------------------------------------------------------- metrics


def _random_table(rng: random.Random, words: list[str]) -> str:
    rows = []
    for _ in range(rng.randint(1, 5)):
        cells = []
        for _ in range(rng.randint(1, 4)):
            attrs = ""
            if rng.random() < 0.15:
                attrs += f' colspan="{rng.randint(2, 3)}"'
            if rng.random() < 0.1:
                attrs += f' rowspan="{rng.choice(["2", "x"])}"'
            tag = "th" if rng.random() < 0.1 else "td"
            text = " ".join(rng.choice(words) for _ in range(rng.randint(0, 3)))
            cells.append(f"<{tag}{attrs}>{text}</{tag}>")
        rows.append("<tr>" + "".join(cells) + "</tr>")
    body = "".join(rows)
    if rng.random() < 0.3:
        body = "<thead>" + rows[0] + "</thead><tbody>" + "".join(rows[1:]) + "</tbody>"
    return f"<table>{body}</table>"


def _mutate(rng: random.Random, html: str) -> str:
    chars = list(html)
    for _ in range(rng.randint(0, 6)):
        if not chars:
            break
        i = rng.randrange(len(chars))
        op = rng.random()
        if op < 0.4:
            chars[i] = rng.choice("abc1 <>/td")
        elif op < 0.7:
            del chars[i]
        else:
            chars.insert(i, rng.choice("xyz2"))
    return "".join(chars)


def test_teds_equals_jax():
    from rapiddoc_tpu.utils import teds as jax_teds
    from rapiddoc_tpu_torch.utils import teds

    rng = random.Random(0)
    words = ["cell", "1.5", "Total", "北京", "x^2", "", "a b"]
    for _ in range(150):
        gt = _random_table(rng, words)
        pred = _mutate(rng, gt) if rng.random() < 0.7 else _random_table(rng, words)
        for structure_only in (False, True):
            assert teds.teds(pred, gt, structure_only) == jax_teds.teds(pred, gt, structure_only)
    assert teds.teds("", "") == jax_teds.teds("", "") == 1.0
    for a, b in (("kitten", "sitting"), ("", "abc"), ("北京", "北方"), ("same", "same")):
        assert teds.levenshtein(a, b) == jax_teds._levenshtein(a, b)


def test_eval_quality_metrics_equal_jax():
    from rapiddoc_tpu.tools import eval_quality as jax_eval
    from rapiddoc_tpu_torch.tools import eval_quality

    rng = random.Random(1)
    words = ["alpha", "beta", "gamma", "delta", "表格", "$x$", "**b**", "#", "![i](a.png)"]
    for _ in range(40):
        paras = [" ".join(rng.choice(words) for _ in range(rng.randint(1, 8)))
                 for _ in range(rng.randint(1, 6))]
        tables = [_random_table(rng, words) for _ in range(rng.randint(0, 2))]
        markdown = "\n\n".join(paras + tables)
        pred_paras = paras[:]
        rng.shuffle(pred_paras)
        pred = "\n\n".join([_mutate(rng, p) for p in pred_paras]
                           + [_mutate(rng, t) for t in tables[: rng.randint(0, len(tables))]])
        gt = {"text": markdown, "tables": tables, "paragraphs": paras}
        assert eval_quality.evaluate_doc(pred, gt) == jax_eval.evaluate_doc(pred, gt)
        assert eval_quality.normalized_edit_distance(pred, markdown) == \
            jax_eval.normalized_edit_distance(pred, markdown)
        assert eval_quality.extract_tables(pred) == jax_eval.extract_tables(pred)
    assert json.dumps(eval_quality.evaluate_doc("", {"tables": ["<table></table>"]})) == \
        json.dumps(jax_eval.evaluate_doc("", {"tables": ["<table></table>"]}))
