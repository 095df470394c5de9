"""The port's Office path (``rapiddoc_tpu_torch/office/``) against the JAX
package's (``rapiddoc_tpu/office/``).

Every case of the JAX package's nine ``tests/test_office_*.py`` files runs
twice here, on the bytes it builds:

- as written, with every call into ``rapiddoc_tpu.office`` made on the
  port's module too, on the same arguments: the results (an
  ``OfficeResult``'s blocks, images, Markdown, content list and middle
  json, or whatever else the function returns) or the errors raised must
  be equal;
- with its names bound to the port's ``office`` modules instead, so its
  own assertions hold the port.

The modules are imported as modules, never their test functions by name
(pytest would collect those twice). Facade tests follow: suffix, zip
sniff, nameless bytes and Magika's guess; ``data_uri``; a mixed ``parse_batch``; the
zero-byte file; truncated and bit-flipped documents built from seeds;
and the legacy formats with and without a stand-in ``soffice``; and the
committed ``assets/office_smoke.{docx,pptx,xlsx}`` with a zero-byte docx
in both image modes, equal to ``assets/office_smoke_golden.json``, which
the smoke's ``office`` phase holds the card's run to.

``python tests/test_torch_office.py`` rebuilds those assets and the
golden with the JAX package (a few seconds).
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import io
import json
import os
import stat
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

import rapiddoc_tpu.office.analyze as jax_analyze
import rapiddoc_tpu_torch.office.analyze as port_analyze

OFFICE_TEST_FILES = (
    "test_office_adversarial", "test_office_chart", "test_office_docx_depth",
    "test_office_docx_round4", "test_office_images", "test_office_pptx_depth",
    "test_office_pptx_round4", "test_office_xlsx_rich", "test_office_xlsx_round4",
)
MODULES = ("common", "images", "omml", "docx", "pptx", "xlsx", "chart", "analyze")


def _test_module(name):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def _cases():
    out = []
    for mod_name in OFFICE_TEST_FILES:
        mod = _test_module(mod_name)
        for name, fn in sorted(vars(mod).items()):
            if not (name.startswith("test_") and inspect.isfunction(fn)):
                continue
            marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "skipif"]
            out.append(pytest.param(mod_name, name, marks=marks, id=f"{mod_name}.{name}"))
    return out


def normal(value):
    """A comparable form of what an Office function returns."""
    if dataclasses.is_dataclass(value) and hasattr(value, "to_markdown"):
        return {
            "blocks": [dataclasses.asdict(b) for b in value.blocks],
            "images": value.images,
            "n_pages": value.n_pages,
            "markdown": value.to_markdown(),
            "content_list": value.to_content_list(),
            "middle_json": value.to_middle_json(),
        }
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, (list, tuple)):
        return [normal(v) for v in value]
    if isinstance(value, dict):
        return {k: normal(v) for k, v in value.items()}
    if hasattr(value, "markdown") and hasattr(value, "middle_json"):
        return {"markdown": value.markdown, "images": value.images,
                "middle_json": value.middle_json, "content_list": value.content_list_json}
    return value


def _outcome(fn, args, kwargs):
    try:
        return "ok", normal(fn(*args, **kwargs))
    except Exception as exc:  # the error itself is the outcome
        return "raised", (type(exc).__name__, str(exc))


def _twin(jax_fn, port_fn, log):
    """``jax_fn`` that also runs ``port_fn`` on the same arguments and
    logs both outcomes."""
    fn_name = getattr(jax_fn, "__name__", repr(jax_fn))

    def call(*args, **kwargs):
        port = _outcome(port_fn, args, kwargs)
        try:
            result = jax_fn(*args, **kwargs)
        except Exception as exc:
            log.append((fn_name, ("raised", (type(exc).__name__, str(exc))), port))
            raise
        log.append((fn_name, ("ok", normal(result)), port))
        return result

    return call


def _entry_points():
    """The JAX package's office functions the Office test files call by
    name (internal helpers, which may mutate what they are handed, are
    left alone)."""
    import re

    here = os.path.dirname(__file__)
    words = set()
    for mod_name in OFFICE_TEST_FILES:
        with open(os.path.join(here, f"{mod_name}.py"), encoding="utf-8") as f:
            words |= set(re.findall(r"\w+", f.read()))
    out = []
    for name in MODULES:
        jmod = importlib.import_module(f"rapiddoc_tpu.office.{name}")
        for attr, obj in vars(jmod).items():
            fn = getattr(obj, "__wrapped__", obj)  # through lru_cache
            if (attr in words and inspect.isfunction(fn) and fn.__module__ == jmod.__name__
                    and not inspect.isgeneratorfunction(fn)):
                out.append((name, attr))
    return out


def _port_twins(monkeypatch, log):
    """Each entry point made a twin: its module attribute and its name in
    each Office test module."""
    for name, attr in _entry_points():
        jmod = importlib.import_module(f"rapiddoc_tpu.office.{name}")
        pmod = importlib.import_module(f"rapiddoc_tpu_torch.office.{name}")
        fn = getattr(jmod, attr)
        twin = _twin(fn, getattr(pmod, attr), log)
        monkeypatch.setattr(jmod, attr, twin)
        for mod_name in OFFICE_TEST_FILES:
            tmod = _test_module(mod_name)
            if vars(tmod).get(attr) is fn:
                monkeypatch.setattr(tmod, attr, twin)


def _on_port(fn, monkeypatch):
    """``fn`` with every name it reads from ``rapiddoc_tpu.office`` bound
    to the port's module: its globals and the modules a local import
    finds."""
    for name in MODULES:
        monkeypatch.setitem(sys.modules, f"rapiddoc_tpu.office.{name}",
                            importlib.import_module(f"rapiddoc_tpu_torch.office.{name}"))
    glb = dict(fn.__globals__)
    for key, value in fn.__globals__.items():
        mod = getattr(value, "__module__", None) or ""
        if isinstance(value, type(sys)) and value.__name__.startswith("rapiddoc_tpu.office."):
            glb[key] = importlib.import_module(value.__name__.replace("rapiddoc_tpu.", "rapiddoc_tpu_torch.", 1))
        elif mod.startswith("rapiddoc_tpu.office.") and hasattr(value, "__name__"):
            port_mod = importlib.import_module(mod.replace("rapiddoc_tpu.", "rapiddoc_tpu_torch.", 1))
            glb[key] = getattr(port_mod, value.__name__)
    return type(fn)(fn.__code__, glb, fn.__name__, fn.__defaults__, fn.__closure__)


def _call(fn, monkeypatch):
    params = inspect.signature(fn).parameters
    return fn(**({"monkeypatch": monkeypatch} if "monkeypatch" in params else {}))


@pytest.mark.parametrize("mod_name,name", _cases())
def test_office_case_matches_jax(mod_name, name, monkeypatch):
    fn = getattr(_test_module(mod_name), name)
    log: list = []
    with monkeypatch.context() as m:
        _port_twins(m, log)
        _call(fn, m)
    assert log, "the case made no call into the office modules"
    for fn_name, jax_out, port_out in log:
        assert port_out == jax_out, fn_name
    with monkeypatch.context() as m:
        _call(_on_port(fn, m), m)


# ------------------------------------------------------------- fixtures


def _zip(parts: dict[str, str | bytes]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name, body in parts.items():
            # a fixed date: the same seed gives the same bytes
            z.writestr(zipfile.ZipInfo(name, (1980, 1, 1, 0, 0, 0)), body,
                       compress_type=zipfile.ZIP_DEFLATED)
    return buf.getvalue()


_W = 'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main"'
_CT = ('<?xml version="1.0"?><Types xmlns="http://schemas.openxmlformats.org/'
       'package/2006/content-types"><Default Extension="png" ContentType="image/png"/></Types>')


def seeded_docx(seed: int) -> bytes:
    """A docx with a title, seeded paragraphs, a table and an image."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta", "kappa"]

    def para(style=None):
        text = " ".join(rng.choice(words, rng.integers(3, 9)))
        ppr = f'<w:pPr><w:pStyle w:val="{style}"/></w:pPr>' if style else ""
        return f"<w:p>{ppr}<w:r><w:t>{text}</w:t></w:r></w:p>"

    cells = "".join(
        "<w:tr>" + "".join(f"<w:tc><w:p><w:r><w:t>{int(v)}</w:t></w:r></w:p></w:tc>"
                           for v in rng.integers(0, 1000, 3)) + "</w:tr>" for _ in range(3))
    pic = ('<w:p><w:r><w:drawing><wp:inline xmlns:wp="http://schemas.openxmlformats.org/'
           'drawingml/2006/wordprocessingDrawing"><a:graphic xmlns:a="http://schemas.'
           'openxmlformats.org/drawingml/2006/main"><a:graphicData><pic:pic xmlns:pic="http:'
           '//schemas.openxmlformats.org/drawingml/2006/picture"><pic:blipFill><a:blip '
           'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships" '
           'r:embed="rId9"/></pic:blipFill></pic:pic></a:graphicData></a:graphic></wp:inline>'
           '</w:drawing></w:r></w:p>')
    body = (para("Heading1") + "".join(para() for _ in range(4)) + f"<w:tbl>{cells}</w:tbl>"
            + pic + para())
    rels = ('<?xml version="1.0"?><Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships"><Relationship Id="rId9" Type="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships/image" '
            'Target="media/image1.png"/></Relationships>')
    png = b"\x89PNG\r\n\x1a\n" + rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    return _zip({
        "[Content_Types].xml": _CT,
        "word/document.xml": f'<?xml version="1.0"?><w:document {_W}><w:body>{body}</w:body></w:document>',
        "word/_rels/document.xml.rels": rels,
        "word/media/image1.png": png,
    })


def seeded_pptx(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    ns = ('xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main" '
          'xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main"')
    shapes = ""
    for i in range(4):
        x, y = (int(v) for v in rng.integers(0, 8_000_000, 2))
        text = " ".join(f"w{int(v)}" for v in rng.integers(0, 99, 4))
        shapes += (f'<p:sp><p:nvSpPr><p:cNvPr id="{i + 2}" name="s{i}"/></p:nvSpPr><p:spPr>'
                   f'<a:xfrm><a:off x="{x}" y="{y}"/><a:ext cx="2000000" cy="500000"/></a:xfrm>'
                   f'</p:spPr><p:txBody><a:p><a:r><a:t>{text}</a:t></a:r></a:p></p:txBody></p:sp>')
    slide = f'<?xml version="1.0"?><p:sld {ns}><p:cSld><p:spTree>{shapes}</p:spTree></p:cSld></p:sld>'
    return _zip({"[Content_Types].xml": _CT, "ppt/slides/slide1.xml": slide,
                 "ppt/presentation.xml": f'<p:presentation {ns}/>'})


def seeded_xlsx(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    rows = "".join(
        f'<row r="{r}">' + "".join(f'<c r="{c}{r}"><v>{int(v)}</v></c>'
                                   for c, v in zip("ABC", rng.integers(0, 500, 3))) + "</row>"
        for r in range(1, 5))
    wb = (f'<?xml version="1.0"?><workbook {ns} xmlns:r="http://schemas.openxmlformats.org/'
          'officeDocument/2006/relationships"><sheets><sheet name="S" sheetId="1" r:id="rId1"/>'
          '</sheets></workbook>')
    rels = ('<?xml version="1.0"?><Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships"><Relationship Id="rId1" Type="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships/worksheet" '
            'Target="worksheets/sheet1.xml"/></Relationships>')
    return _zip({"[Content_Types].xml": _CT, "xl/workbook.xml": wb,
                 "xl/_rels/workbook.xml.rels": rels,
                 "xl/worksheets/sheet1.xml": f'<?xml version="1.0"?><worksheet {ns}><sheetData>'
                                              f'{rows}</sheetData></worksheet>'})


SEEDED = {"docx": seeded_docx, "pptx": seeded_pptx, "xlsx": seeded_xlsx}


def _same(a, b):
    assert a.markdown == b.markdown
    assert a.images == b.images
    assert json.dumps(a.middle_json, sort_keys=True, default=str) == json.dumps(
        b.middle_json, sort_keys=True, default=str)
    assert json.dumps(a.content_list_json, sort_keys=True, default=str) == json.dumps(
        b.content_list_json, sort_keys=True, default=str)


@pytest.fixture(scope="module")
def facades():
    from rapiddoc_tpu import RapidDoc as JaxRapidDoc
    from rapiddoc_tpu_torch import RapidDoc

    return JaxRapidDoc, RapidDoc


class _Named(bytes):
    name = ""


def _named(data: bytes, name: str) -> bytes:
    out = _Named(data)
    out.name = name
    return out


def _past_the_sniff(data: bytes) -> bytes:
    """The same document with a 6000-byte first member, so its part
    names lie past the 4096 bytes ``_sniff_office`` reads and only
    Magika can tell what it is."""
    src = zipfile.ZipFile(io.BytesIO(data))
    pad = np.random.default_rng(0).integers(0, 256, 6000, dtype=np.uint8).tobytes()
    return _zip({"docProps/pad.bin": pad, **{n: src.read(n) for n in src.namelist()}})


@pytest.mark.parametrize("mode", ["url", "data_uri"])
@pytest.mark.parametrize("kind", ["docx", "pptx", "xlsx"])
@pytest.mark.parametrize("how", ["suffix", "sniff", "nameless", "magika"])
def test_facade_routes_office_as_jax(facades, kind, how, mode, tmp_path):
    jax_doc, port_doc = facades
    data = SEEDED[kind](7)
    if how == "magika":
        item = _past_the_sniff(data)
        from rapiddoc_tpu_torch.api import _sniff_office

        assert not _sniff_office(item)
    elif how == "suffix":
        item = tmp_path / f"doc.{kind}"
        item.write_bytes(data)
    elif how == "sniff":
        item = tmp_path / "doc.bin"
        item.write_bytes(data)
    else:
        item = data
    want = jax_doc(image_output_mode=mode)(item)
    got = port_doc(device="cpu", image_output_mode=mode)(item)
    _same(got, want)
    assert got.markdown  # the seeded documents all have text


def test_zero_byte_office_file(facades, tmp_path):
    jax_doc, port_doc = facades
    path = tmp_path / "empty.docx"
    path.write_bytes(b"")
    _same(port_doc(device="cpu")(path), jax_doc()(path))
    assert port_doc(device="cpu")(path).markdown == ""


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_corrupt_docx_raises_jax_valueerror(seed, damage):
    rng = np.random.default_rng(seed)
    data = bytearray(seeded_docx(seed))
    if damage == "truncate":
        data = data[: int(rng.integers(len(data) // 4, 3 * len(data) // 4))]
    else:
        # flip bits inside the compressed document part, past the local
        # header, so the zip opens and the member fails to inflate
        start = bytes(data).index(b"word/document.xml") + len("word/document.xml")
        for pos in rng.integers(start + 4, start + 60, 6):
            data[int(pos)] ^= 1 << int(rng.integers(0, 8))
    outcomes = []
    for analyze in (jax_analyze, port_analyze):
        with pytest.raises(ValueError) as err:
            analyze.office_parse(bytes(data), "broken.docx")
        outcomes.append(str(err.value))
    assert outcomes[0] == outcomes[1]


def test_mixed_parse_batch_equals_single_parses(facades):
    """[PDF, docx, PNG] in one parse_batch: the Office slot through its
    path, the others batched, each equal to its single parse."""
    from rapiddoc_tpu_torch.pdfio.png import encode_png
    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf

    _, port_doc = facades
    rng = np.random.default_rng(3)
    page = np.full((96, 128, 3), 255, np.uint8)
    page[20:40, 10:110] = rng.integers(0, 80, (20, 100, 3), dtype=np.uint8)
    items = [images_to_pdf([page], dpi=72), _named(seeded_docx(3), "b.docx"), encode_png(page)]
    doc = port_doc(device="cpu", parse_method="ocr")
    batch = doc.parse_batch(items)
    assert len(batch) == 3
    for item, got in zip(items, batch):
        _same(got, doc(item))
    assert batch[1].model_json is None


def _fake_soffice(tmp_path, converted: bytes) -> str:
    """A stand-in ``soffice`` that logs its arguments and writes
    ``converted`` as ``input.<target>`` into ``--outdir``."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    payload = tmp_path / "converted.bin"
    payload.write_bytes(converted)
    log = tmp_path / "args.log"
    script = bindir / "soffice"
    script.write_text(
        "#!/bin/sh\n"
        f'printf "%s\\n" "$@" >> "{log}"\n'
        'target=""; out=""\n'
        'while [ $# -gt 0 ]; do case "$1" in\n'
        '  --convert-to) target="$2"; shift 2;;\n'
        '  --outdir) out="$2"; shift 2;;\n'
        '  *) shift;; esac; done\n'
        f'cp "{payload}" "$out/input.$target"\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(bindir)


@pytest.mark.parametrize("suffix,kind", [(".doc", "docx"), (".ppt", "pptx"), (".xls", "xlsx")])
def test_legacy_office_through_soffice(facades, tmp_path, monkeypatch, suffix, kind):
    jax_doc, port_doc = facades
    legacy = tmp_path / f"old{suffix}"
    legacy.write_bytes(b"\xd0\xcf\x11\xe0legacy")
    path = os.environ.get("PATH", "")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    errors = []
    for facade in (jax_doc(), port_doc(device="cpu")):
        with pytest.raises(RuntimeError) as err:
            facade(legacy)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    monkeypatch.setenv("PATH", _fake_soffice(tmp_path, SEEDED[kind](11)) + os.pathsep + path)
    want = jax_doc()(legacy)
    jax_args = (tmp_path / "args.log").read_text()
    (tmp_path / "args.log").unlink()
    got = port_doc(device="cpu")(legacy)
    port_args = (tmp_path / "args.log").read_text()
    _same(got, want)
    # the same argument list, but for each package's own temporary dir
    def strip(text):
        return [a if not a.startswith("/") else
                os.path.basename(a) if os.path.splitext(a)[1] else "<dir>"
                for a in text.split()]

    assert strip(port_args) == strip(jax_args)
    assert strip(port_args)[:4] == ["--headless", "--convert-to", kind, "--outdir"]


# ------------------------------------------------------- the smoke's assets

ASSETS = Path(__file__).resolve().parent.parent / "rapiddoc_tpu_torch" / "assets"
SMOKE_FILES = {kind: f"office_smoke.{kind}" for kind in SEEDED}
SMOKE_SEED = 5


def office_summary(out) -> dict:
    """What the smoke compares: Markdown, content list and middle json
    through JSON, and each payload's size."""
    return json.loads(json.dumps({
        "markdown": out.markdown, "content_list": out.content_list_json,
        "middle_json": out.middle_json,
        "images": {k: len(v) for k, v in sorted(out.images.items())},
    }, default=str))


def office_parses(rapid_cls, **kw) -> dict:
    """The committed documents and a zero-byte docx, in both image modes."""
    import tempfile

    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        empty = Path(tmp) / "empty.docx"
        empty.write_bytes(b"")
        paths = {kind: ASSETS / name for kind, name in SMOKE_FILES.items()}
        paths["empty_docx"] = empty
        for mode in ("url", "data_uri"):
            rapid = rapid_cls(image_output_mode=mode, **kw)
            for kind, path in paths.items():
                got[f"{kind}_{mode}"] = office_summary(rapid(path))
    return got


def test_office_smoke_assets_equal_golden():
    from rapiddoc_tpu_torch import RapidDoc

    golden = json.loads((ASSETS / "office_smoke_golden.json").read_text())
    for kind, name in SMOKE_FILES.items():
        assert (ASSETS / name).read_bytes() == SEEDED[kind](SMOKE_SEED), name
    assert office_parses(RapidDoc, device="cpu") == golden


if __name__ == "__main__":
    from rapiddoc_tpu import RapidDoc as JaxRapidDoc

    for kind, name in SMOKE_FILES.items():
        (ASSETS / name).write_bytes(SEEDED[kind](SMOKE_SEED))
    golden = office_parses(JaxRapidDoc)
    (ASSETS / "office_smoke_golden.json").write_text(
        json.dumps(golden, indent=1, sort_keys=True) + "\n")
    print({k: len(v["markdown"]) for k, v in golden.items()})
