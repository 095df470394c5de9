"""The port imports torch, numpy, scipy and the standard library only:
no jax, flax, cv2, PIL, fontTools, and nothing of the JAX package. The card's
machine is not guaranteed any of those, so this is the CPU-side guard. The
child process imports every module of the port with those blocked and runs
the main path, Magika, the CCITT, JBIG2 and shading code, an Office
document (a docx) and an image file (a GIF)."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "rapiddoc_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "cv2", "PIL", "fontTools", "rapiddoc_tpu")


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _banned_imports(path: Path) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in BANNED]
    return found


def test_no_banned_import_in_the_port_source():
    files = _port_files()
    assert len(files) > 10
    offenders = {str(p.relative_to(REPO)): _banned_imports(p) for p in files}
    assert {k: v for k, v in offenders.items() if v} == {}


# the modules of the main path's slice, which the list below must hold
MAIN_PATH_MODULES = (
    "rapiddoc_tpu_torch.api", "rapiddoc_tpu_torch.bench",
    "rapiddoc_tpu_torch.pdfio.jpeg", "rapiddoc_tpu_torch.pdfio.images",
    "rapiddoc_tpu_torch.pdfio.render", "rapiddoc_tpu_torch.pdfio.document",
    "rapiddoc_tpu_torch.pdfio.classify", "rapiddoc_tpu_torch.pipeline.scheduler",
    "rapiddoc_tpu_torch.pipeline.middle", "rapiddoc_tpu_torch.pipeline.page_build",
    "rapiddoc_tpu_torch.pipeline.mkcontent", "rapiddoc_tpu_torch.reading_order.xycut",
    "rapiddoc_tpu_torch.reading_order.xycut_v3", "rapiddoc_tpu_torch.data.io",
    "rapiddoc_tpu_torch.models.table.engine", "rapiddoc_tpu_torch.models.table.unet",
    "rapiddoc_tpu_torch.models.table.slanet", "rapiddoc_tpu_torch.models.table.unitable",
    "rapiddoc_tpu_torch.models.table.cls", "rapiddoc_tpu_torch.utils.morph",
    # the ONNX interpreter and its users
    "rapiddoc_tpu_torch.engine.onnx_torch", "rapiddoc_tpu_torch.tools.onnx_reader",
    "rapiddoc_tpu_torch.tools.onnx_writer", "rapiddoc_tpu_torch.utils.sniff",
    "rapiddoc_tpu_torch.models.layout.onnx_engine",
    "rapiddoc_tpu_torch.models.table.onnx_models",
    # the scanned and born-digital codecs
    "rapiddoc_tpu_torch.pdfio.ccitt", "rapiddoc_tpu_torch.pdfio.jbig2",
    "rapiddoc_tpu_torch.pdfio.shading",
    # Office documents and the common image files
    "rapiddoc_tpu_torch.office.analyze", "rapiddoc_tpu_torch.office.common",
    "rapiddoc_tpu_torch.office.docx", "rapiddoc_tpu_torch.office.pptx",
    "rapiddoc_tpu_torch.office.xlsx", "rapiddoc_tpu_torch.office.omml",
    "rapiddoc_tpu_torch.office.chart", "rapiddoc_tpu_torch.office.images",
    "rapiddoc_tpu_torch.pdfio.bmp", "rapiddoc_tpu_torch.pdfio.gif",
    "rapiddoc_tpu_torch.pdfio.tiff", "rapiddoc_tpu_torch.pdfio.pil_modes",
)


def _jbig2_stream() -> bytes:
    """A JBIG2 page of one generic region, from the test encoder (which
    the child process cannot import: it borrows the JAX package's
    tables)."""
    sys.path.insert(0, str(REPO / "tests"))
    import numpy as np

    import jbig2_encoder as E

    bmp = (np.arange(12 * 20).reshape(12, 20) % 7 == 0).astype(np.uint8)
    return E.segment(1, 48, [], 1, E.page_info(20, 12)) + E.generic_region_segment(2, bmp)


def _docx() -> bytes:
    """A docx of a heading and a paragraph (built here: the child may not
    import the Office tests, which import the JAX package)."""
    import io
    import zipfile

    w = 'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main"'
    body = ('<w:p><w:pPr><w:pStyle w:val="Heading1"/></w:pPr><w:r><w:t>Title</w:t></w:r></w:p>'
            '<w:p><w:r><w:t>isolated paragraph</w:t></w:r></w:p>')
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("word/document.xml", f"<w:document {w}><w:body>{body}</w:body></w:document>")
    return buf.getvalue()


def test_port_imports_and_runs_with_banned_modules_blocked():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    assert set(MAIN_PATH_MODULES) <= set(modules)
    code = textwrap.dedent(f"""
        import sys
        for name in {BANNED!r}:
            sys.modules[name] = None  # any import of them raises
        import importlib
        import numpy as np
        import torch
        for m in {modules!r} + ["chip_smoke"]:
            importlib.import_module(m)
        from rapiddoc_tpu_torch.models.registry import build_ocr_system
        system = build_ocr_system(device="cpu", dtype=torch.float32)
        with np.load("rapiddoc_tpu_torch/assets/ocr_smoke_pages.npz") as z:
            page = z["pages"][0][:320, :480]
        out = system([page])
        assert len(out) == 1 and len(out[0]) > 0, out
        # the main path on the first fixture page: PDF parse, JPEG decode,
        # render, OCR, assembly
        import os
        from rapiddoc_tpu_torch import RapidDoc
        from rapiddoc_tpu_torch.bench import build_pdf, page_images
        for k in ("LAYOUT", "FORMULA", "TABLE"):
            os.environ["RAPIDDOC_DISABLE_" + k] = "1"
        with open("rapiddoc_tpu_torch/assets/ocr_smoke_doc.pdf", "rb") as f:
            pdf = build_pdf(page_images(f.read())[:1], 1)
        md = RapidDoc(device="cpu", dtype=torch.float32)(pdf, parse_method="ocr").markdown
        assert md.count(chr(10)) > 10, md
        # Magika through the ONNX interpreter
        from rapiddoc_tpu_torch.utils.sniff import guess_suffix_by_bytes
        assert guess_suffix_by_bytes(b"  " + pdf, device="cpu") == "pdf"
        # the bilevel decoders and a shading, plain
        from rapiddoc_tpu_torch.pdfio import ccitt, jbig2, shading
        bits, rows = ccitt.decode_bits_plain(bytes([255]), 9, 8, -1)  # eight V0 rows
        assert rows == 8 and not bits.any()
        bmp = (np.arange(12 * 20).reshape(12, 20) % 7 == 0).astype(np.uint8)
        assert (jbig2.decode({_jbig2_stream()!r}) == bmp).all()
        class Doc:
            resolve = staticmethod(lambda x: x)
        sh = {{"ShadingType": 2, "Coords": [0, 0, 10, 0], "Function": {{"FunctionType": 2,
              "C0": [0], "C1": [1], "N": 1}}, "ColorSpace": "DeviceGray"}}
        rgb, alpha = shading.render_shading(Doc(), sh, (1, 0, 0, 1, 0, 0), (0, 0, 10, 2))
        assert rgb.shape == (2, 10, 3) and rgb[0, 9, 0] > rgb[0, 0, 0]
        # an Office document and a GIF through the facade
        doc = RapidDoc(device="cpu", dtype=torch.float32)
        assert doc({_docx()!r}).markdown == "Title" + chr(10) * 2 + "isolated paragraph"
        with open("rapiddoc_tpu_torch/assets/image_files_page.gif", "rb") as f:
            assert doc(f.read(), parse_method="ocr").markdown.strip()
        loaded = sorted(k for k in sys.modules if k.split(".")[0] in {BANNED!r}
                        and sys.modules[k] is not None)
        assert not loaded, loaded
        print("ok", len(out[0]))
    """)
    # other test files set RAPIDDOC_* knobs (such as RAPIDDOC_DISABLE_OCR)
    # when they are imported; the child runs without any
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RAPIDDOC_", "MINERU_"))}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
