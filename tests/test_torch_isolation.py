"""The port imports torch, numpy, scipy and the standard library only:
no jax, flax, optax, cv2, PIL, matplotlib, pyparsing, fontTools, and nothing of the
JAX package. The card's
machine is not guaranteed any of those, so this is the CPU-side guard. The
child process imports every module of the port with those blocked and runs
the main path, Magika, the CCITT, JBIG2 and shading code, an Office
document (a docx), an image file (a GIF), the command line and the HTTP
service, draws a synthetic text line and takes two training steps, and
starts the render pool, whose workers must import none of
those (nor torch).

aiohttp, click, requests and FastAPI are banned too: the JAX package's
CLI, service and downloads use them, and the card's machine has none of
them. So are PyYAML, safetensors and tokenizers, which the JAX package's
checkpoint converters and formula tokenizer read published files with:
the port reads them with its own ``utils/{yaml_subset,safetensors,
hf_tokenizer}.py``; the child converts a checkpoint, a safetensors file,
an inference yml and decodes through the tokenizer replay."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "rapiddoc_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "matplotlib", "pyparsing", "fontTools",
          "rapiddoc_tpu", "aiohttp", "click", "requests", "fastapi", "yaml", "safetensors", "tokenizers")


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
    # the entry points and the host families they call
    "rapiddoc_tpu_torch.cli.main", "rapiddoc_tpu_torch.cli.common",
    "rapiddoc_tpu_torch.serve.http", "rapiddoc_tpu_torch.serve.webui",
    "rapiddoc_tpu_torch.models.cli", "rapiddoc_tpu_torch.models.custom",
    "rapiddoc_tpu_torch.models.vl", "rapiddoc_tpu_torch.utils.checkbox",
    "rapiddoc_tpu_torch.utils.draw", "rapiddoc_tpu_torch.utils.markdown_convert",
    "rapiddoc_tpu_torch.chunker.text_splitters",
    # the published checkpoints: converters, readers, downloader, bring-up
    "rapiddoc_tpu_torch.engine.weights", "rapiddoc_tpu_torch.models.ocr.convert",
    "rapiddoc_tpu_torch.models.formula.convert", "rapiddoc_tpu_torch.models.table.convert",
    "rapiddoc_tpu_torch.models.layout.hgnet_convert", "rapiddoc_tpu_torch.models.download",
    "rapiddoc_tpu_torch.tools.convert_weights", "rapiddoc_tpu_torch.tools.bringup",
    "rapiddoc_tpu_torch.tools.eval_quality", "rapiddoc_tpu_torch.utils.teds",
    "rapiddoc_tpu_torch.utils.safetensors", "rapiddoc_tpu_torch.utils.yaml_subset",
    "rapiddoc_tpu_torch.utils.hf_tokenizer",
    # the FLOP accounting and the render pool
    "rapiddoc_tpu_torch.engine.flops", "rapiddoc_tpu_torch.pdfio.parallel_render",
    # the compiled host loops and the bench's parts
    "rapiddoc_tpu_torch.utils.native", "rapiddoc_tpu_torch.tools.coldstart",
    "rapiddoc_tpu_torch.profile_heads",
    # training: the trainers, their optimizers and synthetic data
    "rapiddoc_tpu_torch.train.bn", "rapiddoc_tpu_torch.train.optim",
    "rapiddoc_tpu_torch.train.synth", "rapiddoc_tpu_torch.train.det",
    "rapiddoc_tpu_torch.train.rec", "rapiddoc_tpu_torch.train.orientation",
    "rapiddoc_tpu_torch.pdfio.pil_filter",
    # the table trainers and their synthetic tables
    "rapiddoc_tpu_torch.train.synth_table", "rapiddoc_tpu_torch.train.table",
    "rapiddoc_tpu_torch.train.unitable",
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
        # training: a synthetic line (no PIL, cv2 or matplotlib) and one
        # step of each trainer's optimizer on a tiny batch
        import random
        from rapiddoc_tpu_torch.train import orientation, synth
        from rapiddoc_tpu_torch.train.bn import bn_training
        assert synth.render_line("isolated line", random.Random(0)).shape[0] == 48
        net = orientation.new_model(0).eval()
        opt = orientation.make_optimizer(net, 30)
        with bn_training(net):
            for _ in range(2):
                loss = orientation.train_step(net, opt, torch.zeros((2, 32, 32, 3), dtype=torch.uint8),
                                              torch.tensor([0, 1]))
        assert torch.isfinite(loss) and not net.training
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
        # the command line and the HTTP service
        import http.client, tempfile, threading
        from rapiddoc_tpu_torch.cli.main import main
        from rapiddoc_tpu_torch.serve.http import make_server
        os.environ["RAPIDDOC_PLATFORM"] = "cpu"
        os.environ["RAPIDDOC_DISABLE_OCR"] = "1"
        with tempfile.TemporaryDirectory() as tmp:
            assert main(["rapiddoc_tpu_torch/assets/checkbox_smoke_page.pdf", "-o", tmp,
                         "--checkbox", "--draw-layout", "--html"]) == 0
            assert os.path.getsize(tmp + "/checkbox_smoke_page/checkbox_smoke_page_layout.pdf")
        server = make_server("127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever)
        thread.start()
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/health")
        assert conn.getresponse().status == 200
        conn.close()
        server.shutdown()
        server.close()
        thread.join(timeout=60)
        assert not thread.is_alive()
        # the published checkpoints' formats: a bare formula decoder .pth
        # and an inference yml through convert_weights, a safetensors file
        # written here by hand, and the tokenizer replay
        import json, struct
        sys.path.insert(0, "tests")
        import torch_published as P
        from rapiddoc_tpu_torch.tools.convert_weights import main as convert
        from rapiddoc_tpu_torch.models.formula.engine import FormulaTokenizer
        from rapiddoc_tpu_torch.utils import safetensors
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["RAPIDDOC_MODELS_DIR"] = tmp
            sd, _ = P.formula_checkpoint(0, bare=True, layers=6, d_model=16, ffn=32, heads=2,
                                         vocab_size=40, max_len=16)
            torch.save(sd, tmp + "/decoder.pth")
            assert convert(["formula", tmp + "/decoder.pth"]) == 0
            with open(tmp + "/inference.yml", "w") as f:
                f.write(P.inference_yml(P.tokenizer_spec(300, seed=1)))
            assert convert(["formula_dict", tmp + "/inference.yml"]) == 0
            tok = FormulaTokenizer(__import__("pathlib").Path(tmp) / "formula_tokenizer.json")
            assert tok.available() and isinstance(tok.decode(list(range(4, 60))), str)
            head = json.dumps({{"w": {{"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}}})
            with open(tmp + "/w.safetensors", "wb") as f:
                f.write(struct.pack("<Q", len(head)) + head.encode()
                        + np.array([1.5, -2], np.float32).tobytes())
            assert safetensors.load_file(tmp + "/w.safetensors")["w"].tolist() == [1.5, -2.0]
        # the host loops' plain versions and the bench's parts that run
        # without a card
        from rapiddoc_tpu_torch.utils import native
        assert native.png_defilter(bytes([4, 9, 9, 1, 5, 5]), 2, 1) == bytes([9, 18, 5, 10])
        assert native.tiff_defilter(bytes([1, 2, 3, 4]), 2, 1) == bytes([1, 3, 3, 7])
        assert native.nms(np.array([[0, 0, 2, 2], [0, 0, 2, 2.1]]), np.array([0.2, 0.9]),
                          0.5) == [1]
        assert native.iou_matrix(np.zeros((70, 4)), np.ones((70, 4))).shape == (70, 70)
        assert native.levenshtein("表格", "表") == 1
        from rapiddoc_tpu_torch import bench
        docs = bench.corpus_docs()
        assert len(bench.page_images(docs["table_heavy"])) == bench.CORPUS_PAGES
        wl = bench.workload_report({{"formula": {{"items": 2}}}}, 10)
        assert bench.baseline_report(1.0, wl, 2)["vs_baseline"] > 0
        assert bench.overlap_report({{"render": {{"total_s": 1.0}}}}, 2, 1.0, wl,
                                    {{}})["e2e_over_max_path"] == 1.0
        # the render pool's workers import the port's pdfio: nothing
        # banned, and not torch either
        from rapiddoc_tpu_torch.pdfio import parallel_render
        reports = parallel_render.probe_workers()
        parallel_render.kill_pool()
        assert reports and all(r["modules"] == [] for r in reports), reports
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
    assert proc.stdout.splitlines()[-1].startswith("ok")


def test_no_checkpoints_item_remains():
    """ROADMAP item 17 is ported: nothing raises ``not_ported(...,
    "checkpoints")`` and ``ITEMS`` has no ``checkpoints`` key."""
    from rapiddoc_tpu_torch.utils.unported import ITEMS

    assert "checkpoints" not in ITEMS
    calls = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "not_ported":
                calls.append((path.name, [ast.literal_eval(a) for a in node.args[1:]
                                          if isinstance(a, ast.Constant)]))
    assert calls, "no not_ported call found: the scan is wrong"
    assert not [c for c in calls if "checkpoints" in c[1]], calls
