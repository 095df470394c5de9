"""The port imports torch, numpy, scipy and the standard library only:
no jax, flax, cv2, PIL, and nothing of the JAX package. The card's
machine is not guaranteed any of those, so this is the CPU-side guard."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "rapiddoc_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "cv2", "PIL", "rapiddoc_tpu")


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


def test_port_imports_and_runs_with_banned_modules_blocked():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
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
        loaded = sorted(k for k in sys.modules if k.split(".")[0] in {BANNED!r}
                        and sys.modules[k] is not None)
        assert not loaded, loaded
        print("ok", len(out[0]))
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
