"""Build a CUDA source of this package with nvcc and load it with ctypes.

Each source under ``csrc/`` exposes a plain ``extern "C"`` launcher and
includes no PyTorch header (only the shared ``csrc/*.cuh``), so one nvcc
call takes seconds. The shared library goes to
``_build/<name>-<hash>/`` beside the package and is reused while the
source, the headers it includes and the flags are unchanged. Nothing here runs at import
time: the first launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked in PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)"
    )


def local_headers(name: str) -> list[Path]:
    """The headers under ``csrc/`` that ``csrc/<name>.cu`` includes with
    quotes, directly or through one another. Raises FileNotFoundError
    naming a header that is missing (a copy of the package that left out
    ``csrc/*.cuh``) before nvcc would stop on it."""
    found: list[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        src = todo.pop()
        for inc in _INCLUDE.findall(src.read_text()):
            path = CSRC_DIR / inc
            if not path.is_file():
                raise FileNotFoundError(
                    f"{src.name} includes {inc}, which is missing from {CSRC_DIR}"
                )
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` at its current content goes:
    the hash covers the source, the headers it includes and the flags, so
    a changed header rebuilds too."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(local_headers(name)):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this content exists.
    Raises RuntimeError carrying nvcc's output when it fails."""
    out = library_path(name)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def host_compiled() -> bool:
    """Whether the host-side decoders (``csrc/bilevel.cu``,
    ``csrc/jpeg_entropy.cu``) run compiled: where a card is present, with
    no fallback; else their plain Python versions run."""
    import torch

    return torch.cuda.is_available()


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>.so`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
