"""The port's host decoders (``csrc/{webp,jpx,jpeg_entropy,bilevel}.cu``)
built with g++ on the CPU, for tests that run the compiled loops as a card
would.

The sources are plain C++ with C entry points; nvcc builds them on the
card (``ops/build.py``). Here ``compiled_host()`` builds them once per
process into a temporary directory and, while open, maps
``ops.build.load`` to those libraries and ``ops.build.host_compiled`` to
True.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "rapiddoc_tpu_torch" / "csrc"
_libs: dict[str, ctypes.CDLL] = {}
_tmp: list[str] = []


def gxx() -> str | None:
    return shutil.which("g++")


def load(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with ``g++ -O2`` and loaded (once)."""
    lib = _libs.get(name)
    if lib is None:
        if not _tmp:
            _tmp.append(tempfile.mkdtemp(prefix="host_builds_"))
            atexit.register(shutil.rmtree, _tmp[0], True)
        out = Path(_tmp[0]) / f"lib{name}.so"
        subprocess.run([gxx(), "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                        str(CSRC / f"{name}.cu"), "-o", str(out)], check=True,
                       capture_output=True)
        lib = _libs[name] = ctypes.CDLL(str(out))
    return lib


@contextlib.contextmanager
def compiled_host():
    """``ops.build`` as on a card for the host decoders, built here."""
    from rapiddoc_tpu_torch.ops import build

    saved = build.load, build.host_compiled
    build.load, build.host_compiled = load, (lambda: True)
    try:
        yield
    finally:
        build.load, build.host_compiled = saved
