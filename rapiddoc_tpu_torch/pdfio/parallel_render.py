"""Process-pool page rasterization of the port.

Port of ``rapiddoc_tpu/pdfio/parallel_render.py`` (reference:
rapid_doc/utils/pdf_image_tools.py:56-155 load_images_from_pdf, a
process pool of four over page ranges with a timeout, gated by
MINERU_PDF_CONCURRENCY_ENABLED): ``concurrency_enabled``,
``_n_workers`` and the shards ``idxs[k::nw]`` are the JAX package's. The
rasterizer is Python and numpy, bound by the GIL, so processes are what
scale it; each worker re-opens the document from its bytes.

Where the port differs:

- Workers return numpy rasters, text dicts and boxes (the JAX package's
  PNG round trip is lossless; nothing needs it here).
- Workers start with ``spawn``: the parent holds a CUDA context and the
  window loop's render-ahead and assembly threads, which a fork would copy
  in whatever state they are in. A worker imports the port's ``pdfio``
  (and the program's main module, as ``spawn`` does: a program that
  parses 16 pages or more needs the ``if __name__ == "__main__":`` guard
  spawn asks for), never torch, PIL or JAX.
- The compiled host loops (``ops/build.py``): the parent decides
  (``host_compiled()``), builds the host libraries, and hands its answer
  and their paths to each worker (``build.preset``); a worker never probes
  for a card, so it cannot fall to the plain loops where its parent runs
  compiled ones.
- Failures: a page whose page object is broken comes back None (the
  caller's blank page, as the serial path makes it); a page whose render
  raises raises the same error here, as the serial path would. A fault of
  the pool itself, or the ``PDF_LOAD_IMAGES_TIMEOUT``, kills the pool's
  workers and raises ``PoolFault``: the caller logs it and renders the
  window serially, as the JAX package does. ``stats`` counts windows and
  such fallbacks.
"""
from __future__ import annotations

import multiprocessing
import os
import sys
import threading
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

from ..config import env_bool, env_int
from ..utils.logging import get_logger

logger = get_logger("rapiddoc_tpu_torch.pdfio.parallel")

_POOL: ProcessPoolExecutor | None = None
_POOL_LOCK = threading.Lock()
# windows rendered through the pool, the windows a pool fault or timeout
# sent to the serial path (api.render_window counts them) and the
# compiled-loop choices the rendering workers reported
stats = {"windows": 0, "fallbacks": 0, "worker_host_compiled": set()}


class PoolFault(RuntimeError):
    """The pool failed or timed out: nothing about the pages' content."""


class _PageFailure:
    """A page render's exception, carried back to be raised in the parent."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def concurrency_enabled(n_pages: int) -> bool:
    # on by default on multi-core hosts (the reference's default); needs
    # >= 2 cores and a window big enough to amortize each worker's
    # re-parse of the document
    if not env_bool("PDF_CONCURRENCY_ENABLED", True):
        return False
    return n_pages >= 16 and (os.cpu_count() or 1) >= 2


def _n_workers() -> int:
    return max(1, min(env_int("PDF_RENDER_WORKERS", 4), os.cpu_count() or 1))


def _timeout() -> float:
    return float(
        os.environ.get("RAPIDDOC_PDF_LOAD_IMAGES_TIMEOUT")
        or os.environ.get("MINERU_PDF_LOAD_IMAGES_TIMEOUT")
        or 300
    )


def _init_worker(compiled: bool, libraries: dict[str, str]) -> None:
    from ..ops import build

    build.preset(compiled, libraries)


def _render_range(pdf_bytes: bytes, idxs: list[int], dpi: int,
                  want_text: bool) -> tuple[bool, list]:
    """Worker: its compiled-loop choice, and per page (raster, (w, h) page
    units, text_dict|None, image_boxes), None for a broken page object, or
    a _PageFailure."""
    from ..ops import build
    from . import open_pdf
    from .render import render_page_full

    out = []
    doc = open_pdf(pdf_bytes)
    for i in idxs:
        try:
            page = doc.get_page(i)
            size = page.size
        except Exception:
            logger.exception("page %d failed to render", i)
            out.append(None)
            continue
        try:
            img, tdict, boxes = render_page_full(page, dpi=dpi, with_text=want_text)
        except Exception as exc:
            out.append(_PageFailure(exc))
            continue
        out.append((img, size, tdict, boxes))
    return build.host_compiled(), out


def worker_report() -> dict:
    """Worker: what it runs with (the compiled-loop choice, the libraries
    it was given, the heavy packages it has imported)."""
    from ..ops import build

    return {
        "pid": os.getpid(),
        "host_compiled": build.host_compiled(),
        "libraries": dict(build._preset[1]) if build._preset else None,
        "modules": sorted(m for m in ("torch", "PIL", "jax", "rapiddoc_tpu", "cv2")
                          if m in sys.modules),
    }


def _get_pool() -> ProcessPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            from ..ops import build

            compiled = build.host_compiled()
            libraries = build.host_libraries() if compiled else {}
            _POOL = ProcessPoolExecutor(
                max_workers=_n_workers(), mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(compiled, libraries),
            )
        return _POOL


def kill_pool() -> None:
    """Stop the pool's workers now (running renders included) and drop
    the pool; the next window starts a new one."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is None:
        return
    for proc in list((getattr(pool, "_processes", None) or {}).values()):
        proc.kill()
    pool.shutdown(wait=True, cancel_futures=True)


def probe_workers() -> list[dict]:
    """``worker_report`` from each of the pool's workers (starting the
    pool if needed)."""
    pool = _get_pool()
    return [f.result(timeout=_timeout()) for f in
            [pool.submit(worker_report) for _ in range(_n_workers())]]


def render_pages_parallel(pdf_bytes: bytes, idxs: list[int], dpi: int, want_text: bool,
                          timeout: float | None = None) -> list:
    """Render pages across the worker processes. Returns a list aligned
    with ``idxs`` of (raster uint8 (H, W, 3), (w, h), text_dict|None,
    image_boxes), None for a broken page object. A page's render error
    is raised as the serial path raises it; a fault of the pool or the
    timeout kills the pool and raises PoolFault."""
    timeout = timeout or _timeout()
    nw = _n_workers()
    shards = [s for s in (idxs[k::nw] for k in range(nw)) if s]
    results: dict[int, object] = {}
    try:
        # spawn's own refusal (a main module without the __main__ guard,
        # being imported in a worker) is not caught: that worker stops
        pool = _get_pool()
        futures = [pool.submit(_render_range, pdf_bytes, shard, dpi, want_text)
                   for shard in shards]
    except BrokenProcessPool as exc:
        kill_pool()
        raise PoolFault(f"the render pool is broken ({exc})") from exc
    try:
        for shard, fut in zip(shards, futures):
            compiled, items = fut.result(timeout=timeout)
            stats["worker_host_compiled"].add(compiled)
            results.update(zip(shard, items))
    except Exception as exc:
        kill_pool()
        raise PoolFault(f"the render pool failed ({type(exc).__name__}: {exc})") from exc
    for i in idxs:
        if isinstance(results[i], _PageFailure):
            raise results[i].exc
    stats["windows"] += 1
    return [results[i] for i in idxs]
