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
- Workers are fresh interpreters started with ``subprocess`` (fork and
  exec, as ``spawn`` starts them): the parent holds a CUDA context and the
  window loop's render-ahead and assembly threads, which a plain fork would
  copy in whatever state they are in. A worker imports this module and the
  port's ``pdfio``, never torch, PIL or JAX, and never the program's main
  module: ``multiprocessing``'s ``spawn`` re-runs a script's top level in
  every worker (and then refuses to start processes from there), so a
  script without the ``if __name__ == "__main__":`` guard would run its
  model builds and file writes again in each worker. Tasks and results go
  as pickles over the worker's stdin and a copy of its stdout (its fd 1
  then points at stderr, so a stray print cannot break the stream).
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

import os
import pickle
import queue
import subprocess
import sys
import threading
from concurrent.futures import Future, ThreadPoolExecutor

from ..config import env_bool, env_int
from ..utils.logging import get_logger

logger = get_logger("rapiddoc_tpu_torch.pdfio.parallel")

_POOL: "_Pool | None" = None
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


# a worker's first lines: keep a private copy of fd 1 for the results,
# point fd 1 at stderr, take the parent's sys.path, serve
_BOOT = (
    "import os, pickle, sys\n"
    "out = os.fdopen(os.dup(1), 'wb')\n"
    "os.dup2(2, 1)\n"
    "sys.path[:] = pickle.load(sys.stdin.buffer)\n"
    "from rapiddoc_tpu_torch.pdfio.parallel_render import serve\n"
    "serve(sys.stdin.buffer, out)\n"
)


def serve(inp, out) -> None:
    """Worker: take the parent's compiled-loop decision and libraries,
    then run ``(fn, args)`` tasks until stdin closes, answering each with
    ``(True, result)`` or ``(False, exception)``."""
    from ..ops import build

    build.preset(*pickle.load(inp))
    while True:
        try:
            fn, args = pickle.load(inp)
        except EOFError:
            return
        try:
            answer = (True, fn(*args))
        except Exception as exc:  # carried back and raised in the parent
            answer = (False, exc)
        try:
            data = pickle.dumps(answer, pickle.HIGHEST_PROTOCOL)
        except Exception as exc:
            data = pickle.dumps((False, RuntimeError(f"unpicklable answer: {exc!r}")))
        out.write(data)
        out.flush()


class _Worker:
    """One worker process and its two pipes."""

    def __init__(self, compiled: bool, libraries: dict[str, str]):
        self.proc = subprocess.Popen([sys.executable, "-c", _BOOT],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self._send(list(sys.path))
        self._send((compiled, dict(libraries)))

    def _send(self, obj) -> None:
        pickle.dump(obj, self.proc.stdin, pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def call(self, fn, args: tuple):
        self._send((fn, args))
        ok, value = pickle.load(self.proc.stdout)
        if not ok:
            raise value
        return value


class _Pool:
    """``n`` worker processes behind ``submit(fn, *args) -> Future``: each
    task waits for an idle worker on one of ``n`` threads."""

    def __init__(self, n: int, compiled: bool, libraries: dict[str, str]):
        self._idle: queue.Queue[_Worker] = queue.Queue()
        self.procs: list[subprocess.Popen] = []
        try:
            for _ in range(n):
                worker = _Worker(compiled, libraries)
                self.procs.append(worker.proc)
                self._idle.put(worker)
        except OSError:
            for proc in self.procs:
                proc.kill()
            raise
        self._threads = ThreadPoolExecutor(n, thread_name_prefix="render-pool")

    def submit(self, fn, *args) -> Future:
        return self._threads.submit(self._run, fn, args)

    def _run(self, fn, args: tuple):
        worker = self._idle.get()
        try:
            return worker.call(fn, args)
        finally:
            self._idle.put(worker)

    def kill(self) -> None:
        """Kill every worker (a task's read then ends at EOF), wait for
        them and the threads, close the pipes."""
        for proc in self.procs:
            proc.kill()
        for proc in self.procs:
            proc.wait()
        self._threads.shutdown(wait=True, cancel_futures=True)
        for proc in self.procs:
            for pipe in (proc.stdin, proc.stdout):
                try:
                    pipe.close()
                except OSError:  # a broken pipe's unflushed write
                    pass


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


def _get_pool() -> _Pool:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            from ..ops import build

            compiled = build.host_compiled()
            libraries = build.host_libraries() if compiled else {}
            _POOL = _Pool(_n_workers(), compiled, libraries)
        return _POOL


def kill_pool() -> None:
    """Stop the pool's workers now (running renders included) and drop
    the pool; the next window starts a new one."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.kill()


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
        pool = _get_pool()
        futures = [pool.submit(_render_range, pdf_bytes, shard, dpi, want_text)
                   for shard in shards]
    except OSError as exc:  # a worker that could not be started
        kill_pool()
        raise PoolFault(f"the render pool did not start ({exc})") from exc
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
