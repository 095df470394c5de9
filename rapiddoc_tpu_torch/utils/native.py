"""The compiled host loops of the JAX package's ``utils/native.py``.

The JAX package loads these five loops from its C++ library through
ctypes and falls back to Python or numpy when the library is missing.
The port compiles its own copy, ``csrc/hostops.cu``, with nvcc through
``ops/build.py`` (plain C entry points, as ``csrc/jpeg_entropy.cu``) and
follows ``ops.build.host_compiled()``: where a card is present every
wrapper runs the compiled loop, and a failed build or load raises (no
fallback); elsewhere the plain versions run, which are the port's
earlier Python and numpy code: ``pdfio.filters.png_defilter_plain`` and
``tiff_defilter_plain``, ``utils.boxes.iou_matrix_plain`` and
``nms``, ``utils.teds.levenshtein``. The names and signatures are
the JAX wrappers'.

Compiled and plain give equal results but at three corners the plain
version does not reach in practice: ``iou_matrix`` where a union lies in
(0, 1e-12) (numpy divides by 1e-12 there, C by the union) or a
coordinate is NaN (``std::max`` reads NaN as 0, numpy keeps it); ``nms``
with NaN scores (no order is defined).

Row lengths, pixel widths and box counts reach C as 32-bit ints, and
ctypes would truncate a larger one without a word; they come from a
file's ``/Columns``, ``/Colors`` and ``/BitsPerComponent``, so every
wrapper refuses one above ``INT_MAX`` with ValueError on both paths.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

INT_MAX = 2**31 - 1  # the C entry points' int arguments


def _compiled() -> bool:
    from ..ops import build

    return build.host_compiled()


_typed_lock = threading.Lock()
_typed: dict[int, ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    """``csrc/hostops.cu``, handed out only once every entry point is
    typed (under a lock: the render-ahead thread and the caller's may
    ask first at the same time)."""
    from ..ops import build

    lib = build.load("hostops")
    with _typed_lock:
        if id(lib) not in _typed:
            ptr, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.png_defilter.argtypes = [ctypes.c_char_p, i64, cint, cint, ptr]
            lib.png_defilter.restype = i64
            lib.tiff_defilter.argtypes = [ptr, i64, cint, cint]
            lib.tiff_defilter.restype = None
            lib.iou_matrix.argtypes = [ptr, cint, ptr, cint, ptr]
            lib.iou_matrix.restype = None
            lib.nms.argtypes = [ptr, ptr, cint, ctypes.c_double, ptr]
            lib.nms.restype = cint
            lib.levenshtein_u32.argtypes = [ptr, i64, ptr, i64]
            lib.levenshtein_u32.restype = i64
            _typed[id(lib)] = lib
    return lib


def _check_rows(row_len: int, bpp: int, least_row: int) -> None:
    if not (least_row <= row_len < INT_MAX and 1 <= bpp <= INT_MAX):
        raise ValueError(f"predictor rows of {row_len} bytes, {bpp} bytes a pixel")


def _check_count(*counts: int) -> None:
    if max(counts, default=0) > INT_MAX:
        raise ValueError(f"{max(counts)} boxes: more than the compiled loops take")


def png_defilter(data: bytes, row_len: int, bpp: int) -> bytes:
    """PNG-predicted rows (a filter byte, then ``row_len`` bytes) undone;
    an unknown filter byte leaves its row as it is, a partial last row is
    dropped."""
    _check_rows(row_len, bpp, 0)
    if not _compiled():
        from ..pdfio.filters import png_defilter_plain

        return png_defilter_plain(data, row_len, bpp)
    data = bytes(data)
    out = np.empty((len(data) // (row_len + 1)) * row_len, np.uint8)
    _lib().png_defilter(data, len(data), row_len, bpp, out.ctypes.data_as(ctypes.c_void_p))
    return out.tobytes()


def tiff_defilter(data: bytes, row_len: int, bpp: int) -> bytes:
    """TIFF predictor 2 (8-bit components) undone on every whole row."""
    _check_rows(row_len, bpp, 1)
    if not _compiled():
        from ..pdfio.filters import tiff_defilter_plain

        return tiff_defilter_plain(data, row_len, bpp)
    arr = np.frombuffer(data, np.uint8).copy()
    _lib().tiff_defilter(arr.ctypes.data_as(ctypes.c_void_p), len(arr), row_len, bpp)
    return arr.tobytes()


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes, float64 (len(a), len(b))."""
    a = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, 4)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, 4)
    _check_count(len(a), len(b))
    if not _compiled():
        from .boxes import iou_matrix_plain

        return iou_matrix_plain(a, b)
    out = np.empty((len(a), len(b)), np.float64)
    _lib().iou_matrix(a.ctypes.data_as(ctypes.c_void_p), len(a),
                      b.ctypes.data_as(ctypes.c_void_p), len(b),
                      out.ctypes.data_as(ctypes.c_void_p))
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> list[int]:
    """Greedy NMS: kept indices in descending score order (ties in index
    order); a box goes where its IoU with a kept one exceeds the
    threshold."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float64).reshape(-1, 4)
    scores = np.ascontiguousarray(scores, dtype=np.float64).reshape(-1)
    if len(scores) != len(boxes):
        raise ValueError(f"{len(boxes)} boxes but {len(scores)} scores")
    _check_count(len(boxes))
    if not _compiled():
        from .boxes import nms as plain

        return plain(boxes, scores, iou_threshold)
    keep = np.empty(len(boxes), np.int32)
    n = _lib().nms(boxes.ctypes.data_as(ctypes.c_void_p),
                   scores.ctypes.data_as(ctypes.c_void_p), len(boxes), iou_threshold,
                   keep.ctypes.data_as(ctypes.c_void_p))
    return keep[:n].tolist()


def levenshtein(a: str, b: str) -> int:
    """Edit distance over code points (UTF-32 code units; a lone
    surrogate is its own code point, as the plain version compares it)."""
    if not _compiled():
        from .teds import levenshtein as plain

        return plain(a, b)
    aa = np.frombuffer(a.encode("utf-32-le", "surrogatepass"), np.uint32)
    bb = np.frombuffer(b.encode("utf-32-le", "surrogatepass"), np.uint32)
    return int(_lib().levenshtein_u32(aa.ctypes.data if len(aa) else None, len(aa),
                                      bb.ctypes.data if len(bb) else None, len(bb)))
