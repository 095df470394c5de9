"""WEBP files as Pillow 12.1 opens them (``WebPImagePlugin`` over
libwebp 1.6's ``WebPAnimDecoder``, RGBA output).

``webp_mode`` returns PIL's mode and samples; ``decode_webp`` what
``images_to_pdf`` embeds. Read from libwebp's demuxer and checked by
experiment (``tests/test_torch_webp.py``):

- The RIFF container must hold its whole declared size (bytes past it
  are ignored) and every chunk read must fit in it, each padded to an
  even size; the walk ends exactly at the end or fails; a cut file fails.
- A simple file starts with ``VP8 `` or ``VP8L`` (anything after its
  image chunk is not read); the canvas is its size and it is ``RGBA``
  only when a VP8L header says alpha is used (an ``ALPH`` chunk there is
  ignored, and clears that).
- ``VP8X`` gives the canvas and the flags: ``RGBA`` exactly when its
  alpha flag is set. A still image must fill the canvas; an ``ALPH``
  chunk before ``VP8 `` gives alpha, and is ignored without the flag.
  ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks are skipped.
- Animation (``ANIM``, then ``ANMF`` frames inside the canvas): every
  frame's chunks are read and checked, and the walk goes on after a
  frame's own chunks, whatever its ``ANMF`` size says (found by
  fuzzing); the first frame is decoded into a canvas of transparent
  black (0, 0, 0, 0) at its offset, as the anim decoder composes a key
  frame; ``RGB`` drops the alpha of that canvas.
- Pixels: ``pdfio.vp8`` (lossy) and ``pdfio.vp8l`` (lossless, ``ALPH``),
  whose sequential loops run compiled from ``csrc/webp.cu`` where a card
  is present (``ops.build.host_compiled``), with no fallback, and as
  their plain Python versions elsewhere.

Every malformed file raises ValueError, as PIL refuses it.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from .pil_modes import check_size, embed_pixels
from . import vp8, vp8l

ALPHA_FLAG, ANIMATION_FLAG, VALID_FLAGS = 0x10, 0x02, 0x3E
MAX_CHUNK = (1 << 32) - 1 - 8 - 1


def _lib():
    """``csrc/webp.cu``, its entry points typed on first use."""
    from ..ops import build

    lib = build.load("webp")
    if lib.webp_vp8_decode.argtypes is None:
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        lib.webp_vp8l_decode.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.POINTER(ctypes.c_uint32)]
        lib.webp_vp8l_decode.restype = ctypes.c_int
        lib.webp_alpha_unfilter.argtypes = [ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
        lib.webp_alpha_unfilter.restype = None
        lib.webp_vp8_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, u8p, u8p, u8p]
        lib.webp_vp8_decode.restype = ctypes.c_int
        lib.webp_yuv_to_rgb.argtypes = [u8p, u8p, u8p] + [ctypes.c_int] * 4 + [u8p]
        lib.webp_yuv_to_rgb.restype = None
    return lib


def compiled_argb(data: bytes, width: int, height: int, start: int,
                  max_rows: int | None = None) -> np.ndarray:
    """``vp8l.decode_argb`` through ``csrc/webp.cu``."""
    rows = height if max_rows is None else min(height, max_rows)
    out = np.empty((rows, width), np.uint32)
    buf = bytes(data)
    rc = _lib().webp_vp8l_decode(buf, len(buf), start, width, height, rows,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        raise ValueError(f"VP8L bitstream error {rc}")
    return out


def compiled_unfilter(kind: int, levels: np.ndarray) -> np.ndarray:
    """``vp8l.unfilter`` through ``csrc/webp.cu``."""
    out = np.ascontiguousarray(levels, np.uint8).copy()
    _lib().webp_alpha_unfilter(kind, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               out.shape[1], out.shape[0])
    return out


def compiled_planes(data: bytes, max_mb_rows: int | None = None):
    """``vp8.decode_planes`` through ``csrc/webp.cu``: (width, height, Y,
    U, V)."""
    w, h = vp8.frame_info(data)
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    rows = mb_h if max_mb_rows is None else min(mb_h, max_mb_rows)
    ys = np.empty((16 * rows, 16 * mb_w), np.uint8)
    us = np.empty((8 * rows, 8 * mb_w), np.uint8)
    vs = np.empty((8 * rows, 8 * mb_w), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    buf = bytes(data)
    rc = _lib().webp_vp8_decode(buf, len(buf), rows, ys.ctypes.data_as(u8),
                                us.ctypes.data_as(u8), vs.ctypes.data_as(u8))
    if rc != 0:
        raise ValueError(f"VP8 bitstream error {rc}")
    return w, h, ys, us, vs


def compiled_rgb(ys: np.ndarray, us: np.ndarray, vs: np.ndarray, width: int,
                 height: int) -> np.ndarray:
    """``vp8.yuv_to_rgb`` through ``csrc/webp.cu``."""
    if ys.shape[0] < height or ys.shape[1] < width or us.shape[1] != vs.shape[1]:
        raise ValueError("VP8 planes smaller than the frame")
    u8 = ctypes.POINTER(ctypes.c_uint8)
    planes = [np.ascontiguousarray(p, np.uint8) for p in (ys, us, vs)]
    out = np.empty((height, width, 3), np.uint8)
    _lib().webp_yuv_to_rgb(*(p.ctypes.data_as(u8) for p in planes), planes[0].shape[1],
                           planes[1].shape[1], width, height, out.ctypes.data_as(u8))
    return out


def _store_frame(data: bytes, pos: int, riff_end: int, min_size: int = 0) -> tuple[dict, int]:
    """libwebp's ``StoreFrame`` from ``pos``: an ``ALPH`` chunk and an
    image chunk (each taken once; any other chunk ends the frame, unread),
    the image's header checked as ``WebPGetFeatures`` checks it. Returns
    the frame ({} without chunks) and the position after it."""
    if riff_end - pos < max(8, min_size):
        raise ValueError("WEBP frame cut short")
    frame: dict = {}
    while True:
        fourcc = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        padded = size + (size & 1)
        if size > MAX_CHUNK or padded > riff_end - pos - 8:
            raise ValueError("WEBP chunk past the end of the file")
        payload = data[pos + 8:pos + 8 + size]
        if fourcc == b"ALPH" and "alpha" not in frame:
            frame["alpha"] = payload
            frame["alpha_after_image"] = "kind" in frame
        elif fourcc in (b"VP8 ", b"VP8L") and "kind" not in frame:
            if fourcc == b"VP8L":
                if "alpha" in frame:
                    raise ValueError("ALPH before a VP8L image")
                w, h, has_alpha = vp8l.read_header(payload)
            else:
                (w, h), has_alpha = vp8.frame_info(payload), "alpha" in frame
            frame.update(kind=fourcc.strip().decode(), data=payload, width=w, height=h,
                         has_alpha=has_alpha)
        else:
            return frame, pos
        pos += 8 + padded
        if pos == riff_end:
            return frame, pos
        if riff_end - pos < 8:
            raise ValueError("WEBP chunk header cut short")


def _decode_frame(frame: dict, compiled: bool) -> np.ndarray:
    """(h, w, 4) uint8 RGBA of a frame, as libwebp's MODE_RGBA output."""
    w, h = frame["width"], frame["height"]
    check_size(w, h)
    if frame["kind"] == "VP8L":
        if compiled:
            argb = compiled_argb(frame["data"], w, h, 5)
        else:
            argb = vp8l.decode_argb(frame["data"], w, h, 5)
        return vp8l.argb_to_rgba(argb)
    rgb = vp8.decode_vp8(frame["data"], compiled)
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = rgb
    if "alpha" in frame:
        out[..., 3] = vp8l.decode_alpha(frame["alpha"], w, h, compiled)
    else:
        out[..., 3] = 255
    return out


def _demux(data: bytes) -> tuple[str, int, int, dict]:
    """libwebp's ``WebPDemux`` over a whole file: (PIL's mode, canvas
    width, canvas height, first frame with its offset)."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WEBP file")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 8 or riff > MAX_CHUNK or riff + 8 > len(data):
        raise ValueError("WEBP file cut short or with a bad RIFF size")
    end = riff + 8
    first = data[12:16]
    if first in (b"VP8 ", b"VP8L"):  # a simple file
        frame, _ = _store_frame(data, 12, end)
        if "kind" not in frame:
            raise ValueError("WEBP file without an image")
        if frame.pop("alpha", None) is not None:  # no VP8X alpha flag: ALPH ignored,
            frame["has_alpha"] = False  # and with it what the image said
        return ("RGBA" if frame["has_alpha"] else "RGB"), frame["width"], frame["height"], \
            dict(frame, x=0, y=0)
    if first != b"VP8X":
        raise ValueError("WEBP file without VP8 , VP8L or VP8X first")
    size = struct.unpack_from("<I", data, 16)[0]
    padded = size + (size & 1)
    if size > MAX_CHUNK or size < 10 or padded > end - 20:
        raise ValueError("bad VP8X chunk")
    flags = data[20]
    cw = 1 + int.from_bytes(data[24:27], "little")
    ch = 1 + int.from_bytes(data[27:30], "little")
    if cw * ch >= 1 << 32:
        raise ValueError("WEBP canvas too large")
    animated = bool(flags & ANIMATION_FLAG)
    pos = 20 + padded
    if end - pos < 8:
        raise ValueError("VP8X without chunks")
    frames: list[dict] = []
    anim = False
    while True:
        fourcc = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        padded = size + (size & 1)
        if size > MAX_CHUNK or padded > end - pos - 8:
            raise ValueError("WEBP chunk past the end of the file")
        if fourcc == b"VP8X":
            raise ValueError("second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated or frames:
                raise ValueError("a still image in an animation, or twice")
            frame, pos = _store_frame(data, pos, end)
            if not flags & ALPHA_FLAG:
                frame.pop("alpha", None)
            frames.append(dict(frame, x=0, y=0))
        elif fourcc == b"ANMF":
            if not anim:
                raise ValueError("ANMF before ANIM")
            if padded < 16:
                raise ValueError("ANMF chunk too short")
            x = 2 * int.from_bytes(data[pos + 8:pos + 11], "little")
            y = 2 * int.from_bytes(data[pos + 11:pos + 14], "little")
            w = 1 + int.from_bytes(data[pos + 14:pos + 17], "little")
            h = 1 + int.from_bytes(data[pos + 17:pos + 20], "little")
            if w * h >= 1 << 32:
                raise ValueError("WEBP frame too large")
            start = pos + 24
            frame, pos = _store_frame(data, start, end, padded - 16)
            if pos - start > padded - 16:
                raise ValueError("WEBP frame past its ANMF chunk")
            # the parse goes on after the frame's own chunks
            if animated and frame:
                if frames and "kind" not in frames[-1]:
                    raise ValueError("WEBP frame after an incomplete one")
                frames.append(dict({"width": w, "height": h}, **frame, x=x, y=y))
        else:
            if fourcc == b"ANIM":
                if padded < 6:
                    raise ValueError("ANIM chunk too short")
                anim = True
            pos += 8 + padded
        if pos == end:
            break
        if end - pos < 8:
            raise ValueError("WEBP chunk header cut short")
    if flags & ~VALID_FLAGS & 0xFF or not frames:
        raise ValueError("WEBP file without a valid frame")
    for f in frames:
        if "kind" not in f or ("alpha" in f and f["alpha_after_image"]):
            raise ValueError("WEBP frame without an image, or with ALPH after it")
        if animated:
            if f["x"] + f["width"] > cw or f["y"] + f["height"] > ch:
                raise ValueError("WEBP frame outside the canvas")
        elif (f["x"], f["y"], f["width"], f["height"]) != (0, 0, cw, ch):
            raise ValueError("WEBP image and canvas sizes differ")
    return ("RGBA" if flags & ALPHA_FLAG else "RGB"), cw, ch, frames[0]


def webp_mode(data: bytes, compiled: bool | None = None) -> tuple[str, np.ndarray]:
    """WEBP bytes -> (PIL's mode, its samples): ``RGB`` as (H, W, 3),
    ``RGBA`` as (H, W, 4)."""
    if compiled is None:
        from ..ops import build

        compiled = build.host_compiled()
    mode, cw, ch, frame = _demux(bytes(data))
    check_size(cw, ch)
    x, y, w, h = frame["x"], frame["y"], frame["width"], frame["height"]
    rgba = _decode_frame(frame, compiled)
    if (x, y, w, h) != (0, 0, cw, ch):
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[y:y + h, x:x + w] = rgba
        rgba = canvas
    return mode, rgba if mode == "RGBA" else np.ascontiguousarray(rgba[..., :3])


def decode_webp(data: bytes) -> np.ndarray:
    """WEBP bytes -> what ``images_to_pdf`` embeds (RGB; alpha dropped)."""
    return embed_pixels(*webp_mode(data))
