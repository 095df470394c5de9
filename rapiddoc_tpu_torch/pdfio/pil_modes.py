"""PIL's image modes, arrays and image objects as ``images_to_pdf`` embeds
them, without PIL.

The JAX package hands ``images_to_pdf`` a PIL image: a file through
``Image.open`` (``rapiddoc_tpu/pdfio/writer.py:121-125``), an array
through ``Image.fromarray`` and a PIL image as it is
(``rapiddoc_tpu/api.py:710-720``), each converted with
``convert("RGB")`` unless its mode is ``RGB`` or ``L``. ``embed_pixels``
replays that conversion for the modes below; the decoders of
``pdfio/{png,bmp,gif,tiff}.py`` return the mode PIL opens and its
samples. Found by experiment with Pillow 12.1:

- ``1``: 0 and 255 in RGB;
- ``P`` and ``PA``: the index looked up in the palette; an index past
  the palette's end reads black; transparency changes nothing;
- ``LA``: the grey repeated; ``RGBA`` and ``RGBX``: the fourth channel
  dropped (no blend);
- ``I`` and the ``I;16`` family: clipped to 0..255;
- ``F``: NaN and values at or below 0 read 0, values at or above 255
  read 255, the rest truncated;
- ``CMYK``: Pillow's ``cmyk2rgb`` (``pdfio.jpeg.cmyk_to_rgb_pil``).

``array_mode`` replays ``Image.fromarray``'s type map (bool is ``1``;
uint8 with 1, 2, 3 or 4 channels ``L``, ``LA``, ``RGB``, ``RGBA``; int8
read as uint8 into ``I``; the 16- and 32-bit integers ``I``, uint32 past
2**31 wrapping negative; float32 and float64 ``F`` in float32), with its
TypeError for any other type. ``object_pixels`` reads an object with
``__array_interface__`` and a PIL-style ``mode`` (a PIL image) through
numpy, its palette through ``getpalette()``. Other modes (``YCbCr``,
``LAB``, ``HSV``, ``La``) raise NotImplementedError naming their ROADMAP
item.

``check_size`` replays ``Image.open``'s decompression bomb check, which
PIL runs on every file's size before it reads a pixel; the decoders
call it as soon as a header gives the size, before they allocate.
"""
from __future__ import annotations

import numpy as np

from ..utils.unported import not_ported

_GREY_INTS = ("I", "I;16", "I;16B", "I;16L", "I;16N", "I;16S")
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3  # PIL.Image.MAX_IMAGE_PIXELS


def check_size(width: int, height: int) -> None:
    """Raise where ``Image._decompression_bomb_check`` raises: above twice
    ``MAX_IMAGE_PIXELS``, with PIL's message."""
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"Image size ({pixels} pixels) exceeds limit of "
                         f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS "
                         "attack.")


def unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(h, row_bytes) uint8 rows of 1-, 2- or 4-bit samples, most
    significant first (PIL's ``1``, ``P;n`` and ``L;n`` raw modes) ->
    (h, width) uint8 sample values."""
    values = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (values * weights).sum(-1)[:, :width].astype(np.uint8)


def _grey_rgb(grey: np.ndarray) -> np.ndarray:
    return np.repeat(grey[..., None], 3, axis=2)


def palette_rgb(index: np.ndarray, palette) -> np.ndarray:
    """(H, W) palette indices -> (H, W, 3): black past the palette's end."""
    lut = np.zeros((256, 3), np.uint8)
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
    lut[: len(pal)] = pal
    return lut[index]


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` unpacking: each colour times 255 over alpha
    (integer division, clipped), 0 where alpha is 0."""
    a = rgba[..., 3:].astype(np.int32)
    c = rgba[..., :3].astype(np.int32)
    out = np.where(a == 255, c, np.minimum(255, c * 255 // np.maximum(a, 1)))
    out = np.where(a == 0, 0, out)
    return np.concatenate([out, a], axis=-1).astype(np.uint8)


def embed_pixels(mode: str, data: np.ndarray, palette=None) -> np.ndarray:
    """An image of PIL mode ``mode`` with samples ``data`` (as numpy reads
    the PIL image) -> what ``images_to_pdf`` embeds: (H, W) uint8 for
    ``L``, else (H, W, 3) uint8 RGB."""
    if mode == "L":
        return np.ascontiguousarray(data, np.uint8)
    if mode == "RGB":
        return np.ascontiguousarray(data[..., :3], np.uint8)
    if mode == "1":
        return _grey_rgb(np.where(data != 0, 255, 0).astype(np.uint8))
    if mode in ("P", "PA"):
        index = data[..., 0] if data.ndim == 3 else data
        return palette_rgb(index, palette if palette is not None else [])
    if mode == "LA":
        return _grey_rgb(np.ascontiguousarray(data[..., 0], np.uint8))
    if mode in ("RGBA", "RGBX"):
        return np.ascontiguousarray(data[..., :3], np.uint8)
    if mode == "RGBa":
        return np.ascontiguousarray(unpremultiply(data)[..., :3])
    if mode == "CMYK":
        from .jpeg import cmyk_to_rgb_pil  # jpeg imports this module

        return cmyk_to_rgb_pil(np.ascontiguousarray(data, np.uint8))
    if mode in _GREY_INTS:
        return _grey_rgb(np.clip(data.astype(np.int64), 0, 255).astype(np.uint8))
    if mode == "F":
        f = data.astype(np.float32)
        grey = np.where(np.isnan(f) | (f <= 0), 0,
                        np.where(f >= 255, 255, np.nan_to_num(f, nan=0.0)))
        return _grey_rgb(grey.astype(np.uint8))
    raise not_ported(f"images of PIL mode {mode}", "pdfio")


def array_mode(arr: np.ndarray) -> tuple[str, np.ndarray]:
    """``Image.fromarray``'s mode for ``arr`` and its samples as that mode
    holds them."""
    if arr.ndim not in (2, 3):
        raise ValueError(f"an image array is (H, W) or (H, W, C), not {arr.shape}")
    channels = arr.shape[2:]
    kind, size = arr.dtype.kind, arr.dtype.itemsize
    mode, data = None, arr
    if arr.dtype == np.uint8:
        mode = {(): "L", (2,): "LA", (3,): "RGB", (4,): "RGBA"}.get(channels)
    elif channels:
        pass
    elif kind == "b":
        mode = "1"
    elif kind == "i" and size == 1:
        mode, data = "I", arr.view(np.uint8).astype(np.int32)  # read unsigned
    elif kind in "iu" and size in (2, 4):
        mode, data = "I", arr.astype(np.int32)  # uint32 past 2**31 wraps
    elif kind == "f" and size in (4, 8):
        mode, data = "F", arr.astype(np.float32)
    if mode is None:
        typestr = "|b1" if kind == "b" else arr.dtype.str
        raise TypeError(f"Cannot handle this data type: {(1, 1) + channels}, {typestr}")
    return mode, data


def array_pixels(arr: np.ndarray) -> np.ndarray:
    """An array as ``images_to_pdf`` embeds it after ``Image.fromarray``."""
    mode, data = array_mode(np.asarray(arr))
    return embed_pixels(mode, data)


def is_image_object(obj) -> bool:
    """An in-memory image that is no numpy array: it has
    ``__array_interface__`` and a PIL-style ``mode`` (a PIL image)."""
    return (not isinstance(obj, np.ndarray) and hasattr(obj, "__array_interface__")
            and isinstance(getattr(obj, "mode", None), str))


def object_pixels(obj) -> np.ndarray:
    """An image object (``is_image_object``) as ``images_to_pdf`` embeds
    it: its samples through numpy, its palette through ``getpalette()``."""
    data = np.asarray(obj)
    palette = obj.getpalette() if obj.mode in ("P", "PA") else None
    return embed_pixels(obj.mode, data, palette)
