"""Decode PDF image XObjects into numpy arrays.

Port of ``rapiddoc_tpu/pdfio/images.py`` ``xobject_to_pil`` for the
codecs the port takes so far, returning what the JAX package's PIL image
holds as an array: (H, W) uint8 for mode L, (H, W, 3) for RGB, (H, W, 4)
for RGBA and (H, W, 2) for the LA stencil of an image mask.

- DCTDecode: ``pdfio.jpeg`` (baseline grey or YCbCr JPEG, bit-equal to
  PIL's libjpeg-turbo decode).
- Raw 8-bit ``/DeviceRGB`` and ``/DeviceGray`` samples behind zero or more
  non-image filters (Flate and the rest of ``pdfio.filters``).
- Image masks (``/ImageMask true``, 1 bit a sample, ``/Decode [1 0]``
  flipping it): L is 255 where the mask paints, A is 255.
- Soft masks: an ``/SMask`` decoded as above, resized BICUBIC to the
  image's size when it differs (``pil_resample.resize``), becomes alpha.

Everything else raises NotImplementedError naming its ROADMAP item:
JPX, CCITT and JBIG2 streams, indexed, CMYK, ICC-based, separation and
Lab colour, other bit depths and decode arrays.
"""
from __future__ import annotations

import numpy as np

from ..utils.unported import not_ported
from .cos import Stream
from .filters import decode_stream, image_codec
from .jpeg import decode_jpeg
from .pil_resample import resize


def _raw_samples(data: bytes, width: int, height: int, ncomp: int) -> np.ndarray:
    """8-bit samples, zero-padded when the stream is short (the JAX
    package's ``_unpack_bits``)."""
    need = width * ncomp * height
    if len(data) < need:
        data = data + b"\x00" * (need - len(data))
    arr = np.frombuffer(data[:need], dtype=np.uint8)
    return arr.reshape(height, width, ncomp) if ncomp > 1 else arr.reshape(height, width)


def xobject_to_array(doc, stream: Stream) -> np.ndarray | None:
    """Decode an image XObject (or inline image) as the JAX package's
    ``xobject_to_pil`` does: None for an image without a size."""
    d = stream.dict
    r = doc.resolve
    width = int(r(d.get("Width", 0)) or 0)
    height = int(r(d.get("Height", 0)) or 0)
    if width <= 0 or height <= 0:
        return None
    codec = image_codec(d, r)
    if codec in ("DCTDecode", "DCT"):
        img = decode_jpeg(decode_stream(stream, r))
    elif codec is not None:
        raise not_ported(f"{codec} images", "pdfio")
    elif bool(r(d.get("ImageMask", False))):
        return _stencil(decode_stream(stream, r), width, height, r(d.get("Decode")), r)
    else:
        img = _raw_image(decode_stream(stream, r), d, width, height, r)
    smask = r(d.get("SMask"))
    if isinstance(smask, Stream):
        alpha = xobject_to_array(doc, smask)
        if alpha is not None:
            if alpha.ndim != 2:
                raise not_ported(f"a soft mask of shape {alpha.shape}", "pdfio")
            alpha = resize(alpha, img.shape[1], img.shape[0], "bicubic")
            rgb = np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img
            img = np.concatenate([rgb, alpha[..., None]], axis=2)
    return img


def _stencil(data: bytes, width: int, height: int, decode, r) -> np.ndarray:
    """An image mask as the JAX package's LA image: 1-bit samples (rows
    padded to bytes), 0 paints unless ``/Decode [1 0]``."""
    row = (width + 7) // 8
    need = row * height
    if len(data) < need:
        data = data + b"\x00" * (need - len(data))
    bits = np.unpackbits(np.frombuffer(data[:need], np.uint8).reshape(height, row), axis=1)
    bits = bits[:, :width]
    if isinstance(decode, list) and float(r(decode[0])) == 1.0:
        bits = 1 - bits
    out = np.full((height, width, 2), 255, np.uint8)
    out[..., 0] = (1 - bits) * 255
    return out


def _raw_image(data: bytes, d: dict, width: int, height: int, r) -> np.ndarray:
    """Raw 8-bit grey or RGB samples."""
    if r(d.get("Decode") or d.get("D")) is not None:
        raise not_ported("images with a decode array", "pdfio")
    bpc = int(r(d.get("BitsPerComponent", 8)) or 8)
    cs = r(d.get("ColorSpace") or d.get("CS"))
    if cs is None:  # grey, as the JAX package's _colorspace_info reads it
        ncomp = 1
    else:
        ncomp = {"DeviceRGB": 3, "DeviceGray": 1}.get(cs) if isinstance(cs, str) else None
    if ncomp is None or bpc != 8:
        raise not_ported(f"{bpc}-bit images in colour space {cs!r}", "pdfio")
    return _raw_samples(data, width, height, ncomp)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a decoded image: grey and the L of LA
    repeated, alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, 2)
    if img.shape[2] == 2:
        return np.repeat(img[..., :1], 3, 2)
    return np.ascontiguousarray(img[..., :3])
