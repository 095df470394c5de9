"""Decode PDF image XObjects into numpy arrays.

Port of ``rapiddoc_tpu/pdfio/images.py`` ``xobject_to_pil`` for the
codecs the port takes so far, returning what the JAX package's PIL image
holds as an array: (H, W) uint8 for mode L, (H, W, 3) for RGB.

- DCTDecode: ``pdfio.jpeg`` (baseline grey or YCbCr JPEG, bit-equal to
  PIL's libjpeg-turbo decode).
- Raw 8-bit ``/DeviceRGB`` and ``/DeviceGray`` samples behind zero or more
  non-image filters (Flate and the rest of ``pdfio.filters``).

Everything else raises NotImplementedError naming its ROADMAP item:
JPX, CCITT and JBIG2 streams, image masks and soft masks, indexed, CMYK,
ICC-based, separation and Lab colour, other bit depths and decode arrays.
"""
from __future__ import annotations

import numpy as np

from ..utils.unported import not_ported
from .cos import Stream
from .filters import decode_stream, image_codec
from .jpeg import decode_jpeg


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
    if isinstance(r(d.get("SMask")), Stream):
        raise not_ported("an image with a soft mask", "pdfio")
    codec = image_codec(d, r)
    if codec in ("DCTDecode", "DCT"):
        return decode_jpeg(decode_stream(stream, r))
    if codec is not None:
        raise not_ported(f"{codec} images", "pdfio")
    if bool(r(d.get("ImageMask", False))):
        raise not_ported("image masks", "pdfio")
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
    return _raw_samples(decode_stream(stream, r), width, height, ncomp)
