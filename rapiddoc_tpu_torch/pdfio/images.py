"""Decode PDF image XObjects into numpy arrays.

Port of ``rapiddoc_tpu/pdfio/images.py`` ``xobject_to_pil``, returning
what the JAX package's PIL image holds as an array: (H, W) uint8 for
mode L, (H, W, 2) for LA (the stencil of an image mask), (H, W, 3) for
RGB and (H, W, 4) for RGBA.

- DCTDecode: ``pdfio.jpeg`` (bit-equal to PIL's libjpeg-turbo decode).
  A four-component JPEG comes out as PIL's inverted ``CMYK;I`` and goes
  through ``_cmyk_to_rgb(255 - arr)``, as in the JAX package.
- CCITTFaxDecode: ``pdfio.ccitt``, libtiff's G3/G4 decoder replayed on
  the one-strip TIFF the JAX package wraps the stream in, then PIL's
  ``convert("L")`` of the bilevel image.
- JBIG2Decode: ``pdfio.jbig2`` (with ``/JBIG2Globals``); 1 is black.
- Raw samples behind zero or more non-image filters, with the JAX
  package's quirks: 1, 4, 8 and 16 bits a sample (16 keeps the high
  byte; 2-bit rows are not unpacked), the colour space read by
  ``_colorspace_info`` (ICCBased by ``/N``, CalRGB and Lab as RGB,
  CalGray as grey, Separation and DeviceN inverted, Indexed over grey,
  RGB and CMYK bases, CMYK in float32 and truncated), the ``/Decode``
  array in float32, and low bit depths stretched to 8 bits.
- Image masks (``/ImageMask true``, 1 bit a sample, ``/Decode [1 0]``
  flipping it): L is 255 where the mask paints, A is 255.
- Soft masks: an ``/SMask`` of any decoded kind through PIL's
  ``convert("L")`` (ITU-R 601 in 16-bit fixed point; the L of LA),
  resized BICUBIC to the image's size when it differs
  (``pil_resample.resize``), becomes alpha.

- JPXDecode: ``pdfio.jpx`` (PIL's image over OpenJPEG) in PIL's own
  mode, as the JAX package keeps it: ``/ColorSpace``, ``/Decode`` and
  ``/SMaskInData`` are ignored; ``I;16`` comes back as (H, W) uint16,
  which ``convert("L")`` and ``convert("RGB(A)")`` clip at 255, and an
  ``LA`` image is drawn as a stencil, as the JAX renderer draws it.

Where the JAX package's decode fails (a corrupt stream, a colour space
PIL cannot hold), this module raises and the page fails; the JAX
renderer leaves the background there.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..utils.unported import not_ported
from .cos import Stream
from .filters import decode_stream, image_codec
from .jpeg import decode_jpeg
from .pil_resample import resize


def _apply_decode_array(arr: np.ndarray, decode: list, bpc: int) -> np.ndarray:
    """A /Decode remap of integer samples, in float32 as the JAX package
    does it: ``lo + v * (hi - lo) / maxval``, times maxval, clipped and
    truncated."""
    if not decode:
        return arr
    maxval = (1 << bpc) - 1
    out = arr.astype(np.float32)
    ncomp = 1 if arr.ndim == 2 else arr.shape[2]
    for c in range(ncomp):
        lo, hi = float(decode[2 * c]), float(decode[2 * c + 1])
        comp = out[..., c] if arr.ndim == 3 else out
        comp = lo + comp * (hi - lo) / maxval
        comp = comp * maxval
        if arr.ndim == 3:
            out[..., c] = comp
        else:
            out = comp
    return np.clip(out, 0, maxval).astype(arr.dtype)


def _unpack_bits(data: bytes, width: int, height: int, ncomp: int, bpc: int) -> np.ndarray:
    """Samples as the JAX package unpacks them: rows padded to bytes, a
    short stream zero-padded, 16 bits cut to the high byte, and any depth
    but 1, 4, 8 and 16 taken as raw bytes (so a 2-bit image whose packed
    row is shorter than its sample count fails to reshape)."""
    row_bytes = (width * ncomp * bpc + 7) // 8
    need = row_bytes * height
    if len(data) < need:
        data = data + b"\x00" * (need - len(data))
    buf = np.frombuffer(data[:need], dtype=np.uint8).reshape(height, row_bytes)
    if bpc == 1:
        arr = np.unpackbits(buf, axis=1)[:, : width * ncomp]
    elif bpc == 4:
        arr = np.empty((height, row_bytes * 2), dtype=np.uint8)
        arr[:, 0::2] = buf >> 4
        arr[:, 1::2] = buf & 0x0F
        arr = arr[:, : width * ncomp]
    elif bpc == 16:
        arr = (buf.view(">u2")[:, : width * ncomp] >> 8).astype(np.uint8)
    else:
        arr = buf[:, : width * ncomp]
    if ncomp > 1:
        return arr.reshape(height, width, ncomp)
    return arr.reshape(height, width)


def _colorspace_info(doc, cs: Any) -> tuple[str, int, Any]:
    """(family, components, extra) as the JAX package reads a colour
    space; extra is (base family, base components, lookup bytes) for an
    Indexed space."""
    cs = doc.resolve(cs)
    if cs is None:
        return ("DeviceGray", 1, None)
    if isinstance(cs, str):
        if cs in ("DeviceRGB", "CalRGB"):
            return ("DeviceRGB", 3, None)
        if cs == "DeviceCMYK":
            return ("DeviceCMYK", 4, None)
        return ("DeviceGray", 1, None)
    if isinstance(cs, list) and cs:
        family = str(doc.resolve(cs[0]))
        if family == "ICCBased":
            stream = doc.resolve(cs[1]) if len(cs) > 1 else None
            n = 3
            if isinstance(stream, Stream):
                n = int(doc.resolve(stream.dict.get("N", 3)) or 3)
            return ({1: "DeviceGray", 3: "DeviceRGB", 4: "DeviceCMYK"}.get(n, "DeviceRGB"), n,
                    None)
        if family == "Indexed":
            base_family, base_n, _ = _colorspace_info(doc, cs[1])
            lookup = doc.resolve(cs[3]) if len(cs) > 3 else b""
            if isinstance(lookup, Stream):
                lookup = doc.stream_bytes(lookup)
            return ("Indexed", 1, (base_family, base_n, bytes(lookup or b"")))
        if family in ("CalRGB", "Lab"):
            return ("DeviceRGB", 3, None)
        if family == "CalGray":
            return ("DeviceGray", 1, None)
        if family in ("Separation", "DeviceN"):
            n = 1
            if family == "DeviceN" and len(cs) > 1:
                names = doc.resolve(cs[1])
                n = len(names) if isinstance(names, list) else 1
            return ("Separation", n, None)
    return ("DeviceGray", 1, None)


def _cmyk_to_rgb(arr: np.ndarray) -> np.ndarray:
    """The JAX package's naive CMYK to RGB, in float32, truncated."""
    c, m, y, k = [arr[..., i].astype(np.float32) / 255.0 for i in range(4)]
    r = (1 - c) * (1 - k)
    g = (1 - m) * (1 - k)
    b = (1 - y) * (1 - k)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _stretch(arr: np.ndarray, bpc: int) -> np.ndarray:
    """Samples of fewer than 8 bits to 0-255, in float32, truncated."""
    if bpc < 8:
        return (arr.astype(np.float32) * (255.0 / ((1 << bpc) - 1))).astype(np.uint8)
    return arr


def _from_array(arr: np.ndarray) -> np.ndarray:
    """``Image.fromarray`` of a uint8 array: 2 to 4 channels are LA, RGB
    or RGBA; more raise, as PIL does."""
    if arr.ndim == 3 and arr.shape[2] == 1:
        return arr[..., 0]
    if arr.ndim == 3 and not 2 <= arr.shape[2] <= 4:
        raise TypeError(f"an image of {arr.shape[2]} channels")
    return arr


def clip16(img: np.ndarray) -> np.ndarray:
    """An ``I;16`` image's grey levels as PIL converts them to 8 bits
    (``I16_L``, ``I16_RGB``: above 255 reads 255); other images as they
    are."""
    if img.dtype == np.uint16:
        return np.minimum(img, 255).astype(np.uint8)
    return img


def convert_l(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")``: grey as it is (``I;16`` clipped), the L of
    LA, and RGB(A) as ITU-R 601 luma in 16-bit fixed point (alpha
    ignored)."""
    if img.ndim == 2:
        return clip16(img)
    if img.shape[2] == 2:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _parms(d: dict, r, key: str) -> dict:
    """The decode parameters of the filter that carries ``key`` (the first
    dictionary holding it when /DecodeParms is an array)."""
    parms = r(d.get("DecodeParms") or d.get("DP")) or {}
    if isinstance(parms, list):
        parms = next((r(p) for p in parms if isinstance(r(p), dict) and key in r(p)), {}) or {}
    return parms if isinstance(parms, dict) else {}


def xobject_to_array(doc, stream: Stream) -> np.ndarray | None:
    """Decode an image XObject (or inline image) as the JAX package's
    ``xobject_to_pil`` does: None for an image without a size or an
    Indexed image with an empty palette."""
    d = stream.dict
    r = doc.resolve
    width = int(r(d.get("Width", 0)) or 0)
    height = int(r(d.get("Height", 0)) or 0)
    if width <= 0 or height <= 0:
        return None
    codec = image_codec(d, r)
    if codec in ("DCTDecode", "DCT"):
        img = decode_jpeg(decode_stream(stream, r))
        if img.ndim == 3 and img.shape[2] == 4:  # PIL's CMYK;I (Adobe inversion)
            img = _cmyk_to_rgb(255 - img)
    elif codec in ("CCITTFaxDecode", "CCF"):
        from .ccitt import decode_ccitt

        parms = {k: r(v) for k, v in _parms(d, r, "K").items()}
        parms.setdefault("Columns", width)
        img = decode_ccitt(decode_stream(stream, r), int(parms.get("Columns", width)), height,
                           parms)
    elif codec == "JBIG2Decode":
        from .jbig2 import decode as jbig2_decode

        gs = r(_parms(d, r, "JBIG2Globals").get("JBIG2Globals"))
        glob = None
        if gs is not None:
            try:
                glob = decode_stream(gs, r)
            except Exception:  # noqa: BLE001 - the JAX package decodes without them
                glob = None
        bitmap = jbig2_decode(decode_stream(stream, r), glob, width, height)
        img = ((1 - bitmap) * 255).astype(np.uint8)  # 1 is black
    elif codec == "JPXDecode":
        from .jpx import jpx_mode

        img = jpx_mode(decode_stream(stream, r))[1]
    elif codec is not None:
        raise not_ported(f"{codec} images", "pdfio")
    elif bool(r(d.get("ImageMask", False))):
        return _stencil(decode_stream(stream, r), width, height, r(d.get("Decode")), r)
    else:
        img = _raw_image(doc, decode_stream(stream, r), d, width, height)
        if img is None:
            return None
    smask = r(d.get("SMask"))
    if isinstance(smask, Stream):
        alpha = xobject_to_array(doc, smask)
        if alpha is not None:
            alpha = resize(convert_l(alpha), img.shape[1], img.shape[0], "bicubic")
            img = clip16(img)
            if img.ndim == 2 or img.shape[2] == 2:
                rgb = np.repeat(img[..., :1] if img.ndim == 3 else img[..., None], 3, 2)
            else:
                rgb = img[..., :3]
            img = np.concatenate([rgb, alpha[..., None]], axis=2)
    return img


def _stencil(data: bytes, width: int, height: int, decode, r) -> np.ndarray:
    """An image mask as the JAX package's LA image: 1-bit samples (rows
    padded to bytes), 0 paints unless ``/Decode [1 0]``."""
    bits = _unpack_bits(data, width, height, 1, 1)
    if isinstance(decode, list) and float(r(decode[0])) == 1.0:
        bits = 1 - bits
    out = np.full((height, width, 2), 255, np.uint8)
    out[..., 0] = (1 - bits) * 255
    return out


def _raw_image(doc, data: bytes, d: dict, width: int, height: int) -> np.ndarray | None:
    """Raw samples in any colour space and bit depth, as the JAX
    package's raw branch of ``xobject_to_pil``."""
    r = doc.resolve
    bpc = int(r(d.get("BitsPerComponent", 8)) or 8)
    family, ncomp, extra = _colorspace_info(doc, d.get("ColorSpace") or d.get("CS"))
    arr = _unpack_bits(data, width, height, ncomp, bpc)
    decode = r(d.get("Decode") or d.get("D"))
    if isinstance(decode, list):
        decode = [float(r(v)) for v in decode]
        arr = _apply_decode_array(arr, decode, bpc if bpc <= 8 else 8)
    if family == "Indexed":
        _, base_n, lookup = extra
        pal = np.frombuffer(lookup, dtype=np.uint8)
        entries = len(pal) // base_n if base_n else 0
        if entries == 0:
            return None
        pal = pal[: entries * base_n].reshape(entries, base_n)
        out = pal[np.clip(arr, 0, entries - 1)]
        if extra[0] == "DeviceCMYK":
            out = _cmyk_to_rgb(out)
        elif base_n == 1:
            out = out[..., 0]
        return _from_array(out)
    if family == "DeviceCMYK":
        return _cmyk_to_rgb(_stretch(arr, bpc))
    if ncomp == 3:
        return _stretch(arr, bpc)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = _stretch(arr, bpc)
    if family == "Separation":
        arr = 255 - arr  # ink amount -> luminance
    return arr.astype(np.uint8)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a decoded image: grey (``I;16``
    clipped) and the L of LA repeated, alpha dropped."""
    img = clip16(img)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, 2)
    if img.shape[2] == 2:
        return np.repeat(img[..., :1], 3, 2)
    return np.ascontiguousarray(img[..., :3])
