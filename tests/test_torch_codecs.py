"""Raw image samples, colour spaces, soft masks and the codec fixture:
the port against the JAX package on the CPU.

The grid: every colour space ``xobject_to_pil`` reads (grey, RGB, CMYK,
CalGray, CalRGB, Lab, ICCBased with 1, 3 and 4 components, Indexed over
grey, RGB and CMYK, Separation, DeviceN of 2 and 3 inks) at 1, 2, 4, 8
and 16 bits, with and without an inverting ``/Decode`` array; soft masks
of every decoded kind (grey of the image's size and of another, RGB, 1
bit, under a decode array; over grey, RGB and Indexed images); and
DCTDecode images coded CMYK, YCCK and progressive. The port's
``xobject_to_array`` must give the JAX package's image, or fail where it
fails (the JAX package's renderer then leaves the background; the port
fails the page). Progressive, CMYK and YCCK JPEG files as image inputs
give ``images_to_pdf``'s bytes.

The fixture (``rapiddoc_tpu_torch/assets/codec_smoke_doc.pdf``), written
by ``make_codec_doc()`` from seeds, holds five US Letter pages:

0. a 200 dpi page of text as JBIG2: a symbol dictionary in
   ``/JBIG2Globals`` and a text region placing its symbols, plus a
   generic-region figure;
1. the same page as CCITT G4;
2. a progressive 4:2:0 JPEG page and a CMYK Adobe JPEG figure;
3. raw images: text as 1 bit with ``/Decode [1 0]``, a 4-bit Indexed
   palette image, 16-bit RGB, a Separation ink and an image with an RGB
   soft mask;
4. a born-digital page: Type3 outline text over an axial ``sh``, a
   radial shading pattern fill, a tiling-pattern hatch and a mesh
   shading.

``codec_smoke_vector.pdf`` is page 4 alone, for the ``auto`` parse.
``codec_smoke_streams.npz`` holds a 300 dpi Letter text page as one JBIG2
generic region and as a G4 strip. The golden (``codec_smoke_golden.json``)
is the JAX package's: every page's raster sha256 at 200 and 72 dpi, the
sha256 of the two 300 dpi bitmaps (decoded with its native loops and
PIL's libtiff), and ``RapidDoc()`` in fp32 with layout, formula and
table off: "ocr" on the fixture, "auto" on the vector page. The port
must give all of them; its bf16 reading (``python
tests/test_torch_codecs.py --compare``) sets ``chip_smoke.py``'s
``CODECS_BF16`` band.

``python tests/test_torch_codecs.py`` rebuilds the fixture files and the
golden (needs PIL, scipy and matplotlib; a few minutes).
"""
import functools
import hashlib
import io
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(1, str(REPO))

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
DOC_PDF = ASSETS / "codec_smoke_doc.pdf"
VECTOR_PDF = ASSETS / "codec_smoke_vector.pdf"
STREAMS_NPZ = ASSETS / "codec_smoke_streams.npz"
GOLDEN_JSON = ASSETS / "codec_smoke_golden.json"
DPIS = (200, 72)
PARSE_ENV = {"RAPIDDOC_DISABLE_LAYOUT": "1", "RAPIDDOC_DISABLE_FORMULA": "1",
             "RAPIDDOC_DISABLE_TABLE": "1"}


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


class _Doc:
    """Just enough of a document for an image dictionary built in code."""

    @staticmethod
    def resolve(x):
        return x

    @staticmethod
    def stream_bytes(s):
        return s.data


def jax_xobject(d: dict, data: bytes):
    """The JAX package's image as an array, or None where it fails."""
    from rapiddoc_tpu.pdfio.cos import Stream
    from rapiddoc_tpu.pdfio.images import xobject_to_pil

    d = {k: (Stream(v[0], v[1]) if isinstance(v, tuple) else v) for k, v in d.items()}
    try:
        img = xobject_to_pil(_Doc(), Stream(d, data))
    except Exception:  # noqa: BLE001 - the JAX renderer leaves the background
        return None
    return None if img is None else np.asarray(img)


def port_xobject(d: dict, data: bytes):
    from rapiddoc_tpu_torch.pdfio.cos import Stream
    from rapiddoc_tpu_torch.pdfio.images import xobject_to_array

    d = {k: (Stream(v[0], v[1]) if isinstance(v, tuple) else v) for k, v in d.items()}
    try:
        return xobject_to_array(_Doc(), Stream(d, data))
    except Exception:  # noqa: BLE001 - compared with the JAX package's failure
        return None


def _icc(n: int):
    from rapiddoc_tpu.pdfio.cos import Stream

    return Stream({"N": n}, b"")


def _port_icc(cs):
    """The same colour space with the port's Stream for an ICC profile."""
    from rapiddoc_tpu_torch.pdfio.cos import Stream

    if isinstance(cs, list) and cs and cs[0] == "ICCBased":
        return ["ICCBased", Stream(dict(cs[1].dict), b"")]
    return cs


# colour space: (the /ColorSpace value, components a sample)
SPACES = {
    "gray": ("DeviceGray", 1), "rgb": ("DeviceRGB", 3), "cmyk": ("DeviceCMYK", 4),
    "calgray": (["CalGray", {"WhitePoint": [0.95, 1, 1.09]}], 1),
    "calrgb": ("CalRGB", 3), "lab": (["Lab", {"WhitePoint": [0.95, 1, 1.09]}], 3),
    "icc1": (["ICCBased", 1], 1), "icc3": (["ICCBased", 3], 3), "icc4": (["ICCBased", 4], 4),
    "indexed_gray": (["Indexed", "DeviceGray", 7, bytes(range(0, 256, 32))], 1),
    "indexed_rgb": (["Indexed", "DeviceRGB", 15, bytes(range(48))], 1),
    "indexed_cmyk": (["Indexed", "DeviceCMYK", 3, bytes([0, 0, 0, 0, 255, 0, 0, 0, 0, 128, 255,
                                                         30, 10, 20, 30, 200])], 1),
    "separation": (["Separation", "Spot", "DeviceCMYK", {"FunctionType": 2}], 1),
    "devicen2": (["DeviceN", ["A", "B"], "DeviceCMYK", {"FunctionType": 2}], 2),
    "devicen3": (["DeviceN", ["A", "B", "C"], "DeviceRGB", {"FunctionType": 2}], 3),
}


def _space(name: str):
    cs, n = SPACES[name]
    if isinstance(cs, list) and cs[0] == "ICCBased":
        cs = ["ICCBased", _icc(cs[1])]
    return cs, n


def _samples(rng, w: int, h: int, n: int, bpc: int) -> bytes:
    row = (w * n * bpc + 7) // 8
    return bytes(rng.integers(0, 256, row * h, dtype=np.uint8)) + bytes(int(rng.integers(0, 3)))


@pytest.mark.parametrize("space", list(SPACES))
@pytest.mark.parametrize("bpc", [1, 2, 4, 8, 16])
def test_raw_samples_equal_jax(space, bpc):
    """Each colour space at each depth, plain and under an inverting (or,
    for Indexed, a shuffling) decode array; stream lengths one to two
    bytes long or short of the rows."""
    rng = np.random.default_rng(len(space) * 31 + bpc)
    cs, n = _space(space)
    for w, h in ((1, 1), (5, 3), (13, 7)):
        data = _samples(rng, w, h, n, bpc)
        if rng.random() < 0.3:
            data = data[:-1]
        maxv = float((1 << min(bpc, 8)) - 1)
        for decode in (None, [maxv if space.startswith("indexed") else 1.0, 0.0] * n):
            d = {"Type": "XObject", "Subtype": "Image", "Width": w, "Height": h,
                 "BitsPerComponent": bpc, "ColorSpace": cs}
            if decode is not None:
                d["Decode"] = decode
            want = jax_xobject(d, data)
            got = port_xobject(dict(d, ColorSpace=_port_icc(cs)), data)
            assert (got is None) == (want is None), (w, h, decode)
            if got is not None:
                assert got.dtype == np.uint8 and np.array_equal(got, want), (w, h, decode)


# soft mask: (dictionary entries, width, height, components, bits)
SMASKS = {
    "gray_same": ({"ColorSpace": "DeviceGray", "BitsPerComponent": 8}, 9, 6, 1, 8),
    "gray_smaller": ({"ColorSpace": "DeviceGray", "BitsPerComponent": 8}, 4, 3, 1, 8),
    "rgb": ({"ColorSpace": "DeviceRGB", "BitsPerComponent": 8}, 7, 11, 3, 8),
    "one_bit_decode": ({"ColorSpace": "DeviceGray", "BitsPerComponent": 1,
                        "Decode": [1, 0]}, 9, 6, 1, 1),
    "indexed": ({"ColorSpace": ["Indexed", "DeviceRGB", 3, bytes(range(12))],
                 "BitsPerComponent": 2}, 8, 6, 1, 2),
}


@pytest.mark.parametrize("smask", list(SMASKS))
@pytest.mark.parametrize("base", ["gray", "rgb", "indexed_rgb"])
def test_soft_masks_equal_jax(smask, base):
    """An /SMask of each decoded kind through PIL's convert("L"), resized
    BICUBIC where it differs from the image, becomes alpha."""
    rng = np.random.default_rng(len(smask) + 7 * len(base))
    sd, sw, sh, sn, sbpc = SMASKS[smask]
    sdata = _samples(rng, sw, sh, sn, sbpc)
    cs, n = _space(base)
    w, h = 9, 6
    d = {"Type": "XObject", "Subtype": "Image", "Width": w, "Height": h, "BitsPerComponent": 8,
         "ColorSpace": cs,
         "SMask": (dict(sd, Type="XObject", Subtype="Image", Width=sw, Height=sh), sdata)}
    data = _samples(rng, w, h, n, 8)
    want = jax_xobject(d, data)
    got = port_xobject(d, data)
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got, want)


@functools.lru_cache(maxsize=1)
def _jpeg_forms() -> dict[str, bytes]:
    from PIL import Image

    from torch_jpeg_forms import hand_jpeg

    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (21, 37, 3), dtype=np.uint8)
    out = {}
    for name, mode, kw in (("cmyk", "CMYK", {}), ("cmyk_progressive", "CMYK", {"progressive": True}),
                           ("progressive_420", "RGB", {"progressive": True, "subsampling": 2}),
                           ("grey_progressive", "L", {"progressive": True})):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, format="JPEG", **kw)
        out[name] = buf.getvalue()
    out["ycck"] = hand_jpeg(37, 21, [(2, 2), (1, 1), (1, 1), (2, 2)], rng, adobe=2)
    out["rgb_coded"] = hand_jpeg(37, 21, [(1, 1)] * 3, rng, adobe=0)
    return out


@pytest.mark.parametrize("name", ["cmyk", "cmyk_progressive", "progressive_420",
                                  "grey_progressive", "ycck", "rgb_coded"])
def test_dct_images_equal_jax(name):
    """DCTDecode images of the forms the JAX package reads through PIL;
    CMYK and YCCK through ``_cmyk_to_rgb(255 - arr)``, with a soft mask."""
    data = _jpeg_forms()[name]
    d = {"Type": "XObject", "Subtype": "Image", "Width": 37, "Height": 21,
         "BitsPerComponent": 8, "ColorSpace": "DeviceRGB", "Filter": "DCTDecode"}
    want, got = jax_xobject(d, data), port_xobject(d, data)
    assert want is not None and np.array_equal(got, want)
    d["SMask"] = ({"Type": "XObject", "Subtype": "Image", "Width": 5, "Height": 4,
                   "ColorSpace": "DeviceGray", "BitsPerComponent": 8}, bytes(range(0, 200, 10)))
    assert np.array_equal(port_xobject(d, data), jax_xobject(d, data))


@pytest.mark.parametrize("name", ["progressive_420", "grey_progressive", "cmyk",
                                  "cmyk_progressive", "ycck"])
def test_jpeg_files_through_images_to_pdf_equal_jax(name):
    """Progressive and CMYK JPEG files as image inputs: ``images_to_pdf``
    (a CMYK image through Pillow's own ``convert("RGB")``, then q92)
    writes the JAX package's bytes."""
    from rapiddoc_tpu.pdfio.writer import images_to_pdf as jax_images_to_pdf
    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf

    data = _jpeg_forms()[name]
    assert images_to_pdf([data], dpi=144) == jax_images_to_pdf([data], dpi=144)


# ------------------------------------------------------------------ fixture

TEXT_PX = 40  # text size on the 200 dpi pages (about 14 pt)


def _text_page(seed: int, w: int, h: int, lines: int, color: bool = False) -> np.ndarray:
    """A page image of text lines (DejaVu Sans from matplotlib, random
    words), white or tinted, uint8 RGB."""
    from matplotlib import font_manager
    from PIL import Image, ImageDraw, ImageFont

    import test_torch_vector as tv

    font = ImageFont.truetype(font_manager.findfont("DejaVu Sans"), TEXT_PX)
    bg = (250, 246, 232) if color else (255, 255, 255)
    img = Image.new("RGB", (w, h), bg)
    draw = ImageDraw.Draw(img)
    ink = [(20, 30, 120), (120, 20, 20), (10, 10, 10)] if color else [(0, 0, 0)]
    y = int(h * 0.08)
    for i, line in enumerate(tv._text_lines(seed, lines, 48)):
        draw.text((int(w * 0.08), y), line, font=font, fill=ink[i % len(ink)])
        y += int(TEXT_PX * 1.9)
    return np.asarray(img)


def _figure_bits(w: int, h: int, seed: int) -> np.ndarray:
    """A line-art figure (axes, a curve, bars) as 1 = black."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((h, w), np.uint8)
    bits[h - 12:h - 8, 10:w - 10] = 1
    bits[10:h - 8, 10:14] = 1
    xs = np.arange(20, w - 20)
    ys = (h / 2 + h / 3 * np.sin(xs / 23.0)).astype(int)
    for dy in range(3):
        bits[np.clip(ys + dy, 0, h - 1), xs] = 1
    for i in range(6):
        x0 = 40 + i * (w - 80) // 6
        top = int(rng.integers(h // 4, h - 30))
        bits[top:h - 12, x0:x0 + 18] = 1
    return bits


def _binarize(rgb: np.ndarray) -> np.ndarray:
    return (rgb.mean(axis=2) < 128).astype(np.uint8)


def _jbig2_text(bits: np.ndarray, figure: np.ndarray, fig_xy) -> tuple[bytes, bytes]:
    """(page stream, globals): the text's connected components as symbols
    in a dictionary (globals), placed by one text region, and ``figure``
    as a generic region ORed on at ``fig_xy``."""
    from scipy import ndimage

    import jbig2_encoder as E

    h, w = bits.shape
    labels, count = ndimage.label(bits, structure=np.ones((3, 3)))
    symbols, index, places = [], {}, []
    for i, sl in enumerate(ndimage.find_objects(labels), 1):
        sym = (labels[sl] == i).astype(np.uint8)
        key = (sym.shape, sym.tobytes())
        if key not in index:
            index[key] = len(symbols)
            symbols.append(sym)
        places.append((index[key], sl[1].start, sl[0].start))
    dict_seg, order = E.symbol_dict_segment(2, symbols, page=0)
    export = [symbols[i] for i in order]
    rank = {old: new for new, old in enumerate(order)}
    places = [(rank[s], x, y) for s, x, y in places]
    page = (E.segment(1, 48, [], 1, E.page_info(w, h))
            + E.text_region_segment(3, 2, export, places, w, h)
            + E.generic_region_segment(4, figure, x=fig_xy[0], y=fig_xy[1], template=1,
                                       tpgdon=True))
    return page, dict_seg


def _g4(bits: np.ndarray) -> bytes:
    from test_torch_ccitt import libtiff_strip

    return libtiff_strip(bits, -1)


def _jpeg(arr: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _vector_content() -> str:
    import test_torch_vector as tv

    ops = ["q 0 0 612 792 re W n /Ax sh Q"]
    ops.append("0 g " + tv._show("T1", 20, 72, 720, "Gradients, Patterns and Meshes"))
    y = 690
    for line in tv._text_lines(41, 6, 80):
        ops.append(tv._show("T1", 11, 72, y, line))
        y -= 16
    ops.append("q /Pattern cs /Rp scn 72 330 m 300 330 l 300 560 l 72 560 l h f Q")
    ops.append("q /Pattern cs /Hp scn 330 330 m 540 330 l 540 560 l 330 560 l h f "
               "0 G 1 w 330 330 210 230 re S Q")
    ops.append("q 72 90 m 300 90 l 186 300 l h W n /Me sh Q")
    ops.append("0 g " + tv._show("T1", 11, 330, 300, "A radial fill, a hatch and a mesh."))
    for i, line in enumerate(tv._text_lines(43, 4, 40)):
        ops.append(tv._show("T1", 11, 330, 270 - 16 * i, line))
    return "\n".join(ops)


def make_codec_doc(with_streams: bool = True) -> tuple[bytes, bytes, dict[str, np.ndarray]]:
    """(the five-page fixture, its vector page alone, the 300 dpi streams
    unless ``with_streams`` is false), all from seeds."""
    from PIL import Image

    from rapiddoc_tpu.pdfio.cos import Name, Stream
    from rapiddoc_tpu.pdfio.writer import PdfWriter

    import jbig2_encoder as E
    import test_torch_vector as tv

    N = Name
    W200, H200 = 1700, 2200

    def build(which: list[int]) -> bytes:
        w = PdfWriter()
        pages_ref = w.reserve()

        def stream(d: dict, data: bytes, flate: bool = False):
            d = {N(k) if isinstance(k, str) else k: v for k, v in d.items()}
            if flate:
                d[N("Filter")] = N("FlateDecode")
                data = zlib.compress(data, 9)
            return w.add(Stream(d, data))

        def image(wd, ht, data, _flate=False, **extra):
            d = {"Type": N("XObject"), "Subtype": N("Image"), "Width": wd, "Height": ht}
            d.update(extra)
            return stream(d, data, flate=_flate)

        kids = []

        def page(content: str, resources: dict):
            kids.append(w.add({N("Type"): N("Page"), N("Parent"): pages_ref,
                               N("MediaBox"): [0, 0, 612, 792], N("Resources"): resources,
                               N("Contents"): stream({}, content.encode(), flate=True)}))

        full = "q 612 0 0 792 0 0 cm /Im Do Q"
        text = _binarize(_text_page(11, W200, H200, 14))
        figure = _figure_bits(520, 300, 12)
        if 0 in which:
            page_stream, glob = _jbig2_text(text, figure, (1000, 1750))
            gref = stream({}, glob)
            im = image(W200, H200, page_stream, BitsPerComponent=1, ColorSpace=N("DeviceGray"),
                       Filter=N("JBIG2Decode"), DecodeParms={N("JBIG2Globals"): gref})
            page(full, {N("XObject"): {N("Im"): im}})
        if 1 in which:
            combined = text.copy()
            combined[1750:2050, 1000:1520] |= figure
            im = image(W200, H200, _g4(combined), BitsPerComponent=1, ColorSpace=N("DeviceGray"),
                       Filter=N("CCITTFaxDecode"),
                       DecodeParms={N("K"): -1, N("Columns"): W200, N("BlackIs1"): False})
            page(full, {N("XObject"): {N("Im"): im}})
        if 2 in which:
            prog = _jpeg(_text_page(21, 850, 1100, 8, color=True), quality=85, progressive=True,
                         subsampling=2)
            rng = np.random.default_rng(22)
            yy, xx = np.mgrid[0:240, 0:400]
            fig = np.stack([(xx * 0.6) % 256, (yy + 30) % 256, 128 + 90 * np.sin(xx / 17.0)],
                           -1).astype(np.uint8)
            fig = np.clip(fig.astype(int) + rng.integers(-10, 11, fig.shape), 0, 255)
            buf = io.BytesIO()
            Image.fromarray(fig.astype(np.uint8)).convert("CMYK").save(buf, format="JPEG",
                                                                       quality=88)
            im = image(850, 1100, prog, BitsPerComponent=8, ColorSpace=N("DeviceRGB"),
                       Filter=N("DCTDecode"))
            cm = image(400, 240, buf.getvalue(), BitsPerComponent=8, ColorSpace=N("DeviceCMYK"),
                       Filter=N("DCTDecode"), Decode=[1, 0, 1, 0, 1, 0, 1, 0])
            page(full + " q 240 0 0 144 300 60 cm /Cm Do Q",
                 {N("XObject"): {N("Im"): im, N("Cm"): cm}})
        if 3 in which:
            rng = np.random.default_rng(31)
            words = _binarize(_text_page(32, 1400, 700, 6))
            one_bit = np.packbits(words, axis=1).tobytes()  # 1 = black under Decode [1 0]
            idx = (np.add.outer(np.arange(120) // 8, np.arange(160) // 10) % 16).astype(np.uint8)
            packed4 = ((idx[:, 0::2] << 4) | idx[:, 1::2]).tobytes()
            palette = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
            yy, xx = np.mgrid[0:90, 0:150]
            rgb16 = np.stack([xx * 400, yy * 700, (xx + yy) * 250], -1).astype(">u2").tobytes()
            sep = (np.add.outer(np.arange(80), np.arange(120)) % 256).astype(np.uint8).tobytes()
            body = np.stack([(xx * 1.7) % 256, (yy * 2.8) % 256, 200 - yy], -1).astype(np.uint8)
            alpha_rgb = np.stack([255 - xx * 1.5, yy * 2.5, np.full_like(xx, 128)], -1)
            alpha_rgb = np.clip(alpha_rgb, 0, 255).astype(np.uint8)
            smask = image(150, 90, alpha_rgb.tobytes(), BitsPerComponent=8,
                          ColorSpace=N("DeviceRGB"), _flate=True)
            xobjs = {
                N("Tx"): image(1400, 700, one_bit, BitsPerComponent=1,
                               ColorSpace=N("DeviceGray"), Decode=[1, 0], _flate=True),
                N("Ix"): image(160, 120, packed4, BitsPerComponent=4,
                               ColorSpace=[N("Indexed"), N("DeviceRGB"), 15, palette],
                               _flate=True),
                N("R16"): image(150, 90, rgb16, BitsPerComponent=16, ColorSpace=N("DeviceRGB"),
                                _flate=True),
                N("Sp"): image(120, 80, sep, BitsPerComponent=8,
                               ColorSpace=[N("Separation"), N("Spot"), N("DeviceCMYK"),
                                           {N("FunctionType"): 2, N("Domain"): [0, 1],
                                            N("C0"): [0, 0, 0, 0], N("C1"): [0, 0.8, 0.6, 0],
                                            N("N"): 1}], _flate=True),
                N("Sm"): image(150, 90, body.tobytes(), BitsPerComponent=8,
                               ColorSpace=N("DeviceRGB"), SMask=smask, _flate=True),
            }
            content = ("q 504 0 0 252 54 500 cm /Tx Do Q q 160 0 0 120 60 330 cm /Ix Do Q "
                       "q 150 0 0 90 250 360 cm /R16 Do Q q 120 0 0 80 430 360 cm /Sp Do Q "
                       "0.9 0.9 0.2 rg 60 60 300 200 re f q 225 0 0 135 100 100 cm /Sm Do Q")
            page(content, {N("XObject"): xobjs})
        if 4 in which:
            glyphs = tv._outline_glyphs()
            procs = {N(tv._name(ch)): stream({}, proc, flate=True)
                     for ch, (_, proc) in glyphs.items()}
            codes = sorted(ord(ch) for ch in glyphs)
            diffs = []
            for code in codes:
                diffs += [code, N(tv._name(chr(code)))]
            widths = [round(glyphs[chr(c)][0], 2) if chr(c) in glyphs else 0
                      for c in range(codes[0], codes[-1] + 1)]
            font = w.add({N("Type"): N("Font"), N("Subtype"): N("Type3"),
                          N("FontBBox"): [-1100, -300, 1900, 1000],
                          N("FontMatrix"): [0.001, 0, 0, 0.001, 0, 0], N("CharProcs"): procs,
                          N("Resources"): {}, N("FirstChar"): codes[0], N("LastChar"): codes[-1],
                          N("Encoding"): {N("Type"): N("Encoding"), N("Differences"): diffs},
                          N("Widths"): widths})

            def fn2(c0, c1, n=1):
                return {N("FunctionType"): 2, N("Domain"): [0, 1], N("C0"): c0, N("C1"): c1,
                        N("N"): n}

            axial = {N("ShadingType"): 2, N("ColorSpace"): N("DeviceRGB"),
                     N("Coords"): [0, 0, 612, 792], N("Extend"): [True, True],
                     N("Function"): fn2([1, 1, 1], [0.85, 0.9, 1.0])}
            radial = {N("ShadingType"): 3, N("ColorSpace"): N("DeviceRGB"),
                      N("Coords"): [186, 445, 10, 186, 445, 150], N("Extend"): [False, True],
                      N("Function"): {N("FunctionType"): 3, N("Domain"): [0, 1],
                                      N("Bounds"): [0.5], N("Encode"): [0, 1, 0, 1],
                                      N("Functions"): [fn2([1, 0.9, 0.3], [0.9, 0.4, 0.1]),
                                                       fn2([0.9, 0.4, 0.1], [0.3, 0.1, 0.5])]}}
            hatch = stream({"PatternType": 1, "PaintType": 1, "TilingType": 1,
                            "BBox": [0, 0, 10, 10], "XStep": 10, "YStep": 10,
                            "Resources": {}},
                           b"0.2 0.3 0.7 RG 0.8 w 0 0 m 10 10 l S 0 5 m 5 10 l S 5 0 m 10 5 l S")
            mesh = stream({"ShadingType": 4, "ColorSpace": N("DeviceRGB"),
                           "BitsPerCoordinate": 8, "BitsPerComponent": 8, "BitsPerFlag": 8,
                           "Decode": [0, 612, 0, 792, 0, 1],
                           "Function": fn2([0.2, 0.7, 0.4], [0.9, 0.9, 0.2])}, bytes(12))
            resources = {N("Font"): {N("T1"): font},
                         N("Shading"): {N("Ax"): axial, N("Me"): mesh},
                         N("Pattern"): {N("Rp"): {N("PatternType"): 2, N("Shading"): radial},
                                        N("Hp"): hatch}}
            page(_vector_content(), resources)
        w.set(pages_ref, {N("Type"): N("Pages"), N("Kids"): kids, N("Count"): len(kids)})
        root = w.add({N("Type"): N("Catalog"), N("Pages"): pages_ref})
        return w.tobytes(root)

    if not with_streams:
        return build([0, 1, 2, 3, 4]), build([4]), {}
    # the 300 dpi Letter page as one generic region and as a G4 strip (the
    # test encoder codes its 8.4 M pixels in about 25 s)
    text300 = _binarize(_text_page(51, 2550, 3300, 22))
    generic = (E.segment(1, 48, [], 1, E.page_info(2550, 3300))
               + E.generic_region_segment(2, text300, template=0, tpgdon=True))
    streams = {"jbig2_generic_300": np.frombuffer(generic, np.uint8),
               "g4_300": np.frombuffer(_g4(text300), np.uint8)}
    return build([0, 1, 2, 3, 4]), build([4]), streams


# ------------------------------------------------------------------- golden

def jax_pages(pdf: bytes) -> dict:
    from rapiddoc_tpu.pdfio import open_pdf
    from rapiddoc_tpu.pdfio.render import render_page_full

    doc = open_pdf(pdf)
    out = {}
    for dpi in DPIS:
        out[str(dpi)] = [sha256(np.asarray(render_page_full(doc.get_page(i), dpi=dpi,
                                                            with_text=False)[0]))
                         for i in range(len(doc))]
    return out


def jax_bitmaps(streams: dict) -> dict:
    """The JAX package's decode of the 300 dpi streams (its native JBIG2
    loops, PIL's libtiff), as the images ``xobject_to_pil`` gives."""
    from rapiddoc_tpu.pdfio import jbig2
    from rapiddoc_tpu.utils import native

    assert native.lib() is not None and hasattr(native.lib(), "jbig2_mq_new")
    bitmap = jbig2.decode(streams["jbig2_generic_300"].tobytes(), None, 2550, 3300)
    g4 = jax_xobject({"Type": "XObject", "Subtype": "Image", "Width": 2550, "Height": 3300,
                      "BitsPerComponent": 1, "ColorSpace": "DeviceGray",
                      "Filter": "CCITTFaxDecode", "DecodeParms": {"K": -1, "Columns": 2550}},
                     streams["g4_300"].tobytes())
    return {"jbig2_generic_300": sha256(((1 - bitmap) * 255).astype(np.uint8)),
            "g4_300": sha256(g4)}


def jax_parse(pdf: bytes, method: str, fp32: bool = True) -> dict:
    from test_torch_image_inputs import clean_env, summary

    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    env = dict(PARSE_ENV, **({"RAPIDDOC_FP32_PARAMS": "1"} if fp32 else {}))
    with clean_env(**env):
        ModelStack._instances.clear()
        got = summary(RapidDoc()(pdf, parse_method=method))
        ModelStack._instances.clear()
    return json.loads(json.dumps(got))


def port_parse(pdf: bytes, method: str, dtype_name: str = "float32") -> dict:
    import torch

    from test_torch_image_inputs import clean_env, summary

    from rapiddoc_tpu_torch import RapidDoc

    with clean_env(**PARSE_ENV):
        got = summary(RapidDoc(device="cpu", dtype=getattr(torch, dtype_name))(
            pdf, parse_method=method))
    return json.loads(json.dumps(got))


def make_golden(pdf: bytes, vector: bytes, streams: dict) -> dict:
    return {
        "source": "rapiddoc_tpu on the CPU (native JBIG2 loops, PIL 12.1 with libjpeg-turbo "
                  "and libtiff 4.7.1): render_page_full, xobject_to_pil, and RapidDoc() with "
                  "layout, formula and table off; rebuilt by tests/test_torch_codecs.py",
        "pages": jax_pages(pdf),
        "vector_pages": jax_pages(vector),
        "bitmaps": jax_bitmaps(streams),
        "ocr_fp32": jax_parse(pdf, "ocr"),
        "auto_fp32": jax_parse(vector, "auto"),
        "ocr_bf16": jax_parse(pdf, "ocr", fp32=False),
    }


# -------------------------------------------------------------- fixture tests

@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(4)


def test_fixture_pdfs_rebuild_from_seeds():
    """The committed PDFs are what the generator writes (the 300 dpi
    streams are rebuilt by the script only; their decode is checked
    against the golden below)."""
    pdf, vector, _ = make_codec_doc(with_streams=False)
    assert pdf == DOC_PDF.read_bytes() and vector == VECTOR_PDF.read_bytes()


@pytest.mark.parametrize("dpi", DPIS)
def test_rasters_equal_golden(dpi, golden):
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    for path, key in ((DOC_PDF, "pages"), (VECTOR_PDF, "vector_pages")):
        doc = open_pdf(path.read_bytes())
        got = [sha256(render_page_full(doc.get_page(i), dpi=dpi, with_text=False)[0])
               for i in range(len(doc))]
        assert got == golden[key][str(dpi)]


def test_300dpi_bitmaps_equal_golden(golden):
    """The JBIG2 generic page and the G4 page at 300 dpi, decoded by the
    compiled loops (g++ build of csrc/bilevel.cu) as on the card; the
    plain loops equal them on a band (here and on the card)."""
    import ctypes
    import shutil
    import subprocess
    import tempfile

    from rapiddoc_tpu_torch.ops import build
    from rapiddoc_tpu_torch.pdfio import ccitt, jbig2

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/bilevel.cu on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libbilevel.so"
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                        str(REPO / "rapiddoc_tpu_torch" / "csrc" / "bilevel.cu"), "-o", str(so)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        saved = build.load
        build.load = lambda name: lib
        try:
            with np.load(STREAMS_NPZ) as z:
                generic, g4 = z["jbig2_generic_300"].tobytes(), z["g4_300"].tobytes()
            bitmap = jbig2.decode(generic, None, 2550, 3300, compiled=True)
            jbig2_band = jbig2.decode(generic, None, 2550, 3300, compiled=False, max_rows=100)
            bits, rows = ccitt.decode_bits_compiled(g4, 2550, 3300, -1)
            band, _ = ccitt.decode_bits_plain(g4, 2550, 400, -1)
        finally:
            build.load = saved
    assert sha256(((1 - bitmap) * 255).astype(np.uint8)) == golden["bitmaps"]["jbig2_generic_300"]
    assert rows == 3300 and sha256(ccitt.to_l(bits, False)) == golden["bitmaps"]["g4_300"]
    assert np.array_equal(band, bits[:400])
    assert np.array_equal(jbig2_band, bitmap[:100])


def test_fp32_parses_equal_golden(golden, few_threads):
    """RapidDoc(device="cpu") in fp32: "ocr" on the fixture and "auto"
    on its vector page give the JAX package's Markdown and content list."""
    got = port_parse(DOC_PDF.read_bytes(), "ocr")
    for part in ("markdown", "content_list"):
        assert got[part] == golden["ocr_fp32"][part], part
    got = port_parse(VECTOR_PDF.read_bytes(), "auto")
    for part in ("markdown", "content_list"):
        assert got[part] == golden["auto_fp32"][part], part


def _compare() -> None:
    """The port's bf16 "ocr" parse on the CPU against the golden's bf16
    Markdown, and the JAX package's own fp32 against its bf16, as
    ``chip_smoke.compare_markdown`` reads them (the source of
    ``CODECS_BF16``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    golden = json.loads(GOLDEN_JSON.read_text())
    got = port_parse(DOC_PDF.read_bytes(), "ocr", "bfloat16")
    for label, a, b in (("port bf16 vs golden bf16", got, golden["ocr_bf16"]),
                        ("jax fp32 vs jax bf16", golden["ocr_fp32"], golden["ocr_bf16"])):
        vs = smoke.compare_markdown(a["markdown"], b["markdown"])
        print(label, {k: vs[k] for k in ("exact_lines", "lines", "exact_share", "cer") if k in vs})


if __name__ == "__main__":
    if "--compare" in sys.argv:
        _compare()
    else:
        pdf, vector, streams = make_codec_doc()
        DOC_PDF.write_bytes(pdf)
        VECTOR_PDF.write_bytes(vector)
        np.savez_compressed(STREAMS_NPZ, **streams)
        GOLDEN_JSON.write_text(json.dumps(make_golden(pdf, vector, streams), indent=1) + "\n")
        print("wrote", DOC_PDF.name, len(pdf), VECTOR_PDF.name, len(vector), STREAMS_NPZ.name,
              STREAMS_NPZ.stat().st_size)
        _compare()
