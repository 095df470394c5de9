"""Inputs, fixtures and the golden of the WEBP and JPEG 2000 slice.

Every input is made from numpy seeds and encoded by PIL (Pillow 12.1
over libwebp 1.6 and OpenJPEG 2.5.4); the few forms PIL's writers do not
produce (a first animation frame smaller than its canvas, an sYCC JP2)
are edited from PIL's output by hand. ``tests/test_torch_webp.py`` and
``tests/test_torch_jpx.py`` hold the port against PIL and the JAX package
on them; ``python tests/test_torch_webp.py --golden`` rebuilds the
committed fixtures and the golden with ``write_all()``:

- ``webp_jpx_page.webp``: a page of the layout fixture's generator, as a
  photograph of a document (enlarged to 1700 x 2200, tinted, grain),
  lossy WEBP q75;
- ``webp_jpx_scan.pdf``: a US Letter page whose only content is a 300 dpi
  grey scan of another page, a JPXDecode JP2 (9/7, one layer at 1:20);
- ``webp_jpx_matrix.npz``: small WEBP and JPEG 2000 files of every form,
  with PIL's modes and the sha256 of PIL's pixels, which ``chip_smoke.py``
  decodes with the compiled loops (the card's machine has no PIL);
- ``webp_jpx_golden.json``: the JAX package's reading: PIL's pixels of
  the page and of the scan, ``images_to_pdf``'s bytes of the page, the
  scan page rendered at 200 dpi, and ``RapidDoc()`` in fp32 and bf16 with
  the demo layout and the formula stage (tables off) on the page's path,
  its bytes with no suffix and the scan PDF.
"""
from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(1, str(REPO))

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
PAGE_WEBP = ASSETS / "webp_jpx_page.webp"
SCAN_PDF = ASSETS / "webp_jpx_scan.pdf"
MATRIX_NPZ = ASSETS / "webp_jpx_matrix.npz"
GOLDEN_JSON = ASSETS / "webp_jpx_golden.json"
DPI = 200  # get_pdf_render_dpi()
PARSE_ENV = {"RAPIDDOC_DEMO_LAYOUT": "1", "RAPIDDOC_DISABLE_TABLE": "1"}
PAGE_SIZE = (1700, 2200)
SCAN_SIZE = (2550, 3300)


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


# ------------------------------------------------------------ test images

def smooth(seed: int, w: int, h: int, mode: str = "RGB"):
    """A PIL image of smooth colour fields (bicubic from a seeded coarse
    grid) with a dark band, in ``mode``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 4)).astype(np.uint8)
    a = np.asarray(Image.fromarray(small, "RGBA").resize((w, h), Image.BICUBIC)).copy()
    a[h // 3:h // 3 + 3, :, :3] = 0
    if mode == "L":
        return Image.fromarray(a[..., 0])
    if mode == "LA":
        return Image.fromarray(a[..., [0, 3]], "LA")
    if mode == "I;16":
        return Image.fromarray((a[..., 0].astype(np.uint16) * 257 + a[..., 1] // 16)
                               .astype(np.uint16))
    return Image.fromarray(a if mode == "RGBA" else a[..., :3], mode)


def noise(seed: int, w: int, h: int, mode: str = "RGB"):
    from PIL import Image

    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4)).astype(np.uint8)
    return Image.fromarray(a if mode == "RGBA" else a[..., :3], mode)


def palette_image(seed: int, w: int, h: int, colours: int):
    from PIL import Image

    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    return Image.fromarray(pal[rng.integers(0, colours, (h, w))])


def pil_bytes(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def pil_pixels(data: bytes) -> tuple[str, np.ndarray]:
    """PIL's mode and pixels of an image file."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.load()
    return img.mode, np.asarray(img)


# ------------------------------------------------------------------- WEBP

def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def small_first_frame(lossless: bool) -> bytes:
    """An animation whose first frame (20 x 10) sits at (6, 8) of a 40 x 30
    canvas, then a full frame: VP8X, ANIM and ANMF chunks around PIL's
    own frame bitstreams."""
    first = pil_bytes(smooth(71, 20, 10, "RGBA" if lossless else "RGB"), "WEBP",
                      lossless=lossless, quality=80)
    second = pil_bytes(smooth(72, 40, 30), "WEBP", quality=80)

    def anmf(x, y, w, h, payload):
        head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + \
            (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little") + \
            (100).to_bytes(3, "little") + b"\x00"
        return _chunk(b"ANMF", head + payload[12:])

    flags = 0x02 | (0x10 if lossless else 0)
    vp8x = _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (39).to_bytes(3, "little")
                  + (29).to_bytes(3, "little"))
    body = b"WEBP" + vp8x + _chunk(b"ANIM", b"\xff\xff\xff\xff\x00\x00") + \
        anmf(6, 8, 20, 10, first) + anmf(0, 0, 40, 30, second)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def animated(lossless: bool) -> bytes:
    frames = [smooth(80 + i, 48, 36, "RGBA" if lossless else "RGB") for i in range(3)]
    return pil_bytes(frames[0], "WEBP", save_all=True, append_images=frames[1:],
                     lossless=lossless, quality=75, duration=100)


def webp_cases() -> dict[str, bytes]:
    """Every WEBP form the tests hold against PIL."""
    out = {}
    for q in (5, 30, 75, 100):
        out[f"lossy_q{q}"] = pil_bytes(smooth(q, 123, 77), "WEBP", quality=q)
    for m in (0, 6):
        out[f"lossy_method{m}"] = pil_bytes(smooth(40 + m, 96, 64), "WEBP", quality=60,
                                            method=m)
    for w, h in ((16, 16), (33, 17), (1, 1), (17, 1), (1, 17), (250, 3)):
        out[f"lossy_{w}x{h}"] = pil_bytes(smooth(w * h, max(w, 8), max(h, 8)).resize((w, h)),
                                          "WEBP", quality=80)
    out["lossy_noise"] = pil_bytes(noise(3, 37, 29), "WEBP", quality=90)
    out["lossy_alpha"] = pil_bytes(smooth(5, 99, 61, "RGBA"), "WEBP", quality=60)
    out["lossy_alpha_quantised"] = pil_bytes(smooth(6, 99, 61, "RGBA"), "WEBP", quality=60,
                                             alpha_quality=40)
    out["lossy_alpha_raw"] = pil_bytes(noise(7, 31, 23, "RGBA"), "WEBP", quality=60,
                                       alpha_quality=100, method=0)
    for m in (0, 4, 6):
        out[f"lossless_method{m}"] = pil_bytes(smooth(50 + m, 100, 80), "WEBP", lossless=True,
                                               method=m)
    out["lossless_rgba"] = pil_bytes(smooth(9, 77, 53, "RGBA"), "WEBP", lossless=True)
    out["lossless_exact"] = pil_bytes(noise(10, 30, 30, "RGBA"), "WEBP", lossless=True,
                                      exact=True)
    out["lossless_q0"] = pil_bytes(smooth(11, 120, 90), "WEBP", lossless=True, quality=0)
    meta = {"icc_profile": b"\x00" * 130, "xmp": b"<x/>",
            "exif": b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x00"}
    out["vp8x_metadata_lossy"] = pil_bytes(smooth(12, 50, 30), "WEBP", quality=70, **meta)
    out["vp8x_metadata_lossless"] = pil_bytes(smooth(13, 50, 30), "WEBP", lossless=True,
                                              **meta)
    for n in (2, 3, 5, 16, 200):
        out[f"lossless_palette{n}"] = pil_bytes(palette_image(n, 31, 19, n), "WEBP",
                                                   lossless=True)
    out["animated_lossy"] = animated(False)
    out["animated_lossless"] = animated(True)
    out["animated_small_first_frame"] = small_first_frame(False)
    out["animated_small_first_frame_alpha"] = small_first_frame(True)
    return out


def webp_corrupt_cases() -> dict[str, bytes]:
    """Cut and corrupt files PIL refuses."""
    good = pil_bytes(smooth(12, 64, 48), "WEBP", quality=80)
    lossless = pil_bytes(smooth(13, 64, 48), "WEBP", lossless=True)
    out = {
        "header_only": b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(8),
        "header_only_short": b"RIFF\0\0\0\0WEBPVP8 ",
        "cut_half": good[:len(good) // 2],
        "cut_last_byte": good[:-1],
        "lossless_cut": lossless[:len(lossless) // 2],
        "riff_size_past_end": good[:4] + struct.pack("<I", len(good) + 100) + good[8:],
    }
    bad_sig = bytearray(good)
    bad_sig[23:26] = b"\x00\x00\x00"  # the VP8 start code
    out["bad_vp8_start_code"] = bytes(bad_sig)
    bad_l = bytearray(lossless)
    bad_l[20] = 0x2E  # the VP8L signature byte
    out["bad_vp8l_signature"] = bytes(bad_l)
    return out


# ------------------------------------------------------------ JPEG 2000

def jpx_cases() -> dict[str, bytes]:
    """Every JPEG 2000 form Pillow's writer produces, as the tests hold
    them against PIL."""
    W, H = 96, 72
    out = {
        "l_reversible": pil_bytes(smooth(1, W, H, "L"), "JPEG2000"),
        "l_irreversible": pil_bytes(smooth(2, W, H, "L"), "JPEG2000", irreversible=True),
        "l_one_resolution": pil_bytes(smooth(3, 40, 30, "L"), "JPEG2000", num_resolutions=1),
        "la": pil_bytes(smooth(4, 70, 50, "LA"), "JPEG2000"),
        "rgb": pil_bytes(smooth(5, W, H), "JPEG2000"),
        "rgb_irreversible": pil_bytes(smooth(6, W, H), "JPEG2000", irreversible=True),
        "rgb_no_mct": pil_bytes(smooth(7, W, H), "JPEG2000", mct=0),
        "rgb_no_mct_irreversible": pil_bytes(smooth(8, W, H), "JPEG2000", mct=0,
                                             irreversible=True),
        "rgba": pil_bytes(smooth(9, 70, 50, "RGBA"), "JPEG2000"),
        "rgba_irreversible": pil_bytes(smooth(10, 70, 50, "RGBA"), "JPEG2000", irreversible=True),
        "i16": pil_bytes(smooth(11, 70, 50, "I;16"), "JPEG2000"),
        "i16_irreversible": pil_bytes(smooth(12, 70, 50, "I;16"), "JPEG2000", irreversible=True),
        "i16_signed": pil_bytes(smooth(13, 70, 50, "I;16"), "JPEG2000", signed=True),
        "l_signed": pil_bytes(smooth(14, W, H, "L"), "JPEG2000", signed=True),
        "rgb_signed_irreversible": pil_bytes(smooth(15, W, H), "JPEG2000", signed=True,
                                             irreversible=True),
        "tiles_offsets": pil_bytes(smooth(16, 110, 90), "JPEG2000", tile_size=(48, 48),
                                   tile_offset=(5, 7), offset=(13, 9)),
        "odd_origins_irreversible": pil_bytes(smooth(17, 110, 90, "L"), "JPEG2000",
                                              offset=(3, 5), tile_offset=(1, 2),
                                              tile_size=(48, 40), irreversible=True,
                                              num_resolutions=3),
        "odd_origins": pil_bytes(smooth(18, 110, 90), "JPEG2000", offset=(3, 5),
                                 tile_offset=(1, 2), tile_size=(48, 40), num_resolutions=4),
        "two_resolutions": pil_bytes(smooth(19, W, H), "JPEG2000", num_resolutions=2),
        "six_resolutions": pil_bytes(smooth(20, W, H), "JPEG2000", num_resolutions=6,
                                     irreversible=True),
        "codestream": pil_bytes(smooth(21, W, H), "JPEG2000", no_jp2=True),
        "plt": pil_bytes(smooth(22, W, H), "JPEG2000", add_plt=True),
        "comment": pil_bytes(smooth(23, W, H), "JPEG2000", comment="a comment"),
        "layers_db": pil_bytes(smooth(24, W, H), "JPEG2000", quality_mode="dB",
                               quality_layers=[30, 40, 50]),
        "codeblocks_64": pil_bytes(smooth(25, 130, 70, "L"), "JPEG2000",
                                   codeblock_size=(64, 64)),
        "codeblocks_4": pil_bytes(smooth(26, 40, 36, "L"), "JPEG2000", codeblock_size=(4, 4)),
        "one_pixel": pil_bytes(smooth(27, 8, 8, "L").resize((1, 1)), "JPEG2000"),
        "three_by_two_irreversible": pil_bytes(smooth(28, 8, 8).resize((3, 2)), "JPEG2000",
                                               irreversible=True),
    }
    for i, prog in enumerate(("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")):
        out[f"{prog.lower()}_precincts_layers"] = pil_bytes(
            smooth(30 + i, W, H), "JPEG2000", progression=prog, precinct_size=(32, 32),
            codeblock_size=(16, 16), quality_mode="rates", quality_layers=[30, 10, 3])
        out[f"{prog.lower()}_tiles_irreversible"] = pil_bytes(
            smooth(40 + i, W, H), "JPEG2000", progression=prog, precinct_size=(64, 32),
            codeblock_size=(8, 32), irreversible=True, tile_size=(64, 48),
            quality_mode="rates", quality_layers=[20, 5])
    out["sycc"] = with_enumcs(out["rgb_no_mct"], 18)
    out["sycc_rgba"] = with_enumcs(out["rgba"], 18)
    out["colr_icc_unspecified"] = with_enumcs(out["rgb"], None)
    out["colr_other_space"] = with_enumcs(out["rgb"], 20)
    out["rgba_colr_grey"] = with_enumcs(out["rgba"], 17)
    return out


def with_enumcs(jp2: bytes, enumcs: int | None) -> bytes:
    """A JP2 file with its ``colr`` box's enumerated colour space changed,
    or with its method set to an ICC profile (None)."""
    data = bytearray(jp2)
    i = data.find(b"colr")
    if enumcs is None:
        data[i + 4] = 2
    else:
        data[i + 7:i + 11] = enumcs.to_bytes(4, "big")
    return bytes(data)


def jpx_corrupt_cases(cases: dict[str, bytes] | None = None) -> dict[str, bytes]:
    """Cut and corrupt JPEG 2000 files (from ``jpx_cases()``, given or
    made): PIL refuses each, so the JAX package draws nothing where one is
    an image XObject."""
    rgb = (cases or jpx_cases())["rgb"]
    cs = pil_bytes(smooth(90, 64, 48), "JPEG2000", no_jp2=True)
    return {
        "header_only": b"\x00\x00\x00\x0cjP  \r\n\x87\n",
        "cut_half": rgb[:len(rgb) // 2],
        "codestream_cut": cs[:len(cs) // 2],
        "codestream_siz_only": cs[:60],
        "colr_grey_for_rgb": with_enumcs(rgb, 17),
        "colr_esycc": with_enumcs(rgb, 24),
        "not_jpeg2000": b"\x00\x00\x00\x0cjP  \r\n\x87\x0b" + bytes(40),
    }


# --------------------------------------------------------------- fixtures

def _pages() -> list[np.ndarray]:
    import test_torch_pipeline_layout as pl

    return pl.make_pages()


def make_page_webp(pages: list[np.ndarray]) -> bytes:
    """The layout generator's second page as a photograph: enlarged to
    1700 x 2200, a warm tint, seeded grain; lossy WEBP q75."""
    from PIL import Image

    img = np.asarray(Image.fromarray(pages[1]).resize(PAGE_SIZE, Image.BICUBIC)).astype(np.float32)
    rng = np.random.default_rng(1700)
    img = img * np.asarray([0.97, 0.94, 0.86], np.float32) + rng.normal(0, 4.0, img.shape)
    img = np.clip(img + 6, 0, 255).astype(np.uint8)
    return pil_bytes(Image.fromarray(img), "WEBP", quality=75)


def make_scan_pdf(pages: list[np.ndarray]) -> bytes:
    """A US Letter page holding a 300 dpi grey scan of the generator's
    third page as a JPXDecode JP2 (9/7, one layer at 1:20)."""
    from PIL import Image

    from rapiddoc_tpu.pdfio.cos import Name, Stream
    from rapiddoc_tpu.pdfio.writer import PdfWriter

    grey = Image.fromarray(pages[2]).convert("L").resize(SCAN_SIZE, Image.BICUBIC)
    jp2 = pil_bytes(grey, "JPEG2000", irreversible=True, quality_mode="rates",
                    quality_layers=[20])
    writer = PdfWriter()
    pages_ref = writer.reserve()
    img = writer.add(Stream({Name("Type"): Name("XObject"), Name("Subtype"): Name("Image"),
                             Name("Width"): SCAN_SIZE[0], Name("Height"): SCAN_SIZE[1],
                             Name("ColorSpace"): Name("DeviceGray"),
                             Name("BitsPerComponent"): 8, Name("Filter"): Name("JPXDecode")},
                            jp2))
    content = b"q 612 0 0 792 0 0 cm /Im0 Do Q"
    page = {Name("Type"): Name("Page"), Name("Parent"): pages_ref,
            Name("MediaBox"): [0, 0, 612, 792],
            Name("Resources"): {Name("XObject"): {Name("Im0"): img}},
            Name("Contents"): writer.add(Stream({}, content))}
    kid = writer.add(page)
    writer.set(pages_ref, {Name("Type"): Name("Pages"), Name("Kids"): [kid], Name("Count"): 1})
    root = writer.add({Name("Type"): Name("Catalog"), Name("Pages"): pages_ref})
    return writer.tobytes(root)


SMOKE_WEBP = ("lossy_q30", "lossy_33x17", "lossy_alpha", "lossy_alpha_raw", "lossless_method4",
              "lossless_rgba", "lossless_palette3", "lossless_palette200", "animated_lossless",
              "animated_small_first_frame")
SMOKE_JPX = ("l_irreversible", "la", "rgb", "rgba_irreversible", "i16_signed", "tiles_offsets",
             "odd_origins_irreversible", "rpcl_precincts_layers", "cprl_tiles_irreversible",
             "codestream", "sycc")


def make_matrix(webp: dict | None = None, jpx: dict | None = None) -> dict[str, np.ndarray]:
    """The smoke's small files (from the cases given or made):
    ``<kind>/<case>`` bytes, and PIL's mode and pixel sha256 for each under
    ``mode/...`` and ``sha256/...``."""
    webp, jpx = webp or webp_cases(), jpx or jpx_cases()
    out = {}
    for kind, names, cases in (("webp", SMOKE_WEBP, webp), ("jpx", SMOKE_JPX, jpx)):
        for name in names:
            mode, px = pil_pixels(cases[name])
            out[f"{kind}/{name}"] = np.frombuffer(cases[name], np.uint8)
            out[f"mode/{kind}/{name}"] = np.asarray(mode)
            out[f"sha256/{kind}/{name}"] = np.asarray(sha256(px))
    return out


# ----------------------------------------------------------------- golden

def summary(out) -> dict:
    import test_torch_image_inputs as ii

    return json.loads(json.dumps(ii.summary(out)))


def jax_parses(fp32: bool) -> dict:
    import test_torch_image_inputs as ii

    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    env = dict(PARSE_ENV, **({"RAPIDDOC_FP32_PARAMS": "1"} if fp32 else {}))
    with ii.clean_env(**env):
        ModelStack._instances.clear()
        rapid = RapidDoc()
        got = {"webp_path": summary(rapid(str(PAGE_WEBP), parse_method="ocr")),
               "webp_bytes": summary(rapid(PAGE_WEBP.read_bytes(), parse_method="ocr")),
               "jpx_pdf": summary(rapid(SCAN_PDF.read_bytes(), parse_method="ocr"))}
        ModelStack._instances.clear()
    return got


def make_golden() -> dict:
    from rapiddoc_tpu.pdfio import open_pdf
    from rapiddoc_tpu.pdfio.render import render_page_full
    from rapiddoc_tpu.pdfio.writer import images_to_pdf

    page = PAGE_WEBP.read_bytes()
    doc = open_pdf(SCAN_PDF.read_bytes())
    stream = doc.resolve(doc.get_page(0).resources["XObject"]["Im0"])
    return {
        "source": "rapiddoc_tpu on the CPU, PIL 12.1 (libwebp 1.6.0, OpenJPEG 2.5.4): "
                  "Image.open, images_to_pdf, render_page_full and RapidDoc() with the demo "
                  "layout and the formula stage, tables off; rebuilt by "
                  "python tests/test_torch_webp.py --golden",
        "dpi": DPI,
        "config": PARSE_ENV,
        "page_mode": pil_pixels(page)[0],
        "page_sha256": sha256(pil_pixels(page)[1]),
        "page_pdf_sha256": sha256(images_to_pdf([page], dpi=DPI)),
        "scan_sha256": sha256(pil_pixels(doc.stream_bytes(stream))[1]),
        "scan_render_sha256": {str(dpi): sha256(np.asarray(render_page_full(
            doc.get_page(0), dpi=dpi, with_text=False)[0])) for dpi in (200, 72)},
        "fp32": jax_parses(True),
        "bf16": jax_parses(False),
    }


def write_all() -> None:
    pages = _pages()
    PAGE_WEBP.write_bytes(make_page_webp(pages))
    SCAN_PDF.write_bytes(make_scan_pdf(pages))
    np.savez_compressed(MATRIX_NPZ, **make_matrix())
    GOLDEN_JSON.write_text(json.dumps(make_golden(), indent=1) + "\n")
    for path in (PAGE_WEBP, SCAN_PDF, MATRIX_NPZ, GOLDEN_JSON):
        print("wrote", path.name, path.stat().st_size)
