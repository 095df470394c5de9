"""The port's JPEG decoder against PIL (libjpeg-turbo), bit for bit.

The JAX package decodes DCTDecode streams with PIL; the port replays
libjpeg-turbo's decode (``rapiddoc_tpu_torch/pdfio/jpeg.py``). Here the
plain version (the entropy decode in Python, the rest in numpy) must
give PIL's pixels exactly: on the fixture PDF's three streams, and on
random and synthetic-text images that PIL encodes at qualities 50, 75,
92 and 100, sampled 4:4:4, 4:2:2 and 4:2:0 or grey, at sizes that are
not multiples of 16 (1x1 and 17x33 among them), with and without
restart markers; on PIL's progressive streams (colour and grey, every
sampling, restart markers, optimised tables) and CMYK ones (Adobe,
inverted as PIL's CMYK;I); and on hand-built streams of forms PIL does
not write (``tests/torch_jpeg_forms.py``: YCCK, RGB-coded, h1v2, h4v1
and other samplings). Arithmetic-coded and lossless streams, progressive
ones that libjpeg would block-smooth, and WEBP files raise
NotImplementedError; corrupt streams, and scans that name their
components as libjpeg-turbo refuses them, raise JpegError.

The compiled entropy decode (``csrc/jpeg_entropy.cu``) is held to the
plain one on the card, where PIL is absent: ``chip_smoke.py`` phase jpeg
decodes the committed matrix ``rapiddoc_tpu_torch/assets/jpeg_matrix.npz``
(grey, 4:4:4, 4:2:2 and 4:2:0 streams at sizes that are not multiples
of 16, restart intervals of 1 and 3 blocks, and corrupt streams) with
both and compares them, and the pixels with PIL's, recorded here. Rebuild
the matrix with ``PYTHONPATH=. python tests/test_torch_jpeg.py``.
"""
import hashlib
import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rapiddoc_tpu_torch.pdfio import jpeg

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
MATRIX = ASSETS / "jpeg_matrix.npz"
SIZES = [(1, 1), (17, 33), (33, 17), (2, 3), (9, 26), (40, 70), (65, 47)]
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def encode(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    """As the JAX package's xobject_to_pil leaves a grey or RGB JPEG."""
    img = Image.open(io.BytesIO(data))
    img.load()
    return np.asarray(img)


def plain_decode(data: bytes) -> np.ndarray:
    """The decoder with its plain entropy decode, as it runs without a
    card."""
    stream = jpeg.parse_jpeg(data)
    return jpeg.reconstruct(stream, jpeg.decode_coefficients_plain(stream))


def with_frame_ids(data: bytes, ids: list[int]) -> bytes:
    """``data`` with its frame header's component ids replaced."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    for k, cid in enumerate(ids):
        out[i + 10 + 3 * k] = cid
    return bytes(out)


def with_scan_ids(data: bytes, ids: list[int]) -> bytes:
    """``data`` with its first scan header naming components ``ids``, each
    with the table selectors of the original entry at its place (cycled)."""
    i = data.index(b"\xff\xda")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    seg = data[i + 4:i + 2 + n]
    ns = seg[0]
    body = bytes([len(ids)]) + b"".join(
        bytes([cid, seg[2 + 2 * (k % ns)]]) for k, cid in enumerate(ids)) + seg[1 + 2 * ns:]
    return data[:i] + b"\xff\xda" + (len(body) + 2).to_bytes(2, "big") + body + data[i + 2 + n:]


def fixture_pages() -> np.ndarray:
    with np.load(ASSETS / "ocr_smoke_pages.npz") as z:
        return z["pages"]


def images(rng: np.random.Generator, grey: bool) -> list[np.ndarray]:
    """Random images and crops of the synthetic text pages, one each per
    size in SIZES."""
    pages = fixture_pages()
    out = []
    for h, w in SIZES:
        shape = (h, w) if grey else (h, w, 3)
        out.append(rng.integers(0, 256, shape, dtype=np.uint8))
        y, x = rng.integers(0, 960 - h), rng.integers(0, 960 - w)
        crop = pages[int(rng.integers(0, 3)), y:y + h, x:x + w]
        out.append(np.ascontiguousarray(crop[..., 0] if grey else crop))
    return out


def assert_equal_to_pil(data: bytes) -> None:
    got = plain_decode(data)
    want = pil_decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_fixture_pdf_streams_equal_pil():
    from rapiddoc_tpu_torch.bench import page_images

    streams = page_images((ASSETS / "ocr_smoke_doc.pdf").read_bytes())
    assert len(streams) == 3
    for data, width, height, cs in streams:
        assert (width, height, cs) == (960, 960, "DeviceRGB")
        assert_equal_to_pil(data)


@pytest.mark.parametrize("quality", [50, 75, 92, 100])
@pytest.mark.parametrize("sampling", list(SUBSAMPLING))
def test_colour_equal_pil(quality, sampling):
    rng = np.random.default_rng(quality * 10 + SUBSAMPLING[sampling])
    for img in images(rng, grey=False):
        assert_equal_to_pil(encode(img, quality=quality, subsampling=SUBSAMPLING[sampling]))


@pytest.mark.parametrize("quality", [50, 75, 92, 100])
def test_grey_equal_pil(quality):
    rng = np.random.default_rng(quality)
    for img in images(rng, grey=True):
        data = encode(img, quality=quality)
        assert jpeg.parse_jpeg(data).components[0].h == 1
        assert_equal_to_pil(data)


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("sampling", list(SUBSAMPLING))
def test_restart_markers_equal_pil(restart, sampling):
    rng = np.random.default_rng(7)
    for img in images(rng, grey=False)[4:]:
        data = encode(img, quality=92, subsampling=SUBSAMPLING[sampling], **restart)
        assert b"\xff\xd0" in data or img.shape[0] * img.shape[1] <= 256
        assert jpeg.parse_jpeg(data).scans[0].restart_interval > 0
        assert_equal_to_pil(data)


def test_corrupt_streams_raise_jpeg_error():
    data = encode(fixture_pages()[0][:200, :200], quality=92)
    stream = jpeg.parse_jpeg(data)
    cut = data[:stream.scans[0].begin + (stream.scans[0].end - stream.scans[0].begin) // 2]
    with pytest.raises(jpeg.JpegError):
        plain_decode(cut)
    with pytest.raises(jpeg.JpegError):
        plain_decode(b"not a jpeg")


@pytest.mark.parametrize("ns", [2, 4, 5, 10])
def test_scan_repeating_a_component_raises(ns):
    """A grey 1x1 stream whose scan names its one component ``ns`` times
    (libjpeg-turbo refuses it) raises JpegError before any entropy
    decode: neither decoder sees more scan components than the frame
    has."""
    data = with_scan_ids(encode(np.full((1, 1), 77, np.uint8)), [1] * ns)
    with pytest.raises(OSError):
        pil_decode(data)
    with pytest.raises(jpeg.JpegError):
        jpeg.parse_jpeg(data)


@pytest.mark.parametrize("frame_ids,scan_ids", [
    ([1, 2, 3], [1, 2, 3]), ([2, 2, 3], [2, 2, 3]), ([1, 1, 3], [1, 1, 3]),
    ([1, 2, 3], [3, 2, 1]), ([1, 2, 3], [2, 1, 3]), ([1, 2, 3], [1, 1, 1]),
    ([1, 2, 3], [2, 2, 3]), ([1, 2, 2], [1, 2, 3]), ([1, 2, 3], []),
])
def test_scan_components_are_found_as_libjpeg_finds_them(frame_ids, scan_ids):
    """Scan headers that name components out of the frame's order, twice,
    or not at all: the port decodes exactly those that PIL decodes, to
    PIL's pixels, and raises JpegError for the rest."""
    img = np.random.default_rng(5).integers(0, 256, (17, 33, 3), dtype=np.uint8)
    data = with_scan_ids(with_frame_ids(encode(img, quality=92, subsampling=0), frame_ids),
                         scan_ids)
    try:
        want = pil_decode(data)
    except OSError:
        with pytest.raises(jpeg.JpegError):
            plain_decode(data)
    else:
        assert np.array_equal(plain_decode(data), want)


def _once_unsupported(kind: str) -> bytes:
    img = fixture_pages()[0][:64, :64]
    if kind == "progressive":
        return encode(img, quality=90, progressive=True)
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["progressive", "cmyk"])
def test_once_unsupported_streams_equal_pil(kind):
    """Progressive and CMYK streams, which raised before they were
    ported, give PIL's pixels (CMYK as PIL's inverted CMYK;I)."""
    data = _once_unsupported(kind)
    assert np.array_equal(plain_decode(data), pil_decode(data))


PROGRESSIVE = [(size, sub, q) for size in [(1, 1), (17, 33), (40, 70), (65, 47)]
               for sub in ("444", "422", "420") for q in (50, 92)]


@pytest.mark.parametrize("size,sub,quality", PROGRESSIVE)
def test_progressive_streams_equal_pil(size, sub, quality):
    """PIL's progressive streams (spectral selection, successive
    approximation, end-of-band runs), colour and grey, with and without
    restart markers and optimised tables."""
    rng = np.random.default_rng(size[0] * 100 + size[1] + quality)
    img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    img = ((img.astype(np.int32) + np.roll(img, 1, 0)) // 2).astype(np.uint8)
    for data in (encode(img, quality=quality, subsampling=SUBSAMPLING[sub], progressive=True),
                 encode(img[..., 0], quality=quality, progressive=True, optimize=True),
                 encode(img, quality=quality, subsampling=SUBSAMPLING[sub], progressive=True,
                        restart_marker_blocks=2)):
        assert jpeg.parse_jpeg(data).progressive
        assert np.array_equal(plain_decode(data), pil_decode(data))


@pytest.mark.parametrize("sub", ["444", "420"])
def test_cmyk_streams_equal_pil(sub):
    """Adobe CMYK streams as PIL writes them, progressive too."""
    rng = np.random.default_rng(4)
    img = Image.fromarray(rng.integers(0, 256, (23, 41, 3), dtype=np.uint8)).convert("CMYK")
    for kw in ({}, {"progressive": True}, {"quality": 40}):
        buf = io.BytesIO()
        img.save(buf, format="JPEG", subsampling=SUBSAMPLING[sub], **kw)
        data = buf.getvalue()
        assert np.array_equal(plain_decode(data), pil_decode(data))


HAND_FORMS = {
    "ycck": ([(1, 1)] * 4, {"adobe": 2}),
    "ycck_420": ([(2, 2), (1, 1), (1, 1), (2, 2)], {"adobe": 2}),
    "ycck_adobe1": ([(2, 1), (1, 1), (1, 1), (2, 1)], {"adobe": 1}),
    "cmyk_no_marker": ([(1, 1)] * 4, {}),
    "rgb_adobe0": ([(1, 1)] * 3, {"adobe": 0}),
    "rgb_ids": ([(2, 1), (1, 1), (1, 1)], {"ids": [82, 71, 66]}),
    "ycc_jfif_rgb_ids": ([(1, 1)] * 3, {"ids": [82, 71, 66], "jfif": True}),
    "h1v2": ([(1, 2), (1, 1), (1, 1)], {}),
    "h4v1": ([(4, 1), (1, 1), (1, 1)], {}),
    "h3v1": ([(3, 1), (1, 1), (1, 1)], {}),
    "h1v3": ([(1, 3), (1, 1), (1, 1)], {}),
    "mixed_2x2_1x2": ([(2, 2), (1, 2), (1, 1)], {}),
    "chroma_larger": ([(1, 1), (2, 2), (1, 1)], {}),
    "h4v2": ([(4, 2), (1, 1), (1, 1)], {}),
    "h2v1_chroma_2x1": ([(2, 2), (2, 1), (1, 1)], {}),
}


@pytest.mark.parametrize("name", list(HAND_FORMS))
def test_hand_built_forms_equal_pil(name):
    """Forms no encoder here writes (YCCK, RGB-coded, other samplings),
    built by hand at widths of 1-2 samples and larger."""
    from torch_jpeg_forms import hand_jpeg

    samp, kw = HAND_FORMS[name]
    rng = np.random.default_rng(len(name))
    for w, h in ((1, 1), (2, 9), (9, 2), (23, 17), (48, 33)):
        data = hand_jpeg(w, h, samp, rng, **kw)
        assert np.array_equal(plain_decode(data), pil_decode(data))


def test_pil_progressive_streams_are_never_smoothed():
    """libjpeg-turbo block-smooths a progressive image only where a
    component's low AC coefficients stay unrefined; PIL's scripts refine
    every coefficient to Al = 0, so none of its streams reaches it. A
    stream cut before its refinement scans would, and raises."""
    from torch_jpeg_forms import truncated_progression

    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    for sub in ("444", "420"):
        data = encode(img, quality=75, subsampling=SUBSAMPLING[sub], progressive=True)
        jpeg.parse_jpeg(data)  # does not raise
        with pytest.raises(NotImplementedError, match="block-smooths.*ROADMAP Queue 1 item"):
            jpeg.parse_jpeg(truncated_progression(data, 3))


@pytest.mark.parametrize("kind", ["arithmetic", "lossless", "gif_file"])
def test_unsupported_streams_raise(kind):
    from rapiddoc_tpu_torch.pdfio.png import decode_image

    img = fixture_pages()[0][:64, :64]
    data = encode(img, quality=90)
    at = data.index(b"\xff\xc0")
    if kind == "gif_file":
        # GIF files decode as PIL opens them now (pdfio/gif.py); WEBP
        # files still raise
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="GIF")
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        assert np.array_equal(decode_image(buf.getvalue()), want)
        with pytest.raises(NotImplementedError, match="WEBP images.*ROADMAP Queue 1 item"):
            decode_image(b"RIFF\0\0\0\0WEBPVP8 ")
        return
    marker = b"\xff\xc9" if kind == "arithmetic" else b"\xff\xc3"
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        plain_decode(data[:at] + marker + data[at + 2:])


def test_idct_range_limit_wraps_as_libjpeg():
    """A DC-only block far outside the sample range wraps through the
    10-bit range-limit table as libjpeg's does: DC 600 x q 8 descales to
    600, which the table's ``& 1023`` reads as -424, so the sample is 0
    where a plain clamp would give 255; DC 60 x q 8 (60 + 128) is exact."""
    q = np.full(64, 8, np.int64)
    for dc, want in ((600, 0), (60, 188), (-60, 68)):
        coef = np.zeros((1, 64), np.int16)
        coef[0, 0] = dc
        assert (jpeg.idct_islow(coef, q) == want).all()


def matrix_cases() -> list[tuple[str, bytes]]:
    """The streams of the committed matrix: crops of the text pages and
    random images at sizes that are not multiples of 16, grey and each
    sampling, without and with restart intervals of 1 and 3 blocks; then
    corrupt streams (cut mid-scan, a run of bits that is no Huffman code,
    a restart marker dropped, two swapped), and bytes of the valid ones
    changed at random until each of the decoder's four faults shows."""
    rng = np.random.default_rng(11)
    pages = fixture_pages()

    def crop(h: int, w: int, grey: bool) -> np.ndarray:
        """A crop that holds ink (most of a page is white)."""
        while True:
            y, x = rng.integers(0, 960 - h), rng.integers(0, 960 - w)
            c = pages[int(rng.integers(0, 3)), y:y + h, x:x + w]
            if h * w == 1 or c.min() < 128:
                return np.ascontiguousarray(c[..., 0] if grey else c)

    cases = []
    for mode in ["grey", *SUBSAMPLING]:
        grey = mode == "grey"
        kw = {} if grey else {"subsampling": SUBSAMPLING[mode]}
        for h, w in [(1, 1), (17, 33), (33, 17), (65, 47)]:
            cases.append((f"{mode}_{h}x{w}_q92", encode(crop(h, w, grey), quality=92, **kw)))
        noise = rng.integers(0, 256, (9, 26) if grey else (9, 26, 3), dtype=np.uint8)
        cases.append((f"{mode}_9x26_noise_q75", encode(noise, quality=75, **kw)))
        for blocks in (1, 3):
            cases.append((f"{mode}_40x70_dri{blocks}", encode(
                crop(40, 70, grey), quality=92, restart_marker_blocks=blocks, **kw)))
    named = dict(cases)
    data = named["420_65x47_q92"]
    scan = jpeg.parse_jpeg(data).scans[0]
    cases.append(("corrupt_cut_mid_scan", data[:(scan.begin + scan.end) // 2]))
    mid = (scan.begin + scan.end) // 2
    cases.append(("corrupt_no_huffman_code",
                  data[:mid] + b"\xff\x00" * 8 + data[mid + 16:]))
    dri = named["444_40x70_dri3"]
    at = dri.index(b"\xff\xd1")
    cases.append(("corrupt_restart_dropped", dri[:at] + dri[at + 2:]))
    swapped = bytearray(dri)
    swapped[dri.index(b"\xff\xd0") + 1], swapped[at + 1] = 0xD1, 0xD0
    cases.append(("corrupt_restart_swapped", bytes(swapped)))
    valid = [d for _, d in cases if d[-2:] == b"\xff\xd9"]
    found: dict[str, bytes] = {}
    while len(found) < 4:
        data = bytearray(valid[int(rng.integers(0, len(valid)))])
        scan = jpeg.parse_jpeg(bytes(data)).scans[0]
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(scan.begin, scan.end))
            data[at:at + 1] = [bytes([rng.integers(0, 256)]), b"",
                               bytes([0xFF, 0xD0 + rng.integers(0, 8)])][rng.integers(0, 3)]
        try:
            plain_decode(bytes(data))
        except jpeg.JpegError as e:
            found.setdefault(str(e).replace(" ", "_"), bytes(data))
    cases += [(f"corrupt_{fault}", data) for fault, data in sorted(found.items())]
    return cases


def matrix_want(data: bytes) -> str:
    """What the port must give for a matrix stream: the sha256 of PIL's
    pixels, or ``JpegError: <message>`` where the plain decoder rejects
    the stream (libjpeg warns about corrupt data and carries on)."""
    try:
        plain_decode(data)
    except jpeg.JpegError as e:
        return f"JpegError: {e}"
    return hashlib.sha256(np.ascontiguousarray(pil_decode(data)).tobytes()).hexdigest()


def make_matrix() -> None:
    cases = matrix_cases()
    np.savez_compressed(
        MATRIX, names=np.array([n for n, _ in cases]),
        want=np.array([matrix_want(d) for _, d in cases]),
        **{f"s{i}": np.frombuffer(d, np.uint8) for i, (_, d) in enumerate(cases)})


def load_matrix() -> list[tuple[str, bytes, str]]:
    with np.load(MATRIX) as z:
        return [(str(n), z[f"s{i}"].tobytes(), str(w))
                for i, (n, w) in enumerate(zip(z["names"], z["want"]))]


def test_matrix_decodes_as_recorded():
    """Every committed stream decodes (plain entropy decode) to PIL's
    pixels, as PIL gives them now, or raises the recorded JpegError; the
    corrupt streams all raise."""
    matrix = load_matrix()
    assert len(matrix) >= 32
    for name, data, want in matrix:
        if want.startswith("JpegError: "):
            with pytest.raises(jpeg.JpegError) as err:
                plain_decode(data)
            assert f"JpegError: {err.value}" == want, name
        else:
            assert not name.startswith("corrupt")
            got = np.ascontiguousarray(plain_decode(data))
            assert hashlib.sha256(got.tobytes()).hexdigest() == want, name
            assert np.array_equal(got, pil_decode(data)), name
    faults = {w for n, _, w in matrix if n.startswith("corrupt")}
    assert len(faults) == 4 and all(w.startswith("JpegError: ") for w in faults)


@pytest.mark.cuda
def test_compiled_entropy_decode_equals_plain():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the compiled decoder is built by nvcc)")
    for name, data, want in load_matrix():
        stream = jpeg.parse_jpeg(data)
        if want.startswith("JpegError: "):
            with pytest.raises(jpeg.JpegError) as err:
                jpeg.decode_coefficients_compiled(stream)
            assert f"JpegError: {err.value}" == want, name
        else:
            assert np.array_equal(jpeg.decode_coefficients_compiled(stream),
                                  jpeg.decode_coefficients_plain(stream)), name
    rng = np.random.default_rng(3)
    for sampling in SUBSAMPLING.values():
        for img in images(rng, grey=False):
            for kw in ({}, {"restart_marker_blocks": 2}):
                stream = jpeg.parse_jpeg(encode(img, quality=92, subsampling=sampling, **kw))
                assert np.array_equal(jpeg.decode_coefficients_compiled(stream),
                                      jpeg.decode_coefficients_plain(stream))


if __name__ == "__main__":
    # Rewrites the JPEG matrix (needs PIL).
    make_matrix()
    print("wrote", MATRIX, MATRIX.stat().st_size, "bytes,", len(load_matrix()), "streams")
