"""The port's CCITT G3/G4 decoder against the JAX package's PIL/libtiff path.

The JAX package wraps a /CCITTFaxDecode stream in a one-strip TIFF and
lets PIL's libtiff decode it (``xobject_to_pil``); the port replays
libtiff's decoder (``rapiddoc_tpu_torch/pdfio/ccitt.py``). Here the strips
come from PIL's own libtiff encoder (G4, G3 one- and two-dimensional,
which write an EOL before every row) and from a T.4 encoder in this file
that writes rows without EOL codes (PDF's default ``/EndOfLine false``);
bitmaps are seeded random and text-like, at widths that are not
multiples of 8, with ``/BlackIs1`` false and true, and ``/Columns`` apart
from ``/Width``. The port's ``xobject_to_array`` must give the JAX
package's image. On damaged strips it must fail where PIL fails and give
PIL's rows up to where libtiff stopped writing (PIL's later rows hold
stale memory, so nothing compares them): every damage to a G4 strip (cut
short, a flipped bit, random bytes, zeros), and cut or zeroed
one-dimensional G3 strips.

Known differences, in ``ROADMAP.md`` Queue 3 and not compared here:
T.4 rows without EOL codes that are padded to bytes (or whose first EOL
is damaged), where libtiff's choice of the row it decodes next was not
found; and a two-dimensional G3 strip that ends inside a row, which the
port raises on while PIL sometimes keeps the rows. The compiled decoder
(``csrc/bilevel.cu``, built by g++ here) equals the plain one on all of
these, damaged ones included.
"""
import ctypes
import io
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rapiddoc_tpu.pdfio.cos import Stream as JaxStream
from rapiddoc_tpu.pdfio.images import _ccitt_to_tiff, xobject_to_pil
from rapiddoc_tpu_torch.pdfio import ccitt
from rapiddoc_tpu_torch.pdfio.cos import Stream
from rapiddoc_tpu_torch.pdfio.images import xobject_to_array

REPO = Path(__file__).resolve().parent.parent


class _Doc:
    @staticmethod
    def resolve(x):
        return x


def libtiff_strip(bits: np.ndarray, k: int) -> bytes:
    """PIL's libtiff encoding of a bilevel image (1 = a run coded black)
    as one strip: G4 for k < 0, G3 1-D for 0, G3 2-D for k > 0."""
    img = Image.fromarray(bits.astype(bool))
    buf = io.BytesIO()
    kw = {"compression": "group4" if k < 0 else "group3", "strip_size": 1 << 30}
    if k > 0:
        kw["tiffinfo"] = {292: 1}
    img.save(buf, format="TIFF", **kw)
    data = buf.getvalue()
    ifd = struct.unpack("<I", data[4:8])[0]
    tags = {}
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        tag, typ, _, v = struct.unpack("<HHII", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        tags[tag] = v & 0xFFFF if typ == 3 else v
    return data[tags[273]:tags[273] + tags[279]]


def _runs(row) -> list[int]:
    out, color, x = [], 0, 0
    while x < len(row):
        n = 0
        while x < len(row) and row[x] == color:
            n += 1
            x += 1
        out.append(n)
        color ^= 1
    return out


def _code(run: int, white: bool) -> str:
    term = ccitt._WHITE_TERM if white else ccitt._BLACK_TERM
    makeup = ccitt._WHITE_MAKEUP if white else ccitt._BLACK_MAKEUP
    s = ""
    while run >= 2560:
        s += ccitt._COMMON_MAKEUP[-1]
        run -= 2560
    if run >= 64:
        m = run // 64
        s += makeup[m - 1] if m <= 27 else ccitt._COMMON_MAKEUP[m - 28]
        run -= 64 * m
    return s + term[run]


def t4_rows(bits: np.ndarray, eol: bool, align: bool) -> bytes:
    """One-dimensional T.4 rows, with or without an EOL before each and
    with or without fill to a byte boundary after each."""
    s = ""
    for row in bits:
        if eol:
            s += "000000000001"
        s += "".join(_code(r, i % 2 == 0) for i, r in enumerate(_runs(row)))
        if align:
            s += "0" * (-len(s) % 8)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def _bitmap(rng, h: int, w: int) -> np.ndarray:
    """Seeded text-like bits: random blobs and long runs, some rows
    repeated (vertical modes), some empty."""
    bits = (rng.random((h, w)) < rng.uniform(0.05, 0.5)).astype(np.uint8)
    for _ in range(3):
        y = int(rng.integers(0, h))
        bits[y, int(rng.integers(0, w)):] = 1
    if h > 4:
        bits[h // 2:h // 2 + 2] = bits[h // 2 - 1]
        bits[1] = 0
    return bits


def _image_dict(w: int, h: int, parms: dict) -> dict:
    return {"Type": "XObject", "Subtype": "Image", "Width": w, "Height": h,
            "BitsPerComponent": 1, "ColorSpace": "DeviceGray", "Filter": "CCITTFaxDecode",
            "DecodeParms": parms}


def jax_image(data: bytes, w: int, h: int, parms: dict):
    img = xobject_to_pil(_Doc(), JaxStream(_image_dict(w, h, parms), data))
    return None if img is None else np.asarray(img)


def port_image(data: bytes, w: int, h: int, parms: dict):
    try:
        return xobject_to_array(_Doc(), Stream(_image_dict(w, h, parms), data))
    except ccitt.CcittError:
        return None


KINDS = {"g4": -1, "g3_1d": 0, "g3_2d": 1}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("black_is_1", [False, True])
def test_libtiff_strips_equal_jax(kind, black_is_1):
    k = KINDS[kind]
    rng = np.random.default_rng(k + 7 * black_is_1 + 10)
    for h, w in ((1, 1), (3, 13), (17, 61), (40, 203), (9, 1731)):
        bits = _bitmap(rng, h, w)
        data = libtiff_strip(bits, k)
        parms = {"K": k, "Columns": w, "BlackIs1": black_is_1}
        want = jax_image(data, w, h, parms)
        got = port_image(data, w, h, parms)
        assert want is not None and np.array_equal(got, want)
        # runs coded white are 255 with BlackIs1 false, 0 with it true
        assert np.array_equal(got == 0, bits.astype(bool) ^ black_is_1)


@pytest.mark.parametrize("eol", [True, False])
def test_t4_rows_with_and_without_eol_equal_jax(eol):
    """Rows with EOLs, and rows without them (read as libtiff reads a
    strip whose first row has no EOL)."""
    rng = np.random.default_rng(3 + eol)
    for h, w in ((1, 9), (6, 37), (21, 150)):
        bits = _bitmap(rng, h, w)
        data = t4_rows(bits, eol, False)
        want = jax_image(data, w, h, {"K": 0})
        got = port_image(data, w, h, {"K": 0})
        assert np.array_equal(got, want)
        assert np.array_equal(got == 0, bits.astype(bool))


def test_columns_differ_from_width_and_parms_array():
    """/Columns wins over /Width; /DecodeParms given as an array (the K
    entry is found among them); the ignored keys change nothing."""
    rng = np.random.default_rng(5)
    bits = _bitmap(rng, 12, 45)
    data = libtiff_strip(bits, -1)
    for parms in ({"K": -1, "Columns": 45, "EncodedByteAlign": True, "EndOfBlock": False,
                   "Rows": 7, "DamagedRowsBeforeError": 2},
                  [None, {"K": -1, "Columns": 45}]):
        want = jax_image(data, 60, 12, parms)
        got = port_image(data, 60, 12, parms)
        assert got.shape == (12, 45) and np.array_equal(got, want)


def _damaged(rng, data: bytes) -> dict[str, bytes]:
    flip = bytearray(data)
    i = int(rng.integers(len(flip)))
    flip[i] ^= 1 << int(rng.integers(8))
    return {"cut": data[:int(rng.integers(1, len(data) + 1))], "flip": bytes(flip),
            "random": bytes(rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8)),
            "zeros": bytes(int(rng.integers(1, 30)))}


def _pil_rows(data: bytes, w: int, h: int, k: int):
    tiff = _ccitt_to_tiff(data, w, h, {"K": k})
    try:
        img = Image.open(io.BytesIO(tiff))
        img.load()
        return np.asarray(img.convert("L"))
    except OSError:
        return None


@pytest.mark.parametrize("kind", ["g4", "g3_1d"])
def test_damaged_strips_equal_pil_rows(kind):
    """Damaged strips: the port fails where PIL fails and gives PIL's
    rows as far as libtiff wrote them (G4: every damage; G3: cut and
    zeroed strips, see the module docstring)."""
    k = KINDS[kind]
    rng = np.random.default_rng(21 + k)
    checked = 0
    for _ in range(40):
        h, w = int(rng.integers(1, 12)), int(rng.integers(1, 80))
        bits = _bitmap(rng, h, w)
        for name, data in _damaged(rng, libtiff_strip(bits, k)).items():
            if k == 0 and name in ("flip", "random"):
                continue
            want = _pil_rows(data, w, h, k)
            try:
                got, rows = ccitt.decode_bits_plain(data, w, h, k)
            except ccitt.CcittError:
                assert want is None, name
                continue
            assert want is not None, name
            assert np.array_equal(ccitt.to_l(got, False)[:rows], want[:rows]), name
            checked += 1
    assert checked > 50


@pytest.fixture(scope="module")
def gxx_bilevel(tmp_path_factory):
    """``csrc/bilevel.cu`` built with g++ (it holds no device code)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/bilevel.cu on the CPU")
    out = tmp_path_factory.mktemp("bilevel") / "libbilevel.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    str(REPO / "rapiddoc_tpu_torch" / "csrc" / "bilevel.cu"), "-o", str(out)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


@pytest.mark.parametrize("kind", list(KINDS))
def test_compiled_decoder_equals_plain(kind, gxx_bilevel, monkeypatch):
    from rapiddoc_tpu_torch.ops import build

    monkeypatch.setattr(build, "load", lambda name: gxx_bilevel)
    k = KINDS[kind]
    rng = np.random.default_rng(31 + k)
    for _ in range(25):
        h, w = int(rng.integers(1, 20)), int(rng.integers(1, 300))
        strip = libtiff_strip(_bitmap(rng, h, w), k)
        for data in [strip, *_damaged(rng, strip).values(),
                     t4_rows(_bitmap(rng, h, w), False, False)]:
            outs = []
            for fn in (ccitt.decode_bits_plain, ccitt.decode_bits_compiled):
                try:
                    outs.append(fn(data, w, h, k))
                except ccitt.CcittError:
                    outs.append(None)
            if outs[0] is None or outs[1] is None:
                assert outs[0] is None and outs[1] is None
            else:
                assert outs[0][1] == outs[1][1] and np.array_equal(outs[0][0], outs[1][0])
