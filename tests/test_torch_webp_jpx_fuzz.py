"""Damaged WEBP and JPEG 2000 files: the port decides as PIL does.

Each case flips one or two bits of a file PIL wrote (seeded), in the RIFF
and VP8X headers, an animation's ANIM and ANMF chunks, the VP8 frame
header and its tokens, a VP8L stream, an ``ALPH`` chunk, a JPEG 2000
codestream's marker segments, its packet data, or a JP2 file's boxes.
Where PIL decodes the file, the port gives PIL's mode and pixels (plain and
compiled), or raises NotImplementedError naming ROADMAP item 12f for a
feature it has not ported; where PIL refuses it, the port raises. These
cases found the rules the decoders' docstrings and ROADMAP Queue 3 record
(libwebp's demuxer walk and SSE2 transform, OpenJPEG's marker,
tile-part, box and segment rules).
"""
import random
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(1, str(REPO))

import torch_host_builds as hb  # noqa: E402
import torch_webp_jpx as fx  # noqa: E402


def _flip(data: bytes, lo: int, hi: int, rng: random.Random) -> bytes:
    out = bytearray(data)
    for _ in range(rng.randint(1, 2)):
        out[rng.randint(lo, hi)] ^= 1 << rng.randint(0, 7)
    return bytes(out)


def _cases() -> dict[str, tuple[str, bytes]]:
    webp = {"vp8": fx.pil_bytes(fx.smooth(3, 64, 48), "WEBP", quality=60),
            "vp8l": fx.pil_bytes(fx.smooth(4, 40, 30, "RGBA"), "WEBP", lossless=True),
            "alph": fx.pil_bytes(fx.smooth(5, 40, 30, "RGBA"), "WEBP", quality=60),
            "anim": fx.small_first_frame(True)}
    jpx = fx.jpx_cases()
    out = {}
    rng = random.Random(19)
    for name, data, lo, hi, count in (
            ("vp8_header", webp["vp8"], 30, 42, 16), ("vp8_tokens", webp["vp8"], 43, None, 10),
            ("vp8l", webp["vp8l"], 25, None, 12), ("alph", webp["alph"], 38, None, 8),
            # the RIFF, VP8X and first chunk headers (not the canvas size)
            ("container", webp["alph"], 0, 23, 8), ("anim", webp["anim"], 30, 90, 8)):
        for i in range(count):
            out[f"webp_{name}_{i}"] = ("webp", _flip(data, lo, hi or len(data) - 1, rng))
    for name in ("rgb", "tiles_offsets", "la"):
        data = jpx[name]
        cs0 = data.find(b"\xff\x4f\xff\x51")
        sod = data.find(b"\xff\x93")
        for region, lo, hi, count in (("header", cs0, sod, 10), ("data", sod + 2, len(data) - 3, 4),
                                      ("boxes", 0, max(cs0 - 1, 0), 6 if cs0 else 0)):
            for i in range(count):
                out[f"jpx_{name}_{region}_{i}"] = ("jpx", _flip(data, lo, hi, rng))
    return out


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_damaged_file_decided_as_pil(name):
    from rapiddoc_tpu_torch.pdfio.jpx import jpx_mode
    from rapiddoc_tpu_torch.pdfio.webp import webp_mode

    kind, data = CASES[name]
    decode = webp_mode if kind == "webp" else jpx_mode
    try:
        want = fx.pil_pixels(data)
    except Exception:  # noqa: BLE001 - PIL refuses the file
        want = None
    runs = [False] + ([True] if hb.gxx() is not None else [])
    for compiled in runs:
        with hb.compiled_host():
            try:
                got = decode(data, compiled=compiled)
            except NotImplementedError as exc:
                assert "ROADMAP Queue 1 item 12: 12f" in str(exc)
                continue
            except ValueError:
                assert want is None, "the port refuses a file PIL decodes"
                continue
        assert want is not None, "the port decodes a file PIL refuses"
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
