"""The port's RapidDoc with the table stage on, against the JAX package's,
on the CPU.

``RAPIDDOC_DEMO_LAYOUT=1`` with the table stage on (the JAX bench's
headline: layout, OCR, formula and table, demo checkpoints) over the
layout fixture ``layout_smoke_doc.pdf``: 15 table regions, 13 routed to
the UNet (two of them to the ruling-line extractor) and 2 to SLANet. The
golden (``table_smoke_golden.json``, rebuilt by ``python
tests/test_torch_table.py``) holds the JAX package's Markdown, content
list, every table's HTML, the LaTeX and the payload sha256, with the
in-table images' uuid4 placeholders masked.

In fp32 the port must give the golden exactly, in one window and with
one page per window (``DeferredAR`` then packs the formula and table
regions of four windows, formulas first). In bf16 with the int8 formula
head it must meet the limits ``chip_smoke.py`` holds the card's run to.

The demo checkpoints on the 15 table crops of the layout fixture
(``rapiddoc_tpu_torch/assets/table_smoke_crops.npz``), fp32, against the
JAX package's outputs stored with them: classifier kinds, the UNet's line
bits (every differing bit a near-tie), cells and grid, SLANet tokens and
boxes, UniTable tokens. The UNet's bits of a crop the fp32 parse already
dispatched with the same wire bytes are that parse's; the others are
computed here.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_torch_table as tt  # noqa: E402


def port_parse(pdf: bytes, mode: str, window: int | None = None):
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    dtype = torch.float32 if mode.startswith("fp32") else torch.bfloat16
    extra = {"RAPIDDOC_INT8_HEAD": "1"} if mode.endswith("int8") else {}
    if window is not None:
        extra["RAPIDDOC_PROCESSING_WINDOW_SIZE"] = str(window)
    with tt.table_env(**extra):
        return RapidDoc(device="cpu", dtype=dtype)(pdf, parse_method="ocr")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs (see
    test_torch_table.few_threads)."""
    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(tt.GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def pdf() -> bytes:
    return tt.DOC_PDF.read_bytes()


@pytest.fixture(scope="module")
def stored() -> dict:
    with np.load(tt.CROPS_NPZ) as z:
        return dict(z)


@pytest.fixture(scope="module")
def fp32_parse(pdf):
    """The fp32 parse with the default window, and the UNet's line bits
    of every crop it dispatched, by the sha256 of the crop's wire bytes."""
    from rapiddoc_tpu_torch.models.table.unet import WiredTableStructure

    seen = {}
    dispatch = WiredTableStructure.dispatch

    def recording(self, prepped):
        handles = dispatch(self, prepped)
        rows = [bits for h, n in handles for bits in h[:n].numpy()]
        seen.update({tt.sha256(p): bits for p, bits in zip(prepped, rows)})
        return handles

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(WiredTableStructure, "dispatch", recording)
        out = port_parse(pdf, "fp32")
    return out, seen


@pytest.mark.parametrize("window", [None, 1])
def test_port_fp32_equals_golden(request, pdf, golden, window):
    """fp32, int8 head off: Markdown, content list, every table's HTML,
    LaTeX and payload sha256 equal to the golden's, with the default
    window and with one page per window; the table stage ran on all 15
    regions."""
    if window is None:
        out = request.getfixturevalue("fp32_parse")[0]
    else:
        out = port_parse(pdf, "fp32", window)
    got = tt.parse_summary(out)
    want = golden["fp32"]
    assert golden["fp32_window1_equal"]
    for key in ("markdown", "content_list", "tables", "latex", "images"):
        assert got[key] == want[key], key
    assert out.stage_report["table"]["items"] >= 15
    if window is None:
        tt._pipeline_helpers().assert_dets_equal(
            tt.mask_uuids(tt._pipeline_helpers().plain(out.model_json), out.model_json),
            want["model_info"])


def test_port_bf16_int8_meets_the_card_limits(pdf, golden):
    """bf16 with the int8 formula head against the JAX package's bf16
    int8 golden, held to the limits chip_smoke.py holds its main_path run to."""
    smoke = tt._pipeline_helpers()._chip_smoke()
    vs = smoke.compare_table_parse(tt.parse_summary(port_parse(pdf, "bf16_int8")),
                                   golden["bf16_int8"])
    smoke.check_table_parse_bf16(vs)


def test_demo_checkpoints_on_golden_crops_fp32(golden, stored, fp32_parse):
    """fp32 on the 15 table crops of the layout fixture: classifier
    kinds equal and probabilities within 1e-5, the UNet's line bits equal
    but for near-ties, cells and grid equal, SLANet tokens and lengths
    equal with boxes within tt.SLANET_BOX_TOL px, UniTable tokens equal."""
    import torch

    crops = tt.crops_of(stored)
    assert [tt.sha256(c) for c in crops] == golden["crops"]["sha256"]
    want = golden["stages"]["fp32"]
    rec = tt.port_table()
    np.testing.assert_allclose(rec.classifier.probs(crops), stored["fp32/cls_probs"],
                               rtol=0, atol=1e-5)
    assert rec.classifier(crops) == want["kinds"]
    wired = rec.wired
    prepped = [wired.preprocess(c) for c in crops]
    seen = fp32_parse[1]
    rest = [i for i, p in enumerate(prepped) if tt.sha256(p) not in seen]
    assert len(rest) < len(crops)
    ran = dict(zip(rest, (bits for h, n in wired.dispatch([prepped[i] for i in rest])
                          for bits in h[:n].numpy())))
    bits = np.stack([ran[i] if i in ran else seen[tt.sha256(p)]
                     for i, p in enumerate(prepped)])
    tt.check_unet_bits(rec, crops, bits, stored["fp32/unet_bits"])
    structs = wired.finish(crops, [(torch.from_numpy(bits), len(crops))])
    assert [list(map(list, g)) for _, g in structs] == want["grid"]
    for (cells, _), wc in zip(structs, want["cells"]):
        np.testing.assert_allclose(np.asarray(cells).reshape(-1, 4),
                                   np.asarray(wc).reshape(-1, 4), rtol=0, atol=1e-9)
    sla = rec.wireless
    batch = torch.from_numpy(np.stack([sla.preprocess(c) for c in crops] + [sla.preprocess(crops[-1])]))
    tokens, locs, lengths = (a.numpy()[:15] for a in sla.run(batch))
    np.testing.assert_array_equal(lengths, stored["fp32/slanet_lengths"])
    np.testing.assert_array_equal(tokens, stored["fp32/slanet_tokens"])
    # the sigmoid quads, which become boxes times the crop's longer side
    # (<= 942 px here): 1e-5 is 0.01 px
    np.testing.assert_allclose(locs, stored["fp32/slanet_locs"], rtol=0, atol=1e-5)
    uni = tt.port_table("unet_unitable").wireless
    batch = torch.from_numpy(np.stack([tt.uni_resize(c) for c in crops] + [tt.uni_resize(crops[-1])]))
    tokens, lengths = (a.numpy()[:15] for a in uni.run(batch, tt.UNITABLE_MAX_LEN))
    np.testing.assert_array_equal(lengths, stored["fp32/unitable_lengths"])
    np.testing.assert_array_equal(tokens, stored["fp32/unitable_tokens"])
