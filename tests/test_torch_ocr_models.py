"""DBNet and SVTRRec of the port against the JAX package's, with the
demo checkpoints carried over by rapiddoc_tpu_torch/models/weights.py,
in fp32 on the CPU. Inputs are crops of the committed fixture page,
normalized on both sides by the same numpy code.

Tolerances: prob map 1e-4 and rec features 1e-3 absolute (fp32
summation order through ~60 layers; features reach magnitude ~20). The
threshold bitmap must be equal away from pixels within 1e-4 of the
threshold, and the bit-packed device output equal to the JAX one."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rapiddoc_tpu.models.ocr.det import DBNet as JaxDBNet
from rapiddoc_tpu.models.ocr.rec import SVTRRec as JaxSVTRRec
from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables
from rapiddoc_tpu_torch.models.ocr.det import DBNet
from rapiddoc_tpu_torch.models.ocr.engine import det_wire
from rapiddoc_tpu_torch.models.ocr.rec import SVTRRec
from rapiddoc_tpu_torch.models.weights import load_flax_into, load_npz

PAGES = Path(__file__).resolve().parent.parent / "rapiddoc_tpu_torch" / "assets" / "ocr_smoke_pages.npz"
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
THRESH = 0.3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(4)


@pytest.fixture(scope="module")
def page():
    with np.load(PAGES) as z:
        return z["pages"][0]


def test_dbnet_matches_jax(page):
    x = np.stack([page[96:224, 32:224], page[400:528, 500:692]])
    x = ((x.astype(np.float32) / 255.0 - MEAN) / STD).astype(np.float32)
    variables = _load_variables(DEMO_ASSETS_DIR / "ocr_det_demo.npz")
    ref = np.asarray(JaxDBNet().apply(variables, jnp.asarray(x)))[..., 0]
    model = load_flax_into(DBNet(), load_npz(DEMO_ASSETS_DIR / "ocr_det_demo.npz")).eval()
    with torch.no_grad():
        got_t = model(torch.from_numpy(x))[..., 0]
    got = got_t.numpy()
    assert got.shape == ref.shape == (2, 128, 192)
    assert (ref > THRESH).mean() > 0.01  # the crops hold text
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    clear = np.abs(ref - THRESH) > 1e-4
    np.testing.assert_array_equal((got > THRESH)[clear], (ref > THRESH)[clear])
    # the packed wire matches the JAX package's bit order and 4-bit map
    wire = det_wire(torch.tensor(ref), THRESH)
    bits = np.packbits(ref > THRESH, axis=2)
    np.testing.assert_array_equal(wire["bits"].numpy(), bits)
    pooled = ref.reshape(2, 64, 2, 96, 2).mean(axis=(2, 4))
    q = np.round(pooled * 15.0).astype(np.uint8)
    p4 = wire["prob4"].numpy()
    np.testing.assert_array_equal(p4 >> 4, q[..., 0::2])
    np.testing.assert_array_equal(p4 & 15, q[..., 1::2])


@pytest.mark.parametrize("width", [160, 320])
def test_svtr_rec_matches_jax(page, width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, 256, (2, 48, width, 3)).astype(np.float32)
    x[0, :, : min(width, 288)] = page[100:148, 40 : 40 + min(width, 288)]
    x = x / 127.5 - 1.0
    variables = _load_variables(DEMO_ASSETS_DIR / "ocr_rec_demo.npz")
    ref = np.asarray(JaxSVTRRec(num_classes=96).apply(
        variables, jnp.asarray(x), features_only=True
    ))
    model = load_flax_into(
        SVTRRec(num_classes=96), load_npz(DEMO_ASSETS_DIR / "ocr_rec_demo.npz")
    ).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), features_only=True).numpy()
    assert got.shape == ref.shape == (2, width // 8, 120)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    # the head's (C, V) kernel is carried over as stored
    np.testing.assert_array_equal(
        model.head.kernel.detach().numpy(), variables["params"]["head"]["kernel"]
    )


def test_published_charset_gets_a_random_head(page):
    """charset_path swaps in the published 18,710-entry dictionary with a
    seeded random head over the demo backbone and neck."""
    from rapiddoc_tpu_torch.models.registry import PUBLISHED_DICT, build_ocr_system

    system = build_ocr_system(device="cpu", dtype=torch.float32, charset_path=PUBLISHED_DICT)
    rec = system.recognizer
    assert len(rec.decoder.chars) == 18710
    assert tuple(rec.session.module.head.kernel.shape) == (120, 18710)
    out = rec([page[100:130, 40:300], page[200:240, 60:500]])
    assert len(out) == 2 and all(isinstance(r.text, str) for r in out)
