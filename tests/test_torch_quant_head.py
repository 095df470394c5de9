"""The int8 fused head of the port (rapiddoc_tpu_torch/ops/quant_head.py).

On the CPU the wrapper takes the kernel's plain PyTorch version; it is
held against the JAX package's ``fused_argmax_int8`` in interpret mode
(the Pallas kernel run off the TPU): ids equal, softmax prob within 2e-6
relative (both sides: bf16 x times bf16(int8) with fp32 accumulation,
the scale applied after the dot). 2e-6 is the fp32 floor here, not a
margin: with logits up to about 9, each side's prob lies up to 9e-7
from a float64 evaluation of the same bf16 inputs (the fp32 rounding
of the top logit shifts every exp term), and the two sides differ by
up to 1.07e-6 at V = 8193. The quantizer must give the JAX
package's (q, scale) bit for bit. The CUDA kernel runs only on the
card: ``chip_smoke.py`` holds it against the plain version there, and
``test_cuda_kernel_matches_plain`` does when a card is present."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rapiddoc_tpu.ops.quant_head import fused_argmax_int8 as jax_fused_argmax_int8
from rapiddoc_tpu.ops.quant_head import quantize_weight_int8 as jax_quantize
from rapiddoc_tpu_torch.ops.quant_head import (
    TILE_V,
    fused_argmax_int8,
    quant_argmax_plain,
    quantize_weight_int8,
    ranges,
    row_tile,
)


def _inputs(n, k, v, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = (rng.standard_normal((k, v)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(v) * 0.1).astype(np.float32)
    return x, w, bias


def test_quantize_bit_equal_to_jax():
    _, w, _ = _inputs(1, 512, 1000, seed=0)
    w[:, 7] = 0.0  # an all-zero column takes the 1e-12 scale floor
    w[3, 9] = 0.5 * np.abs(w[:, 9]).max()  # exact halves round to even
    q, scale = quantize_weight_int8(torch.from_numpy(w))
    jq, jscale = jax_quantize(jnp.asarray(w))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("v", [4096, 8193])
def test_plain_matches_pallas_kernel(v):
    x, w, bias = _inputs(16, 512, v, seed=v)
    wq, scale = quantize_weight_int8(torch.from_numpy(w))
    ref_ids, ref_conf = jax_fused_argmax_int8(
        jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(scale.numpy()),
        jnp.asarray(bias), interpret=True,
    )
    ids, conf = fused_argmax_int8(torch.from_numpy(x), wq, scale, torch.from_numpy(bias))
    assert ids.shape == (16,) and ids.dtype == torch.int32 and conf.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref_conf), rtol=2e-6)


def test_padding_never_wins():
    # far below one vocabulary tile: the Pallas kernel pads V to 8192
    # with scale 0 and bias -1e30, the CUDA kernel skips columns past V
    x, w, bias = _inputs(4, 32, 7, seed=1)
    bias[:] = -50.0  # every real logit well below zero
    wq, scale = quantize_weight_int8(torch.from_numpy(w))
    ids, conf = fused_argmax_int8(torch.from_numpy(x), wq, scale, torch.from_numpy(bias))
    ref_ids, _ = jax_fused_argmax_int8(
        jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(scale.numpy()),
        jnp.asarray(bias), interpret=True,
    )
    assert (ids < 7).all() and ((conf > 0) & (conf <= 1)).all()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def test_ties_go_to_lowest_index():
    # equal columns on both sides of the Pallas kernel's 8192-wide tile
    # boundary: the first one wins, with prob 1 / (number of ties)
    v = 8200
    x = np.ones((4, 8), np.float32)
    w = np.zeros((8, v), np.float32)
    w[:, [5, 150, 8195]] = 1.0
    wq, scale = quantize_weight_int8(torch.from_numpy(w))
    ids, conf = fused_argmax_int8(torch.from_numpy(x), wq, scale, torch.zeros(v))
    assert ids.tolist() == [5] * 4
    e = np.exp(-8.0)
    np.testing.assert_allclose(conf.numpy(), 1.0 / (3 + (v - 3) * e), rtol=1e-6)
    ref_ids, _ = jax_fused_argmax_int8(
        jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(scale.numpy()),
        jnp.zeros(v), interpret=True,
    )
    assert np.asarray(ref_ids).tolist() == [5] * 4


@pytest.mark.parametrize("n,v", [(16, 50000), (4, 50000), (16, 57), (4, 57), (5, 8193), (40, 4096)])
def test_vocab_ranges_cover_every_tile(n, v):
    n_ranges, per = ranges(n, v)
    n_tiles = -(-v // TILE_V)
    assert n_ranges * per >= n_tiles > (n_ranges - 1) * per  # no empty range
    assert 1 <= n_ranges <= n_tiles
    assert row_tile(n) == (4 if n <= 4 else 16)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(8, 3, dtype=torch.int8)
    with pytest.raises(ValueError):
        fused_argmax_int8(torch.zeros(4, 9), q, torch.ones(3), torch.zeros(3))
    with pytest.raises(ValueError):
        fused_argmax_int8(torch.zeros(4, 8), q, torch.ones(4), torch.zeros(3))
    with pytest.raises(ValueError):
        fused_argmax_int8(torch.zeros(4, 8), q.float(), torch.ones(3), torch.zeros(3))


def test_cpu_tensors_take_plain_version_without_launching():
    x, w, bias = _inputs(4, 512, 57, seed=2)
    wq, scale = quantize_weight_int8(torch.from_numpy(w))
    args = (torch.from_numpy(x), wq, scale, torch.from_numpy(bias))
    before = fused_argmax_int8.launches
    ids, conf = fused_argmax_int8(*args)
    pids, pconf = quant_argmax_plain(*args)
    assert fused_argmax_int8.launches == before
    assert torch.equal(ids, pids) and torch.equal(conf, pconf)


@pytest.mark.cuda
@pytest.mark.parametrize("n,v", [(16, 50000), (4, 50000), (16, 57), (3, 57), (20, 1001)])
def test_cuda_kernel_matches_plain(n, v):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, bias = _inputs(n, 512, v, seed=3)
    wq, scale = quantize_weight_int8(torch.from_numpy(w).cuda())
    args = (torch.from_numpy(x).cuda(), wq, scale, torch.from_numpy(bias).cuda())
    before = fused_argmax_int8.launches
    ids, conf = fused_argmax_int8(*args)
    torch.cuda.synchronize()
    assert fused_argmax_int8.launches == before + 1
    pids, pconf = quant_argmax_plain(*args)
    assert torch.equal(ids, pids)
    assert ((conf - pconf).abs() <= 1e-5 * pconf + 1e-8).all()
