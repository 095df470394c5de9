"""The fused CTC head of the port (rapiddoc_tpu_torch/ops/ctc_head.py).

On the CPU the wrapper takes the kernel's plain PyTorch version; it is
held against the JAX package's ``ctc_head_decode``, which runs the
Pallas kernel in interpret mode off-TPU. Ids must be equal and the
softmax prob within 1e-3 (both sides: bf16 inputs, fp32 accumulation).
The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there, and ``test_cuda_kernel_matches_plain``
does when a card is present."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rapiddoc_tpu.ops.ctc_head import ctc_head_decode as jax_ctc_head_decode
from rapiddoc_tpu_torch.ops.ctc_head import (
    _splits,
    ctc_argmax_plain,
    ctc_head_decode,
    fused_ctc_argmax,
)


def _inputs(b, t, c, v, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((c, v)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(v) * 0.1).astype(np.float32)
    return feats, w, bias


@pytest.mark.parametrize("v", [96, 3001])
def test_plain_matches_pallas_kernel(v):
    feats, w, bias = _inputs(2, 5, 120, v, seed=v)
    ref_ids, ref_conf = jax_ctc_head_decode(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(bias)
    )
    ids, conf = ctc_head_decode(
        torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(bias)
    )
    assert ids.shape == (2, 5) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref_conf), atol=1e-3)


def test_padding_never_wins():
    # a vocabulary far below one 128-column tile: the kernel's padded
    # columns must never be chosen; the plain version has none
    feats, w, bias = _inputs(1, 3, 16, 7, seed=1)
    ids, conf = ctc_head_decode(
        torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(bias)
    )
    ref_ids, _ = jax_ctc_head_decode(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(bias))
    assert (ids < 7).all() and ((conf > 0) & (conf <= 1)).all()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def test_ties_go_to_lowest_index():
    # identical columns give identical logits: the first one wins, and
    # each tied winner gets prob 1 / (number of ties)
    x = torch.ones(4, 8)
    w = torch.zeros(8, 300)
    w[:, [5, 150, 299]] = 1.0
    ids, conf = fused_ctc_argmax(x, w, torch.zeros(300))
    assert ids.tolist() == [5] * 4
    e = np.exp(-8.0)
    np.testing.assert_allclose(conf.numpy(), 1.0 / (3 + 297 * e), rtol=1e-6)
    feats = np.ones((1, 4, 8), np.float32)
    ref_ids, _ = jax_ctc_head_decode(
        jnp.asarray(feats), jnp.asarray(w.numpy()), jnp.zeros(300)
    )
    assert np.asarray(ref_ids).tolist() == [[5] * 4]


@pytest.mark.parametrize("n,v", [(10240, 96), (10240, 18710), (5, 7), (640, 3001)])
def test_vocab_split_covers_every_tile(n, v):
    n_splits, per = _splits(n, v)
    n_tiles = -(-v // 128)
    assert n_splits * per >= n_tiles > (n_splits - 1) * per  # no empty range
    assert 1 <= n_splits <= n_tiles


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        fused_ctc_argmax(torch.zeros(4, 8), torch.zeros(9, 3), torch.zeros(3))
    with pytest.raises(ValueError):
        fused_ctc_argmax(torch.zeros(4, 8), torch.zeros(8, 3), torch.zeros(4))


def test_cpu_tensors_take_plain_version_without_launching():
    feats, w, bias = _inputs(1, 6, 120, 96, seed=2)
    before = fused_ctc_argmax.launches
    ids, conf = fused_ctc_argmax(
        torch.from_numpy(feats[0]), torch.from_numpy(w), torch.from_numpy(bias)
    )
    pids, pconf = ctc_argmax_plain(
        torch.from_numpy(feats[0]), torch.from_numpy(w), torch.from_numpy(bias)
    )
    assert fused_ctc_argmax.launches == before
    assert torch.equal(ids, pids) and torch.equal(conf, pconf)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    feats, w, bias = _inputs(64, 80, 120, 18710, seed=3)
    x = torch.from_numpy(feats.reshape(-1, 120)).cuda()
    wt, bt = torch.from_numpy(w).cuda(), torch.from_numpy(bias).cuda()
    ids, conf = fused_ctc_argmax(x, wt, bt)
    pids, pconf = ctc_argmax_plain(x, wt, bt)
    logits = x.bfloat16().float() @ wt.bfloat16().float() + bt
    top2 = logits.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert not ((ids != pids) & decisive).any()
    # relative: conf is about 3e-3 at this width, merged from 7 vocabulary ranges
    assert ((conf - pconf).abs() <= 1e-5 * pconf + 1e-8).all()
