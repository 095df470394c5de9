"""The fused CTC head of the port (rapiddoc_tpu_torch/ops/ctc_head.py).

On the CPU the wrapper takes the kernel's plain PyTorch version; it is
held against the JAX package's ``ctc_head_decode``, which runs the
Pallas kernel in interpret mode off-TPU. Ids must be equal and the
softmax prob within 1e-3 (both sides: bf16 inputs, fp32 accumulation).
The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there, and ``test_cuda_kernel_matches_plain``
does when a card is present. The schedule tests here check the plan the
wrapper hands the kernel; that the kernel's own indexing follows it
(every range, ragged V, several ranges merged) is what the ``cuda``
tests check."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rapiddoc_tpu.ops.ctc_head import ctc_head_decode as jax_ctc_head_decode
from rapiddoc_tpu_torch.ops.ctc_head import (
    MIN_TILES_PER_RANGE,
    TV,
    ctc_argmax_plain,
    ctc_head_decode,
    fused_ctc_argmax,
    pad_ctc_kernel,
    schedule,
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
def test_schedule_covers_every_tile(n, v):
    plan = schedule(n, v)
    n_tiles = -(-v // TV)
    per = plan.tiles_per_range
    tiles = [list(range(r * per, min((r + 1) * per, n_tiles))) for r in range(plan.n_ranges)]
    assert [t for ts in tiles for t in ts] == list(range(n_tiles))  # each tile once, in order
    assert all(ts for ts in tiles)  # no empty block
    assert plan.tiles_per_range >= min(MIN_TILES_PER_RANGE, n_tiles)


@pytest.mark.parametrize("n,v", [(10240, 96), (5, 7), (640, 4 * 64)])
def test_single_range_needs_no_merge(n, v):
    # the demo vocabulary (2 tiles) is one range: one launch writes ids and conf
    plan = schedule(n, v)
    assert plan.n_ranges == 1 and not plan.merge
    assert schedule(10240, 18710).merge


def test_padded_kernel_keeps_values_and_results():
    feats, w, bias = _inputs(1, 6, 120, 18710, seed=4)
    wt = torch.from_numpy(w)
    padded = pad_ctc_kernel(wt)
    assert padded.shape == wt.shape and padded.dtype == torch.bfloat16
    assert padded.stride(1) == 1 and (padded.stride(0) * 2) % 16 == 0
    assert torch.equal(padded, wt.to(torch.bfloat16))
    x, b = torch.from_numpy(feats[0]), torch.from_numpy(bias)
    got, want = fused_ctc_argmax(x, padded, b), fused_ctc_argmax(x, wt, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("n,v", [(n, v) for n in (5, 10240) for v in (7, 96, 3001, 18710)])
def test_cuda_kernel_matches_plain(n, v, padded):
    _cuda_or_skip()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n, 120)).astype(np.float32)).cuda()
    wt = torch.from_numpy((rng.standard_normal((120, v)) * 0.1).astype(np.float32)).cuda()
    bt = torch.from_numpy((rng.standard_normal(v) * 0.1).astype(np.float32)).cuda()
    kernel = pad_ctc_kernel(wt) if padded else wt
    before = fused_ctc_argmax.launches
    ids, conf = fused_ctc_argmax(x, kernel, bt)
    torch.cuda.synchronize()
    assert fused_ctc_argmax.launches == before + 1
    pids, pconf = ctc_argmax_plain(x, wt, bt)
    logits = x.bfloat16().float() @ wt.bfloat16().float() + bt
    top2 = logits.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert not ((ids != pids) & decisive).any()
    # relative: conf is about 3e-3 at V = 18710, merged from 33 vocabulary ranges
    assert ((conf - pconf).abs() <= 1e-5 * pconf + 1e-8).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c,offset", [(20, 0), (120, 1)])
def test_cuda_unaligned_x_matches_plain(c, offset):
    # x rows that do not start on 16 bytes (C = 20: 40-byte rows; a view
    # one element in): the wrapper copies x into aligned rows
    _cuda_or_skip()
    rng = np.random.default_rng(c)
    base = torch.from_numpy(rng.standard_normal((300, c + offset)).astype(np.float32)).cuda()
    x = base.bfloat16()[:, offset:]
    wt = torch.from_numpy((rng.standard_normal((c, 3001)) * 0.1).astype(np.float32)).cuda()
    bt = torch.from_numpy((rng.standard_normal(3001) * 0.1).astype(np.float32)).cuda()
    ids, conf = fused_ctc_argmax(x, pad_ctc_kernel(wt), bt)
    pids, pconf = ctc_argmax_plain(x, wt, bt)
    logits = x.float() @ wt.bfloat16().float() + bt
    top2 = logits.topk(2, dim=-1).values
    assert not ((ids != pids) & ((top2[:, 0] - top2[:, 1]) > 1e-3)).any()
    assert ((conf - pconf).abs() <= 1e-5 * pconf + 1e-8).all()


@pytest.mark.cuda
def test_cuda_ties_go_to_lowest_index():
    # identical columns in several vocabulary ranges and in one lane's run
    _cuda_or_skip()
    v = 18710
    w = torch.zeros(120, v)
    w[:, [5, 7, 150, 9000, 18709]] = 1.0
    ids, conf = fused_ctc_argmax(torch.ones(300, 120).cuda(), w.cuda(), torch.zeros(v).cuda())
    assert ids.tolist() == [5] * 300
    np.testing.assert_allclose(conf.cpu().numpy(), 1.0 / (5 + (v - 5) * np.exp(-120.0)), rtol=1e-6)
