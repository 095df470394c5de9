"""The int8 fused head of the port (rapiddoc_tpu_torch/ops/quant_head.py).

On the CPU the wrapper takes the kernel's plain PyTorch version; it is
held against the JAX package's ``fused_argmax_int8`` in interpret mode
(the Pallas kernel run off the TPU): ids equal, and each side's softmax
prob held to a float64 evaluation of the same bf16 inputs (bf16 x times
bf16(int8), the scale applied after the dot), within

    8 u L + ceil(log2 V) u,   u = 2^-24, L = the row's largest |logit|.

Why that bound: a logit computed in fp32 rounds at least once at its
own magnitude (u L), and its K-term dot, whose partial sums stay of the
order of the logits for these zero-mean inputs, adds a few such
roundings in whatever order the backend sums; the prob moves by at most
the top logit's error plus the weighted mean of the others', 2 x 4 u L;
the sum of V positive exp terms in fp32 adds ceil(log2 V) u for a
pairwise or blocked sum. ``test_bound_covers_fp32_summation_orders``
holds a blocked matmul and sequential, reversed and pairwise sums to
it. The sides are not held to each other: each may lie on either side
of float64, so a side-to-side limit sits on the fp32 floor and breaks
whenever a backend changes its summation order. The quantizer must give the JAX
package's (q, scale) bit for bit. The CUDA kernel runs only on the
card: ``chip_smoke.py`` holds it against the plain version there, and
``test_cuda_kernel_matches_plain`` does when a card is present. The
schedule tests here check the plan the wrapper hands the kernel; that the
kernel's own indexing follows it (ragged V, several blocks merged) is
what the ``cuda`` tests check."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rapiddoc_tpu.ops.quant_head import fused_argmax_int8 as jax_fused_argmax_int8
from rapiddoc_tpu.ops.quant_head import quantize_weight_int8 as jax_quantize
from rapiddoc_tpu_torch.ops.layout import aligned_rows, has_aligned_rows, with_aligned_rows
from rapiddoc_tpu_torch.ops.quant_head import (
    ROWS,
    SMS,
    TILE_V,
    fused_argmax_int8,
    quant_argmax_plain,
    quantize_weight_int8,
    schedule,
)

U = 2.0 ** -24  # fp32 unit roundoff


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
    # float64 of the same bf16 inputs, and the fp32 bound of the docstring
    xb = torch.from_numpy(x).bfloat16().double().numpy()
    logits = (xb @ wq.double().numpy()) * scale.double().numpy() + bias.astype(np.float64)
    exact = 1.0 / np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)
    bound = 8 * U * np.abs(logits).max(-1) + np.ceil(np.log2(v)) * U
    for side in (conf.numpy(), np.asarray(ref_conf)):
        assert (np.abs(side / exact - 1.0) <= bound).all()


def _fp32_conf(dot, scale, bias):
    logits = (dot.astype(np.float32) * scale).astype(np.float32) + bias
    e = np.exp(logits - logits.max(-1, keepdims=True)).astype(np.float32)
    return np.float32(1) / e.sum(-1, dtype=np.float32)


@pytest.mark.parametrize("order", ["blocked", "sequential", "reversed", "pairwise"])
def test_bound_covers_fp32_summation_orders(order):
    # the docstring's bound against the same bf16 inputs summed in fp32 in
    # four orders: a backend may sum in any of them
    v = 8193
    x, w, bias = _inputs(16, 512, v, seed=v)
    wq, scale = quantize_weight_int8(torch.from_numpy(w))
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    q = wq.float().numpy()
    terms = xb[:, :, None] * q[None]  # exact in fp32
    if order == "blocked":
        dot = xb @ q
    elif order == "pairwise":
        dot = terms
        while dot.shape[1] > 1:
            dot = (dot[:, 0::2] + dot[:, 1::2]).astype(np.float32)
        dot = dot[:, 0]
    else:
        dot = np.zeros((16, v), np.float32)
        for k in range(512) if order == "sequential" else reversed(range(512)):
            dot = (dot + terms[:, k]).astype(np.float32)
    logits = (xb.astype(np.float64) @ q.astype(np.float64)) * scale.double().numpy() + bias
    exact = 1.0 / np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)
    bound = 8 * U * np.abs(logits).max(-1) + np.ceil(np.log2(v)) * U
    err = np.abs(_fp32_conf(dot, scale.numpy(), bias) / exact - 1.0)
    assert (err <= bound).all()
    assert err.max() > 1e-7  # the fp32 floor is there to be bounded


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
def test_schedule_covers_every_tile(n, v):
    plan = schedule(n, v)
    n_tiles = -(-v // TILE_V)
    tiles = [list(range(b, n_tiles, plan.n_blocks)) for b in range(plan.n_blocks)]
    assert sorted(t for ts in tiles for t in ts) == list(range(n_tiles))  # each tile once
    assert all(1 <= len(ts) <= plan.tiles_per_block for ts in tiles)  # no empty block
    assert plan.n_blocks * -(-n // ROWS) <= max(SMS, -(-n // ROWS))  # at most a block per SM


@pytest.mark.parametrize("n,v", [(16, 57), (4, 57), (3, 100)])
def test_single_range_needs_no_merge(n, v):
    # a vocabulary of one tile is one block, which writes ids and conf itself
    plan = schedule(n, v)
    assert plan.n_blocks == 1 and not plan.merge
    assert schedule(16, 50000).merge


def test_aligned_rows_keep_values_and_results():
    x, w, bias = _inputs(4, 64, 57, seed=5)
    wq, scale = quantize_weight_int8(torch.from_numpy(w))
    view = aligned_rows(wq)
    assert view.shape == wq.shape and view.dtype == torch.int8
    assert view.stride(1) == 1 and view.stride(0) % 16 == 0 and view.stride(0) >= 57
    assert torch.equal(view, wq)
    args = (torch.from_numpy(x), scale, torch.from_numpy(bias))
    got, want = fused_argmax_int8(args[0], view, *args[1:]), fused_argmax_int8(args[0], wq, *args[1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["int8_v64", "int8_v57", "bf16_c120", "bf16_c20", "view_offset",
                                  "padded", "transposed"])
def test_with_aligned_rows_copies_only_unaligned_layouts(case):
    # what the wrappers hand the kernels: rows on 16 bytes, copied only
    # where they are not (no model's head or activation is)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(12, 64, generator=g)
    dtype, t, aligned = {
        "int8_v64": (torch.int8, w.to(torch.int8), True),
        "int8_v57": (torch.int8, w[:, :57].to(torch.int8).contiguous(), False),
        "bf16_c120": (torch.bfloat16, torch.randn(12, 120, generator=g).bfloat16(), True),
        "bf16_c20": (torch.bfloat16, w[:, :20].bfloat16(), False),
        "view_offset": (torch.bfloat16, w.bfloat16()[:, 1:57], False),
        "padded": (torch.int8, aligned_rows(w[:, :57].to(torch.int8)), True),
        "transposed": (torch.bfloat16, w.bfloat16().t()[:, :8], False),
    }[case]
    assert t.dtype == dtype and has_aligned_rows(t) == aligned
    out = with_aligned_rows(t, dtype)
    assert out.dtype == dtype and has_aligned_rows(out) and torch.equal(out, t)
    assert (out.data_ptr() == t.data_ptr()) == aligned


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


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("n,v", [(n, v) for n in (3, 4, 5, 16) for v in (57, 1001, 8193, 50000)]
                         + [(20, 1001)])
def test_cuda_kernel_matches_plain(n, v, aligned):
    _cuda_or_skip()
    x, w, bias = _inputs(n, 512, v, seed=3)
    wq, scale = quantize_weight_int8(torch.from_numpy(w).cuda())
    if aligned:
        wq = aligned_rows(wq)
    args = (torch.from_numpy(x).cuda(), wq, scale, torch.from_numpy(bias).cuda())
    before = fused_argmax_int8.launches
    ids, conf = fused_argmax_int8(*args)
    torch.cuda.synchronize()
    assert fused_argmax_int8.launches == before + 1
    pids, pconf = quant_argmax_plain(*args)
    assert torch.equal(ids, pids)
    assert ((conf - pconf).abs() <= 1e-5 * pconf + 1e-8).all()


@pytest.mark.cuda
def test_cuda_ties_go_to_lowest_index():
    # equal columns in three vocabulary ranges and inside one lane's run
    _cuda_or_skip()
    v = 50000
    w = torch.zeros(512, v)
    w[:, [5, 6, 150, 20000, 49999]] = 1.0
    wq, scale = quantize_weight_int8(w.cuda())
    ids, conf = fused_argmax_int8(torch.ones(16, 512).cuda(), wq, scale, torch.zeros(v).cuda())
    assert ids.tolist() == [5] * 16
    e = np.exp(-512.0)
    np.testing.assert_allclose(conf.cpu().numpy(), 1.0 / (5 + (v - 5) * e), rtol=1e-6)
