"""The port's PPHGNetV2 (rapiddoc_tpu_torch/models/layout/hgnet.py)
against the JAX package's, on the CPU in fp32.

Weights come from a JAX random init, with every leaf (BatchNorm
statistics and the LAB scalars included) perturbed from a numpy seed so
that a wrong mapping cannot hide behind identity values, and are carried
across by ``models/weights.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from rapiddoc_tpu.models.layout import hgnet as jax_hgnet
from rapiddoc_tpu_torch.models.layout import hgnet
from rapiddoc_tpu_torch.models.weights import load_flax_into

TOL = 1e-4


def flatten(tree) -> dict:
    """flax variables -> flat ``a/b/c`` dict of float32 numpy arrays."""
    return {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(dict(tree), sep="/").items()}


def unflatten(flat: dict):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def perturbed(variables, seed):
    """Every leaf moved by a little noise (scales and variances by a
    positive factor), small enough that activations stay of order one
    through the whole backbone."""
    rng = np.random.default_rng(seed)
    flat = flatten(variables)
    for k, v in flat.items():
        noise = rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith(("/var", "/scale")):
            flat[k] = v * np.exp(np.float32(0.05) * noise)
        else:
            flat[k] = v + np.float32(0.02) * noise
    return flat


def test_pphgnetv2_b0_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 96, 384, 3)).astype(np.float32)
    model = jax_hgnet.PPHGNetV2("B0", out_indices=(2,))
    flat = perturbed(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    (want,) = jax.jit(model.apply)(unflatten(flat), jnp.asarray(x))
    port = load_flax_into(hgnet.PPHGNetV2("B0", out_indices=(2,)), flat).eval()
    with torch.no_grad():
        (got,) = port(torch.from_numpy(x))
    assert got.shape == (2, 6, 24, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _stem_case(lab_bias):
    x = np.random.default_rng(2).standard_normal((1, 32, 48, 3)).astype(np.float32)
    stem = jax_hgnet.HGStem([3, 16, 16], use_lab=True)
    flat = perturbed(jax.jit(stem.init)(jax.random.PRNGKey(1), jnp.asarray(x)), seed=3)
    flat["params/stem1/lab/bias"] = np.full((1,), lab_bias, np.float32)
    return x, stem, flat


def test_stem_pools_over_zero_padding():
    """A negative LAB bias makes stem1's output negative, so the zero
    padding of the 2x2/s1 max pool wins on the last row and column:
    replicate padding (the OCR layers' max_pool_2x2_s1_ceil) would
    differ there."""
    x, stem, flat = _stem_case(-20.0)
    want = np.asarray(jax.jit(stem.apply)(unflatten(flat), jnp.asarray(x)))
    port = load_flax_into(hgnet.HGStem([3, 16, 16], use_lab=True), flat).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        xp = port.stem1(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (xp < 0).all()  # the case this test is for
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=TOL, atol=TOL)
    # the same stem with replicate padding in the pool gives another result
    from rapiddoc_tpu_torch.models.common.layers import max_pool_2x2_s1_ceil

    zero_pooled = torch.nn.functional.max_pool2d(torch.nn.functional.pad(xp, (0, 1, 0, 1)), 2, 1)
    assert not torch.equal(zero_pooled, max_pool_2x2_s1_ceil(xp))


@pytest.mark.parametrize("size", ["B0", "B6"])
def test_checkpoint_layout_matches_flax_tree(size):
    """Every flax leaf of a full backbone has exactly one home in the
    port (load_flax_into is strict both ways), and the stage widths
    agree."""
    model = jax_hgnet.PPHGNetV2(size, out_indices=(3,))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    flat = flatten(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    port = load_flax_into(hgnet.PPHGNetV2(size, out_indices=(3,)), flat)
    assert sum(p.numel() for p in port.parameters()) + sum(
        b.numel() for b in port.buffers()) == sum(v.size for v in flat.values())
    assert hgnet.PPHGNetV2.out_channels(size) == jax_hgnet.PPHGNetV2.out_channels(size)
