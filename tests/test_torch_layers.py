"""Each layer of the port (rapiddoc_tpu_torch/models/common/layers.py)
against its flax original, in fp32 on the CPU, on inputs made from a
numpy seed. Flax params are initialised from a seed and carried over by
the port's checkpoint loader. Tolerance rtol/atol 1e-4: fp32 summation
order only."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rapiddoc_tpu.models.common import layers as jl
from rapiddoc_tpu_torch.models.common import layers as tl
from rapiddoc_tpu_torch.models.weights import load_flax_into

TOL = dict(rtol=1e-4, atol=1e-4)


def _flat(variables) -> dict:
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, key)
            else:
                out[key] = np.asarray(v, np.float32)

    walk(variables, "")
    return out


def _randomize_bn(variables, rng):
    """Give BatchNorm non-trivial stats so the test sees them."""
    flat = _flat(variables)
    for k in flat:
        if k.endswith("/mean") or k.endswith("/bias"):
            flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32) * 0.1
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _wrap(module: torch.nn.Module, name: str) -> torch.nn.Module:
    root = torch.nn.Module()
    root.add_module(name, module)
    return root


def _run_pair(flax_mod, torch_mod, x_nhwc, nchw=True, seed=0):
    rng = np.random.default_rng(seed)
    variables = flax_mod.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    variables = _randomize_bn(jax.tree.map(np.asarray, variables), rng)
    # flax keys of a bare module have no module name: wrap both in "m"
    flat = {
        f"{k.split('/', 1)[0]}/m/{k.split('/', 1)[1]}": v
        for k, v in _flat(variables).items()
    }
    root = load_flax_into(_wrap(torch_mod, "m"), flat).eval()
    ref = np.asarray(flax_mod.apply(variables, jnp.asarray(x_nhwc)))
    xt = torch.from_numpy(x_nhwc)
    with torch.no_grad():
        if nchw:
            got = root.m(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        else:
            got = root.m(xt).numpy()
    return ref, got


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [
        dict(features=16, kernel_size=3, strides=1),
        dict(features=16, kernel_size=3, strides=2, act="gelu"),
        dict(features=8, kernel_size=(1, 7), groups=8, act="silu"),
        dict(features=16, kernel_size=3, strides=(2, 1), groups=8, act=None),
        dict(features=4, kernel_size=2, padding="VALID"),
    ],
)
def test_conv_bn_act(kw):
    x = _x((2, 12, 10, 8))
    tkw = dict(kw)
    feats = tkw.pop("features")
    ref, got = _run_pair(jl.ConvBNAct(**kw), tl.ConvBNAct(8, feats, **tkw), x)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("cls", ["SqueezeExcite", "ClampSqueezeExcite"])
def test_squeeze_excite(cls):
    x = _x((2, 6, 5, 16))
    ref, got = _run_pair(getattr(jl, cls)(16), getattr(tl, cls)(16), x)
    np.testing.assert_allclose(got, ref, **TOL)


def test_deconv2x2_bn_act():
    x = _x((2, 5, 7, 6))
    ref, got = _run_pair(jl.Deconv2x2BNAct(6, 4), tl.Deconv2x2BNAct(6, 4), x)
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got, ref, **TOL)


def test_deconv2x2_function():
    rng = np.random.default_rng(3)
    x = _x((1, 4, 3, 5))
    k = rng.standard_normal((5, 2, 2, 2)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    ref = np.asarray(jl.deconv2x2(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = tl.deconv2x2(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(k), torch.from_numpy(b)
    ).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_upsample_nearest(scale):
    x = _x((2, 3, 5, 4))
    ref = np.asarray(jl.upsample_nearest(jnp.asarray(x), scale))
    got = tl.upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), scale)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_max_pool_2x2_s1_ceil():
    x = _x((2, 5, 6, 3))
    ref = np.asarray(jl.max_pool_2x2_s1_ceil(jnp.asarray(x)))
    got = tl.max_pool_2x2_s1_ceil(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_mhsa():
    x = _x((2, 9, 24))
    ref, got = _run_pair(jl.MHSA(24, num_heads=4), tl.MHSA(24, num_heads=4), x, nchw=False)
    np.testing.assert_allclose(got, ref, **TOL)


def test_transformer_block():
    x = _x((2, 9, 24))
    ref, got = _run_pair(
        jl.TransformerBlock(24, num_heads=4, mlp_ratio=2.0),
        tl.TransformerBlock(24, num_heads=4, mlp_ratio=2.0), x, nchw=False,
    )
    np.testing.assert_allclose(got, ref, **TOL)
