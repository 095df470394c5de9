"""The port's MBart decoder, memory projector and greedy decode
(rapiddoc_tpu_torch/models/formula/decoder.py) against the JAX
package's, on the CPU in fp32, at a small width (vocab 128, d 32, 4
heads, 2 layers, 16 positions). Weights come from a JAX random init with
every leaf perturbed from a numpy seed (LayerNorms and positions
included) and are carried across by ``models/weights.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from rapiddoc_tpu.models.formula import decoder as jax_dec
from rapiddoc_tpu.ops.quant_head import quantize_weight_int8 as jax_quantize
from rapiddoc_tpu_torch.models.formula import decoder as dec
from rapiddoc_tpu_torch.models.weights import load_flax_into
from rapiddoc_tpu_torch.ops.quant_head import quantize_weight_int8

TOL = 1e-4
CFG = dict(vocab_size=128, d_model=32, layers=2, heads=4, ffn=64, max_positions=16)
B, S, MAX_LEN = 3, 6, 12


def flatten(tree) -> dict:
    """flax variables -> flat ``a/b/c`` dict of float32 numpy arrays."""
    return {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(dict(tree), sep="/").items()}


def unflatten(flat: dict):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def perturb(flat, seed, head_scale=1.0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        out[k] = v + np.float32(0.05) * rng.standard_normal(v.shape).astype(np.float32)
        if "lm_head" in k:
            out[k] = out[k] * np.float32(head_scale)
    return out


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: the decode is thousands
    of tiny ops, and with one OpenMP thread per core in each of the
    tier-1 run's six worker processes their spin-waits made it about
    100x slower (measured: six concurrent demo decodes took 301 s each
    at 8 threads, 2-3 s at 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_nets():
    """(jax cfg, jax decoder, dec flat, jax projector, mem flat) with the
    lm_head widened x4 so that the int8 head's argmax is tie-free."""
    cfg = jax_dec.MBartConfig(**CFG)
    hd = cfg.d_model // cfg.heads
    decoder, proj = jax_dec.MBartDecoder(cfg), jax_dec.MemoryProjector(cfg)
    key = jax.random.PRNGKey(0)
    zeros = np.zeros((cfg.layers, 1, MAX_LEN, cfg.heads, hd), np.float32)
    mem = np.zeros((cfg.layers, 1, S, cfg.heads, hd), np.float32)
    dec_vars = decoder.init(key, np.zeros((1, 1), np.int32), zeros, zeros, 0, mem, mem,
                            np.ones((1, S), bool))
    mem_vars = proj.init(key, np.zeros((1, S, cfg.d_model), np.float32))
    dec_flat = perturb(flatten(dec_vars), 1, head_scale=4.0)
    mem_flat = perturb(flatten(mem_vars), 2)
    return cfg, decoder, dec_flat, proj, mem_flat


@pytest.fixture(scope="module")
def nets():
    return make_nets()


def _port(nets):
    cfg, _, dec_flat, _, mem_flat = nets
    pcfg = dec.MBartConfig(**CFG)
    return (load_flax_into(dec.MBartDecoder(pcfg), dec_flat).eval(),
            load_flax_into(dec.MemoryProjector(pcfg), mem_flat).eval())


def _memory(seed):
    return np.random.default_rng(seed).standard_normal((B, S, CFG["d_model"])).astype(np.float32)


def test_memory_projector_matches_jax(nets):
    cfg, _, _, proj, mem_flat = nets
    memory = _memory(3)
    want_k, want_v = proj.apply(unflatten(mem_flat), jnp.asarray(memory))
    _, port_proj = _port(nets)
    with torch.no_grad():
        got_k, got_v = port_proj(torch.from_numpy(memory))
    assert got_k.shape == (cfg.layers, B, S, cfg.heads, cfg.d_model // cfg.heads)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,position", [(1, 0), (3, 4)])
def test_decoder_logits_and_caches_match_jax(nets, t, position):
    """One step at position 0, and a 3-token block at position 4 over a
    cache whose first 4 slots are already filled."""
    cfg, decoder, dec_flat, _, _ = nets
    hd = cfg.d_model // cfg.heads
    rng = np.random.default_rng(10 + t)
    tokens = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    shape = (cfg.layers, B, MAX_LEN, cfg.heads, hd)
    ck = np.zeros(shape, np.float32)
    cv = np.zeros(shape, np.float32)
    ck[:, :, :position] = rng.standard_normal(ck[:, :, :position].shape)
    cv[:, :, :position] = rng.standard_normal(cv[:, :, :position].shape)
    mk = rng.standard_normal((cfg.layers, B, S, cfg.heads, hd)).astype(np.float32)
    mv = rng.standard_normal((cfg.layers, B, S, cfg.heads, hd)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[0, -2:] = False  # one row sees only part of the memory
    want, want_k, want_v = decoder.apply(unflatten(dec_flat), jnp.asarray(tokens), ck, cv,
                                         position, mk, mv, jnp.asarray(mask))
    port, _ = _port(nets)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        got, got_k, got_v = port(torch.from_numpy(tokens), tk, tv, position,
                                 torch.from_numpy(mk), torch.from_numpy(mv),
                                 torch.from_numpy(mask))
    assert got.shape == (B, t, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=TOL, atol=TOL)
    # the caches were updated in place
    assert got_k is tk and got_v is tv


def test_skip_lm_head_returns_hidden_states(nets):
    port, _ = _port(nets)
    cfg = port.cfg
    hd = cfg.d_model // cfg.heads
    caches = torch.zeros((cfg.layers, 1, MAX_LEN, cfg.heads, hd))
    mem = torch.zeros((cfg.layers, 1, S, cfg.heads, hd))
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with torch.no_grad():
        hidden, _, _ = port(tok, caches.clone(), caches.clone(), 0, mem, mem, None,
                            skip_lm_head=True)
        logits, _, _ = port(tok, caches.clone(), caches.clone(), 0, mem, mem, None)
    assert hidden.shape == (1, 1, cfg.d_model)
    torch.testing.assert_close(port.lm_head(hidden), logits)


def _jax_decode(nets, memory, int8_head):
    cfg, decoder, dec_flat, proj, mem_flat = nets
    head = None
    if int8_head:
        head = jax_quantize(dec_flat["params/lm_head/kernel"])
    tokens, lengths = jax_dec.greedy_decode(
        decoder, unflatten(dec_flat), proj, unflatten(mem_flat), jnp.asarray(memory),
        jnp.ones(memory.shape[:2], bool), MAX_LEN, dtype=jnp.float32, int8_head=head,
    )
    return np.asarray(tokens), np.asarray(lengths)


def _eos_prone(nets):
    """(nets, memory) where every row ends early, at different steps: the
    lm_head columns of EOS and of a token t are swapped, with t a token
    that every row of a full-length decode emits, at different first
    steps (the first memory seed from 5 on that has one). Each row now
    ends where it emitted t."""
    cfg, decoder, dec_flat, proj, mem_flat = nets
    for seed in range(5, 25):
        memory = _memory(seed)
        tokens, _ = _jax_decode(nets, memory, int8_head=False)
        for t in dict.fromkeys(tokens.ravel().tolist()):
            if t == cfg.eos_token_id or not (tokens == t).any(axis=1).all():
                continue
            if len(set((tokens == t).argmax(axis=1).tolist())) > 1:
                flat = dict(dec_flat)
                w = flat["params/lm_head/kernel"].copy()
                w[:, [cfg.eos_token_id, t]] = w[:, [t, cfg.eos_token_id]]
                flat["params/lm_head/kernel"] = w
                return (cfg, decoder, flat, proj, mem_flat), memory
    raise AssertionError("no memory seed gives an early-exit case")


@pytest.mark.parametrize("int8_head", [False, True], ids=["plain_head", "int8_head"])
@pytest.mark.parametrize("eos_prone", [False, True], ids=["full_length", "early_exit"])
def test_greedy_decode_equals_jax(nets, int8_head, eos_prone):
    """Tokens and lengths equal to the JAX package's greedy_decode, with
    the plain lm_head and with the int8 head (JAX runs the Pallas kernel
    in interpret mode off the TPU)."""
    memory = _memory(4)
    if eos_prone:
        nets, memory = _eos_prone(nets)
    want_tok, want_len = _jax_decode(nets, memory, int8_head)
    cfg, _, dec_flat, _, _ = nets
    port, port_proj = _port(nets)
    head = None
    if int8_head:
        head = quantize_weight_int8(port.lm_head.weight.detach().t().contiguous())
    with torch.no_grad():
        tok, lengths, steps = dec.greedy_decode(
            port, port_proj, torch.from_numpy(memory), None, MAX_LEN, int8_head=head)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_array_equal(lengths.numpy(), want_len)
    # on the CPU the loop stops on the step where the last row finished
    assert steps == int(want_len.max())
    if eos_prone:
        assert want_len.max() < MAX_LEN and len(set(want_len.tolist())) > 1
    else:
        assert (want_len == MAX_LEN).all()
