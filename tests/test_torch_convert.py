"""The port's checkpoint converters, ``convert_weights`` and the registry's
published formula and table builds against the JAX package, on the CPU.

State dicts in the published key layouts come from
``tests/torch_published.py`` (seeded, narrow widths: a B0 backbone and 2
decoder layers for the formula, 2 + 2 layers of 64/128 for UniTable).
Every converter kind's tree must equal the JAX package's leaf for leaf
(key, dtype, shape, value) with the same ``TorchDict.unused()`` keys, and
equal the helper's own tree (so the helper inverts the key maps). The
models built from the two trees then run the same inputs in fp32:
outputs within 1e-4 relative (fp32 summation order only).
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rapiddoc_tpu.engine.weights as jax_weights
import rapiddoc_tpu.models.formula.convert as jax_formula
import rapiddoc_tpu.models.layout.hgnet_convert as jax_hgnet
import rapiddoc_tpu.models.ocr.convert as jax_ocr
import rapiddoc_tpu.models.table.convert as jax_table
import rapiddoc_tpu_torch.engine.weights as port_weights
import rapiddoc_tpu_torch.models.formula.convert as port_formula
import rapiddoc_tpu_torch.models.layout.hgnet_convert as port_hgnet
import rapiddoc_tpu_torch.models.ocr.convert as port_ocr
import rapiddoc_tpu_torch.models.table.convert as port_table
from rapiddoc_tpu_torch.models.table.unitable import UniTableDims
from rapiddoc_tpu_torch.models.weights import load_flax_into, load_npz, nest_models, subtree

import torch_published as P

NARROW = dict(layers=2, d_model=32, ffn=64, heads=4, vocab_size=60, max_len=64)
UNI_DIMS = UniTableDims(enc_d=64, enc_layers=2, dec_d=128, dec_layers=2, dec_ffn=96)
EXTRA = "extra.unused.weight"  # a key no converter reads


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(4)


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _formula_modules() -> dict:
    from rapiddoc_tpu_torch.models.formula.model import build_formula_modules

    enc, dec, mem, _ = build_formula_modules(
        max_len=NARROW["max_len"], vocab_size=NARROW["vocab_size"], layers=2,
        backbone_size="B0", out_index=3, d_model=32, ffn=64, heads=4)
    return {"encoder": enc, "decoder": dec, "mem_proj": mem}


def _hgnet_sd(seed):
    backbone = P.formula_modules(backbone_size="B0", **NARROW)["encoder"].backbone
    return P.checkpoint({"": backbone}, lambda _, p: P.hgnet_torch_key(p, ""), seed)


def _unitable(seed):
    enc, dec, flat = P.unitable_checkpoint(seed, UNI_DIMS)
    return (enc, dec), flat


# kind -> (state dicts and the helper's tree, converter of a package)
KINDS = {
    "det": (lambda: P.det_checkpoint(1), lambda m, sd: m.det_variables_from_torch(sd)),
    "rec": (lambda: P.rec_checkpoint(2, num_classes=50),
            lambda m, sd: m.rec_variables_from_torch(sd)),
    "formula": (lambda: P.formula_checkpoint(3, backbone_size="B0", **NARROW),
                lambda m, sd: m.formula_variables_from_torch(sd, layers=2, backbone_size="B0")),
    "formula_bare": (lambda: P.formula_checkpoint(4, bare=True, **{**NARROW, "layers": 6}),
                     lambda m, sd: dict(zip(("decoder", "mem_proj"),
                                            m.decoder_variables_from_torch(sd)))),
    "unitable": (lambda: _unitable(5), lambda m, sds: m.unitable_variables_from_torch(*sds)),
    "hgnet": (lambda: _hgnet_sd(6), lambda m, sd: dict(zip(
        ("params", "batch_stats"), m.hgnet_variables_from_torch(m.TorchDict(sd), "", "B0")))),
}
MODULES = {
    "jax": {"det": jax_ocr, "rec": jax_ocr, "formula": jax_formula, "formula_bare": jax_formula,
            "unitable": jax_table, "hgnet": jax_hgnet},
    "port": {"det": port_ocr, "rec": port_ocr, "formula": port_formula,
             "formula_bare": port_formula, "unitable": port_table, "hgnet": port_hgnet},
}


def _convert(package: str, kind: str, sds, monkeypatch):
    """The package's tree and every TorchDict's unused keys."""
    made = []
    cls = (jax_weights if package == "jax" else port_weights).TorchDict
    init = cls.__init__

    def recording(self, sd):
        init(self, sd)
        made.append(self)

    monkeypatch.setattr(cls, "__init__", recording)
    tree = KINDS[kind][1](MODULES[package][kind], sds)
    monkeypatch.setattr(cls, "__init__", init)
    # keys that no TorchDict read (each dict over a full checkpoint leaves
    # the other models' keys unused)
    never = set().union(*(t.sd for t in made)) - set().union(*(t.used for t in made))
    return tree, [t.unused() for t in made], {k for k in never
                                               if not k.endswith("num_batches_tracked")}


def _with_extra(sds):
    if isinstance(sds, tuple):
        return ({**sds[0], EXTRA: torch.zeros(2)}, sds[1])
    return {**sds, EXTRA: torch.zeros(2)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_converter_tree_equals_jax(kind, monkeypatch):
    sds, want = KINDS[kind][0]()
    sds = _with_extra(sds)
    jax_tree, jax_unused, jax_never = _convert("jax", kind, sds, monkeypatch)
    port_tree, port_unused, port_never = _convert("port", kind, sds, monkeypatch)
    jflat, pflat = flatten(jax_tree), flatten(port_tree)
    assert list(pflat) == list(jflat)
    for k, v in jflat.items():
        assert pflat[k].dtype == v.dtype and pflat[k].shape == v.shape, k
        np.testing.assert_array_equal(pflat[k], v, err_msg=k)
    assert port_unused == jax_unused
    assert port_never == jax_never == {EXTRA}
    # the helper's state dict is the inverse of the key map
    if kind == "hgnet":
        jflat = {("params/" if not k.startswith("batch_stats") else "") + k
                 if not k.startswith(("params/", "batch_stats/")) else k: v
                 for k, v in jflat.items()}
    assert set(jflat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)


def _trees(kind):
    sds, _ = KINDS[kind][0]()
    return (KINDS[kind][1](MODULES["jax"][kind], sds),
            flatten(KINDS[kind][1](MODULES["port"][kind], sds)))


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_converted_dbnet_matches_jax():
    from rapiddoc_tpu.models.ocr.det import DBNet as JaxDBNet
    from rapiddoc_tpu_torch.models.ocr.det import DBNet

    jax_tree, port_flat = _trees("det")
    x = np.random.default_rng(0).standard_normal((1, 96, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxDBNet().apply)(jax_tree, jnp.asarray(x)))
    model = load_flax_into(DBNet(), port_flat).eval()
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), want)


def test_converted_svtr_rec_matches_jax():
    from rapiddoc_tpu.models.ocr.rec import SVTRRec as JaxRec
    from rapiddoc_tpu_torch.models.ocr.rec import SVTRRec

    jax_tree, port_flat = _trees("rec")
    x = np.random.default_rng(1).uniform(-1, 1, (2, 48, 160, 3)).astype(np.float32)
    apply = jax.jit(functools.partial(JaxRec(num_classes=50).apply, features_only=True))
    want = np.asarray(apply(jax_tree, jnp.asarray(x)))
    model = load_flax_into(SVTRRec(num_classes=50), port_flat).eval()
    with torch.no_grad():
        _close(model(torch.from_numpy(x), features_only=True).numpy(), want)


def test_converted_formula_encoder_and_first_step_match_jax():
    """The B0 encoder's memory, then the first decode step's logits (BOS
    at position 0) from the memory projector and the 2-layer decoder."""
    from rapiddoc_tpu.models.formula.model import build_formula_modules as jax_modules

    jax_tree, port_flat = _trees("formula")
    widths = dict(max_len=NARROW["max_len"], vocab_size=NARROW["vocab_size"], layers=2,
                  d_model=32, ffn=64, heads=4, backbone_size="B0", out_index=3)
    jenc, jdec, jmem, cfg = jax_modules(**widths)
    ports = _formula_modules()
    for name, module in ports.items():
        load_flax_into(module.eval(), subtree(port_flat, name))
    x = np.random.default_rng(2).standard_normal((2, 64, 256, 3)).astype(np.float32)
    memory = np.asarray(jax.jit(jenc.apply)(jax_tree["encoder"], jnp.asarray(x)))
    with torch.no_grad():
        got = ports["encoder"](torch.from_numpy(x))
    _close(got.numpy(), memory)
    b, s = memory.shape[:2]
    hd = cfg.d_model // cfg.heads
    caches = np.zeros((cfg.layers, b, 8, cfg.heads, hd), np.float32)
    cur = np.full((b, 1), cfg.bos_token_id, np.int32)
    mk, mv = jmem.apply(jax_tree["mem_proj"], jnp.asarray(memory))
    want, _, _ = jax.jit(jdec.apply, static_argnums=4)(
        jax_tree["decoder"], cur, caches, caches, 0, mk, mv, jnp.ones((b, s), bool))
    with torch.no_grad():
        tk, tv = ports["mem_proj"](torch.from_numpy(np.array(memory)))
        tcaches = [torch.zeros(caches.shape) for _ in range(2)]
        logits, _, _ = ports["decoder"](torch.from_numpy(cur), *tcaches, 0, tk, tv, None)
    _close(logits.numpy(), np.asarray(want))


def test_converted_unitable_encoder_and_first_step_match_jax():
    from rapiddoc_tpu.models.formula.decoder import MemoryProjector as JaxMem
    from rapiddoc_tpu.models.table import unitable as J
    from rapiddoc_tpu_torch.models.table.unitable import UniTableModel

    jax_tree, port_flat = _trees("unitable")
    dims = J.UniTableDims(enc_d=64, enc_layers=2, dec_d=128, dec_layers=2, dec_ffn=96)
    jenc = J.UniTableEncoder(d_model=64, layers=2, heads=dims.enc_heads)
    jdec, jmem = J.GPTFastDecoder(cfg=dims), JaxMem(dims)
    model = load_flax_into(UniTableModel(UNI_DIMS), nest_models(port_flat)).eval()
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 80, 3)).astype(np.float32)
    memory = np.asarray(jax.jit(jenc.apply)(jax_tree["encoder"], jnp.asarray(x)))
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    _close(got.numpy(), memory)
    mem_in = np.concatenate([memory, memory], axis=-1)  # the decoder reads 128-wide memory
    b, s = mem_in.shape[:2]
    caches = np.zeros((dims.layers, b, 8, dims.heads, dims.head_dim), np.float32)
    cur = np.full((b, 1), J.PREFIX_ID, np.int32)
    mk, mv = jmem.apply(jax_tree["mem_proj"], jnp.asarray(mem_in))
    want = jdec.apply(jax_tree["decoder"], cur, caches, caches, 0, mk, mv,
                      jnp.ones((b, s), bool))[0]
    with torch.no_grad():
        tk, tv = model.mem_proj(torch.from_numpy(mem_in))
        tcaches = [torch.zeros(caches.shape) for _ in range(2)]
        logits = model.decoder(torch.from_numpy(cur), *tcaches, 0, tk, tv, None)
    _close(logits.numpy(), np.asarray(want))


# ---------------------------------------------------------------- the CLI


def _write_sources(src):
    """Checkpoint files of every converter kind, narrow, seeded."""
    from safetensors.torch import save_file

    src.mkdir()
    det, _ = P.det_checkpoint(7)
    save_file({k: v.contiguous() for k, v in det.items()}, str(src / "det.safetensors"))
    torch.save({"state_dict": det, "epoch": 3}, src / "det_wrapped.pth")
    rec, _ = P.rec_checkpoint(8, num_classes=50)
    save_file({k: v.contiguous() for k, v in rec.items()}, str(src / "rec.safetensors"))
    bare, _ = P.formula_checkpoint(9, bare=True, **{**NARROW, "layers": 6})
    torch.save(bare, src / "decoder.pth")
    full, _ = P.formula_checkpoint(9, backbone_size="B0", **NARROW)
    torch.save(full, src / "formula_b0.pth")
    (enc, dec), _ = _unitable(10)
    (src / "unitable").mkdir()
    torch.save(enc, src / "unitable" / "encoder.pth")
    torch.save(dec, src / "unitable" / "decoder.pth")
    (src / "unitable" / "vocab.json").write_text(json.dumps(P.unitable_vocab()))
    import yaml

    (src / "inference.yml").write_text(yaml.safe_dump(P.inference_config(
        P.tokenizer_spec(700, seed=11)), allow_unicode=True), encoding="utf-8")
    (src / "ppocrv6_small_dict.txt").write_text("a\nb\nc\n")


def _run(main, argv, models, monkeypatch):
    monkeypatch.setenv("RAPIDDOC_MODELS_DIR", str(models))
    try:
        return main(argv)
    except Exception as exc:
        return type(exc).__name__


def _tree_of(models):
    out = {}
    for path in sorted(p for p in models.rglob("*") if p.is_file()):
        rel = str(path.relative_to(models))
        if path.suffix == ".npz":
            with np.load(path) as z:
                out[rel] = {k: z[k] for k in z.files}
        else:
            out[rel] = path.read_bytes()
    return out


def test_convert_weights_cli_equals_jax(tmp_path, monkeypatch, capsys):
    """Every converter through ``main`` of both packages on the same
    files: the same exit codes, the same files in the models dir (npz
    leaves equal after load, other files byte-equal), including usage
    errors, a missing checkpoint, an output path and a ``state_dict``
    wrapper; a B0 formula checkpoint fails in both (the CLI converts the
    published B6 layout)."""
    from rapiddoc_tpu.tools.convert_weights import main as jax_main
    from rapiddoc_tpu_torch.tools.convert_weights import main as port_main

    src = tmp_path / "src"
    _write_sources(src)
    cases = [
        ["det", str(src / "det.safetensors")],
        ["det", str(src / "det_wrapped.pth"), "custom/det_out.npz"],
        ["rec", str(src / "rec.safetensors")],
        ["formula", str(src / "decoder.pth")],
        ["formula", str(src / "formula_b0.pth")],
        ["unitable", str(src / "unitable" / "encoder.pth")],
        ["unitable", str(src / "unitable")],
        ["formula_dict", str(src / "inference.yml")],
        ["dict", str(src / "ppocrv6_small_dict.txt")],
        [], ["det"], ["nope", str(src / "det.safetensors")], ["det", str(src / "missing.pth")],
    ]
    for n, argv in enumerate(cases):
        results = {}
        for name, main in (("jax", jax_main), ("port", port_main)):
            models = tmp_path / f"{name}_{n}"
            models.mkdir()
            out_argv = list(argv)
            if len(argv) == 3:
                out_argv[2] = str(models / argv[2])
            monkeypatch.chdir(models)
            results[name] = (_run(main, out_argv, models, monkeypatch), _tree_of(models))
            capsys.readouterr()
        (jrc, jfiles), (prc, pfiles) = results["jax"], results["port"]
        assert prc == jrc, argv
        assert sorted(pfiles) == sorted(jfiles), argv
        for rel, want in jfiles.items():
            got = pfiles[rel]
            if isinstance(want, dict):
                assert list(got) == list(want), rel
                for k in want:
                    assert got[k].dtype == want[k].dtype, (rel, k)
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rel} {k}")
            else:
                assert got == want, rel
    assert results["jax"][0] == 1  # the missing checkpoint, last


# ---------------------------------------------------------------- registry


def test_registry_builds_the_published_formula(tmp_path, monkeypatch):
    """A converted formula_net_plus_m.npz and formula_tokenizer.json in
    the models dir: the registry builds the published recognizer (here
    under a narrow FormulaConfig: the default one is B6 at 50 000 tokens)
    with the npz's weights, decoding through the tokenizer replay, which
    equals the JAX package's FormulaTokenizer on the decoded ids."""
    from tokenizers import Tokenizer

    from rapiddoc_tpu.models.formula.engine import FormulaTokenizer as JaxTok
    from rapiddoc_tpu_torch.models import registry
    from rapiddoc_tpu_torch.models.formula.engine import FormulaConfig, FormulaTokenizer, fix_latex
    from rapiddoc_tpu_torch.models.weights import save_variables
    from rapiddoc_tpu_torch.utils.hf_tokenizer import Tokenizer as Replay

    models = tmp_path / "models"
    monkeypatch.setenv("RAPIDDOC_MODELS_DIR", str(models))
    monkeypatch.delenv("RAPIDDOC_DISABLE_FORMULA", raising=False)
    sd, _ = P.formula_checkpoint(12, backbone_size="B0", **NARROW)
    save_variables(port_formula.formula_variables_from_torch(sd, layers=2, backbone_size="B0"),
                   models / "formula_net_plus_m.npz")
    tok_path = models / "formula_tokenizer.json"
    tok_path.write_text(json.dumps(P.tokenizer_spec(NARROW["vocab_size"], seed=13)))
    narrow = dict(max_len=NARROW["max_len"], vocab_size=NARROW["vocab_size"], layers=2,
                  backbone_size="B0", d_model=32, ffn=64, heads=4, default_length_bucket=16)
    monkeypatch.setattr(registry, "FormulaConfig", functools.partial(FormulaConfig, **narrow))
    rec = registry.build_formula_model({}, device="cpu", dtype=torch.float32)
    assert isinstance(rec.tokenizer, FormulaTokenizer) and isinstance(rec.tokenizer._tok, Replay)
    flat = load_npz(models / "formula_net_plus_m.npz")
    fresh = _formula_modules()
    for name, module in fresh.items():
        load_flax_into(module, subtree(flat, name))
        got = getattr(rec, name).state_dict()
        for k, v in module.state_dict().items():
            assert torch.equal(got[k], v), (name, k)
    rng = np.random.default_rng(14)
    crops = [np.full((40, 120, 3), 255, np.uint8) for _ in range(2)]
    for c in crops:
        c[10:30, 10:110] = rng.integers(0, 120, (20, 100, 3))
    ids = rec.batch_predict(crops, return_ids=True)
    latex = rec.batch_predict(crops)
    hf = Tokenizer.from_file(str(tok_path))
    assert any(ids)
    for i, seq in enumerate(ids):
        assert latex[i] == fix_latex(hf.decode(seq, skip_special_tokens=True)) == \
            JaxTok(tok_path).decode(seq)
    monkeypatch.setenv("RAPIDDOC_DISABLE_FORMULA", "1")
    assert registry.build_formula_model({}, device="cpu") is None


VOCAB_CASES = {
    "token_to_id": lambda: {**P.unitable_vocab(), "<td></td>": 13, "<td>[": 12},
    "id_to_token": lambda: {str(i): t for t, i in P.unitable_vocab().items() if i % 2},
    "tokenizer_json": lambda: {"version": "1.0", "model": {"vocab": P.unitable_vocab()}},
    "not_a_map": lambda: [1, 2, 3],
    "bad_ids": lambda: {"a": "b"},
}


@pytest.mark.parametrize("case", sorted(VOCAB_CASES) + ["corrupt", "missing"])
def test_table_vocab_reads_as_jax(case, tmp_path):
    from rapiddoc_tpu.models.table.unitable import TableVocab as JaxVocab
    from rapiddoc_tpu_torch.models.table.unitable import TableVocab

    path = tmp_path / "unitable_vocab.json"
    if case == "corrupt":
        path.write_text("{oops")
    elif case != "missing":
        path.write_text(json.dumps(VOCAB_CASES[case]()))
    assert TableVocab(path).id_to_token == JaxVocab(path).id_to_token
    ids = list(range(0, 80)) + [1]
    assert TableVocab(path).decode(ids) == JaxVocab(path).decode(ids)


def test_registry_prefers_published_table_npz(tmp_path, monkeypatch):
    """Published table_cls.npz and a converted table_unitable.npz (with
    unitable_vocab.json) in the models dir take priority over the demo
    checkpoints; the models the dir does not hold come from the demos."""
    from rapiddoc_tpu.models.table.unitable import TableVocab as JaxVocab
    from rapiddoc_tpu_torch.config import DEMO_ASSETS_DIR
    from rapiddoc_tpu_torch.models.registry import build_table_model
    from rapiddoc_tpu_torch.models.table.cls import TableClsNet
    from rapiddoc_tpu_torch.models.table.unet import UNet
    from rapiddoc_tpu_torch.models.table.unitable import UniTableModel
    from rapiddoc_tpu_torch.tools.convert_weights import main

    models = tmp_path / "models"
    models.mkdir()
    monkeypatch.setenv("RAPIDDOC_MODELS_DIR", str(models))
    monkeypatch.delenv("RAPIDDOC_DISABLE_TABLE", raising=False)
    demo_cls = load_npz(DEMO_ASSETS_DIR / "table_cls_demo.npz")
    published_cls = {k: (v * np.float32(1.5) if v.dtype == np.float32 else v)
                     for k, v in demo_cls.items()}
    np.savez(models / "table_cls.npz", **published_cls)
    src = tmp_path / "unitable"
    src.mkdir()
    (enc, dec), _ = _unitable(15)
    torch.save(enc, src / "encoder.pth")
    torch.save(dec, src / "decoder.pth")
    vocab = {**P.unitable_vocab(), "<td></td>": 13, "<td>[": 12}
    (src / "vocab.json").write_text(json.dumps(vocab))
    assert main(["unitable", str(src / "encoder.pth")]) == 0
    assert (models / "table_unitable.npz").is_file() and (models / "unitable_vocab.json").is_file()

    rec = build_table_model({"strategy": "unitable"}, device="cpu", dtype=torch.float32)
    assert rec.config.use_cls_model
    _same_state(rec.classifier.model, load_flax_into(TableClsNet(), published_cls))
    uni = rec.wireless
    assert uni.dims == UNI_DIMS
    _same_state(uni.model, load_flax_into(
        UniTableModel(UNI_DIMS), nest_models(load_npz(models / "table_unitable.npz"))))
    assert uni.vocab.id_to_token == JaxVocab(models / "unitable_vocab.json").id_to_token
    assert uni.vocab.id_to_token[13] == "<td></td>"
    # the default strategy: the UNet from its demo checkpoint, the cls published
    default = build_table_model({}, device="cpu", dtype=torch.float32)
    _same_state(default.wired.model,
                load_flax_into(UNet(), load_npz(DEMO_ASSETS_DIR / "table_unet_demo.npz")))
    _same_state(default.classifier.model, load_flax_into(TableClsNet(), published_cls))


def _same_state(got: torch.nn.Module, want: torch.nn.Module) -> None:
    got_sd, want_sd = got.state_dict(), want.state_dict()
    assert list(got_sd) == list(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
