"""The port's readers of the published checkpoints' formats against the
packages the JAX package reads them with (safetensors 0.8, PyYAML 6,
tokenizers 0.22):

- ``utils/safetensors.py`` against ``safetensors`` (every dtype, metadata,
  zero-size and scalar tensors; malformed files refused by both);
- ``utils/yaml_subset.py`` against ``yaml.safe_load`` (synthetic inference
  ymls and seeded plain data dumped by PyYAML in several styles; inputs
  outside the subset refused, malformed ones refused by both);
- ``utils/hf_tokenizer.py`` against ``tokenizers`` (tokenizers trained here
  on seeded LaTeX for each model and decoder, the 50 000-entry stand-in
  of the published formula tokenizer; a few hundred id sequences each,
  with special, added and out-of-range ids), and ``FormulaTokenizer``
  against the JAX package's.
"""
import json
import math
import random
import struct

import numpy as np
import pytest
import torch
import yaml

from rapiddoc_tpu_torch.utils import hf_tokenizer, safetensors as st_port, yaml_subset

import torch_published as P

# ---------------------------------------------------------------- safetensors


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 4, generator=g), "f64": torch.randn(2, generator=g).double(),
        "f16": torch.randn(5, generator=g).half(), "bf16": torch.randn(3, 2, generator=g).bfloat16(),
        "i64": torch.arange(6).reshape(2, 3), "i32": torch.arange(3, dtype=torch.int32),
        "i16": torch.arange(4, dtype=torch.int16), "i8": torch.arange(-2, 2, dtype=torch.int8),
        "u8": torch.arange(4, dtype=torch.uint8), "bool": torch.tensor([True, False, True]),
        "u16": torch.arange(3, dtype=torch.int32).to(torch.uint16),
        "u32": torch.arange(3).to(torch.uint32), "u64": torch.arange(3).to(torch.uint64),
        "f8e4m3": torch.randn(4, generator=g).to(torch.float8_e4m3fn),
        "f8e5m2": torch.randn(4, generator=g).to(torch.float8_e5m2),
        "empty": torch.zeros(0, 3), "scalar": torch.tensor(2.5),
    }


def _same_tensor(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.numel():
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_safetensors_reader_equals_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    path = tmp_path / "t.safetensors"
    save_file(_tensors(), str(path), metadata={"format": "pt", "note": "é"})
    want, got = load_file(str(path)), st_port.load_file(path)
    assert list(sorted(got)) == list(sorted(want))
    for k in want:
        _same_tensor(got[k], want[k])
    with safe_open(str(path), framework="pt") as f:
        assert st_port.metadata(path) == f.metadata()
    save_file({"a": torch.ones(2)}, str(path))
    assert st_port.metadata(path) is None


def _malformed(body: bytes, header: dict) -> dict[str, bytes]:
    def pack(h, data=body):
        text = json.dumps(h).encode()
        return struct.pack("<Q", len(text)) + text + data

    def edit(**change):
        h = json.loads(json.dumps(header))
        for k, v in change.items():
            name, field = k.split("__")
            if v is None:
                del h[name][field]
            else:
                h[name][field] = v
        return pack(h)

    first = header["a"]["data_offsets"]
    return {
        "short": b"\x01\x00", "huge_header": struct.pack("<Q", 10 ** 12) + b"{}",
        "header_past_file": struct.pack("<Q", 1000) + b"{}",
        "not_json": struct.pack("<Q", 3) + b"{ab", "not_object": struct.pack("<Q", 2) + b"[]",
        "not_utf8": struct.pack("<Q", 3) + b"{\xff}",
        "trailing_text": struct.pack("<Q", 4) + b"{}ab",
        "overlap": edit(a__data_offsets=[first[0], first[1] + 4]),
        "gap": edit(a__data_offsets=[first[0] + 4, first[1] + 4]),
        "truncated": pack(header, body[:-1]), "extra_bytes": pack(header, body + b"\0\0"),
        "bad_dtype": edit(a__dtype="F33"), "bad_shape": edit(a__shape=[4, 4]),
        "negative_dim": edit(a__shape=[-1]), "float_dim": edit(a__shape=[1.5, 12]),
        "three_offsets": edit(a__data_offsets=[0, 48, 3]), "no_shape": edit(a__shape=None),
        "bad_metadata": pack({**header, "__metadata__": {"x": 1}}),
        "empty_header_with_bytes": pack({}),
    }


def test_safetensors_reader_refuses_what_package_refuses(tmp_path):
    from safetensors.torch import load_file, save_file

    path = tmp_path / "t.safetensors"
    save_file({"a": torch.arange(12, dtype=torch.float32), "b": torch.ones(2, 2)}, str(path))
    raw = path.read_bytes()
    n = struct.unpack("<Q", raw[:8])[0]
    header, body = json.loads(raw[8:8 + n]), raw[8 + n:]
    # what the package reads, the reader reads too: leading spaces, extra
    # fields, a null __metadata__
    ok = {"space_first": struct.pack("<Q", n + 1) + b" " + raw[8:]}
    h = json.loads(json.dumps(header))
    h["a"]["extra"] = 1
    h["__metadata__"] = None
    text = json.dumps(h).encode()
    ok["extra_field"] = struct.pack("<Q", len(text)) + text + body
    for name, data in {**ok, **_malformed(body, header)}.items():
        path.write_bytes(data)
        try:
            want = load_file(str(path))
        except Exception:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                st_port.load_file(path)
        else:
            got = st_port.load_file(path)
            assert name in ok and set(got) == set(want), name
            for k in want:
                _same_tensor(got[k], want[k])


# ---------------------------------------------------------------- YAML

STYLES = {
    "safe_dump": (yaml.safe_dump, {}),
    "dump": (yaml.dump, {}),
    "safe_dump_unicode": (yaml.safe_dump, {"allow_unicode": True}),
    "dump_unicode": (yaml.dump, {"allow_unicode": True}),
    "flow_none": (yaml.safe_dump, {"default_flow_style": None}),
    "flow_none_unicode": (yaml.dump, {"default_flow_style": None, "allow_unicode": True}),
    "flow_true": (yaml.safe_dump, {"default_flow_style": True}),
    "narrow_indent4": (yaml.safe_dump, {"width": 24, "indent": 4, "sort_keys": False}),
    "explicit_start": (yaml.dump, {"explicit_start": True, "explicit_end": True}),
}


def _eq(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture(scope="module")
def small_tokenizer_spec():
    return P.tokenizer_spec(600, seed=3)


@pytest.mark.parametrize("style", sorted(STYLES))
def test_yaml_reader_equals_pyyaml_on_inference_ymls(style, small_tokenizer_spec):
    """A PP-FormulaNet_plus-M inference yml carrying a ByteLevel tokenizer
    (byte characters such as Ġ and Ċ, quotes, backslashes, nulls), dumped
    by PyYAML in each style, then read back; and the smoke's own writer."""
    fn, kw = STYLES[style]
    data = P.inference_config(small_tokenizer_spec)
    text = fn(data, **kw)
    want = yaml.safe_load(text)
    assert _eq(yaml_subset.safe_load(text), want)
    assert want == data
    ours = P.inference_yml(small_tokenizer_spec)
    assert _eq(yaml_subset.safe_load(ours), yaml.safe_load(ours))
    assert yaml.safe_load(ours) == data


_ALPHABET = list("abcxyz ABC019_-.:#'\"\\/?!@&*%[]{},|>=<~`\t\n\r") + [
    "Ġ", "é", "ĊĠ", "\x85", "\u2028", "\u2029", "\ufeff", "\x7f", "\x00", "😀", "\xa0"]
_WORDS = ["yes", "no", "on", "Off", "null", "~", "true", "1", "0x1F", "017", "0o17",
          "1_000", "1:30", "1.5", ".5", "1e3", "1.0e+3", ".inf", "-.INF", ".nan", "<<", "=",
          "2001-12-14", "---", "...", "- a", "? b", ": c", "a: b", "a #b", "#x", "", " ",
          "word " * 25, "long" * 40, "x" * 130, "a\n\nb", " lead", "trail "]


def _random_node(rng: random.Random, depth: int):
    r = rng.random()
    if depth > 3 or r < 0.45:
        k = rng.random()
        if k < 0.6:
            if rng.random() < 0.3:
                return rng.choice(_WORDS)
            return "".join(rng.choice(_ALPHABET) for _ in range(rng.randint(0, 12)))
        if k < 0.7:
            return rng.randint(-10 ** 20, 10 ** 20)
        if k < 0.8:
            return rng.choice([1.5, -0.25, 1e30, float("inf"), -float("inf"), 0.0, 3.0])
        return rng.choice([True, False, None])
    if r < 0.75:
        return {(_random_node(rng, 9) if rng.random() < 0.9 else rng.choice([1, 2.5, True, None])):
                _random_node(rng, depth + 1) for _ in range(rng.randint(0, 5))}
    return [_random_node(rng, depth + 1) for _ in range(rng.randint(0, 5))]


@pytest.mark.parametrize("seed", range(4))
def test_yaml_reader_equals_pyyaml_on_seeded_data(seed):
    """Seeded plain data (keys and strings PyYAML must quote, fold or
    escape: indicators, resolvable words, line breaks NEL/LS/PS, long and
    empty keys, astral characters) in every style."""
    rng = random.Random(seed)
    n = 0
    for _ in range(60):
        data = _random_node(rng, 0)
        for fn, kw in STYLES.values():
            text = fn(data, **kw)
            want = yaml.safe_load(text)
            assert _eq(yaml_subset.safe_load(text), want), text
            n += 1
    assert n == 60 * len(STYLES)


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x\n", "a: >\n  x\n", "%YAML 1.1\n---\na: 1",
    "a: 1\n---\nb: 2\n", "<<: {a: 1}", "a: 2001-12-14", "a: =", "[a: 1]",
])
def test_yaml_outside_the_subset_raises(text):
    """Anchors, aliases, tags, block scalars, directives, several
    documents, merge keys, timestamps, value keys, pairs in a flow
    sequence: ValueError."""
    with pytest.raises(ValueError):
        yaml_subset.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 'x", 'a: "x', "a:\n\t- b", "a: [1, 2", "a: {b: 1", "a: b: c", "- a\nb: 1",
    "a:\n  b: 1\n c: 2", "a: 'x' y", '"\\q"', "? [a]\n: 1", "{[a]: 1}", "\x07", "a: 1\n  b: 2",
    'a: "\\uZZZZ"', "a: 'x\n---\n'",
])
def test_yaml_malformed_raises_as_pyyaml(text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(ValueError):
        yaml_subset.safe_load(text)


# ---------------------------------------------------------------- tokenizer

_CORPUS = ["\\frac{a}{b} + x^2 = y_{ij}", "\\alpha \\beta é ü 中文 😀",
           "hello world, it's don't . do not", "a  b   c", "\\sum_{i=1}^{n} i^2 \\leq n^3"] * 4


def _trained(model: str, decoder):
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers, trainers

    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    byte_level = model == "bpe_bytelevel"
    if model.startswith("bpe"):
        tok = Tokenizer(models.BPE(unk_token=None if byte_level else "<unk>"))
        trainer = trainers.BpeTrainer(
            vocab_size=300, special_tokens=specials,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet() if byte_level else [])
    elif model == "wordpiece":
        tok = Tokenizer(models.WordPiece(unk_token="<unk>"))
        trainer = trainers.WordPieceTrainer(vocab_size=200, special_tokens=specials)
    elif model == "wordlevel":
        tok = Tokenizer(models.WordLevel(unk_token="<unk>"))
        trainer = trainers.WordLevelTrainer(special_tokens=specials)
    else:
        tok = Tokenizer(models.Unigram())
        trainer = trainers.UnigramTrainer(vocab_size=100, special_tokens=specials,
                                          unk_token="<unk>")
    tok.pre_tokenizer = (pre_tokenizers.ByteLevel(add_prefix_space=False) if byte_level
                         else pre_tokenizers.Whitespace())
    tok.train_from_iterator(_CORPUS, trainer)
    tok.decoder = decoder(decoders) if decoder else None
    # added tokens: plain, byte-level characters, decoder markers; special
    # ones, one of which looks like a byte-fallback token
    tok.add_tokens(["\\foo", AddedToken("Ġbar", special=False), "▁x", "##y", "<0x41>", "|",
                    "</w>"])
    tok.add_special_tokens(["<sp1>", "<0x42>"])
    return tok


DECODERS = {
    "bytelevel": ("bpe_bytelevel", lambda d: d.ByteLevel()),
    "none": ("bpe_bytelevel", None),
    "metaspace": ("unigram", lambda d: d.Metaspace()),
    "metaspace_never": ("unigram", lambda d: d.Metaspace(prepend_scheme="never")),
    "metaspace_first": ("unigram", lambda d: d.Metaspace(prepend_scheme="first")),
    "wordpiece": ("wordpiece", lambda d: d.WordPiece()),
    "wordpiece_no_cleanup": ("wordpiece", lambda d: d.WordPiece(prefix="##", cleanup=False)),
    "bpe_decoder": ("bpe", lambda d: d.BPEDecoder(suffix="</w>")),
    "ctc": ("wordlevel", lambda d: d.CTC()),
    "byte_fallback": ("unigram", lambda d: d.ByteFallback()),
    "fuse": ("unigram", lambda d: d.Fuse()),
    "strip": ("unigram", lambda d: d.Strip(" ", 1, 0)),
    "strip_both": ("unigram", lambda d: d.Strip("a", 1, 1)),
    "replace": ("unigram", lambda d: d.Replace("▁", " ")),
    "replace_regex": ("wordlevel", lambda d: d.Replace(__import__("tokenizers").Regex("[ab]+"), "_")),
    "llama_sequence": ("unigram", lambda d: d.Sequence([
        d.Replace("▁", " "), d.ByteFallback(), d.Fuse(), d.Strip(" ", 1, 0)])),
    "bytelevel_strip_sequence": ("bpe_bytelevel", lambda d: d.Sequence([
        d.ByteLevel(), d.Strip(" ", 1, 0)])),
}


def _decode_both(tok, replay, ids, skip):
    try:
        want = tok.decode(ids, skip_special_tokens=skip)
    except BaseException:  # the package panics on some Strip cuts
        want = None
    if want is None:
        with pytest.raises(ValueError):
            replay.decode(ids, skip)
        return
    assert replay.decode(ids, skip) == want, (ids, skip)


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_tokenizer_decode_equals_tokenizers(name, tmp_path):
    model, decoder = DECODERS[name]
    tok = _trained(model, decoder)
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    replay = hf_tokenizer.Tokenizer.from_file(path)
    size = tok.get_vocab_size(with_added_tokens=True)
    rng = random.Random(name)
    for _ in range(150):
        ids = [rng.randrange(0, size + 6) for _ in range(rng.randint(0, 14))]
        for skip in (True, False):
            _decode_both(tok, replay, ids, skip)


def test_tokenizer_added_token_ids_follow_the_package(tmp_path):
    """Added tokens whose written ids disagree with the model, repeated
    tokens and specials re-added as plain: ids as the package assigns them
    on load."""
    from tokenizers import Tokenizer

    spec = json.loads(_trained("bpe_bytelevel", lambda d: d.ByteLevel()).to_str())
    spec["added_tokens"] += [
        {"id": 5, "content": "NEWTOK", "special": True, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False},
        {"id": 7, "content": "NEW2", "special": False, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": True},
        {"id": 9, "content": "<s>", "special": False, "single_word": True, "lstrip": False,
         "rstrip": False, "normalized": False},
    ]
    tok = Tokenizer.from_str(json.dumps(spec))
    replay = hf_tokenizer.Tokenizer(spec)
    rng = random.Random(1)
    for _ in range(100):
        ids = [rng.randrange(0, tok.get_vocab_size(True) + 4) for _ in range(rng.randint(0, 10))]
        for skip in (True, False):
            _decode_both(tok, replay, ids, skip)


@pytest.fixture(scope="module")
def formula_tokenizer_file(tmp_path_factory):
    """The 50 000-entry ByteLevel stand-in of the published formula
    tokenizer, as the smoke's published phase writes it."""
    path = tmp_path_factory.mktemp("tok") / "formula_tokenizer.json"
    path.write_text(json.dumps(P.tokenizer_spec(50000, P.TOKENIZER_SEED)), encoding="utf-8")
    return path


def test_formula_tokenizer_equals_jax(formula_tokenizer_file):
    """``FormulaTokenizer`` (the replay, then ``fix_latex``) against the
    JAX package's (``tokenizers`` 0.22.2, then ``fix_latex``) on 300
    seeded id sequences, with the specials, invalid UTF-8 from lone byte
    tokens and ids past the vocabulary."""
    from rapiddoc_tpu.models.formula.engine import FormulaTokenizer as JaxTok
    from rapiddoc_tpu_torch.models.formula.engine import FormulaTokenizer

    jax_tok, port_tok = JaxTok(formula_tokenizer_file), FormulaTokenizer(formula_tokenizer_file)
    assert jax_tok.available() and port_tok.available()
    rng = np.random.default_rng(0)
    for n in range(300):
        ids = rng.integers(0, 50008, size=int(rng.integers(0, 80))).tolist()
        if n % 3 == 0:  # byte tokens alone: invalid UTF-8
            ids += rng.integers(4, 260, size=5).tolist()
        if n % 5 == 0:
            ids = [0, *ids, 1, 2, 3]
        assert port_tok.decode(ids) == jax_tok.decode(ids), ids


def test_formula_tokenizer_missing_and_corrupt_files(tmp_path):
    """A missing file decodes to "" in both packages; a file that does
    not parse decodes to "" in the JAX package and raises in the port
    (ROADMAP Queue 3)."""
    from rapiddoc_tpu.models.formula.engine import FormulaTokenizer as JaxTok
    from rapiddoc_tpu_torch.models.formula.engine import FormulaTokenizer

    missing = tmp_path / "missing.json"
    assert FormulaTokenizer(missing).decode([5, 6]) == JaxTok(missing).decode([5, 6]) == ""
    assert not FormulaTokenizer(missing).available()
    for text in ("{not json", json.dumps({"model": {"type": "Mystery"}}), "[]"):
        bad = tmp_path / "bad.json"
        bad.write_text(text)
        assert JaxTok(bad).decode([5, 6]) == ""
        with pytest.raises(ValueError):
            FormulaTokenizer(bad)
