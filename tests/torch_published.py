"""Seeded checkpoints in the published torch key layouts, for the tests
and the card's smoke run.

The published checkpoints (PP-OCRv6 det/rec ``.safetensors``,
PP-FormulaNet_plus-M ``.pth`` with its inference yml, UniTable's
``encoder.pth``/``decoder.pth`` and ``vocab.json``) are not in the
repository and cannot be fetched. These helpers build stand-ins from a
seed: the flax-layout leaves of each model (the shapes of the port's own
modules, so the tree is the one the JAX package's converters produce),
filled by seeded numpy, then mapped back onto the published torch keys by
the inverse of each converter's key map (``*_torch_key``). The tests hold
the helpers to the JAX package's converters: converting a helper's state
dict gives back its tree, with no key unused.

Values are scaled so that a model's forward and decode stay finite:
kernels N(0, 1/fan_in), BatchNorm variances in [0.5, 1.5], scales near
1, small biases, means and learned positions. Imports only the port,
numpy and torch (``chip_smoke.py`` imports it on the card's machine).
"""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path
from typing import Iterator

import numpy as np
import torch
from torch import nn

from rapiddoc_tpu_torch.models.common.layers import BatchNorm
from rapiddoc_tpu_torch.utils.hf_tokenizer import bytes_to_unicode

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "embedding": "weight"}


def flax_shapes(module: nn.Module, prefix: str = "") -> dict[str, tuple[int, ...]]:
    """The flax leaves ``models/weights.load_flax_into`` reads for
    ``module`` (``params/…`` and ``batch_stats/…``, under ``prefix``),
    with their shapes: the inverse of its module-type rules."""
    out: dict[str, tuple[int, ...]] = {}
    for path, mod in module.named_modules():
        parts = path.split(".") if path else []
        fp = "/".join([prefix + "params", *parts])
        sp = "/".join([prefix + "batch_stats", *parts])
        if isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            out[f"{fp}/kernel"] = (kh, kw, i, o)
            if mod.bias is not None:
                out[f"{fp}/bias"] = (o,)
        elif isinstance(mod, nn.Linear):
            out[f"{fp}/kernel"] = (mod.in_features, mod.out_features)
            if mod.bias is not None:
                out[f"{fp}/bias"] = (mod.out_features,)
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            n = tuple(mod.weight.shape)
            out[f"{fp}/scale"] = out[f"{fp}/bias"] = n
            if isinstance(mod, BatchNorm):
                out[f"{sp}/mean"] = out[f"{sp}/var"] = n
        elif isinstance(mod, nn.Embedding):
            out[f"{fp}/embedding"] = tuple(mod.weight.shape)
        else:
            for name, p in mod.named_parameters(recurse=False):
                out[f"{fp}/{name}"] = tuple(p.shape)
    return out


def _fill(leaf: str, shape: tuple[int, ...], rng: np.random.Generator,
          torch_layout: bool) -> np.ndarray:
    def normal(std: float) -> np.ndarray:
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def uniform(lo: float, hi: float) -> np.ndarray:
        return rng.uniform(lo, hi, shape).astype(np.float32)

    if leaf == "var":
        return uniform(0.5, 1.5)
    if leaf == "scale":
        return uniform(0.8, 1.2)
    if leaf in ("mean", "bias", "final_bias", "embed_positions", "pos_embed"):
        return normal(0.05 if leaf == "mean" else 0.02)
    if leaf == "embedding":
        return normal(shape[-1] ** -0.5)
    # kernels: flax (kh, kw, in, out) / (in, out), or a torch-layout
    # (in, out, kh, kw) deconvolution kept as stored
    fan_in = shape[0] * int(np.prod(shape[2:])) if torch_layout else int(np.prod(shape[:-1]))
    return normal(fan_in ** -0.5)


def _dotted(path: str) -> str:
    parts = path.split("/")
    parts[-1] = _LEAF[parts[-1]]
    return ".".join(parts)


# -- the inverse key maps: flax path (collection taken off) -> torch key

def hgnet_torch_key(path: str, prefix: str) -> str:
    """``models/layout/hgnet_convert.py``'s map, inverted."""
    p = re.sub(r"stage(\d+)", r"stages/\1", path)
    p = re.sub(r"block(\d+)", r"blocks/\1", p)
    p = re.sub(r"layer(\d+)", r"layers/\1", p)
    p = p.replace("agg_squeeze", "aggregation_squeeze_conv")
    p = p.replace("agg_excite", "aggregation_excitation_conv").replace("cba/", "")
    if "/lab/" in p:
        return prefix + p.replace("/", ".")
    return prefix + _dotted(p)


def ocr_torch_key(path: str) -> str:
    """``models/ocr/convert.py``'s map (BaseModel layout), inverted."""
    conv_bn = {"conv": "convolution", "bn": "normalization"}
    m = re.fullmatch(r"backbone/stem/(\w+)/(conv|bn)/(\w+)", path)
    if m:
        return f"backbone.encoder.convolution.{m[1]}.{conv_bn[m[2]]}.{_LEAF[m[3]]}"
    m = re.fullmatch(r"backbone/stage(\d+)_block(\d+)/(.+)", path)
    if m:
        pre, rest = f"backbone.encoder.blocks.{m[1]}.blocks.{m[2]}.", m[3]
        r = re.fullmatch(r"token_conv/(kernel|bias)", rest)
        if r:
            return pre + f"token_conv.{_LEAF[r[1]]}"
        r = re.fullmatch(r"(\w+)/(conv|bn)/(\w+)", rest)
        if r:
            return pre + f"{r[1]}.{conv_bn[r[2]]}.{_LEAF[r[3]]}"
        r = re.fullmatch(r"se/fc(1|2)/(\w+)", rest)
        return pre + f"token_squeeze_excitation.convolutions.{0 if r[1] == '1' else 2}.{_LEAF[r[2]]}"
    rules = (
        (r"neck/insert_conv(\d)/kernel", "neck.insert_conv.{0}.in_conv.weight"),
        (r"neck/insert_se(\d)/fc(\d)/(\w+)", "neck.insert_conv.{0}.squeeze_excitation_block.conv{1}.{2}"),
        (r"neck/input_dw(\d)/(\w+)", "neck.input_conv.{0}.depthwise_convolution.{1}"),
        (r"neck/input_pw(\d)/kernel", "neck.input_conv.{0}.pointwise_convolution.weight"),
        (r"neck/input_se(\d)/fc(\d)/(\w+)",
         "neck.input_conv.{0}.squeeze_excitation_module.conv{1}.{2}"),
        (r"head/conv_down/conv/(\w+)", "head.conv_down.convolution.{0}"),
        (r"head/conv_down/bn/(\w+)", "head.conv_down.norm.{0}"),
        (r"head/conv_up/(kernel|bias)", "head.conv_up.convolution.{0}"),
        (r"head/conv_up/bn/(\w+)", "head.conv_up.norm.{0}"),
        (r"head/final_(kernel|bias)", "head.conv_final.{0}"),
        (r"neck/skip_conv/(conv|bn)/(\w+)", "head.encoder.conv_block.0.{0}.{1}"),
        (r"neck/reduce_conv/(conv|bn)/(\w+)", "head.encoder.conv_block.1.{0}.{1}"),
        (r"neck/local_conv/(conv|bn)/(\w+)", "head.encoder.conv_block.2.{0}.{1}"),
        (r"neck/block(\d+)/norm(\d)/(\w+)", "head.encoder.svtr_block.{0}.layer_norm{1}.{2}"),
        (r"neck/block(\d+)/attn/qkv/(\w+)", "head.encoder.svtr_block.{0}.self_attn.qkv.{1}"),
        (r"neck/block(\d+)/attn/proj/(\w+)", "head.encoder.svtr_block.{0}.self_attn.projection.{1}"),
        (r"neck/block(\d+)/fc(\d)/(\w+)", "head.encoder.svtr_block.{0}.mlp.fc{1}.{2}"),
        (r"neck/norm/(\w+)", "head.encoder.norm.{0}"),
        (r"head/(kernel|bias)", "head.head.{0}"),
    )
    for pattern, key in rules:
        m = re.fullmatch(pattern, path)
        if m:
            groups = [{"conv": "convolution", "bn": "normalization"}.get(g, _LEAF.get(g, g))
                      for g in m.groups()]
            return key.format(*groups)
    raise KeyError(path)


def formula_torch_key(model: str, path: str, backbone_size: str = "B6",
                      bare: bool = False) -> str:
    """``models/formula/convert.py``'s map (the published BaseModel
    layout, or a bare HF-MBart decoder), inverted."""
    dec = "model.decoder." if bare else "head.decoder.model.decoder."
    if model == "encoder":
        if path.startswith("backbone/"):
            return hgnet_torch_key(path[len("backbone/"):],
                                   f"backbone.pphgnet_{backbone_size.lower()}.")
        return "head." + _dotted(path)  # enc_to_dec_proj
    if model == "mem_proj":
        m = re.fullmatch(r"layer(\d+)_(k|v)/(\w+)", path)
        return f"{dec}layers.{m[1]}.encoder_attn.{m[2]}_proj.{_LEAF[m[3]]}"
    if path == "lm_head/kernel":
        return "lm_head.weight" if bare else "head.decoder.lm_head.weight"
    if path == "embed_positions":
        return dec + "embed_positions.weight"
    m = re.fullmatch(r"layer(\d+)/(.+)", path)
    if m:
        return f"{dec}layers.{m[1]}." + _dotted(m[2])
    return dec + _dotted(path)


def unitable_torch_key(model: str, path: str) -> str:
    """``models/table/convert.py``'s map, inverted."""
    rules = {
        "encoder": (
            (r"conv_proj/(\w+)", "backbone.conv_proj.{0}"),
            (r"pos_embed", "pos_embed.embedding.weight"),
            (r"norm/(\w+)", "norm.{0}"),
            (r"block(\d+)/attn/qkv/kernel", "encoder.layers.{0}.self_attn.in_proj_weight"),
            (r"block(\d+)/attn/qkv/bias", "encoder.layers.{0}.self_attn.in_proj_bias"),
            (r"block(\d+)/attn/proj/(\w+)", "encoder.layers.{0}.self_attn.out_proj.{1}"),
            (r"block(\d+)/norm(\d)/(\w+)", "encoder.layers.{0}.norm{1}.{2}"),
            (r"block(\d+)/fc(\d)/(\w+)", "encoder.layers.{0}.linear{1}.{2}"),
        ),
        "decoder": (
            (r"token_embed/embedding", "token_embed.embedding.weight"),
            (r"pos_embed", "pos_embed.embedding.weight"),
            (r"generator/(\w+)", "generator.{0}"),
            (r"layer(\d+)/norm(\d)/(\w+)", "layers.{0}.norm{1}.{2}"),
            (r"layer(\d+)/self_attn/(wqkv|wo)/(\w+)", "layers.{0}.self_attn.{1}.{2}"),
            (r"layer(\d+)/cross_attn/q_proj/(\w+)", "layers.{0}.multihead_attn.query.{1}"),
            (r"layer(\d+)/cross_attn/out_proj/(\w+)", "layers.{0}.multihead_attn.out.{1}"),
            (r"layer(\d+)/linear(\d)/(\w+)", "layers.{0}.linear{1}.{2}"),
        ),
        "mem_proj": (
            (r"layer(\d+)_k/(\w+)", "layers.{0}.multihead_attn.key.{1}"),
            (r"layer(\d+)_v/(\w+)", "layers.{0}.multihead_attn.value.{1}"),
        ),
    }[model]
    for pattern, key in rules:
        m = re.fullmatch(pattern, path)
        if m:
            return key.format(*(_LEAF.get(g, g) for g in m.groups()))
    raise KeyError(path)


# -- checkpoints

def _torch_value(path: str, arr: np.ndarray, vec: bool) -> np.ndarray:
    """A flax leaf in its torch layout: HWIO -> OIHW, (in, out) ->
    (out, in); ``vec`` leaves as stored."""
    leaf = path.rsplit("/", 1)[-1]
    if vec or leaf != "kernel":
        return arr
    if arr.ndim == 4:
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    return np.ascontiguousarray(arr.T)


def iter_checkpoint(modules: dict[str, nn.Module], key_fn, seed: int,
                    vec_leaves: tuple[str, ...] = (), overrides: dict | None = None,
                    ) -> Iterator[tuple[str, str, np.ndarray, np.ndarray]]:
    """(npz key, torch key, flax value, torch-layout value) for every leaf
    of ``modules`` ({npz model name or "": module}), filled from ``seed``
    in the modules' order. ``key_fn(model, path)`` is the inverse key map;
    ``vec_leaves`` are paths stored in torch layout; ``overrides`` maps
    an npz key to a function that edits its filled value. Each BatchNorm
    also yields its ``num_batches_tracked`` (npz key "": the converters
    skip it)."""
    rng = np.random.default_rng(seed)
    for model, module in modules.items():
        prefix = f"{model}/" if model else ""
        for flat_key, shape in flax_shapes(module, prefix).items():
            path = flat_key[len(prefix):].split("/", 1)[1]
            vec = path in vec_leaves
            arr = _fill(path.rsplit("/", 1)[-1], shape, rng, torch_layout=vec)
            if overrides and flat_key in overrides:
                arr = overrides[flat_key](arr)
            key = key_fn(model, path)
            yield flat_key, key, arr, _torch_value(path, arr, vec)
            if path.endswith("/mean"):
                count = np.array(0, np.int64)
                yield "", key.replace("running_mean", "num_batches_tracked"), count, count


def checkpoint(modules: dict[str, nn.Module], key_fn, seed: int,
               vec_leaves: tuple[str, ...] = (), overrides: dict | None = None,
               ) -> tuple[dict, dict]:
    """(torch state dict, the flax leaves its conversion must give)."""
    sd, flat = {}, {}
    for flat_key, key, value, torch_value in iter_checkpoint(modules, key_fn, seed, vec_leaves,
                                                            overrides):
        sd[key] = torch.from_numpy(torch_value)
        if flat_key:
            flat[flat_key] = value
    return sd, flat


DET_VEC = ("head/conv_up/kernel", "head/final_kernel")


def det_checkpoint(seed: int = 0) -> tuple[dict, dict]:
    """A PP-OCRv6 det state dict (BaseModel layout) and its flax tree."""
    from rapiddoc_tpu_torch.models.ocr.det import DBNet

    with torch.device("meta"):  # the modules give shapes only
        model = DBNet()
    return checkpoint({"": model}, lambda _, p: ocr_torch_key(p), seed, DET_VEC)


def rec_checkpoint(seed: int = 0, num_classes: int = 97) -> tuple[dict, dict]:
    """A PP-OCRv6 rec state dict (BaseModel layout) and its flax tree."""
    from rapiddoc_tpu_torch.models.ocr.rec import SVTRRec

    with torch.device("meta"):
        model = SVTRRec(num_classes=num_classes)
    return checkpoint({"": model},
                      lambda _, p: ocr_torch_key(p), seed)


def formula_modules(layers: int = 6, backbone_size: str = "B6", d_model: int = 512,
                    ffn: int = 2048, heads: int = 16, vocab_size: int = 50000,
                    max_len: int = 2560, bare: bool = False) -> dict[str, nn.Module]:
    from rapiddoc_tpu_torch.models.formula.model import build_formula_modules

    with torch.device("meta"):  # the modules give shapes only
        encoder, decoder, mem_proj, _ = build_formula_modules(
            max_len=max_len, vocab_size=vocab_size, layers=layers, backbone_size=backbone_size,
            out_index=3, d_model=d_model, ffn=ffn, heads=heads)
    modules = {"encoder": encoder, "decoder": decoder, "mem_proj": mem_proj}
    if bare:
        del modules["encoder"]
    return modules


def formula_checkpoint(seed: int = 0, *, backbone_size: str = "B6", bare: bool = False,
                       **widths) -> tuple[dict, dict]:
    """A PP-FormulaNet_plus state dict (``backbone.pphgnet_b6.*``,
    ``head.enc_to_dec_proj.*``, ``head.decoder.model.decoder.*``,
    ``head.decoder.lm_head.weight``; or a bare ``model.decoder.*`` +
    ``lm_head.weight`` decoder) and its flax tree (``encoder/…``,
    ``decoder/…``, ``mem_proj/…``). The defaults are the published
    PP-FormulaNet_plus-M widths."""
    modules = formula_modules(backbone_size=backbone_size, bare=bare, **widths)
    return checkpoint(modules, lambda m, p: formula_torch_key(m, p, backbone_size, bare), seed)


def unitable_checkpoint(seed: int = 0, dims=None) -> tuple[dict, dict, dict]:
    """UniTable's ``encoder.pth`` and ``decoder.pth`` state dicts and
    their flax tree; ``dims`` defaults to the published 12 x 768 encoder
    and 4 x 768 decoder."""
    from rapiddoc_tpu_torch.models.table.unitable import UniTableDims, UniTableModel

    with torch.device("meta"):
        model = UniTableModel(dims or UniTableDims())
    enc, flat = checkpoint({"encoder": model.encoder}, unitable_torch_key, seed)
    dec, dec_flat = checkpoint({"decoder": model.decoder, "mem_proj": model.mem_proj},
                               unitable_torch_key, seed + 1, overrides=UNITABLE_OVERRIDES)
    return enc, dec, {**flat, **dec_flat}


def _table_bias(bias: np.ndarray) -> np.ndarray:
    from rapiddoc_tpu_torch.models.table.unitable import EOS_ID, HTML_BASE, HTML_TOKENS

    bias = bias.copy()
    bias[EOS_ID] = -8.0
    for tok in ("<td></td>", "<tr>", "</tr>"):
        bias[HTML_BASE + HTML_TOKENS.index(tok)] += 4.0
    return bias


# a random generator ends the whitelisted decode at its first step (EOS
# wins for every crop), and without EOS falls into runs of bbox tokens
# that hold no cell: its bias is moved off EOS and onto empty cells and
# rows, so that the decode runs to max_len and builds a table
UNITABLE_OVERRIDES = {"decoder/params/generator/bias": _table_bias}


# -- the formula's tokenizer and inference yml, UniTable's vocab

SPECIAL_TOKENS = ("<s>", "<pad>", "</s>", "<unk>")
# characters of LaTeX the merged tokens are drawn from ("Ġ" is the space)
LATEX_CHARS = "\\Ġ{}^_()+-=abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789,.|[]"


def tokenizer_spec(vocab_size: int = 50000, seed: int = 0) -> dict:
    """A ByteLevel BPE tokenizer.json (the UniMERNet/Nougat layout: the
    four specials at ids 0-3, then the 256 byte characters, then merged
    tokens of LaTeX characters, each with its merge) of ``vocab_size``
    entries."""
    rng = np.random.default_rng(seed)
    byte_chars = [bytes_to_unicode()[b] for b in range(256)]
    vocab = {t: i for i, t in enumerate([*SPECIAL_TOKENS, *byte_chars])}
    tokens = list(LATEX_CHARS)
    merges = []
    while len(vocab) < vocab_size:
        picks = rng.integers(0, 1 << 30, size=(4096, 2))
        for a_pick, b_pick in picks:
            a = tokens[a_pick % len(tokens)]
            b = LATEX_CHARS[b_pick % len(LATEX_CHARS)]
            if a + b in vocab or len(a) >= 12:
                continue
            vocab[a + b] = len(vocab)
            tokens.append(a + b)
            merges.append([a, b])
            if len(vocab) == vocab_size:
                break
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, t in enumerate(SPECIAL_TOKENS)]
    def byte_level():  # a new dict each time: PyYAML writes a shared one as an anchor
        return {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                "use_regex": True}

    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None, "pre_tokenizer": byte_level(), "post_processor": byte_level(),
            "decoder": byte_level(),
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


def inference_config(spec: dict) -> dict:
    """A PP-FormulaNet_plus-M inference config carrying ``spec``."""
    return {
        "Global": {"model_name": "PP-FormulaNet_plus-M"},
        "PreProcess": {"transform_ops": [
            {"UniMERNetImgDecode": {"input_size": [384, 384]}},
            {"UniMERNetTestTransform": None},
            {"LatexImageFormat": None},
            {"KeepKeys": {"keep_keys": ["image"]}},
        ]},
        "PostProcess": {"name": "UniMERNetDecode",
                        "character_dict": {"fast_tokenizer_file": spec,
                                           "tokenizer_config_file": {"model_max_length": 2560}}},
    }


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v) if np.isfinite(v) else (".nan" if v != v else ("-" if v < 0 else "") + ".inf")
    out = []
    for ch in v:
        code = ord(ch)
        if ch in '"\\':
            out.append("\\" + ch)
        elif 0x20 <= code < 0x7F:
            out.append(ch)
        elif code < 0x100:
            out.append(f"\\x{code:02X}")
        elif code < 0x10000:
            out.append(f"\\u{code:04X}")
        else:
            out.append(f"\\U{code:08X}")
    return '"' + "".join(out) + '"'


def to_yaml(obj, indent: int = 0) -> list[str]:
    """Block YAML lines for plain data: mappings and sequences in block
    style (a mapping's sequence indentless, as PyYAML writes it), a
    sequence of scalars in flow style, every string double-quoted with
    PyYAML's escapes."""
    pad = " " * indent
    lines: list[str] = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = _yaml_scalar(k)
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{key}:")
                lines += to_yaml(v, indent + 2)
            elif isinstance(v, list) and v and not all(
                    not isinstance(x, (dict, list)) for x in v):
                lines.append(f"{pad}{key}:")
                lines += to_yaml(v, indent)
            else:
                lines.append(f"{pad}{key}: {_inline(v)}")
        return lines
    for item in obj:
        if isinstance(item, dict) and item:
            sub = to_yaml(item, indent + 2)
            lines.append(f"{pad}- {sub[0].lstrip()}")
            lines += sub[1:]
        else:
            lines.append(f"{pad}- {_inline(item)}")
    return lines


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_yaml_scalar(k)}: {_inline(x)}" for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ", ".join(_inline(x) for x in v) + "]"
    return _yaml_scalar(v)


def inference_yml(spec: dict) -> str:
    return "\n".join(to_yaml(inference_config(spec))) + "\n"


def unitable_vocab() -> dict[str, int]:
    """UniTable's vocab.json as a token -> id map of the published layout
    (the layout ``TableVocab`` falls back to)."""
    from rapiddoc_tpu_torch.models.table.unitable import TableVocab

    return {tok: i for i, tok in sorted(TableVocab().id_to_token.items())}


# -- the files of the published checkpoints, and their digests

FORMULA_SEED, UNITABLE_SEED, TOKENIZER_SEED = 18, 19, 20


def digest(items) -> str:
    """sha256 over (key, array) pairs in their order: each key, dtype,
    shape and bytes (independent of the pickle that holds them)."""
    h = hashlib.sha256()
    for key, t in items:
        arr = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        h.update(f"{key}|{arr.dtype}|{arr.shape}|".encode())
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return h.hexdigest()


def _published_parts():
    """(file name, its state dict's (key, value) pairs, lazily) of the
    published-width stand-ins, in the order ``write_published`` writes."""
    from rapiddoc_tpu_torch.models.table.unitable import UniTableDims, UniTableModel

    def pairs(modules, key_fn, seed):
        return ((key, torch_value) for _, key, _, torch_value
                in iter_checkpoint(modules, key_fn, seed))

    with torch.device("meta"):
        model = UniTableModel(UniTableDims())
    yield "pp_formulanet_plus_m.pth", pairs(
        formula_modules(), lambda m, p: formula_torch_key(m, p), FORMULA_SEED)
    yield "unitable/encoder.pth", pairs({"encoder": model.encoder}, unitable_torch_key,
                                        UNITABLE_SEED)
    yield "unitable/decoder.pth", (
        (key, torch_value) for _, key, _, torch_value in iter_checkpoint(
            {"decoder": model.decoder, "mem_proj": model.mem_proj}, unitable_torch_key,
            UNITABLE_SEED + 1, overrides=UNITABLE_OVERRIDES))


def _published_texts() -> dict[str, str]:
    return {"pp_formulanet_plus_m_inference.yml":
            inference_yml(tokenizer_spec(50000, TOKENIZER_SEED)),
            "unitable/vocab.json": json.dumps(unitable_vocab())}


def published_digests() -> dict[str, str]:
    """The digests ``write_published`` returns, computed leaf by leaf
    without holding a state dict or writing a file."""
    out = {name: digest(items) for name, items in _published_parts()}
    for name, text in _published_texts().items():
        out[name] = hashlib.sha256(text.encode()).hexdigest()
    return out


def write_published(src: Path) -> dict[str, str]:
    """Write the published-width stand-ins under ``src``:
    ``pp_formulanet_plus_m.pth`` (PP-FormulaNet_plus-M: B6, 6 x 512,
    50 000 tokens), ``pp_formulanet_plus_m_inference.yml`` (its
    50 000-entry ByteLevel tokenizer) and ``unitable/{encoder,decoder}.pth``
    (12 x 768 and 4 x 768) + ``vocab.json``. Returns each file's digest
    (state dicts by :func:`digest`, text by sha256)."""
    (src / "unitable").mkdir(parents=True, exist_ok=True)
    digests = {}
    for name, items in _published_parts():
        sd = {key: torch.from_numpy(value) for key, value in items}
        torch.save(sd, src / name)
        digests[name] = digest(sd.items())
        del sd
    for name, text in _published_texts().items():
        (src / name).write_text(text, encoding="utf-8")
        digests[name] = hashlib.sha256(text.encode()).hexdigest()
    return digests
