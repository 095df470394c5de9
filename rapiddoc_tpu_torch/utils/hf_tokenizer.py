"""The decode half of a Hugging Face ``tokenizer.json``, in the standard
library.

The JAX package decodes the published formula model's token ids with the
``tokenizers`` package (``Tokenizer.from_file(path).decode(ids,
skip_special_tokens=True)``, ``rapiddoc_tpu/models/formula/engine.py:71-91``),
which the port does not depend on. ``Tokenizer.decode`` replays that
package (0.22) on the same file:

- each id becomes the content of the added token with that id, else the
  model's token (BPE, WordPiece and WordLevel ``vocab`` maps, Unigram's
  list); an id that is neither is dropped;
- with ``skip_special_tokens``, the tokens whose content is a special
  added token's are dropped (added tokens that are not special stay, and
  pass the decoder like any other);
- the decoder chain runs on the tokens: ByteLevel (each token's
  characters back to the bytes they stand for, a token holding any
  other character taken as its UTF-8 bytes; the bytes then read as UTF-8
  with U+FFFD for each maximal invalid sequence), ``Sequence``,
  ``Replace``, ``Strip``, ``Fuse``, ``ByteFallback``, ``Metaspace``,
  ``WordPiece``, ``BPEDecoder`` and ``CTC``; without a decoder the
  tokens are joined by spaces.

Added tokens get their ids as the package gives them when it loads the
file (the ``id`` written beside each is not read): the model's id where
the model has the content, else the next id past the model's vocabulary.
The tokenizer's encode half (normalizer, pre-tokenizer, model merges,
post-processor) is not read.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Callable


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map, which ByteLevel uses."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_CHAR_BYTES = {c: b for b, c in bytes_to_unicode().items()}


def _cleanup(text: str) -> str:
    """WordPiece's (and CTC's) clean-up of spaces before punctuation."""
    for old, new in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                     (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
                     (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(old, new)
    return text


def _byte_level(tokens: list[str]) -> list[str]:
    out = bytearray()
    for token in tokens:
        try:
            out += bytes(_CHAR_BYTES[c] for c in token)
        except KeyError:
            out += token.encode("utf-8")
    return [out.decode("utf-8", errors="replace")]


def _byte_fallback(tokens: list[str]) -> list[str]:
    out: list[str] = []
    pending = bytearray()

    def flush() -> None:
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for token in tokens:
        byte = None
        if len(token.encode("utf-8")) == 6 and token.startswith("<0x") and token.endswith(">"):
            digits = token[3:5]
            if re.fullmatch(r"\+?[0-9a-fA-F]{1,2}", digits):
                byte = int(digits, 16)
        if byte is None:
            flush()
            out.append(token)
        else:
            pending.append(byte)
    flush()
    return out


def _metaspace(spec: dict) -> Callable[[list[str]], list[str]]:
    replacement = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme")
    if scheme is None:  # files written before prepend_scheme
        scheme = "always" if spec.get("add_prefix_space", True) else "never"

    def run(tokens: list[str]) -> list[str]:
        return ["".join(("" if i == 0 and scheme != "never" else " ") if c == replacement
                        else c for c in token) for i, token in enumerate(tokens)]
    return run


def _wordpiece(spec: dict) -> Callable[[list[str]], list[str]]:
    prefix, cleanup = spec.get("prefix", "##"), spec.get("cleanup", True)

    def run(tokens: list[str]) -> list[str]:
        out = []
        for i, token in enumerate(tokens):
            if i != 0:
                token = token.replace(prefix, "", 1) if token.startswith(prefix) else " " + token
            out.append(_cleanup(token) if cleanup else token)
        return out
    return run


def _bpe(spec: dict) -> Callable[[list[str]], list[str]]:
    suffix = spec.get("suffix", "</w>")

    def run(tokens: list[str]) -> list[str]:
        last = len(tokens) - 1
        return [t.replace(suffix, "" if i == last else " ") for i, t in enumerate(tokens)]
    return run


def _ctc(spec: dict) -> Callable[[list[str]], list[str]]:
    pad = spec.get("pad_token", "<pad>")
    delimiter = spec.get("word_delimiter_token", "|")
    cleanup = spec.get("cleanup", True)

    def run(tokens: list[str]) -> list[str]:
        out = []
        for i, token in enumerate(tokens):
            if i and token == tokens[i - 1]:
                continue
            token = token.replace(pad, "")
            if cleanup:
                token = _cleanup(token).replace(delimiter, " ")
            if token:
                out.append(token)
        return out
    return run


def _replace(spec: dict) -> Callable[[list[str]], list[str]]:
    pattern = spec["pattern"]
    if "String" in pattern:
        regex = re.compile(re.escape(pattern["String"]))
    elif "Regex" in pattern:
        regex = re.compile(pattern["Regex"])
    else:
        raise ValueError(f"tokenizer: Replace pattern {pattern!r}")
    content = spec["content"]

    def run(tokens: list[str]) -> list[str]:
        return [regex.sub(lambda _: content, t) for t in tokens]
    return run


def _strip(spec: dict) -> Callable[[list[str]], list[str]]:
    content, start, stop = spec["content"], int(spec["start"]), int(spec["stop"])

    def run(tokens: list[str]) -> list[str]:
        out = []
        for token in tokens:
            chars = list(token)
            cut0 = 0
            for i in range(min(start, len(chars))):
                if chars[i] != content:
                    break
                cut0 = i + 1
            cut1 = len(chars)
            for i in range(stop):
                if i >= len(chars) or chars[len(chars) - i - 1] != content:
                    if i >= len(chars):
                        raise ValueError("tokenizer: Strip past the start of a token")
                    break
                cut1 = len(chars) - i - 1
            if cut1 < cut0:
                raise ValueError("tokenizer: Strip cuts a token from both ends past itself")
            out.append("".join(chars[cut0:cut1]))
        return out
    return run


def decoder_chain(spec: dict | None) -> Callable[[list[str]], list[str]] | None:
    """The decoder of a tokenizer.json's ``decoder`` entry, as a function
    from tokens to tokens (None: no decoder)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        return _byte_level
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Sequence":
        steps = [decoder_chain(d) for d in spec["decoders"]]

        def run(tokens: list[str]) -> list[str]:
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    builders = {"Metaspace": _metaspace, "WordPiece": _wordpiece, "BPEDecoder": _bpe,
                "CTC": _ctc, "Replace": _replace, "Strip": _strip}
    if kind not in builders:
        raise ValueError(f"tokenizer: decoder {kind!r} is not replayed")
    return builders[kind](spec)


def _model_vocab(model: dict) -> tuple[dict[str, int], int]:
    """The model's token -> id map and its vocabulary size."""
    kind = model.get("type")
    if kind == "Unigram":
        return {entry[0]: i for i, entry in enumerate(model["vocab"])}, len(model["vocab"])
    if kind in ("BPE", "WordPiece", "WordLevel") or (kind is None and "vocab" in model):
        vocab = model["vocab"]
        if not isinstance(vocab, dict):
            raise ValueError(f"tokenizer: {kind} vocab is not a map")
        return {t: int(i) for t, i in vocab.items()}, len(vocab)
    raise ValueError(f"tokenizer: model {kind!r} is not replayed")


class Tokenizer:
    """``tokenizers.Tokenizer``'s decode, from the parsed JSON."""

    def __init__(self, spec: dict[str, Any]):
        if not isinstance(spec, dict) or not isinstance(spec.get("model"), dict):
            raise ValueError("tokenizer: no model in the file")
        token_to_id, vocab_size = _model_vocab(spec["model"])
        self.id_to_token = {i: t for t, i in token_to_id.items()}
        # AddedVocabulary.add_tokens, in the file's order
        self.added: dict[int, str] = {}
        added_ids: dict[str, int] = {}
        self.special: set[str] = set()
        for entry in spec.get("added_tokens") or []:
            content = entry["content"]
            if not content:
                continue
            if content in added_ids:
                new_id = added_ids[content]
            elif content in token_to_id:
                new_id = token_to_id[content]
            elif added_ids:
                top = max(added_ids.values())
                new_id = top + 1 if top >= vocab_size or vocab_size == 0 else vocab_size
            else:
                new_id = vocab_size
            added_ids[content] = new_id
            self.added[new_id] = content
            if entry.get("special", False):
                self.special.add(content)
        self.decoder = decoder_chain(spec.get("decoder"))

    @classmethod
    def from_file(cls, path: str | Path) -> "Tokenizer":
        try:
            spec = json.loads(Path(path).read_text(encoding="utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(f"tokenizer: {path} is not JSON ({exc})") from None
        return cls(spec)

    def decode(self, ids: list[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            token = self.added.get(i)
            if token is None:
                token = self.id_to_token.get(i)
            if token is None or (skip_special_tokens and token in self.special):
                continue
            tokens.append(token)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
