"""Torch->flax conversion for the table stack (UNITABLE et al).

Copy of ``rapiddoc_tpu/models/table/convert.py``.

Maps the published UNITABLE encoder.pth/decoder.pth key layout (reference:
rapid_doc/model/table/rapid_table_self/table_structure/unitable/
unitable_modules.py — Encoder :418, GPTFastDecoder :667; registry URLs +
SHA pins in rapid_table_self/default_models.yaml) onto unitable.py.
"""
from __future__ import annotations

from typing import Mapping

from ...engine.weights import TorchDict, conv_kernel, dense, layernorm, vec


def unitable_encoder_variables_from_torch(state_dict: Mapping) -> dict:
    t = TorchDict(state_dict)
    params: dict = {
        "conv_proj": {
            "kernel": conv_kernel(t("backbone.conv_proj.weight")),
            "bias": vec(t("backbone.conv_proj.bias")),
        },
        "pos_embed": vec(t("pos_embed.embedding.weight")),
        "norm": layernorm(t, "norm"),
    }
    i = 0
    while t.has(f"encoder.layers.{i}.self_attn.in_proj_weight"):
        lp = f"encoder.layers.{i}"
        params[f"block{i}"] = {
            "norm1": layernorm(t, f"{lp}.norm1"),
            "norm2": layernorm(t, f"{lp}.norm2"),
            "attn": {
                "qkv": {
                    "kernel": vec(t(f"{lp}.self_attn.in_proj_weight")).T,
                    "bias": vec(t(f"{lp}.self_attn.in_proj_bias")),
                },
                "proj": dense(t, f"{lp}.self_attn.out_proj"),
            },
            "fc1": dense(t, f"{lp}.linear1"),
            "fc2": dense(t, f"{lp}.linear2"),
        }
        i += 1
    return {"params": params}


def unitable_decoder_variables_from_torch(
    state_dict: Mapping,
) -> tuple[dict, dict]:
    """Returns (decoder_variables, mem_proj_variables). Cross-attn K/V
    (multihead_attn.key/value) live in the standalone memory projector."""
    t = TorchDict(state_dict)
    dec: dict = {
        "token_embed": {"embedding": vec(t("token_embed.embedding.weight"))},
        "pos_embed": vec(t("pos_embed.embedding.weight")),
        "generator": dense(t, "generator"),
    }
    mem: dict = {}
    i = 0
    while t.has(f"layers.{i}.self_attn.wqkv.weight"):
        lp = f"layers.{i}"
        dec[f"layer{i}"] = {
            "norm1": layernorm(t, f"{lp}.norm1"),
            "norm2": layernorm(t, f"{lp}.norm2"),
            "norm3": layernorm(t, f"{lp}.norm3"),
            "self_attn": {
                "wqkv": dense(t, f"{lp}.self_attn.wqkv"),
                "wo": dense(t, f"{lp}.self_attn.wo"),
            },
            "cross_attn": {
                "q_proj": dense(t, f"{lp}.multihead_attn.query"),
                "out_proj": dense(t, f"{lp}.multihead_attn.out"),
            },
            "linear1": dense(t, f"{lp}.linear1"),
            "linear2": dense(t, f"{lp}.linear2"),
        }
        mem[f"layer{i}_k"] = dense(t, f"{lp}.multihead_attn.key")
        mem[f"layer{i}_v"] = dense(t, f"{lp}.multihead_attn.value")
        i += 1
    return {"params": dec}, {"params": mem}


def unitable_variables_from_torch(
    encoder_sd: Mapping, decoder_sd: Mapping
) -> dict:
    dec_vars, mem_vars = unitable_decoder_variables_from_torch(decoder_sd)
    return {
        "encoder": unitable_encoder_variables_from_torch(encoder_sd),
        "decoder": dec_vars,
        "mem_proj": mem_vars,
    }
