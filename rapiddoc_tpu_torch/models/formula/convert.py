"""Torch->flax conversion for the formula model.

Copy of ``rapiddoc_tpu/models/formula/convert.py``.

Maps HF-MBart-style state dicts (the published PP-FormulaNet checkpoints
use this layout via the reference's CustomMBartForCausalLM, reference:
rec_ppformulanet_head.py:633) onto decoder.py module trees.
"""
from __future__ import annotations

from typing import Mapping

from ...engine.weights import TorchDict, dense, layernorm, vec


def decoder_variables_from_torch(
    state_dict: Mapping,
    layers: int = 6,
    prefix: str = "model.decoder.",
    lm_head_key: str = "lm_head",
) -> tuple[dict, dict]:
    """Returns (decoder_variables, mem_proj_variables)."""
    t = TorchDict(state_dict)

    dec: dict = {
        "embed_tokens": {"embedding": vec(t(f"{prefix}embed_tokens.weight"))},
        "embed_positions": vec(t(f"{prefix}embed_positions.weight")),
        "layernorm_embedding": layernorm(t, f"{prefix}layernorm_embedding"),
        "layer_norm": layernorm(t, f"{prefix}layer_norm"),
    }
    if t.has(f"{lm_head_key}.weight"):
        dec["lm_head"] = dense(t, lm_head_key, bias=False)
    mem: dict = {}
    for i in range(layers):
        lp = f"{prefix}layers.{i}."
        dec[f"layer{i}"] = {
            "self_attn": {
                "q_proj": dense(t, f"{lp}self_attn.q_proj"),
                "k_proj": dense(t, f"{lp}self_attn.k_proj"),
                "v_proj": dense(t, f"{lp}self_attn.v_proj"),
                "out_proj": dense(t, f"{lp}self_attn.out_proj"),
            },
            "self_attn_layer_norm": layernorm(t, f"{lp}self_attn_layer_norm"),
            "encoder_attn": {
                "q_proj": dense(t, f"{lp}encoder_attn.q_proj"),
                "out_proj": dense(t, f"{lp}encoder_attn.out_proj"),
            },
            "encoder_attn_layer_norm": layernorm(
                t, f"{lp}encoder_attn_layer_norm"
            ),
            "fc1": dense(t, f"{lp}fc1"),
            "fc2": dense(t, f"{lp}fc2"),
            "final_layer_norm": layernorm(t, f"{lp}final_layer_norm"),
        }
        # cross-attn K/V live in the standalone memory projector
        mem[f"layer{i}_k"] = dense(t, f"{lp}encoder_attn.k_proj")
        mem[f"layer{i}_v"] = dense(t, f"{lp}encoder_attn.v_proj")
    return {"params": dec}, {"params": mem}


def encoder_variables_from_torch(
    state_dict: Mapping, backbone_size: str = "B6"
) -> dict:
    """Build FormulaEncoder variables from a published PP-FormulaNet
    checkpoint (BaseModel layout: backbone.pphgnet_b6.* per reference
    rec_pphgnetv2.py:1587 PPHGNetV2_B6_Formula, head.enc_to_dec_proj per
    rec_ppformulanet_head.py:787)."""
    from ..layout.hgnet_convert import hgnet_variables_from_torch

    t = TorchDict(state_dict)
    attr = f"pphgnet_{backbone_size.lower()}"
    prefix = (
        f"backbone.{attr}."
        if t.has(f"backbone.{attr}.stem.stem1.conv.weight")
        else f"{attr}."
        if t.has(f"{attr}.stem.stem1.conv.weight")
        else ""
    )
    bb_params, bb_stats = hgnet_variables_from_torch(t, prefix, backbone_size)
    proj_key = (
        "head.enc_to_dec_proj"
        if t.has("head.enc_to_dec_proj.weight")
        else "enc_to_dec_proj"
    )
    params = {"backbone": bb_params, "enc_to_dec_proj": dense(t, proj_key)}
    return {"params": params, "batch_stats": {"backbone": bb_stats}}


def formula_variables_from_torch(
    state_dict: Mapping, layers: int = 6, backbone_size: str = "B6"
) -> dict:
    """Full PP-FormulaNet_plus checkpoint -> framework variables tree.

    Published .pth layout (reference inference_engine/torch.py:51-56 builds
    BaseModel; keys: backbone.pphgnet_b6.*, head.enc_to_dec_proj.*,
    head.decoder.model.decoder.*, head.decoder.lm_head.weight).
    """
    enc_vars = encoder_variables_from_torch(state_dict, backbone_size)
    dec_vars, mem_vars = decoder_variables_from_torch(
        state_dict,
        layers=layers,
        prefix="head.decoder.model.decoder.",
        lm_head_key="head.decoder.lm_head",
    )
    return {"encoder": enc_vars, "decoder": dec_vars, "mem_proj": mem_vars}
