"""State-dict conversion for the OCR det/rec models.

Copy of ``rapiddoc_tpu/models/ocr/convert.py``, on the port's own
``NET_CONFIG_DET``/``NET_CONFIG_REC``.

Maps the published PP-OCRv6 torch checkpoints (key layout per reference
rapid_doc/model/ocr/ppocrv6_pytorch/modeling/*) onto the flax module trees
defined in det.py / rec.py.
"""
from __future__ import annotations

from typing import Mapping

from ...engine.weights import (
    TorchDict,
    convbn,
    dense,
    layernorm,
    plain_conv,
    se_params,
    vec,
)
from .backbone import NET_CONFIG_DET, NET_CONFIG_REC


def _lcnet_stem(t: TorchDict, prefix: str) -> tuple[dict, dict]:
    params, stats = {}, {}
    for name in ("stem1", "stem2a", "stem2b", "stem3", "stem4"):
        p, s = convbn(
            t, f"{prefix}.{name}.convolution", f"{prefix}.{name}.normalization"
        )
        params[name] = p
        stats[name] = s
    return params, stats


def _lcnet_block(
    t: TorchDict, prefix: str, cin: int, cout: int, stride, use_se: bool
) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    stride_t = (stride, stride) if isinstance(stride, int) else tuple(stride)
    rep_dw = stride_t == (1, 1) and cin == cout
    if rep_dw:
        params["token_conv"] = plain_conv(t, f"{prefix}.token_conv", dw=True)
    else:
        p, s = convbn(
            t,
            f"{prefix}.token_conv.convolution",
            f"{prefix}.token_conv.normalization",
            dw=True,
        )
        params["token_conv"] = p
        stats["token_conv"] = s
    if use_se:
        params["se"] = se_params(
            t,
            f"{prefix}.token_squeeze_excitation.convolutions.0",
            f"{prefix}.token_squeeze_excitation.convolutions.2",
        )
    for name in ("channel_conv1", "channel_conv2"):
        p, s = convbn(
            t, f"{prefix}.{name}.convolution", f"{prefix}.{name}.normalization"
        )
        params[name] = p
        stats[name] = s
    return params, stats


def _lcnet_backbone(
    t: TorchDict, prefix: str, det: bool, model_size: str
) -> tuple[dict, dict]:
    cfg = (NET_CONFIG_DET if det else NET_CONFIG_REC)[model_size]
    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = _lcnet_stem(t, f"{prefix}.convolution")
    for si, stage in enumerate(cfg["block_configs"]):
        for bi, (k, cin, cout, stride, use_se) in enumerate(stage):
            p, s = _lcnet_block(
                t, f"{prefix}.blocks.{si}.blocks.{bi}", cin, cout, stride, use_se
            )
            name = f"stage{si}_block{bi}"
            params[name] = p
            if s:
                stats[name] = s
    return params, stats


def det_variables_from_torch(state_dict: Mapping) -> dict:
    """Build DBNet flax variables from a torch det state dict.

    Accepts either the bare module layout (encoder.* / insert_conv.* /
    conv_down.*) with backbone/neck/head prefixes, or the BaseModel layout
    (backbone.encoder..., neck.insert_conv..., head.conv_down...).
    """
    t = TorchDict(state_dict)
    pre_b, pre_n, pre_h = _detect_prefixes(t)

    params: dict = {}
    stats: dict = {}
    params["backbone"], stats["backbone"] = _lcnet_backbone(
        t, f"{pre_b}encoder", det=True, model_size="small"
    )

    neck_p: dict = {}
    neck_s: dict = {}
    for i in range(4):
        neck_p[f"insert_conv{i}"] = plain_conv(
            t, f"{pre_n}insert_conv.{i}.in_conv", bias=False
        )
        neck_p[f"insert_se{i}"] = se_params(
            t,
            f"{pre_n}insert_conv.{i}.squeeze_excitation_block.conv1",
            f"{pre_n}insert_conv.{i}.squeeze_excitation_block.conv2",
        )
        neck_p[f"input_dw{i}"] = plain_conv(
            t, f"{pre_n}input_conv.{i}.depthwise_convolution", dw=True
        )
        neck_p[f"input_pw{i}"] = plain_conv(
            t, f"{pre_n}input_conv.{i}.pointwise_convolution", bias=False
        )
        neck_p[f"input_se{i}"] = se_params(
            t,
            f"{pre_n}input_conv.{i}.squeeze_excitation_module.conv1",
            f"{pre_n}input_conv.{i}.squeeze_excitation_module.conv2",
        )
    params["neck"] = neck_p
    if neck_s:
        stats["neck"] = neck_s

    head_p: dict = {}
    head_s: dict = {}
    p, s = convbn(t, f"{pre_h}conv_down.convolution", f"{pre_h}conv_down.norm")
    head_p["conv_down"] = p
    head_s["conv_down"] = s
    head_p["conv_up"] = {
        "kernel": vec(t(f"{pre_h}conv_up.convolution.weight")),
        "bias": vec(t(f"{pre_h}conv_up.convolution.bias")),
        "bn": {
            "scale": vec(t(f"{pre_h}conv_up.norm.weight")),
            "bias": vec(t(f"{pre_h}conv_up.norm.bias")),
        },
    }
    head_s["conv_up"] = {
        "bn": {
            "mean": vec(t(f"{pre_h}conv_up.norm.running_mean")),
            "var": vec(t(f"{pre_h}conv_up.norm.running_var")),
        }
    }
    head_p["final_kernel"] = vec(t(f"{pre_h}conv_final.weight"))
    head_p["final_bias"] = vec(t(f"{pre_h}conv_final.bias"))
    params["head"] = head_p
    stats["head"] = head_s

    return {"params": params, "batch_stats": stats}


def rec_variables_from_torch(state_dict: Mapping, depth: int = 2) -> dict:
    """Build SVTRRec flax variables from a torch rec state dict."""
    t = TorchDict(state_dict)
    pre_b = "backbone." if t.has("backbone.encoder.convolution.stem1.convolution.weight") else ""
    pre_h = "head." if t.has("head.encoder.conv_block.0.convolution.weight") else ""

    params: dict = {}
    stats: dict = {}
    params["backbone"], stats["backbone"] = _lcnet_backbone(
        t, f"{pre_b}encoder", det=False, model_size="small"
    )

    neck_p: dict = {}
    neck_s: dict = {}
    enc = f"{pre_h}encoder"
    for flax_name, idx in (("skip_conv", 0), ("reduce_conv", 1), ("local_conv", 2)):
        p, s = convbn(
            t,
            f"{enc}.conv_block.{idx}.convolution",
            f"{enc}.conv_block.{idx}.normalization",
            dw=(idx == 2),
        )
        neck_p[flax_name] = p
        neck_s[flax_name] = s
    for i in range(depth):
        blk = f"{enc}.svtr_block.{i}"
        neck_p[f"block{i}"] = {
            "norm1": layernorm(t, f"{blk}.layer_norm1"),
            "norm2": layernorm(t, f"{blk}.layer_norm2"),
            "attn": {
                "qkv": dense(t, f"{blk}.self_attn.qkv"),
                "proj": dense(t, f"{blk}.self_attn.projection"),
            },
            "fc1": dense(t, f"{blk}.mlp.fc1"),
            "fc2": dense(t, f"{blk}.mlp.fc2"),
        }
    neck_p["norm"] = layernorm(t, f"{enc}.norm")
    params["neck"] = neck_p
    stats["neck"] = neck_s
    params["head"] = dense(t, f"{pre_h}head")
    return {"params": params, "batch_stats": stats}


def _detect_prefixes(t: TorchDict) -> tuple[str, str, str]:
    if t.has("backbone.encoder.convolution.stem1.convolution.weight"):
        return "backbone.", "neck.", "head."
    return "", "", ""
