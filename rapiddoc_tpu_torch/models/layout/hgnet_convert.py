"""Torch->flax conversion for PPHGNetV2 backbones.

Copy of ``rapiddoc_tpu/models/layout/hgnet_convert.py``, on the port's own
``hgnet.STAGE_CONFIGS``.

Maps the published PaddleOCR-family torch key layout (reference:
rapid_doc/model/formula/rapid_formula_self/networks/backbones/
rec_pphgnetv2.py — StemBlock :979, HGV2_Block :1059, HGV2_Stage :1139,
PPHGNetV2 :1209) onto the flax module tree in hgnet.py. Used by the
formula encoder (PPHGNetV2_B6_Formula checkpoints) and any HGNet-backed
detector.
"""
from __future__ import annotations

from ...engine.weights import TorchDict, convbn, vec
from .hgnet import STAGE_CONFIGS


def _hg_cba(
    t: TorchDict, key: str, use_lab: bool, *, dw: bool = False,
    has_act: bool = True,
) -> tuple[dict, dict]:
    """HGConvBNAct: torch {key}.conv/{key}.bn(/{key}.lab) -> {cba:{conv,bn}}(+lab)."""
    p, s = convbn(t, f"{key}.conv", f"{key}.bn", dw=dw)
    params: dict = {"cba": p}
    stats: dict = {"cba": s}
    if use_lab and has_act:
        params["lab"] = {
            "scale": vec(t(f"{key}.lab.scale")),
            "bias": vec(t(f"{key}.lab.bias")),
        }
    return params, stats


def _hg_light(t: TorchDict, key: str, use_lab: bool) -> tuple[dict, dict]:
    """LightConvBNAct: 1x1 (no act) + depthwise kxk (act)."""
    p1, s1 = _hg_cba(t, f"{key}.conv1", use_lab, has_act=False)
    p2, s2 = _hg_cba(t, f"{key}.conv2", use_lab, dw=True)
    return {"conv1": p1, "conv2": p2}, {"conv1": s1, "conv2": s2}


def hgnet_variables_from_torch(
    t: TorchDict, prefix: str, size: str
) -> tuple[dict, dict]:
    """Build flax PPHGNetV2 (params, batch_stats) from torch keys at prefix.

    `prefix` addresses the torch PPHGNetV2 module itself, e.g.
    "backbone.pphgnet_b6." for PPHGNetV2_B6_Formula checkpoints.
    """
    cfg = STAGE_CONFIGS[size]
    use_lab = cfg["use_lab"]
    params: dict = {}
    stats: dict = {}

    stem_p: dict = {}
    stem_s: dict = {}
    for name in ("stem1", "stem2a", "stem2b", "stem3", "stem4"):
        stem_p[name], stem_s[name] = _hg_cba(
            t, f"{prefix}stem.{name}", use_lab
        )
    params["stem"] = stem_p
    stats["stem"] = stem_s

    for si, (cin, mid, cout, nblocks, down, light, k, nlayer) in enumerate(
        cfg["stages"]
    ):
        st_p: dict = {}
        st_s: dict = {}
        sp = f"{prefix}stages.{si}."
        if down:
            st_p["downsample"], st_s["downsample"] = _hg_cba(
                t, f"{sp}downsample", use_lab, dw=True, has_act=False
            )
        for bi in range(nblocks):
            bp = f"{sp}blocks.{bi}."
            blk_p: dict = {}
            blk_s: dict = {}
            for li in range(nlayer):
                conv = _hg_light if light else _hg_cba
                blk_p[f"layer{li}"], blk_s[f"layer{li}"] = conv(
                    t, f"{bp}layers.{li}", use_lab
                )
            blk_p["agg_squeeze"], blk_s["agg_squeeze"] = _hg_cba(
                t, f"{bp}aggregation_squeeze_conv", use_lab
            )
            blk_p["agg_excite"], blk_s["agg_excite"] = _hg_cba(
                t, f"{bp}aggregation_excitation_conv", use_lab
            )
            st_p[f"block{bi}"] = blk_p
            st_s[f"block{bi}"] = blk_s
        params[f"stage{si}"] = st_p
        stats[f"stage{si}"] = st_s
    return params, stats
