"""Quality evaluation harness (OmniDocBench-style metrics).

Port of ``rapiddoc_tpu/tools/eval_quality.py``; the edit distance is the
JAX package's pure-Python path (its native Levenshtein is not ported).

Counterpart of the reference's eval tooling (reference:
demo/omnidocbench-eval.sh + demo/generate_result_tables.py — parse a
dataset, score text edit distance / table TEDS / reading order against
ground truth). The dataset itself is not bundled; this tool takes a
directory of documents plus a ground-truth JSON and reports:

  - text_edit:   normalized Levenshtein over concatenated body text (down)
  - table_teds:  mean TEDS over paired tables (up)
  - table_teds_s: structure-only TEDS (up)
  - order_edit:  normalized Kendall-style inversion rate over paragraph
                 order (down)

Ground truth JSON: {"<doc name>": {"text": "...", "tables": ["<html>", ...],
"paragraphs": ["...", ...]}}

Usage:
  python -m rapiddoc_tpu_torch.tools.eval_quality DATASET_DIR GT_JSON [-o OUT]
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path


def normalized_edit_distance(a: str, b: str) -> float:
    """Levenshtein(a, b) / max(len) in [0, 1] (0 = identical)."""
    a, b = a or "", b or ""
    if a == b:
        return 0.0
    if not a or not b:
        return 1.0
    from ..utils.native import levenshtein

    return levenshtein(a, b) / max(len(a), len(b))


def _normalize_text(text: str) -> str:
    text = re.sub(r"!\[[^\]]*\]\([^)]*\)", "", text)   # images
    text = re.sub(r"<[^>]+>", " ", text)                # html tags
    text = re.sub(r"[#*`$\\]", "", text)
    return re.sub(r"\s+", " ", text).strip().lower()


def order_inversion_rate(pred_paras: list[str], gt_paras: list[str]) -> float:
    """Fraction of GT paragraph pairs whose order is inverted in the
    prediction (matched fuzzily by best edit distance)."""
    if len(gt_paras) < 2:
        return 0.0
    pred_norm = [_normalize_text(p) for p in pred_paras]
    positions = []
    for g in gt_paras:
        gn = _normalize_text(g)
        best, best_d = None, 0.6  # require a reasonable match
        for k, p in enumerate(pred_norm):
            d = normalized_edit_distance(gn[:80], p[:80])
            if d < best_d:
                best, best_d = k, d
        positions.append(best)
    matched = [p for p in positions if p is not None]
    if len(matched) < 2:
        return 1.0
    inversions = sum(
        1
        for i in range(len(matched))
        for j in range(i + 1, len(matched))
        if matched[i] > matched[j]
    )
    pairs = len(matched) * (len(matched) - 1) / 2
    return inversions / pairs


def extract_tables(markdown: str) -> list[str]:
    return re.findall(r"<table.*?</table>", markdown, re.S | re.I)


def evaluate_doc(markdown: str, gt: dict) -> dict:
    from ..utils.teds import teds

    scores: dict = {}
    if gt.get("text"):
        scores["text_edit"] = normalized_edit_distance(
            _normalize_text(markdown), _normalize_text(gt["text"])
        )
    gt_tables = gt.get("tables") or []
    if gt_tables:
        pred_tables = extract_tables(markdown)
        t_scores, ts_scores = [], []
        for k, gt_html in enumerate(gt_tables):
            pred_html = pred_tables[k] if k < len(pred_tables) else ""
            t_scores.append(teds(pred_html, gt_html))
            ts_scores.append(teds(pred_html, gt_html, structure_only=True))
        scores["table_teds"] = sum(t_scores) / len(t_scores)
        scores["table_teds_s"] = sum(ts_scores) / len(ts_scores)
    if gt.get("paragraphs"):
        pred_paras = [p for p in markdown.split("\n\n") if p.strip()]
        scores["order_edit"] = order_inversion_rate(
            pred_paras, gt["paragraphs"]
        )
    return scores


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset_dir", type=Path)
    ap.add_argument("gt_json", type=Path)
    ap.add_argument("-o", "--out", type=Path, default=None)
    ap.add_argument("--parse-method", default="auto")
    args = ap.parse_args(argv)

    from ..api import RapidDoc

    gt_all = json.loads(args.gt_json.read_text(encoding="utf-8"))
    engine = RapidDoc(parse_method=args.parse_method)
    per_doc: dict[str, dict] = {}
    for name, gt in gt_all.items():
        path = args.dataset_dir / name
        if not path.exists():
            print(f"skip {name}: not found", file=sys.stderr)
            continue
        out = engine(str(path))
        per_doc[name] = evaluate_doc(out.markdown, gt)
    agg: dict[str, float] = {}
    for metric in ("text_edit", "table_teds", "table_teds_s", "order_edit"):
        vals = [d[metric] for d in per_doc.values() if metric in d]
        if vals:
            agg[metric] = sum(vals) / len(vals)
    report = {"per_doc": per_doc, "aggregate": agg}
    text = json.dumps(report, indent=2, ensure_ascii=False)
    if args.out:
        args.out.write_text(text, encoding="utf-8")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
