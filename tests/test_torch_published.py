"""The published-width golden of the card's ``published`` phase, and the
tier-1 check that the seeded files it was made from have not changed.

``python tests/test_torch_published.py`` writes
``rapiddoc_tpu_torch/assets/published_smoke_golden.json`` with the JAX
package on the CPU (about 5 minutes, a few GB of memory):

1. ``tests/torch_published.write_published`` writes the seeded
   published-layout files (PP-FormulaNet_plus-M ``.pth`` and inference
   yml, UniTable ``encoder.pth``/``decoder.pth``/``vocab.json``);
2. the JAX package's own ``convert_weights`` turns them into npz and
   ``formula_tokenizer.json`` in a models dir;
3. with ``RAPIDDOC_FP32_PARAMS=1``, the JAX package's
   ``FormulaRecognizer.build`` decodes the 14 committed formula crops
   (length bucket 256): token ids, LaTeX through its tokenizer, and the
   top-two logit margin of every step along its own ids (a teacher-forced
   pass), which the smoke's tie rule reads where the port's ids differ;
4. ``TableRecognizer.build({"strategy": "unitable"})`` turns the first
   four committed table crops into HTML, with their structure tokens, token
   ids and the top-two margin of the whitelisted scores at every step.

The golden records the digests of the files it was made from; the test
below recomputes them from the helpers, so a change to the seeded files
shows here before it shows on the card.
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "rapiddoc_tpu_torch" / "assets" / "published_smoke_golden.json"
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
TABLE_CROPS = (0, 1, 2, 3)
LENGTH_BUCKET = 256


def test_seeded_published_files_hash_as_the_golden():
    """The digests of the published-width stand-ins (state dicts leaf by
    leaf, text files by sha256) equal the golden's: the golden still
    describes the files the smoke writes."""
    import torch_published as P

    golden = json.loads(GOLDEN.read_text())
    assert P.published_digests() == golden["digests"]


def _env(**env):
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = {k: v for k, v in os.environ.items() if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in saved:
            del os.environ[k]
        os.environ.update(env)
        try:
            yield
        finally:
            for k in env:
                os.environ.pop(k, None)
            os.environ.update(saved)

    return ctx()


def jax_margins(rec, crops, ids) -> list[list[float]]:
    """Top-two margin of the fp32 logits at every step of each crop's own
    decode (BOS, then its ids fed back), the EOS step included."""
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.models.formula.engine import UNIMER_MEAN, UNIMER_STD, preprocess_formula

    cfg = rec.mbart_cfg
    hd = cfg.d_model // cfg.heads
    v = rec.variables
    step = jax.jit(lambda dec, cur, ck, cv, pos, mk, mv, mask: rec.decoder.apply(
        dec, cur, ck, cv, pos, mk, mv, mask))
    encode = jax.jit(rec.encoder.apply)
    project = jax.jit(rec.mem_proj.apply)
    canvases = [preprocess_formula(c) for c in crops]
    out: list[list[float]] = [[] for _ in crops]
    for bucket in dict.fromkeys(b for _, b in canvases):
        idx = [i for i, (_, b) in enumerate(canvases) if b == bucket]
        x = np.stack([canvases[i][0] for i in idx]).astype(np.float32) / 255.0
        x = np.broadcast_to((x - UNIMER_MEAN) / UNIMER_STD, (*x.shape[:-1], 3))
        memory = encode(v["encoder"], jnp.asarray(x, jnp.float32))
        mk, mv = project(v["mem_proj"], memory)
        b, s = memory.shape[:2]
        ck = jnp.zeros((cfg.layers, b, LENGTH_BUCKET, cfg.heads, hd), jnp.float32)
        cv = jnp.zeros_like(ck)
        mask = jnp.ones((b, s), bool)
        steps = max(min(len(ids[i]) + 1, LENGTH_BUCKET) for i in idx)
        cur = np.full((b, 1), cfg.bos_token_id, np.int32)
        for t in range(steps):
            logits, ck, cv = step(v["decoder"], jnp.asarray(cur), ck, cv, t, mk, mv, mask)
            top2 = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)[:, -2:]
            for row, i in enumerate(idx):
                if t <= len(ids[i]) and t < LENGTH_BUCKET:
                    out[i].append(float(f"{top2[row, 1] - top2[row, 0]:.6g}"))
                cur[row, 0] = ids[i][t] if t < len(ids[i]) else cfg.eos_token_id
    return out


def jax_unitable(uni, crops) -> tuple[list[list[int]], list[list[float]]]:
    """The JAX UniTable's token ids for the crops (one bucket of four, its
    own compiled decode), and the top-two margin of the whitelisted fp32
    scores at every step along them (a teacher-forced pass with the bf16
    KV caches of the decode)."""
    import cv2
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.models.table import unitable as U

    assert len(crops) == 4
    images = np.stack([cv2.resize(im, (U.IMG_SIZE, U.IMG_SIZE)) for im in crops])
    v = uni.variables
    tokens, lengths = (np.asarray(a) for a in uni._compiled(256)(
        v["encoder"], v["decoder"], v["mem_proj"], jnp.asarray(images)))
    ids = [tokens[i, :lengths[i]].tolist() for i in range(len(crops))]
    x = (images.astype(np.float32) / 255.0 - U.UNITABLE_MEAN) / U.UNITABLE_STD
    memory = jax.jit(uni.encoder.apply)(v["encoder"], jnp.asarray(x, jnp.bfloat16))
    mk, mv = jax.jit(uni.mem_proj.apply)(v["mem_proj"], memory)
    cfg = uni.decoder.cfg
    b = len(crops)
    ck = jnp.zeros((cfg.layers, b, 256, cfg.heads, cfg.d_model // cfg.heads), jnp.bfloat16)
    cv = jnp.zeros_like(ck)
    mask = jnp.ones(memory.shape[:2], bool)
    wl = U.whitelist_mask()
    step = jax.jit(uni.decoder.apply)
    cur = np.full((b, 1), U.PREFIX_ID, np.int32)
    margins: list[list[float]] = [[] for _ in crops]
    for t in range(int(lengths.max())):
        logits, ck, cv = step(v["decoder"], jnp.asarray(cur), ck, cv, t, mk, mv, mask)
        scores = np.asarray(logits[:, -1], np.float32) + wl
        top2 = np.sort(scores, axis=-1)[:, -2:]
        for i in range(b):
            if t < len(ids[i]):
                margins[i].append(float(f"{top2[i, 1] - top2[i, 0]:.6g}"))
            cur[i, 0] = ids[i][t] if t < len(ids[i]) else U.PAD_ID
    return ids, margins


def make_golden() -> dict:
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import torch_published as P
    from rapiddoc_tpu.models.formula.engine import FormulaRecognizer
    from rapiddoc_tpu.models.table.engine import TableRecognizer
    from rapiddoc_tpu.tools.convert_weights import main as convert

    with np.load(ASSETS / "formula_smoke_crops.npz") as z:
        crops = [z[f"crop{i:02d}"] for i in range(len(z.files))]
    with np.load(ASSETS / "table_smoke_crops.npz") as z:
        table_crops = [z[f"crop_{i}"] for i in TABLE_CROPS]
    with tempfile.TemporaryDirectory() as tmp:
        src, models = Path(tmp) / "src", Path(tmp) / "models"
        t0 = time.time()
        digests = P.write_published(src)
        print(f"files written in {time.time() - t0:.1f} s", flush=True)
        with _env(RAPIDDOC_MODELS_DIR=str(models)):
            for argv in (["formula", src / "pp_formulanet_plus_m.pth"],
                         ["formula_dict", src / "pp_formulanet_plus_m_inference.yml"],
                         ["unitable", src / "unitable" / "encoder.pth"]):
                assert convert([str(a) for a in argv]) == 0, argv
        with _env(RAPIDDOC_MODELS_DIR=str(models), RAPIDDOC_FP32_PARAMS="1"):
            t0 = time.time()
            rec = FormulaRecognizer.build({})
            assert rec.config.backbone_size == "B6" and rec.tokenizer.available()
            ids = [list(map(int, x)) for x in rec.batch_predict(crops, return_ids=True)]
            latex = [rec.tokenizer.decode(x) for x in ids]
            print(f"formula decoded in {time.time() - t0:.1f} s", flush=True)
            margins = jax_margins(rec, crops, ids)
            print(f"margins in {time.time() - t0:.1f} s", flush=True)
            del rec
            t0 = time.time()
            table = TableRecognizer.build({"strategy": "unitable"})
            html = table.batch_predict(table_crops)
            tokens = [list(t) for t, _ in table.wireless(table_crops, max_len=256)]
            table_ids, table_margins = jax_unitable(table.wireless, table_crops)
            print(f"tables in {time.time() - t0:.1f} s", flush=True)
    return {
        "digests": digests,
        "formula_fp32": {"crops": len(crops), "length_bucket": LENGTH_BUCKET, "ids": ids,
                         "latex": latex, "top2_margins": margins},
        "unitable_fp32": {"crops": list(TABLE_CROPS), "max_len": 256, "html": html,
                          "structure_tokens": tokens, "ids": table_ids,
                          "top2_margins": table_margins},
    }


if __name__ == "__main__":
    golden = make_golden()
    GOLDEN.write_text(json.dumps(golden, ensure_ascii=False) + "\n", encoding="utf-8")
    f = golden["formula_fp32"]
    u = golden["unitable_fp32"]
    print("wrote", GOLDEN, "ids lengths", [len(x) for x in f["ids"]],
          "min margin", min(min(m) for m in f["top2_margins"] if m),
          "tables", [len(h) for h in u["html"]], [len(x) for x in u["ids"]],
          "min margin", min(min(m) for m in u["top2_margins"] if m))
