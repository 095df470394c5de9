"""Synthetic-data training of the demo checkpoints, in PyTorch.

Port of ``rapiddoc_tpu/train/``: the trainers that make every demo
checkpoint the main path runs, from pages, lines, tables and formulas
drawn by the port's own replays (``pdfio/pil_draw.py``,
``pdfio/ft_face.py``, ``models/ocr/pre_post.resize_linear``,
``pdfio/jpeg_encode.py``, ``pdfio/jpeg.py`` and matplotlib's mathtext in
``utils/mathtext.py``).

Ported: ``bn`` (train-mode batch statistics, see
``models/common/layers.BatchNorm``), ``optim`` (optax's ``adam``,
``adamw``, ``warmup_cosine_decay_schedule`` and ``clip_by_global_norm``),
``synth``, ``det`` (DBNet), ``rec`` (SVTR/CTC, per language),
``orientation``, ``synth_table`` (synthetic tables with their grid,
tokens and cell boxes), ``table`` (the UNet, the wired/wireless
classifier and SLANet), ``unitable``, ``synth_layout`` (labeled layout
pages with mathtext formulas), ``layout`` (RT-DETR with Hungarian
matching) and ``formula`` (the formula recognizer). Every trainer of the
JAX package is ported. Checkpoints are written as the JAX package writes
them (``models/weights.save_variables`` of ``flax_variables``), so both
packages' registries read them.

Every trainer runs on the card unless the caller passes ``device="cpu"``;
a failed CUDA step raises.
"""
