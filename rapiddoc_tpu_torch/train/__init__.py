"""Synthetic-data training of the demo checkpoints, in PyTorch.

Port of ``rapiddoc_tpu/train/``: the trainers that make the demo det, rec
and orientation weights the main path runs, from pages and lines drawn by
``synth.py`` (the port's own drawing: ``pdfio/pil_draw.py``,
``pdfio/ft_face.py``, ``models/ocr/pre_post.resize_linear``,
``pdfio/jpeg_encode.py`` and ``pdfio/jpeg.py``).

Ported: ``bn`` (train-mode batch statistics, see
``models/common/layers.BatchNorm``), ``optim`` (optax's ``adam``,
``adamw``, ``warmup_cosine_decay_schedule`` and ``clip_by_global_norm``),
``synth``, ``det`` (DBNet), ``rec`` (SVTR/CTC, per language),
``orientation``, ``synth_table`` (synthetic tables with their grid,
tokens and cell boxes), ``table`` (the UNet, the wired/wireless
classifier and SLANet) and ``unitable``. Checkpoints are written as the
JAX package writes them (``models/weights.save_variables`` of
``flax_variables``), so both packages' registries read them.

Not ported yet: ``layout`` and ``formula``, whose synthetic pages need
matplotlib's mathtext (``synth_layout``).

Every trainer runs on the card unless the caller passes ``device="cpu"``;
a failed CUDA step raises.
"""
