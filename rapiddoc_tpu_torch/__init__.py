"""rapiddoc_tpu_torch: the PyTorch/CUDA port of rapiddoc_tpu for NVIDIA
Hopper. The JAX package ``rapiddoc_tpu`` is its reference; this package
imports nothing of it. Ported so far: the OCR system
(``models.registry.build_ocr_system``) and the formula recognizer
(``models.registry.build_formula_recognizer``)."""
from .version import __version__

__all__ = ["__version__"]
