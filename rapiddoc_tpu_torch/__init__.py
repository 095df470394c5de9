"""rapiddoc_tpu_torch: the PyTorch/CUDA port of rapiddoc_tpu for NVIDIA
Hopper. The JAX package ``rapiddoc_tpu`` is its reference; this package
imports nothing of it. The first slice is the OCR system
(``models.registry.build_ocr_system``)."""
from .version import __version__

__all__ = ["__version__"]
