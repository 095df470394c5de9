"""rapiddoc_tpu_torch: the PyTorch/CUDA port of rapiddoc_tpu for NVIDIA
Hopper. The JAX package ``rapiddoc_tpu`` is its reference; this package
imports nothing of it. Ported so far: the system's main path,
``RapidDoc()(pdf_bytes, parse_method="ocr")`` for image-only PDFs with
layout, formula and table disabled (``api``, ``pdfio``, ``pipeline``),
over the OCR system (``models.registry.build_ocr_system``); and the
formula recognizer (``models.registry.build_formula_recognizer``)."""
from .api import RapidDoc, RapidDocOutput
from .version import __version__

__all__ = ["RapidDoc", "RapidDocOutput", "__version__"]
