"""Self-contained PDF subsystem of the port: parse, extract text,
rasterize image pages.

The parsing modules (``cos``, ``crypt``, ``filters``, ``document``,
``fonts``, ``content``, ``text``, ``placements``, ``classify``) are the
JAX package's pure-Python ``rapiddoc_tpu/pdfio`` modules, copied;
``filters`` takes its numpy/Python paths only. ``jpeg``, ``images`` and
``render`` decode and draw without PIL or cv2 (see each module), the
Pillow operations the JAX renderer uses replayed in ``pil_draw`` and
``pil_resample``;
``png``, ``jpeg_encode`` and ``writer`` turn image files and arrays
into PDFs as the JAX package's PIL-based ``writer`` does.
"""
from .classify import classify_pdf
from .document import PdfDocument, PdfError, PdfPage, open_pdf
from .render import render_page_full
from .text import get_page, page_text

__all__ = [
    "PdfDocument",
    "PdfPage",
    "PdfError",
    "open_pdf",
    "render_page_full",
    "get_page",
    "page_text",
    "classify_pdf",
]
