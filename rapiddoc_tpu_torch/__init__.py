"""rapiddoc_tpu_torch: the PyTorch/CUDA port of rapiddoc_tpu for NVIDIA
Hopper. The JAX package ``rapiddoc_tpu`` is its reference; this package
imports nothing of it. Its entry points: ``RapidDoc`` (``api``), the
command line (``cli.main``, the ``rapiddoc-tpu-torch`` script),
``do_parse`` / ``aio_do_parse`` (``cli.common``), the HTTP service and
web UI (``serve.http``), the per-model command lines
(``python -m rapiddoc_tpu_torch.models.<stage>``) and the chunker
(``chunker``). They run on the card unless the caller names another
device or ``RAPIDDOC_PLATFORM=cpu`` is set. Every name is imported at
first use, so a process that needs only ``pdfio`` (a render pool's
worker) imports neither torch nor the models."""
from .version import __version__

__all__ = ["RapidDoc", "RapidDocOutput", "NamedBytes", "do_parse", "aio_do_parse",
           "CustomBaseModel", "__version__"]

_LAZY = {
    "RapidDoc": ("api", "RapidDoc"),
    "RapidDocOutput": ("api", "RapidDocOutput"),
    "NamedBytes": ("api", "NamedBytes"),
    "do_parse": ("cli.common", "do_parse"),
    "aio_do_parse": ("cli.common", "aio_do_parse"),
    "CustomBaseModel": ("models.custom", "CustomBaseModel"),
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{target[0]}", __name__), target[1])
