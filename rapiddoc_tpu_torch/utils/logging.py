"""Framework logger (stdlib logging; the environment has no loguru)."""
from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"


def get_logger(name: str = "rapiddoc_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("RAPIDDOC_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger


logger = get_logger()
