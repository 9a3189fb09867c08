"""Console/file logging (port of rec_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def setup_logger(name: str, level=logging.INFO,
                 log_file: Optional[str] = None,
                 to_console: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if to_console:
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    return logger
