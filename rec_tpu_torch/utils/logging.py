"""Console/file logging and ``gaussian_blur`` (port of
rec_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


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


def gaussian_blur(image: torch.Tensor, kernel_size: int = 5,
                  sigma: float = 1.0) -> torch.Tensor:
    """Depthwise Gaussian blur of an NHWC tensor with zero "SAME" padding;
    the kernel is built in float64 and cast to float32, as ``rec_tpu``
    builds it."""
    r = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-0.5 * (r / sigma) ** 2)
    g /= g.sum()
    k2d = torch.from_numpy(np.outer(g, g).astype(np.float32)).to(image.device)
    C = image.shape[-1]
    weight = k2d[None, None].expand(C, 1, kernel_size, kernel_size)
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    x = F.pad(image.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    out = F.conv2d(x, weight, groups=C)
    return out.permute(0, 2, 3, 1)
