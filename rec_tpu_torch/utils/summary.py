"""Training summaries (port of rec_tpu/utils/summary.py): scalars to
``metrics.jsonl`` in the log directory on every call, and scalars and
images to TensorBoard through ``torch.utils.tensorboard`` where the
``tensorboard`` package is installed (nothing else where it is not)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class SummaryWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = TBWriter(log_dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            v = float(v)
            rec[k] = v
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def images(self, step: int, tag: str, images) -> None:
        """(N, H, W, C) images in [0, 1] (clipped)."""
        if self._tb is not None:
            arr = np.clip(np.asarray(images), 0.0, 1.0)
            self._tb.add_images(tag, arr, step, dataformats="NHWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
