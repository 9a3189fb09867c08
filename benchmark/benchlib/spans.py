"""Spans the benchmark records around its own calls into the program's
layers: name, start and end on the host's monotonic clock (ns).  They are
kept in memory and read when the run ends; ``fence`` makes a span end only
when the device work it launched has finished."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Spans:
    def __init__(self):
        self.records: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str, fence=None):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if fence is not None:
                for dev in fence:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            self.records.append((name, t0, time.perf_counter_ns()))

    def totals_ms(self) -> Dict[str, Tuple[float, int]]:
        """Per name: (total ms, count)."""
        acc: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        for name, t0, t1 in self.records:
            acc[name][0] += (t1 - t0) / 1e6
            acc[name][1] += 1
        return {k: (v[0], v[1]) for k, v in acc.items()}
