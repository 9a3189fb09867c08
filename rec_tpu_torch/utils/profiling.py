"""Timing boundaries (port of rec_tpu/utils/profiling.py).

PyTorch returns from a CUDA call before the device finishes, so a host
timer around device work must end in ``device_fence``: it synchronizes
every CUDA device that holds a tensor of the given tree (nested dicts,
lists, tuples).  CPU tensors need no fence.  ``device_trace`` records a
torch.profiler trace that TensorBoard reads, and ``annotate`` names a span
in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_fence(tree) -> None:
    """Wait until the device work producing ``tree``'s CUDA tensors is
    done."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating per-phase wall-clock timer; pass the phase's device
    outputs as ``sync`` so device work is fenced at phase exit."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_fence(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000.0 * self.totals[k] / self.counts[k]}
                for k in self.totals}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler session over the CPU and, where a card is present,
    CUDA activity; the trace goes to ``log_dir`` for TensorBoard
    (``tensorboard_trace_handler``).  Yields the profiler, whose events
    the caller may read after the block."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named span in the profiler's trace (``record_function``), and an
    NVTX range when a card is present."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
