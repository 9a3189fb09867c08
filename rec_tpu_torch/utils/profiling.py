"""Timing boundaries and the program's own trace (port of
rec_tpu/utils/profiling.py, extended).

PyTorch returns from a CUDA call before the device finishes, so a host
timer around device work must end in ``device_fence``: it synchronizes
every CUDA device that holds a tensor of the given tree (nested dicts,
lists, tuples).  CPU tensors need no fence.  ``device_trace`` records a
torch.profiler trace that TensorBoard reads.

The recorder.  ``span(name, card=None, setup=False, **counts)`` marks one
layer boundary of the program (``with span("coder.replay", rows=n): ...``)
and records

    (name, request id, parent index, card, t0_ns, t1_ns, counts)

on ``time.perf_counter_ns``, the host clock onto which a device trace's
events can be mapped.  A span opened with no span open in its thread is a
root, the program's entry call, and opens a new request id; its children
carry that id and the index of their parent.  ``card`` is the CUDA card the
span's work is issued to (-1: the host), given as an index or a device; a
span that names none takes its parent's.  ``counts`` are integers, or
tensors: a tensor's sum goes, as its device computes it, into the span's
slot of one buffer per device and key, and ``collect`` reads each buffer
once (the hot path gains no host sync, and the recorder keeps no tensor
of the program's).

Hot-path spans record only while a ``torch.profiler`` session is active
(``torch.autograd.profiler._is_profiler_enabled``, which every session
sets, whatever its activities); they then also enter ``record_function``,
so ``device_trace``'s TensorBoard traces name them.  With no session a span
costs one flag check and returns a shared no-op object: no clock, no
record.  Set-up spans (``setup=True``: work done once per process or cache
fill) record whether a session is active or not, and end with a fence of
their card, so they time the work and not its enqueue.

Records go into a buffer of ``CAPACITY`` spans; past it the oldest are
dropped and counted.  Counters (``add``; read with ``counter``) are always
on: the kernels' launch counts, by card.  ``collect()`` returns the spans,
the drops and the counters; an operator reads the program's trace from it,
or reads the spans by name in a ``device_trace`` TensorBoard trace.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 20


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
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Count one phase ``name`` timed elsewhere."""
        self.totals[name] += seconds
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
    the caller may read after the block.  The session turns the recorder's
    hot-path spans on."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def is_annotation(event) -> bool:
    """Whether a torch.profiler event (a ``prof.events()`` item or a raw
    kineto event) is a ``record_function`` range, such as the recorder's
    spans while a session is on, and not work of its own: readers that sum
    device time or count events leave these out."""
    flag = getattr(event, "is_user_annotation", False)
    return bool(flag() if callable(flag) else flag)


def _card_index(device) -> int:
    """The CUDA card index of ``device`` (a bare "cuda" is the current
    card), -1 for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return -1
    return torch.cuda.current_device() if device.index is None \
        else device.index


class SpanRecord(NamedTuple):
    """One span as ``collect`` returns it.  ``parent`` indexes the same
    list (-1: a root, or a parent dropped from the buffer); ``t1_ns`` is
    None while the span is open."""

    name: str
    request: int
    parent: int
    card: int
    t0_ns: int
    t1_ns: Optional[int]
    counts: dict


class Recorder:
    """The spans and counters of one process (``RECORDER``; tests make
    their own).  Safe to record into from several threads."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # A ring of [name, request, parent id, card, t0, t1, counts].
        self._slots: list = []
        self._opened = 0         # spans ever opened; a span's id
        self._requests = 0
        self._local = threading.local()
        self._counters: Dict[str, collections.Counter] = defaultdict(
            collections.Counter)
        # (device, key) -> int64 (capacity,): tensor counts' sums by slot.
        self._held: dict = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, card, counts: dict):
        """(id, record) of a new span, pushed on this thread's stack; its
        t0 is set by the caller."""
        stack = self._stack()
        parent, request, parent_card = stack[-1] if stack else (-1, None, -1)
        if card is None:
            card = parent_card
        elif not isinstance(card, int):
            card = _card_index(card)
        with self._lock:
            sid = self._opened
            self._opened += 1
            if request is None:
                request = self._requests
                self._requests += 1
            rec = [name, request, parent, card, None, None, {}]
            if sid < self.capacity:
                self._slots.append(rec)
            else:
                self._slots[sid % self.capacity] = rec
        stack.append((sid, request, card))
        self._put(sid, rec[6], counts)
        return sid, rec

    def _close(self) -> None:
        self._stack().pop()

    def _put(self, sid: int, into: dict, counts: dict) -> None:
        """Set span ``sid``'s counts; a tensor's sum is written on its
        device into slot ``sid`` of the buffer for its key, which ``into``
        then names in the tensor's place."""
        for k, v in counts.items():
            if isinstance(v, torch.Tensor):
                buf = self._held.get((v.device, k))
                if buf is None:
                    with self._lock:
                        buf = self._held.get((v.device, k))
                        if buf is None:
                            buf = self._held[v.device, k] = torch.empty(
                                self.capacity, dtype=torch.int64,
                                device=v.device)
                torch.sum(v.reshape(-1), 0, dtype=torch.int64,
                          out=buf[sid % self.capacity])
                v = buf
            into[k] = v

    def span(self, name: str, card=None, setup: bool = False, **counts):
        """A span (module docstring), as a context manager; while the
        recorder is off, the shared no-op one."""
        if not (setup or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, name, card, setup, counts)

    def add(self, name: str, key: str, n: int = 1) -> None:
        """Add ``n`` to the always-on counter ``name`` under ``key`` (e.g.
        ``add("mega_beam.launches", "cuda:0")``)."""
        with self._lock:
            self._counters[name][key] += n

    def counter(self, name: str, since: Optional[dict] = None
                ) -> Dict[str, int]:
        """Counter ``name`` by key (a copy); given an earlier reading
        ``since``, what was added after it (keys that grew only)."""
        with self._lock:
            now = dict(self._counters.get(name, {}))
        if since is None:
            return now
        return {k: v - since.get(k, 0) for k, v in now.items()
                if v != since.get(k, 0)}

    def collect(self) -> dict:
        """``{"spans": [SpanRecord], "dropped": int, "counters": {name:
        {key: int}}}``: the buffered spans in the order they opened, their
        tensor counts read as integers (one read per buffer)."""
        with self._lock:
            n = self._opened
            first = max(0, n - self.capacity)
            raw = [r[:6] + [dict(r[6])] for r in
                   (self._slots[i % self.capacity] for i in range(first, n))]
            counters = {k: dict(v) for k, v in self._counters.items()}
        held = defaultdict(list)      # id(buffer) -> [(counts, key, slot)]
        buffers = {}
        for sid, r in enumerate(raw, first):
            for k, v in r[6].items():
                if isinstance(v, torch.Tensor):
                    buffers[id(v)] = v
                    held[id(v)].append((r[6], k, sid % self.capacity))
        for b, items in held.items():
            buf = buffers[b]
            slots = torch.tensor([i for _, _, i in items], device=buf.device)
            for (counts, k, _), v in zip(items, buf[slots].tolist()):
                counts[k] = v
        spans = [SpanRecord(r[0], r[1], r[2] - first if r[2] >= first
                            else -1, r[3], r[4], r[5], r[6])
                 for r in raw]
        return {"spans": spans, "dropped": first, "counters": counters}


class _Span:
    __slots__ = ("_rec", "_name", "_card", "_setup", "_counts", "_sid",
                 "_record", "_fn")

    def __init__(self, recorder: Recorder, name: str, card, setup: bool,
                 counts: dict):
        self._rec, self._name, self._card = recorder, name, card
        self._setup, self._counts = setup, counts
        self._fn = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._fn = torch.profiler.record_function(self._name)
            self._fn.__enter__()
        self._sid, self._record = self._rec._open(self._name, self._card,
                                                  self._counts)
        self._record[4] = time.perf_counter_ns()
        return self

    def count(self, **counts) -> None:
        """Add counts known only inside the span."""
        self._rec._put(self._sid, self._record[6], counts)

    def __exit__(self, *exc):
        card = self._record[3]
        if self._setup and card >= 0:
            torch.cuda.synchronize(card)
        self._record[5] = time.perf_counter_ns()
        self._rec._close()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


class _Off:
    """The span of a recorder that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def count(self, **counts) -> None:
        pass

    def __exit__(self, *exc):
        return False


_OFF = _Off()

RECORDER = Recorder()
# The process's recorder, which the program's spans and counters use.
span = RECORDER.span
add = RECORDER.add
counter = RECORDER.counter
collect = RECORDER.collect
