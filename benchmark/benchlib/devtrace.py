"""The device trace of a traced run: every kernel and copy the cards ran
in the window, read from torch.profiler's raw kineto events (building its
Python event tree costs seconds per ten thousand kernels, and an image
launches ~90,000).  Only device activity is recorded.

The window's idle share is taken from the union of the kernel intervals
inside the one traced window: 1 - union / window, per card.  Host and
device clocks are tied by a marker kernel launched right after a fence at
the window's start: its device start is the host time of its launch, to a
launch's latency (microseconds)."""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, NamedTuple, Tuple

import torch

MARKER = 7.25   # the marker kernel fills one float with this value


class DeviceEvent(NamedTuple):
    name: str
    device: int
    start_ns: int
    end_ns: int


class DeviceTrace:
    """``with DeviceTrace(devices) as tr: ...``; afterwards ``tr.events``
    (device events in host-clock ns), ``tr.window_ns`` (start, end)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.events: List[DeviceEvent] = []
        self.window_ns: Tuple[int, int] = (0, 0)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        for d in self.devices:
            torch.cuda.synchronize(d)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.devices[0])
        self._marker = torch.empty(1, device=self.devices[0])
        self._t_marker = time.perf_counter_ns()
        self._marker.fill_(MARKER)
        torch.cuda.synchronize(self.devices[0])
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        for d in self.devices:
            torch.cuda.synchronize(d)
        t1 = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.device_index(), e.start_ns(), e.duration_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        if not raw:
            raise RuntimeError("torch.profiler recorded no device event")
        raw.sort(key=lambda r: r[2])
        fills = [r for r in raw if "fill" in r[0].lower()]
        marker = fills[0] if fills else raw[0]
        offset = marker[2] - self._t_marker
        self.events = [DeviceEvent(n, d, s - offset, s - offset + dur)
                       for n, d, s, dur in raw if (n, d, s, dur) != marker]
        self.window_ns = (self._t0, t1)
        return False


def union_ns(intervals: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_by_device(events: List[DeviceEvent], window: Tuple[int, int],
                   devices: List[int]) -> Dict[int, int]:
    by: Dict[int, list] = {d: [] for d in devices}
    for e in events:
        if e.device in by:
            by[e.device].append((e.start_ns, e.end_ns))
    return {d: union_ns(iv, *window) for d, iv in by.items()}


def top_ops(events: List[DeviceEvent], n: int = 10) -> List[list]:
    by: Dict[str, float] = {}
    for e in events:
        by[e.name] = by.get(e.name, 0.0) + (e.end_ns - e.start_ns) / 1e9
    return [[k[:120], v] for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:n]]


def idle_by_span(events: List[DeviceEvent], window: Tuple[int, int],
                 device: int, spans, n: int = 10) -> List[list]:
    """Card ``device``'s idle seconds in the window, split by the
    benchmark span the host was in (the drivers' spans do not nest); the
    rest is ``outside_spans``."""
    iv = sorted((e.start_ns, e.end_ns) for e in events if e.device == device)
    starts = [s for s, _ in iv]
    lo, hi = window
    total_idle = (hi - lo) - union_ns(iv, lo, hi)
    by: Dict[str, float] = {}
    inside = 0
    for name, t0, t1 in spans.records:
        a, b = max(t0, lo), min(t1, hi)
        if b <= a:
            continue
        i0 = max(bisect.bisect_left(starts, a) - 1, 0)
        i1 = bisect.bisect_left(starts, b)
        idle = (b - a) - union_ns(iv[i0:i1], a, b)
        by[name] = by.get(name, 0.0) + idle / 1e9
        inside += idle
    by["outside_spans"] = (total_idle - inside) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
