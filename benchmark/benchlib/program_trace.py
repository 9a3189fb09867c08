"""The program's own spans and counters (``rec_tpu_torch.utils.profiling``)
read against a traced run: what the readers of the program's per-layer
metrics share.

A traced run's ``torch.profiler`` session turns the program's recorder on;
after the window ``collect()`` gives every span (name, request, parent,
card, host start and end in ``time.perf_counter_ns``, counts) and the
counters.  Spans of the window are those that start in
``ctx["window_ns"]``; set-up spans (``setup.*``) are read before the
window, where set-up ran them.  A device event of ``ctx["events"]`` (host
clock, ``devtrace``) is attributed to the innermost span of its card whose
host interval holds the event's start.  The trace keeps no correlation
ids, so a kernel is placed by when the card started it, not by when the
host launched it: the two agree where the card waits on the host (it
starts a kernel as soon as it is launched), and drift apart where a queue
of launched work builds up.  A span's self time is its duration minus the
part its children cover.

Every reader returns None where the program records nothing: a program
without the recorder (``collect``), or a cell whose spans are absent."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from .devtrace import union_ns

_COPIES = ("Memcpy", "Memset")


class ProgramTrace:
    """The program's spans in a traced run's context."""

    def __init__(self, collected: dict, events, window_ns):
        self.spans = collected["spans"]
        self.counters = collected["counters"]
        self.dropped = collected["dropped"]
        self.window = window_ns
        self.events = events
        self._owner: Optional[List[int]] = None
        self._children: Optional[Dict[int, List[int]]] = None
        self._busy: Dict[int, tuple] = {}

    # --- selecting spans ----------------------------------------------------

    def in_window(self, name: str) -> List[int]:
        """Indices of the finished spans ``name`` that start in the
        window."""
        lo, hi = self.window
        return [i for i, s in enumerate(self.spans)
                if s.name == name and s.t1_ns is not None
                and lo <= s.t0_ns < hi]

    def before_window(self, name: str) -> List[int]:
        """Indices of the finished spans ``name`` that end before the
        window (set-up spans)."""
        lo = self.window[0]
        return [i for i, s in enumerate(self.spans)
                if s.name == name and s.t1_ns is not None and s.t1_ns <= lo]

    def total_ns(self, idx: List[int]) -> int:
        return sum(self.spans[i].t1_ns - self.spans[i].t0_ns for i in idx)

    # --- self time ----------------------------------------------------------

    def children(self) -> Dict[int, List[int]]:
        if self._children is None:
            kids: Dict[int, List[int]] = defaultdict(list)
            for i, s in enumerate(self.spans):
                if s.parent >= 0:
                    kids[s.parent].append(i)
            self._children = kids
        return self._children

    def self_ns(self, i: int) -> int:
        """Span i's duration minus what its finished children cover."""
        s = self.spans[i]
        kids = [(self.spans[k].t0_ns, self.spans[k].t1_ns)
                for k in self.children().get(i, ())
                if self.spans[k].t1_ns is not None]
        return (s.t1_ns - s.t0_ns) - union_ns(kids, s.t0_ns, s.t1_ns)

    # --- device events ------------------------------------------------------

    def owners(self) -> List[int]:
        """For each event of ``events``, the index of the innermost span of
        its card whose interval holds the event's start (-1: none)."""
        if self._owner is not None:
            return self._owner
        by_card: Dict[int, List[int]] = defaultdict(list)
        for i, s in enumerate(self.spans):
            if s.t1_ns is not None:
                by_card[s.card].append(i)
        owner = [-1] * len(self.events)
        ev_by_card: Dict[int, List[int]] = defaultdict(list)
        for j, e in enumerate(self.events):
            ev_by_card[e.device].append(j)
        for card, evs in ev_by_card.items():
            spans = sorted(by_card.get(card, ()),
                           key=lambda i: (self.spans[i].t0_ns,
                                          -self.spans[i].t1_ns))
            evs.sort(key=lambda j: self.events[j].start_ns)
            stack: List[int] = []
            k = 0
            for j in evs:
                t = self.events[j].start_ns
                while k < len(spans) and self.spans[spans[k]].t0_ns <= t:
                    stack.append(spans[k])
                    k += 1
                while stack and self.spans[stack[-1]].t1_ns < t:
                    stack.pop()
                # Spans of other threads may interleave: take the innermost
                # open one that still holds t.
                for i in reversed(stack):
                    if self.spans[i].t1_ns >= t:
                        owner[j] = i
                        break
        self._owner = owner
        return owner

    def under(self, names) -> List[bool]:
        """Per span: whether it, or an ancestor, is a span of the window
        named one of ``names``."""
        names = set(names)
        lo, hi = self.window
        flag: List[bool] = []
        for s in self.spans:   # a parent precedes its children
            flag.append((s.name in names and lo <= s.t0_ns < hi)
                        or (s.parent >= 0 and flag[s.parent]))
        return flag

    def kernels_under(self, names) -> int:
        """Device kernels (copies left out) attributed to the window's
        spans named one of ``names`` or to their descendants."""
        flag = self.under(names)
        return sum(1 for e, o in zip(self.events, self.owners())
                   if o >= 0 and flag[o] and not e.name.startswith(_COPIES))

    def idle_inside_ns(self, idx: List[int], card: int) -> int:
        """Card ``card``'s idle time, clipped to the window, inside the
        spans ``idx`` (which do not overlap one another)."""
        if card not in self._busy:
            iv = sorted((e.start_ns, e.end_ns) for e in self.events
                        if e.device == card)
            self._busy[card] = (iv, [s for s, _ in iv])
        iv, starts = self._busy[card]
        lo, hi = self.window
        idle = 0
        for i in idx:
            s = self.spans[i]
            a, b = max(s.t0_ns, lo), min(s.t1_ns, hi)
            if b <= a:
                continue
            i0 = max(bisect.bisect_left(starts, a) - 1, 0)
            i1 = bisect.bisect_left(starts, b)
            idle += (b - a) - union_ns(iv[i0:i1], a, b)
        return idle


def program(ctx) -> Optional[ProgramTrace]:
    """The program's trace of this run (read once and kept in ``ctx``), or
    None where the program has no recorder."""
    if "program_trace" not in ctx:
        from rec_tpu_torch.utils import profiling

        collect = getattr(profiling, "collect", None)
        ctx["program_trace"] = (
            None if collect is None else
            ProgramTrace(collect(), ctx["events"], ctx["window_ns"]))
    return ctx["program_trace"]


def span_ms_per_unit(ctx, *names) -> Optional[float]:
    """Host ms per unit in the window's spans ``names``, summed."""
    pt = program(ctx)
    if pt is None or not ctx.get("units"):
        return None
    idx = [i for n in names for i in pt.in_window(n)]
    if not idx:
        return None
    return pt.total_ns(idx) / 1e6 / ctx["units"]


def kernels_per_unit(ctx, *names) -> Optional[float]:
    """Device kernels per unit attributed to the window's spans ``names``
    and their descendants."""
    pt = program(ctx)
    if pt is None or not ctx.get("units"):
        return None
    if not any(pt.in_window(n) for n in names):
        return None
    return pt.kernels_under(names) / ctx["units"]


def idle_share(ctx, name: str) -> Optional[float]:
    """Each card's idle time inside the window's spans ``name`` of that
    card, over its idle time in the window, in %; the mean over the
    cards."""
    pt = program(ctx)
    if pt is None:
        return None
    idx = pt.in_window(name)
    if not idx:
        return None
    lo, hi = ctx["window_ns"]
    shares = []
    for card, busy in ctx["busy_ns"].items():
        idle = (hi - lo) - busy
        mine = [i for i in idx if pt.spans[i].card == card]
        shares.append(100.0 * pt.idle_inside_ns(mine, card) / idle
                      if idle > 0 else 0.0)
    return sum(shares) / len(shares)


def count_share(ctx, name: str, part: str, whole: str) -> Optional[float]:
    """100 * the sum of count ``part`` over the sum of count ``whole`` in
    the window's spans ``name``."""
    pt = program(ctx)
    if pt is None:
        return None
    idx = pt.in_window(name)
    total = sum(pt.spans[i].counts.get(whole, 0) for i in idx)
    if not total:
        return None
    return 100.0 * sum(pt.spans[i].counts.get(part, 0) for i in idx) / total


def setup_s(ctx, name: str) -> Optional[float]:
    """Seconds in the set-up spans ``name`` before the window."""
    pt = program(ctx)
    if pt is None:
        return None
    idx = pt.before_window(name)
    return pt.total_ns(idx) / 1e9 if idx else None


def table(ctx) -> dict:
    """Per span name in the window, per unit: count, host ms and self ms,
    the kernels (copies left out) whose innermost span it is, and each
    card's idle ms inside the spans of that card; each card's idle ms in
    the window per unit; set-up spans before the window in seconds; the
    counters.  For PERF.md's breakdown, not a metric."""
    pt = program(ctx)
    if pt is None:
        return {}
    units = ctx.get("units") or 1
    lo, hi = ctx["window_ns"]
    rows: Dict[str, dict] = defaultdict(lambda: {"n": 0, "ms": 0.0,
                                                 "self_ms": 0.0,
                                                 "kernels": 0})
    by_name: Dict[str, List[int]] = defaultdict(list)
    for i, s in enumerate(pt.spans):
        if s.t1_ns is None or not lo <= s.t0_ns < hi:
            continue
        by_name[s.name].append(i)
        r = rows[s.name]
        r["n"] += 1
        r["ms"] += (s.t1_ns - s.t0_ns) / 1e6 / units
        r["self_ms"] += pt.self_ns(i) / 1e6 / units
    for e, o in zip(pt.events, pt.owners()):
        if o >= 0 and not e.name.startswith(_COPIES):
            s = pt.spans[o]
            if lo <= s.t0_ns < hi:
                rows[s.name]["kernels"] += 1
    for name, r in rows.items():
        r["kernels"] /= units
        r["idle_ms_by_card"] = {
            card: pt.idle_inside_ns(
                [i for i in by_name[name] if pt.spans[i].card == card],
                card) / 1e6 / units
            for card in ctx["busy_ns"]}
    setup = {name: pt.total_ns(pt.before_window(name)) / 1e9
             for name in {s.name for s in pt.spans
                          if s.name.startswith("setup.")}}
    card_idle = {card: ((hi - lo) - busy) / 1e6 / units
                 for card, busy in ctx["busy_ns"].items()}
    return {"units": units, "spans": dict(rows), "setup_s": setup,
            "idle_ms_by_card": card_idle, "counters": pt.counters,
            "dropped": pt.dropped}
