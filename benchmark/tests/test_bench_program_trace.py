"""``benchlib/program_trace.py`` on synthetic spans and device events:
kernels attributed to the innermost span of their card, idle time inside
spans, self times, the window filter, set-up spans, and readers returning
None where the program records nothing.  Then the tiny cells on the CPU,
with a CPU profiler session standing in for the device trace: every
metric that reads the program's spans reads a value in each cell its
entry lists."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchlib import devtrace, manifest, program_trace, yardstick
from benchlib.devtrace import DeviceEvent
from conftest import tiny
from rec_tpu_torch.coding import rng
from rec_tpu_torch.utils import profiling
from rec_tpu_torch.utils.profiling import SpanRecord

WINDOW = (100, 1000)


def _span(name, parent, card, t0, t1, **counts):
    return SpanRecord(name, 0, parent, card, t0, t1, counts)


SPANS = [
    _span("setup.normal_table", -1, 0, 10, 60),           # 0
    _span("setup.normal_table", -1, 1, 20, 50),           # 1 (card 1)
    _span("model.compress_batch", -1, 0, 100, 500),       # 2
    _span("coder.replay", 2, 0, 150, 350, rows=48, live_rows=12),  # 3
    _span("replay.normals", 3, 0, 200, 300),              # 4
    _span("model.compress_batch", -1, 1, 500, 900),       # 5
    _span("coder.replay", 5, 1, 600, 800, rows=48, live_rows=36),  # 6
    _span("coder.replay", -1, 0, 1000, 1100, rows=99, live_rows=0),  # 7
]
EVENTS = [
    DeviceEvent("k_root", 0, 120, 140),      # model.compress_batch
    DeviceEvent("k_replay", 0, 160, 170),    # coder.replay
    DeviceEvent("k_normals", 0, 210, 260),   # replay.normals
    DeviceEvent("Memcpy HtoD", 0, 220, 230),  # a copy: never a kernel
    DeviceEvent("k_tail", 0, 340, 400),      # coder.replay, ends after it
    DeviceEvent("k_card1", 1, 650, 700),     # card 1's replay
    DeviceEvent("k_idle", 1, 950, 960),      # no span of card 1 holds it
    DeviceEvent("k_late", 0, 1050, 1060),    # after the window
]


@pytest.fixture
def ctx():
    collected = {"spans": list(SPANS), "dropped": 0,
                 "counters": {"mega_beam.launches": {"cuda:0": 2}}}
    busy = devtrace.busy_by_device(EVENTS, WINDOW, [0, 1])
    return {"events": EVENTS, "window_ns": WINDOW, "busy_ns": busy,
            "units": 4, "program_trace": program_trace.ProgramTrace(
                collected, EVENTS, WINDOW)}


def test_kernels_go_to_the_innermost_span_of_their_card(ctx):
    pt = program_trace.program(ctx)
    assert pt.owners() == [2, 3, 4, 4, 3, 6, -1, 7]
    # The window's replays' kernels and their children's, copies left out:
    # k_replay, k_normals, k_tail on card 0, k_card1 on card 1.
    assert pt.kernels_under(["coder.replay"]) == 4
    assert program_trace.kernels_per_unit(ctx, "coder.replay") == 4 / 4


def test_the_window_filter(ctx):
    pt = program_trace.program(ctx)
    assert pt.in_window("coder.replay") == [3, 6]
    assert program_trace.span_ms_per_unit(ctx, "coder.replay") == \
        (200 + 200) / 1e6 / 4
    assert program_trace.count_share(ctx, "coder.replay", "live_rows",
                                     "rows") == 100.0 * 48 / 96


def test_setup_spans_before_the_window(ctx):
    pt = program_trace.program(ctx)
    assert pt.before_window("setup.normal_table") == [0, 1]
    assert program_trace.setup_s(ctx, "setup.normal_table") == 80 / 1e9
    assert program_trace.setup_s(ctx, "setup.ddi") is None


def test_self_time(ctx):
    pt = program_trace.program(ctx)
    assert pt.self_ns(2) == 400 - 200
    assert pt.self_ns(3) == 200 - 100
    assert pt.self_ns(4) == 100


def test_idle_inside_spans(ctx):
    pt = program_trace.program(ctx)
    # Card 0 in replay 3 [150, 350]: busy 160-170, 210-260, 340-350.
    assert pt.idle_inside_ns([3], 0) == 200 - 10 - 50 - 10
    # Card 1 in replay 6 [600, 800]: busy 650-700.
    assert pt.idle_inside_ns([6], 1) == 150
    idle0 = (WINDOW[1] - WINDOW[0]) - ctx["busy_ns"][0]
    idle1 = (WINDOW[1] - WINDOW[0]) - ctx["busy_ns"][1]
    want = (100.0 * 130 / idle0 + 100.0 * 150 / idle1) / 2
    assert program_trace.idle_share(ctx, "coder.replay") == \
        pytest.approx(want)


def test_table(ctx):
    t = program_trace.table(ctx)
    assert t["spans"]["replay.normals"]["kernels"] == 1 / 4
    assert t["spans"]["coder.replay"]["n"] == 2
    assert t["spans"]["coder.replay"]["idle_ms_by_card"] == {
        0: 130 / 1e6 / 4, 1: 150 / 1e6 / 4}
    assert t["setup_s"]["setup.normal_table"] == 80 / 1e9
    assert t["counters"] == {"mega_beam.launches": {"cuda:0": 2}}


def test_readers_return_none_without_their_spans(ctx, monkeypatch):
    assert program_trace.span_ms_per_unit(ctx, "train.forward") is None
    assert program_trace.kernels_per_unit(ctx, "train.ema") is None
    assert program_trace.idle_share(ctx, "io.to_host") is None
    assert program_trace.count_share(ctx, "io.to_host", "a", "b") is None
    # A program without the recorder (the parent of the change that added
    # it): every reader gives None.
    monkeypatch.delattr(profiling, "collect")
    bare = {k: v for k, v in ctx.items() if k != "program_trace"}
    assert program_trace.program(bare) is None
    assert program_trace.span_ms_per_unit(bare, "coder.replay") is None
    assert program_trace.setup_s(bare, "setup.ddi") is None
    assert program_trace.table(bare) == {}


class _CpuTrace:
    """``devtrace.DeviceTrace`` on the CPU: a profiler session (which turns
    the program's recorder on) over the window, and no device events."""

    def __init__(self, devices):
        self.events, self.window_ns = [], (0, 0)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        self.window_ns = (self._t0, t1)
        return False


PROGRAM_METRICS = ["replay_ms_per_image.encode_rate",
                   "replay_kernels_per_image.encode_rate",
                   "replay_idle_share.encode_rate",
                   "replay_ms_per_image.encode_p95",
                   "replay_live_share.encode_p95",
                   "device_wait_ms_per_image.encode_p95",
                   "forward_ms_per_step.train", "backward_ms_per_step.train",
                   "update_ms_per_step.train",
                   "update_kernels_per_step.train", "ddi_s.setup",
                   "tables_s.setup"]


@pytest.mark.parametrize("workload", ["rvae24.serve_b8", "lossy2.kodak_b1",
                                      "rvae24.train_b8",
                                      "rvae24.serve_b8.x4"])
def test_each_cell_reads_its_program_metrics(root, workload, monkeypatch):
    import run

    torch.set_num_threads(2)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    want = {n for n in PROGRAM_METRICS
            if workload in entries[n]["workloads"]}
    monkeypatch.setattr(devtrace, "DeviceTrace", _CpuTrace)
    monkeypatch.setattr(yardstick, "card_rates", dict)
    # A fresh process builds the normal table in set-up.
    rng.normal_table.cache_clear()
    rng.erfinv_table.cache_clear()

    def small(cell):
        cell = tiny(cell)
        return cell._replace(traffic=dict(cell.traffic, trace_units=1))

    line = run.run_cell(root, workload, 2 ** 31 + 99, 0.2, True,
                        device="cpu", tweak=small)
    got = {n for n in PROGRAM_METRICS if n in line["metrics"]}
    assert got == want, line["metrics"]
    cell = manifest.load_cell(root, workload)
    assert {m["name"] for m in cell.per_layer} >= want
    if "replay_live_share.encode_p95" in want:
        assert 0 < line["metrics"]["replay_live_share.encode_p95"][
            "value"] <= 100
