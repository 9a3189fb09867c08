"""``BENCHMARK.json`` against the benchmark's contract: names and units of
the allowed characters and lengths, every file it names present, every
metric's reader present, and the cells' metrics consistent."""

from __future__ import annotations

import json
import os
import re

import pytest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench(root):
    path = os.path.join(root, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def test_keys_and_command(bench, root):
    assert set(bench) == KEYS
    assert 1 <= len(bench["command"]) <= 32
    assert all(TEXT.match(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(root, p))
    assert os.path.isfile(os.path.join(root, bench["command"][1]))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    groups = (bench["configs"], bench["workloads"], metrics)
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["per_layer"]:
        assert TEXT.match(m["layer"])


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_files_exist(bench, root):
    bench_dir = os.path.join(root, "benchmark")
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(root, c["file"]))
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(bench_dir, "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(bench_dir, "layer_metrics",
                                           m["name"] + ".py"))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for w in bench["workloads"]:
        mine = {n for n, m in e2e.items() if reports(m, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in bench["per_layer"] if reports(m, w["name"])]
        assert layer
        for m in layer:
            assert m["moves"] in mine
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert len({m["layer"] for m in bench["per_layer"]
                    if m["layer"].lower() == m["layer"].lower()}) >= 1
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_mixes_and_limits(bench, root):
    for w in bench["workloads"]:
        with open(os.path.join(root, "benchmark", "traffic",
                               w["traffic"] + ".json")) as f:
            t = json.load(f)
        assert os.path.isfile(os.path.join(
            root, "benchmark", "benchlib", t["driver"] + ".py"))
        assert t["limits"] and all(v >= 0 for v in t["limits"].values())
        assert t.get("devices", 1) <= w["chips"]


def test_check_time_fits(bench):
    """A full check of 24 cells: 2 + 14 runs a cell, each allowed
    run_seconds + 60 s, each cell 180 s to compile, 1200 s spare."""
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200
