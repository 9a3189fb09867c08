"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and the readers of its per-layer metrics (``layer_metrics/<metric>.py``).
A later cell, mix or metric is a new file and a new entry; no code here
changes for it."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic files read."""
    bench = load_manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, cfgs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in reported]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def layer_reader(metric: str):
    """The ``read(ctx)`` function of ``layer_metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "layer_metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "layer_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
