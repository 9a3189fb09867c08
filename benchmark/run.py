"""Run one cell of the benchmark of rec_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
per-layer readers are the files that ``BENCHMARK.json`` names.  Set-up
(process start, imports, CUDA, weights from the seed, the data-dependent
init, one warm-up unit of the cell's own shapes, nvcc on a first run) is
timed as ``setup_s``; then the window runs for ``--seconds`` (``--trace 0``:
the end-to-end metrics) or over the mix's stated number of whole units
under the device trace (``--trace 1``: the per-layer metrics).  After the
window the program's state is freed and the reference judges what the
window produced; the numbers it compared, each beside its limit, end
standard error and the result line, which is the last line of standard
output.  Exits non-zero, printing no result, without enough CUDA cards,
or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time


def _process_start() -> float:
    """Seconds since this process started (from /proc), so that set-up
    counts the interpreter's own start too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_start()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "rec_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``rec_tpu_torch`` is not ``rec_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


import torch  # noqa: E402  (after the clock starts: set-up counts it)


def fail(msg: str, code: int = 3) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", tweak=None,
             around=contextlib.nullcontext) -> dict:
    """One run of ``workload``; returns the result line.  ``tweak(cell)``
    may change the cell before it runs and ``around()`` wraps the program's
    set-up and window (the tests' small CPU cells, the precision control
    and the planted faults use them); the benchmark's own runs use
    neither."""
    from benchlib import devtrace, manifest, yardstick

    cell = manifest.load_cell(root, workload)
    if tweak is not None:
        cell = tweak(cell)
    driver = importlib.import_module(
        "benchlib." + cell.traffic["driver"]).Driver(cell, seed, device)
    cuda = device == "cuda"
    with around():
        driver.setup()
        for d in driver.devs if cuda else ():
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - T_START
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": cell.chips}
        breakdown = None
        driver.spans.records.clear()
        if trace:
            with devtrace.DeviceTrace(driver.devs) as tr:
                res = driver.traced(int(cell.traffic["trace_units"]))
            cards = sorted({d.index for d in driver.devs})
            window = tr.window_ns
            busy = devtrace.busy_by_device(tr.events, window, cards)
            window_s = (window[1] - window[0]) / 1e9
            ctx = {"events": tr.events, "window_ns": window,
                   "window_s": window_s, "busy_ns": busy,
                   "cards": len(cards), "spans": driver.spans,
                   "rates": yardstick.card_rates()}
            driver.layer_context(res, ctx)
            metrics = {}
            for m in cell.per_layer:
                value = manifest.layer_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info.update(busy_s=sum(busy.values()) / 1e9 / len(cards),
                               window_s=window_s)
            breakdown = {"device_ops": devtrace.top_ops(tr.events),
                         "idle_gaps": devtrace.idle_by_span(
                             tr.events, window, cards[0], driver.spans)}
        else:
            res = driver.window(seconds)
            values = dict(driver.end_to_end(res), setup_s=setup_s)
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        device_info["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(d) for d in driver.devs
        ) if cuda else 0
        driver.release()
    limits = cell.traffic["limits"]
    check = driver.check()
    numbers = check["numbers"]
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    line = {"correct": all(numbers[k] <= limits[k] for k in limits),
            "attempted": check["checked"], "failed": check["failed"],
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["units_in_window"] = res["units"]
    line.update(getattr(driver, "extra", dict)())
    line["checks"] = compared
    return line


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    # The port's build caches stay at fixed paths inside the checkout.
    build = os.path.join(root, "rec_tpu_torch", "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [BENCH_DIR, root]
    from benchlib import manifest

    chips = manifest.load_cell(root, args.workload).chips
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} visible")
    if not os.path.isdir(os.path.join(root, "rec_tpu_torch")):
        return fail("no rec_tpu_torch beside BENCHMARK.json")
    line = run_cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        return fail(f"JAX or the JAX package was loaded: {loaded}")
    for k, v in line["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"check correct = {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
