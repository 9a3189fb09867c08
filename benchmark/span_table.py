"""One traced run of a cell, with the program's spans broken down.

    python3 benchmark/span_table.py --workload <name> --seed <n>

from the root of a checkout, on the cell's cards.  Runs the cell as
``run.py --trace 1`` does and prints its result line, then one JSON line:
per span name of the traced window its count, host ms and self ms per unit
and the device kernels (copies left out) whose innermost span it is, per
unit; the set-up spans before the window in seconds; the program's
counters (``benchlib/program_trace.py: table``); and ``span_cost``, a span
timed in a loop of 100,000 with no profiler session (the recorder off) and
under a CUDA-only session (on), in microseconds a span.  A program without
the recorder gives an empty table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def span_cost(n: int = 100_000) -> dict:
    """Microseconds per ``with span(...)`` with the recorder off and on,
    and per iteration of the same loop around a shared no-op object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rec_tpu_torch.utils import profiling

    off = profiling.span("cost")

    def loop(make):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make():
                pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    out = {"empty_us": loop(lambda: off),
           "off_us": loop(lambda: profiling.span("cost", rows=1))}
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
        ProfilerActivity.CPU]
    with profile(activities=acts):
        out["on_us"] = loop(lambda: profiling.span("cost", rows=1))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    root = os.getcwd()
    build = os.path.join(root, "rec_tpu_torch", "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [BENCH_DIR, root]
    import run
    from benchlib import manifest, program_trace

    seen = {}
    layer_reader = manifest.layer_reader

    def keep_ctx(metric):
        read = layer_reader(metric)

        def reader(ctx):
            seen["ctx"] = ctx
            return read(ctx)

        return reader

    manifest.layer_reader = keep_ctx
    line = run.run_cell(root, args.workload, args.seed, 0.0, True)
    table = dict(program_trace.table(seen["ctx"]), workload=args.workload,
                 seed=args.seed, span_cost=span_cost())
    print(json.dumps(line), json.dumps(table), sep="\n", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
