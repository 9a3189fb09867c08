"""Run chosen phases of ``chip_smoke.py`` from two checkouts back to back on
one card, so that a change's phase times and counts sit beside its
parent's from the same machine and the same call.

    python -m rec_tpu_torch.utils.phase_ab --base <parent checkout> \\
        --phases train rejection_coder --out chiprun_out/phase_ab.jsonl

``--base`` is a checkout of the parent (``git archive`` unpacked into a
directory ``.gitignore`` lists); the other side is the checkout holding
this file.  The runs go base, head, head, base, each in a fresh process
whose working directory and ``sys.path[0]`` are its checkout, so each
imports its own ``rec_tpu_torch`` and ``chip_smoke``.  A phase gets the
card as ``dev`` where its signature asks for one.  Every JSON line a
phase prints is written to ``--out`` tagged with the run's side and
number, followed by the phase's wall seconds;
the same seconds are printed as one summary line at the end.  Needs a
card; a run that fails fails the command.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HEAD = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORDER = ("base", "head", "head", "base")
RUN_TIMEOUT_S = 900

# The child: imports the checkout's chip_smoke (its working directory is
# sys.path[0] under ``python -c``) and runs the phases in order.
_CHILD = """
import inspect, json, sys, time
import torch
import chip_smoke as cs
if not torch.cuda.is_available():
    raise SystemExit("phase_ab: no CUDA device available")
dev = torch.device("cuda")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
for name in sys.argv[1:]:
    fn = getattr(cs, "phase_" + name)
    args = [dev] if list(inspect.signature(fn).parameters)[:1] == ["dev"] \\
        else []
    t0 = time.perf_counter()
    fn(*args)
    print(json.dumps({"phase_ab_seconds": time.perf_counter() - t0,
                      "phase": name}), flush=True)
"""


def run_side(root: str, phases) -> list:
    """One run of ``phases`` in ``root``: the JSON lines its phases
    printed, in order."""
    proc = subprocess.run([sys.executable, "-c", _CHILD, *phases],
                          cwd=root, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"phase_ab: the run in {root} exited "
                         f"{proc.returncode}")
    lines = []
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            lines.append(obj)
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True,
                    help="checkout of the parent commit")
    ap.add_argument("--phases", nargs="+", required=True,
                    help="chip_smoke phase names, without 'phase_'")
    ap.add_argument("--out", default="chiprun_out/phase_ab.jsonl")
    args = ap.parse_args(argv)
    roots = {"base": os.path.abspath(args.base), "head": HEAD}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    seconds = {}
    with open(args.out, "w") as f:
        for n, side in enumerate(ORDER):
            for obj in run_side(roots[side], args.phases):
                f.write(json.dumps({"side": side, "run": n, **obj}) + "\n")
                if "phase_ab_seconds" in obj:
                    seconds.setdefault(f"{side}:{obj['phase']}", []).append(
                        obj["phase_ab_seconds"])
            f.flush()
    print(json.dumps({"phase_ab": seconds}), flush=True)
    return seconds


if __name__ == "__main__":
    main()
