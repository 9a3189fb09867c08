"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``rec_tpu_torch`` is not ``rec_tpu``), and
the reference loads nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

FORBIDDEN = {"jax", "jaxlib", "flax", "rec_tpu"}

RUN_SMALL = """
import sys, torch
sys.path[:0] = [{tests!r}, {bench!r}, {root!r}]
torch.set_num_threads(2)
import run
from conftest import tiny
for w in ("rvae24.serve_b8", "lossy2.kodak_b1", "rvae24.train_b8"):
    line = run.run_cell({root!r}, w, 5, 0.2, False, device="cpu", tweak=tiny)
    assert line["correct"], line
print(sorted(run.forbidden_modules()))
"""

REFERENCE = """
import sys
sys.path[:0] = [{bench!r}]
import reference.ac, reference.beam, reference.lossy, reference.rvae
import reference.train
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _run(code, root):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax(root):
    bench = os.path.join(root, "benchmark")
    code = RUN_SMALL.format(tests=os.path.join(bench, "tests"), bench=bench,
                            root=root)
    assert _run(code, root) == "[]"


def test_reference_loads_nothing_of_the_port(root):
    bench = os.path.join(root, "benchmark")
    loaded = set(eval(_run(REFERENCE.format(bench=bench), root)))
    assert not loaded & (FORBIDDEN | {"rec_tpu_torch"})


def test_sources_import_no_jax(root):
    bench = os.path.join(root, "benchmark")
    for base, _, files in os.walk(bench):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(base, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops = {node.module.split(".")[0]}
                else:
                    continue
                assert not tops & FORBIDDEN, (path, tops)
                if "reference" in path.split(os.sep):
                    assert "rec_tpu_torch" not in tops, path
