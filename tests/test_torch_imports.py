"""rec_tpu_torch and chip_smoke.py import no JAX, no flax and nothing of
rec_tpu (an AST scan of every module, including imports inside
functions)."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rec_tpu")


def _sources():
    pkg = ROOT / "rec_tpu_torch"
    # build/ holds generated artifacts (gitignored), not package modules.
    files = sorted(p for p in pkg.rglob("*.py")
                   if "build" not in p.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_sources_exist():
    names = {p.name for p in _sources()}
    assert {"mega_beam.py", "resnet_vae.py", "chip_smoke.py",
            "rejection.py", "rejection_coder.py", "sample_generator.py",
            "mnist_vae.py", "mnist_convert.py", "mnist_emp_bayes.py",
            "pixel_cnn.py", "pixel_cnn_convert.py", "discrete_rec_demo.py",
            "snis_mog.py", "astar_sampling_demo.py"} <= names
    assert (ROOT / "rec_tpu_torch" / "csrc" / "mega_beam.cu").exists()


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_rec_tpu_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("module", ["rec_tpu_torch.ops",
                                    "rec_tpu_torch.coding.gauss"])
def test_imports_first_in_a_fresh_interpreter(module):
    """Either end of the ops -> coding edge imports first on its own
    (chip_smoke.py imports rec_tpu_torch.ops first; coding.gauss reads
    ops.threefry_normal's sqrt)."""
    proc = subprocess.run([sys.executable, "-c", f"import {module}"],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
