"""One build path for the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own ``build/lib<name>.so`` (gitignored), which the
kernel's wrapper loads with ctypes.  A library newer than its source and
than every shared header (``csrc/*.cuh``) is reused.  A failed build
raises: the port has no fallback for a CUDA tensor.
``ptxas``'s resource report (registers, shared memory, spills per kernel)
is kept beside each library as ``build/lib<name>.ptxas.txt``.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
# The coder's kernels: an encode launches both, so a first run builds them
# in one parallel call (``build_all(CODER)``) from whichever loads first.
CODER = ("mega_beam", "replay")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def library_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def report_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.ptxas.txt")


def parse_ptxas(text: str) -> list:
    """Per kernel entry of ``ptxas -v``'s report: its mangled name,
    registers, static shared memory and spill bytes."""
    kernels = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernels.append({"function": m.group(1), "registers": None,
                            "smem_bytes": 0, "spill_stores": 0,
                            "spill_loads": 0})
            continue
        if not kernels:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            kernels[-1]["spill_stores"] = int(m.group(1))
            kernels[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            kernels[-1]["smem_bytes"] = int(m.group(1)) if m else 0
    return kernels


def ptxas_report(name: str) -> list:
    """The parsed ``ptxas -v`` report of the last build of ``name``."""
    with open(report_path(name)) as f:
        return parse_ptxas(f.read())


def _stale(name: str) -> bool:
    """Whether ``name``'s library is missing or older than its source or
    any shared header (``csrc/*.cuh``, which a source may include)."""
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu"),
            *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in deps)


def build_all(names) -> dict:
    """Build several kernels at once, one ``nvcc`` process per source, all
    started together; a library that is not stale (``_stale``) is kept.
    Returns {name: library path}; raises, after every build has ended, if
    any failed."""
    os.makedirs(BUILD, exist_ok=True)
    jobs = {}
    for name in names:
        if not _stale(name):
            continue
        src = os.path.join(CSRC, f"{name}.cu")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        jobs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode == 0:
            with open(report_path(name), "w") as f:
                f.write(out + err)
            os.replace(tmp, library_path(name))
        else:
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                          f"{out}\n{err}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def build_kernel(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so`` unless the
    library is up to date.  Returns the library path."""
    return build_all([name])[name]
