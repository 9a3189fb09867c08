"""Where the beam-search kernel's time goes, phase by phase, on one GPU.

    python3 tools/mega_beam_phases.py

Builds a copy of ``rec_tpu_torch/csrc/mega_beam.cu`` that stamps the
card's ``%globaltimer`` around every ``grid.sync()``: the latest arrival of
any CTA (the end of the phase's work) and the release seen by CTA 0.  It
runs that copy at chip_smoke.py's single-image (N=9) and serving (N=72)
inputs, fmix stream, and prints one JSON line per N: the kernel's time,
the traced copy's time, and for each step phase (score, select, carry) its
mean work and barrier time in microseconds.  Kernel time alone cannot say
which phase moved; this can.  The copy and its library go to the gitignored
``rec_tpu_torch/build/``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rec_tpu_torch.ops import _build, mega_beam  # noqa: E402

SLOTS = 8192
TRACE = """
__device__ unsigned long long g_trace[%d];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE_SYNC() {                                                  \\
  __syncthreads();                                                      \\
  if (threadIdx.x == 0) atomicMax(&g_trace[2 * tk], gtime());           \\
  grid.sync();                                                          \\
  if (blockIdx.x == 0 && threadIdx.x == 0) g_trace[2 * tk + 1] = gtime(); \\
  ++tk;                                                                 \\
}
""" % SLOTS
TRACE_API = """
extern "C" int trace_get(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
extern "C" int trace_reset() {
  static unsigned long long z[%d];
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
""" % SLOTS


def traced_source() -> str:
    with open(os.path.join(_build.CSRC, "mega_beam.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", "namespace {\n" + TRACE, 1)
    start = "cg::grid_group grid = cg::this_grid();"
    src = src.replace(start, start + " int tk = 0; if (blockIdx.x == 0 && "
                      "threadIdx.x == 0) g_trace[%d] = gtime();" % (SLOTS - 1))
    head, body = src.split("mega_beam_kernel(Args a)", 1)
    return (head + "mega_beam_kernel(Args a)"
            + body.replace("grid.sync();", "TRACE_SYNC();") + TRACE_API)


def build() -> tuple:
    os.makedirs(_build.BUILD, exist_ok=True)
    src = os.path.join(_build.BUILD, "phases_mega_beam.cu")
    lib = os.path.join(_build.BUILD, "libphases_mega_beam.so")
    with open(src, "w") as f:
        f.write(traced_source())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           "-I", _build.CSRC, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on the traced copy:\n{proc.stderr}")
    return lib, _build.parse_ptxas(proc.stdout + proc.stderr)


def phases(lib, inputs) -> dict:
    """Run the traced library once on ``inputs`` and read its stamps."""
    n, bkeys, qa, qb, ascale = inputs
    real = mega_beam._load_kernel
    mega_beam._load_kernel = lambda: lib
    mega_beam.grid.cache_clear()   # the copy's own occupancy
    try:
        ctas, _ = mega_beam.grid(torch.cuda.current_device(), "fmix")
        run = lambda: mega_beam.launch_kernel(  # noqa: E731
            n, bkeys, qa, qb, ascale, n_beams=20, n_samples=36,
            stream="fmix")
        traced_ms = chip_smoke.cuda_time(run, 5)
        lib.trace_reset()
        run()
        torch.cuda.synchronize()
    finally:
        mega_beam._load_kernel = real
        mega_beam.grid.cache_clear()
    buf = (ctypes.c_ulonglong * SLOTS)()
    lib.trace_get(buf)
    tr = np.array(buf[:], dtype=np.float64)
    n_sync = int(np.sum(tr[1:SLOTS - 1:2] > 0))
    arrive, release = tr[0:2 * n_sync:2], tr[1:2 * n_sync:2]
    work = (arrive - np.concatenate([[tr[SLOTS - 1]], release[:-1]])) / 1e3
    wait = (release - arrive) / 1e3
    steps_work = work[1:].reshape(-1, 3).mean(axis=0)
    steps_wait = wait[1:].reshape(-1, 3).mean(axis=0)
    out = {"traced_ms": traced_ms, "ctas": ctas, "barriers": n_sync,
           "steps": (n_sync - 1) // 3}
    for i, name in enumerate(("score", "select", "carry")):
        out[f"{name}_us"] = float(steps_work[i])
        out[f"{name}_barrier_us"] = float(steps_wait[i])
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mega_beam_phases: no CUDA device available", file=sys.stderr)
        return 1
    if argv:
        raise SystemExit("usage: python3 tools/mega_beam_phases.py")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    path, ptxas = build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mega_beam_launch.restype = i
    lib.mega_beam_launch.argtypes = [p] * 14 + [i] * 7 + [p]
    lib.mega_beam_occupancy.restype = i
    lib.mega_beam_occupancy.argtypes = [i] + [
        ctypes.POINTER(ctypes.c_int)] * 5
    for copies, seed in ((1, 5), (8, 6)):
        t, c, bkeys = chip_smoke._blocks(dev, n_copies=copies, seed=seed)
        n, qa, qb, ascale = mega_beam.precompute(t, c, 3.0, 24)
        ms = chip_smoke.cuda_time(lambda: mega_beam.launch_kernel(
            n, bkeys, qa, qb, ascale, n_beams=20, n_samples=36,
            stream="fmix"), 10)
        row = phases(lib, (n, bkeys, qa, qb, ascale))
        print(json.dumps({"blocks": 9 * copies, "kernel_ms": ms, **row,
                          "ptxas": [{k: v for k, v in r.items()
                                     if k != "function"} for r in ptxas],
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
