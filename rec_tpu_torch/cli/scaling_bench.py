"""Scaling of the port's data-parallel paths over devices and processes
(port of examples/lossless/scaling_bench.py).

    python -m rec_tpu_torch.cli.scaling_bench mode=serve|codec|hlo|all \
        size=flagship|tiny device=cuda|cpu output_dir=results/torch_scaling

Each mode prints one JSON line and ``output_dir/scaling.json`` keeps the
newest line of each.  ``size=flagship`` is RVAE-24 at 160/32 with the paper
coder (B = 20, S = 36, budget 24, block 1000); ``size=tiny`` is rec_tpu's
tiny config (``TINY``).  ``device=cpu`` runs everything on the CPU with
``[cpu] * k`` meshes, whose shards take turns on the same cores: its rates
say nothing of a card.

- ``mode=serve``: ``cli.serve`` on the same ``num_images`` global images
  (32 by default, batches of ``batch_size`` = 8; no verify, no residual;
  the first batch left out of each rate) as 1 process x 1 device (the
  base), then for
  each k (2, and 4 where four cards are visible; 2 on the CPU) as 1
  process x k devices (``n_devices=k``) and as k processes x 1 device
  (Gloo, one card each).  Each run is its own processes, the kernels built
  before.  Reports each run's images/s (summed over its processes), its
  images/s per device, its scaling efficiency (rate / (k x the base
  rate)), and whether the two k-device runs wrote the same file bytes:
  they give each device the same rows at the same per-device batch.
- ``mode=codec``: ``parallel.sharded_encode_blocks`` on one latent of 72
  blocks (the flagship's serving batch) over a 1-entry mesh and over every
  visible card (``[cpu] * 2`` on the CPU): wall ms per encode, their
  ratio, each card's beam-search launches per encode, and whether the two
  encodes are bitwise equal.
- ``mode=hlo``: rec_tpu compiles the sharded programs and counts the
  collectives in their HLO.  PyTorch runs no such program, so the port
  answers the same question from a ``utils.profiling.device_trace`` of one
  sharded serving batch (``make_batch_compress`` over every visible card):
  it counts the NCCL kernels and the copies between cards ("Memcpy PtoP")
  among the trace's events (``events``: all of them but the program's
  spans, ``record_function`` ranges).  Only the outputs' copy to the host
  may move data off a card, so the count must be 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..coding import BeamSearchCoder, GaussianParams
from ..device import resolve_device
from ..models.resnet_vae import BidirectionalResNetVAE, ResNetVAEConfig
from ..parallel import (Mesh, make_batch_compress, make_mesh,
                        sharded_encode_blocks)
from ..utils.config import apply_overrides
from ..utils import profiling
from ..utils.profiling import device_fence, device_trace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# rec_tpu's tiny serving config (examples/lossless/scaling_bench.py:48-52).
TINY = dict(num_res_blocks=4, deterministic_filters=16, stochastic_filters=8,
            n_beams=8, extra_samples=1.2, block_size=250, max_partitions=12)
FLAGSHIP = dict(num_res_blocks=24, deterministic_filters=160,
                stochastic_filters=32, n_beams=20, extra_samples=1.2,
                block_size=1000, max_partitions=24)
SERVE_ARGS = ["codec=rans", "verify=false", "true_lossless=false"]
# Trace events that move data between devices: NCCL's kernels and
# peer-to-peer copies between cards.
COLLECTIVE = re.compile(r"nccl|PtoP", re.IGNORECASE)
CODEC_REPS = 5


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "all"             # serve | codec | hlo | all
    size: str = "flagship"        # flagship | tiny
    device: str = "cuda"
    output_dir: str = "results/torch_scaling"
    num_images: int = 32          # mode=serve's global images
    batch_size: int = 8


def _size(cfg: Config) -> dict:
    if cfg.size not in ("flagship", "tiny"):
        raise ValueError(f"size is flagship or tiny, got {cfg.size!r}")
    return FLAGSHIP if cfg.size == "flagship" else TINY


def _device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    return {"device": "cpu", "count": 1}


def _serve_args(cfg: Config, out_dir: str) -> list:
    s = _size(cfg)
    return [f"model_cfg.num_res_blocks={s['num_res_blocks']}",
            f"model_cfg.deterministic_filters={s['deterministic_filters']}",
            f"model_cfg.stochastic_filters={s['stochastic_filters']}",
            f"n_beams={s['n_beams']}", f"extra_samples={s['extra_samples']}",
            f"block_size={s['block_size']}",
            f"max_partitions={s['max_partitions']}", *SERVE_ARGS,
            f"num_images={cfg.num_images}", f"batch_size={cfg.batch_size}",
            f"dataset.synthetic_size={cfg.num_images}",
            f"device={cfg.device}", f"output_dir={out_dir}",
            f"model_save_dir={out_dir}/ckpt"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_serve(cfg: Config, processes: int, devices: int, out_dir: str
               ) -> dict:
    """``cli.serve`` as ``processes`` coordinated processes of ``devices``
    devices each; their summed images/s and image count."""
    args = [sys.executable, "-m", "rec_tpu_torch.cli.serve",
            *_serve_args(cfg, out_dir), f"n_devices={devices}"]
    if processes > 1:
        args[-1] = f"n_devices={processes}"
        args += [f"coordinator=localhost:{_free_port()}",
                 f"num_processes={processes}"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    if cfg.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        args + ([f"process_id={i}"] if processes > 1 else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for i in range(processes)]
    try:
        outs = [p.communicate(timeout=1800)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall_s = time.perf_counter() - t0
    images, rate = 0, 0.0
    for p, out in zip(procs, outs):
        m = re.search(r"served (\d+) images at ([\d.]+|nan) images/sec", out)
        if p.returncode != 0 or m is None:
            raise RuntimeError(f"serve ({processes} x {devices}) failed:\n"
                               f"{out[-3000:]}")
        images += int(m.group(1))
        rate += float(m.group(2))
    return {"images": images, "images_per_s": rate,
            "images_per_s_per_device": rate / (processes * devices),
            "wall_s": wall_s}


def _files(out_dir: str) -> dict:
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir)) if f.endswith(".rec")}


def mode_serve(cfg: Config) -> dict:
    dev = resolve_device(cfg.device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.build_all([*_build.CODER, "beam_score"])
        ks = [k for k in (2, 4) if k <= torch.cuda.device_count()]
    else:
        ks = [2]
    root = os.path.join(cfg.output_dir, "serve")
    runs = {"1x1": _run_serve(cfg, 1, 1, f"{root}/1x1")}
    base = runs["1x1"]["images_per_s"]
    identical = True
    for k in ks:
        for processes, devices in ((1, k), (k, 1)):
            name = f"{processes}x{devices}"
            runs[name] = _run_serve(cfg, processes, devices,
                                    f"{root}/{name}")
            runs[name]["efficiency"] = runs[name]["images_per_s"] / (k * base)
        identical &= _files(f"{root}/1x{k}") == _files(f"{root}/{k}x1")
    return {"mode": "serve", "size": cfg.size, "ks": ks, "runs": runs,
            "files_identical": identical, **_device_info(dev)}


def _codec_latent(dev, size: dict, blocks: int = 72):
    """One latent of ``blocks`` coder blocks: a target around a standard
    normal coder (~0.04 nats per dim), from numpy seed 0."""
    rs = np.random.RandomState(0)
    shape = (blocks, size["block_size"])
    loc = (rs.randn(*shape) * 0.25).astype(np.float32)
    scale = np.exp(rs.randn(*shape) * 0.1).astype(np.float32)
    return (GaussianParams(torch.tensor(loc, device=dev),
                           torch.tensor(scale, device=dev)),
            GaussianParams(torch.zeros(shape, device=dev),
                           torch.ones(shape, device=dev)))


def _cpu_or_cards(dev: torch.device) -> Mesh:
    return make_mesh() if dev.type == "cuda" else make_mesh(2, "cpu")


def mode_codec(cfg: Config) -> dict:
    dev = resolve_device(cfg.device)
    size = _size(cfg)
    coder = BeamSearchCoder(n_beams=size["n_beams"],
                            extra_samples=size["extra_samples"],
                            block_size=size["block_size"],
                            max_partitions=size["max_partitions"])
    home = torch.device("cuda", 0) if dev.type == "cuda" else dev
    t, c = _codec_latent(home, size)
    meshes = {"one": Mesh([home]), "all": _cpu_or_cards(dev)}
    out = {}
    for name, mesh in meshes.items():
        coded = sharded_encode_blocks(coder, t, c, 7, mesh)   # warm-up
        device_fence(coded)
        before = profiling.counter("mega_beam.launches")
        t0 = time.perf_counter()
        for _ in range(CODEC_REPS):
            coded = sharded_encode_blocks(coder, t, c, 7, mesh)
            device_fence(coded)
        ms = (time.perf_counter() - t0) / CODEC_REPS * 1e3
        out[name] = {"mesh": [str(d) for d in mesh], "wall_ms": ms,
                     "launches_per_encode_by_device": {
                         k: v / CODEC_REPS for k, v in profiling.counter(
                             "mega_beam.launches", since=before).items()},
                     "coded": coded}
    a, b = out["one"].pop("coded"), out["all"].pop("coded")
    equal = (torch.equal(a.indices, b.indices)
             and torch.equal(a.counts, b.counts)
             and torch.equal(a.sample.view(torch.int32),
                             b.sample.view(torch.int32)))
    return {"mode": "codec", "size": cfg.size, "blocks": int(a.counts.numel()),
            **out, "wall_ratio_all_vs_one":
                out["all"]["wall_ms"] / out["one"]["wall_ms"],
            "bitwise_equal": equal, **_device_info(dev)}


def mode_hlo(cfg: Config) -> dict:
    dev = resolve_device(cfg.device)
    size = _size(cfg)
    mesh = _cpu_or_cards(dev)
    mc = ResNetVAEConfig(num_res_blocks=size["num_res_blocks"],
                         deterministic_filters=size["deterministic_filters"],
                         stochastic_filters=size["stochastic_filters"])
    coder = BeamSearchCoder(n_beams=size["n_beams"],
                            extra_samples=size["extra_samples"],
                            block_size=size["block_size"],
                            max_partitions=size["max_partitions"])
    rs = np.random.RandomState(0)
    images = ((rs.randint(0, 256, (8, 32, 32, 3)) + 0.5) / 256.0
              - 0.5).astype(np.float32)
    model = BidirectionalResNetVAE(mc, coder, seed=0, device=mesh[0])
    model.requires_grad_(False)
    model.data_dependent_init(
        torch.as_tensor(images[:1], device=mesh[0]),
        rs.randn(mc.num_res_blocks, 1, 16, 16,
                 mc.stochastic_filters).astype(np.float32))
    compress = make_batch_compress(model, mesh)
    seeds = 42 + 101 * np.arange(len(images))
    compress(images, seeds)   # warm-up
    with device_trace(os.path.join(cfg.output_dir, "hlo_trace")) as prof:
        compress(images, seeds)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if not profiling.is_annotation(e)]
    moves = sorted({n for n in names if COLLECTIVE.search(n)})
    return {"mode": "hlo", "size": cfg.size, "mesh": [str(d) for d in mesh],
            "program": "sharded batch compress, 8 images",
            "events": len(names),
            "collectives": sum(bool(COLLECTIVE.search(n)) for n in names),
            "collective_names": moves, **_device_info(dev)}


MODES = {"serve": mode_serve, "codec": mode_codec, "hlo": mode_hlo}


def main(argv) -> list:
    cfg = apply_overrides(Config(), argv)
    modes = list(MODES) if cfg.mode == "all" else [cfg.mode]
    if any(m not in MODES for m in modes):
        raise ValueError(f"mode is one of {sorted(MODES)} or all, got "
                         f"{cfg.mode!r}")
    os.makedirs(cfg.output_dir, exist_ok=True)
    path = os.path.join(cfg.output_dir, "scaling.json")
    saved = {}
    if os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
    lines = []
    for mode in modes:
        line = MODES[mode](cfg)
        print(json.dumps(line), flush=True)
        lines.append(line)
        saved[mode] = line
    with open(path, "w") as f:
        json.dump(saved, f, indent=2)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
