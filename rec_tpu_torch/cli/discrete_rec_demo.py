"""Single-partition REC on synthetic Gaussians (port of
examples/discrete_rec_demo.py).

    python -m rec_tpu_torch.cli.discrete_rec_demo [--device cpu]

Prints what the example prints: an importance-sampling round trip of one
2-dim Gaussian (index <-> bit-exact sample), then beam-search REC of a
16-dim Gaussian pair at four KLs (``BeamSearchCoder`` at Omega = 3, B = 8,
extra samples 1.2 (S = 36), one block, budget 32): partitions, code bits
and the KL in bits, each round trip bit-exact.  On the card the sweep's
encodes launch the beam-search kernel (one block of D = 16 per launch),
on the CPU they take the scan path.  A decode that differs from its
encode raises.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from ..coding import BeamSearchCoder, GaussianParams, kl_divergence, rng
from ..coding.importance import (decode_gaussian_importance_sample,
                                 encode_gaussian_importance_sample)
from ..device import resolve_device

LOG2 = math.log(2.0)
SHIFTS = (0.3, 0.6, 1.0, 1.5)
SWEEP_CODER = BeamSearchCoder(kl_per_partition=3.0, n_beams=8,
                              extra_samples=1.2, block_size=None,
                              max_partitions=32)
SWEEP_DIM, SWEEP_SEED = 16, 1


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def single_partition_demo(dev) -> dict:
    print("=== single-partition importance REC ===")
    target = GaussianParams(torch.tensor([1.2, -0.4], device=dev),
                            torch.tensor([0.3, 0.5], device=dev))
    coder = GaussianParams(torch.zeros(2, device=dev),
                           torch.ones(2, device=dev))
    kl = float(torch.sum(kl_divergence(target, coder)))
    bits = max(math.ceil(kl / LOG2) + 2, 4)
    key = rng.root_key(0, dev)
    idx, sample = encode_gaussian_importance_sample(target, coder, key, bits)
    recon = decode_gaussian_importance_sample(coder, idx, key, bits)
    exact = _same_bits(sample, recon)
    print(f"  KL={kl:.2f} nats -> {bits} bits, index={int(idx)}, "
          f"bit-exact decode: {exact}")
    if not exact:
        raise AssertionError("importance decode differs from its encode")
    return {"kl": kl, "bits": bits, "index": int(idx),
            "sample": sample.cpu()}


def sweep_target(shift: float, dev) -> GaussianParams:
    return GaussianParams(torch.full((SWEEP_DIM,), shift, device=dev),
                          torch.full((SWEEP_DIM,), 0.7, device=dev))


def kl_sweep(dev) -> list:
    print("=== beam-search codelength vs KL ===")
    coder = GaussianParams(torch.zeros(SWEEP_DIM, device=dev),
                           torch.ones(SWEEP_DIM, device=dev))
    print(f"  {'KL (nats)':>10} {'partitions':>10} {'code bits':>10} "
          f"{'KL bits':>8}")
    rows = []
    for shift in SHIFTS:
        target = sweep_target(shift, dev)
        kl = float(torch.sum(kl_divergence(target, coder)))
        out = SWEEP_CODER.encode(target, coder, seed=SWEEP_SEED)
        decoded = SWEEP_CODER.decode(coder, out.indices, out.counts,
                                     seed=SWEEP_SEED)
        if not _same_bits(out.sample, decoded):
            raise AssertionError(f"shift {shift}: decode differs from its "
                                 "encode")
        bits = float(SWEEP_CODER.codelength_nats(out)) / LOG2
        count = int(out.counts[0])
        print(f"  {kl:10.2f} {count:10d} {bits:10.1f} {kl / LOG2:8.1f}")
        rows.append({"shift": shift, "kl": kl, "count": count,
                     "code_bits": bits, "indices": out.indices.cpu(),
                     "sample": out.sample.cpu()})
    return rows


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs both demos; returns their numbers (the sweep's indices and
    samples on the CPU)."""
    dev = resolve_device(parse_args(argv).device)
    return {"importance": single_partition_demo(dev),
            "sweep": kl_sweep(dev)}


if __name__ == "__main__":
    main(sys.argv[1:])
