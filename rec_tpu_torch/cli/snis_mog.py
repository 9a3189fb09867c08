"""SNIS mixture-of-Gaussians toy (port of examples/snis_mog.py).

    python -m rec_tpu_torch.cli.snis_mog --iters 2000 --out results/snis_mog

Trains a self-normalised importance-sampling distribution
(``models/mnist_vae.py::SNISDistribution``: a standard-normal proposal
tilted by a 2-100-100-1 tanh energy network, K = 128) by adam on samples of
a 3x3 mixture of Gaussians, writes its unnormalised log density on a 100 x
100 grid over [-2, 2]^2 (``density.npy``, and ``density.png`` where
matplotlib is installed), then codes one sample of the learned
distribution with importance-sampling REC: 2^10 standard-normal proposals
from the root key of 7, scored by the energy network
(``log_weighting_fn``), decoded from the index alone, bit-exact or it
raises.

Fresh weights come from ``--seed`` (``nn.Linear``'s initialisation), and
the MoG batches and the bound's K - 1 proposals per step from one
``torch.Generator`` on the device seeded from it, not from JAX keys; the
coder's proposals are ``rec_tpu``'s streams.  ``--device cpu`` runs on the
CPU; by default the run needs a GPU and raises without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..coding import GaussianParams, rng
from ..coding.importance import (decode_gaussian_importance_sample,
                                 encode_gaussian_importance_sample)
from ..device import resolve_device
from ..models.mnist_vae import SNISDistribution
from ..train.state import Optimizer
from ..utils.logging import setup_logger

COMPONENT_MEANS = np.array(
    [[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 0], [0, 1],
     [1, -1], [1, 0], [1, 1]], np.float32)
COMPONENT_STD = 0.1
GRID = 100
CODING_BITS, CODING_SEED = 10, 7


def sample_mog(gen: torch.Generator, n: int) -> torch.Tensor:
    """n points of the 3x3 MoG (components uniform, std 0.1), on the
    generator's device."""
    dev = gen.device
    comp = torch.randint(0, len(COMPONENT_MEANS), (n,), generator=gen,
                         device=dev)
    eps = torch.randn((n, 2), generator=gen, device=dev)
    return torch.from_numpy(COMPONENT_MEANS).to(dev)[comp] \
        + COMPONENT_STD * eps


def draws(gen: torch.Generator, batch: int, K: int):
    """Each step's (MoG batch, K - 1 bound proposals), endlessly."""
    while True:
        x = sample_mog(gen, batch)
        yield x, torch.randn((K - 1, 2), generator=gen, device=gen.device)


def train(model: SNISDistribution, steps, iters: int, lr: float,
          log=None, log_every: int = 200) -> torch.Tensor:
    """``iters`` adam steps on -mean(log-density bound) of ``steps``'
    (batch, proposals); returns the losses (iters,) on the device, read
    back only every ``log_every`` steps for the log."""
    params = dict(model.named_parameters())
    tx = Optimizer("adam", lambda step: lr)
    state = tx.init(params)
    losses = []
    for i, (x, proposals) in zip(range(iters), steps):
        loss = -torch.mean(model(x, proposals))
        grads = torch.autograd.grad(loss, list(params.values()))
        state = tx.update(dict(zip(params, grads)), state, params)
        losses.append(loss.detach())
        if log is not None and i % log_every == 0:
            log.info(f"step {i}: nll={float(losses[-1]):.3f}")
    return torch.stack(losses)


@torch.no_grad()
def density_grid(model: SNISDistribution) -> np.ndarray:
    """Unnormalised log density (prior + energy) on the 100 x 100 grid."""
    dev = model.energy_0.weight.device
    g = np.linspace(-2, 2, GRID)
    xx, yy = np.meshgrid(g, g)
    points = torch.tensor(np.stack([xx.ravel(), yy.ravel()], -1),
                          dtype=torch.float32, device=dev)
    prior_lp = torch.sum(-0.5 * points ** 2 - 0.9189385, dim=1,
                         keepdim=True)
    return (prior_lp + model.energy(points)).cpu().numpy().reshape(GRID,
                                                                   GRID)


@torch.no_grad()
def code_sample(model: SNISDistribution) -> dict:
    """One sample of the learned distribution through importance REC:
    the index, the encoder's sample and the decode of the index."""
    dev = model.energy_0.weight.device
    proposal = GaussianParams(torch.zeros(2, device=dev),
                              torch.ones(2, device=dev))
    key = rng.root_key(CODING_SEED, dev)
    idx, sample = encode_gaussian_importance_sample(
        proposal, proposal, key, coding_bits=CODING_BITS,
        log_weighting_fn=lambda eps: model.energy(eps)[..., 0])
    recon = decode_gaussian_importance_sample(proposal, idx, key,
                                              coding_bits=CODING_BITS)
    return {"index": int(idx), "sample": sample.cpu(),
            "decoded": recon.cpu(),
            "exact": torch.equal(sample.view(torch.int32),
                                 recon.view(torch.int32))}


def _save_png(grid: np.ndarray, path: str) -> None:
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imshow(np.exp(grid - grid.max()), extent=[-2, 2, -2, 2],
               origin="lower")
    plt.title("SNIS learned density")
    plt.savefig(path, dpi=120)
    plt.close()


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=100)
    ap.add_argument("--K", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", type=str, default="results/snis_mog")
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Trains, writes the grid, codes one sample; returns the run's
    numbers."""
    args = parse_args(argv)
    log = setup_logger("snis_mog")
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    model = SNISDistribution(
        2, K=args.K, hidden=args.hidden,
        generator=torch.Generator().manual_seed(args.seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    losses = train(model, draws(gen, args.batch, args.K), args.iters,
                   args.lr, log, args.log_every).cpu().numpy()
    seconds = time.perf_counter() - t0

    grid = density_grid(model)
    np.save(os.path.join(args.out, "density.npy"), grid)
    _save_png(grid, os.path.join(args.out, "density.png"))
    log.info(f"final nll={losses[-1]:.3f}; wrote {args.out}/density.npy")

    coded = code_sample(model)
    log.info(f"SNIS-REC: coded sample {coded['sample'].numpy().round(3)} "
             f"with {CODING_BITS} bits (index {coded['index']}), "
             f"bit-exact decode: {coded['exact']}")
    if not coded["exact"]:
        raise AssertionError("SNIS-REC decode differs from its encode")
    return {"steps": len(losses), "seconds": seconds,
            "steps_per_s": len(losses) / seconds, "losses": losses,
            "final_nll": float(losses[-1]), "density": grid, **coded}


if __name__ == "__main__":
    main(sys.argv[1:])
