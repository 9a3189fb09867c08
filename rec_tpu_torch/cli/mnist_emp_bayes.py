"""MNIST empirical-Bayes VAE training on the GPU (port of
examples/mnist_emp_bayes.py).

    python -m rec_tpu_torch.cli.mnist_emp_bayes --prior vamp --iters 5000

Trains a dense MNIST VAE (``models/mnist_vae.py``, 784-300-300-50) with
one of the priors gaussian, mog (a 50 x 100 mixture grid), vamp (500
inducing pseudo-images) or snis (K = 1024), by adam at a constant learning
rate on -ELBO, plus the soft max-KL term max(mean KL - max_kl, 0) when
``--max-kl`` is given.  A step whose loss is not finite is skipped (the
parameters and the optimizer keep their state); past 50 such steps the run
stops.  The data is ``binarized_mnist`` in [0, 1]: a local copy under
``data/`` when there is one, else the repo's deterministic synthetic
stand-in.  Fresh weights come from ``--seed`` and each step's posterior
noise (and the SNIS bound's K - 1 proposals) from one ``torch.Generator``
on the device seeded from it, not from JAX keys.  ``--device cpu`` trains
on the CPU; by default the run needs a GPU and raises without one.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from ..data.datasets import DatasetConfig, iterate_batches
from ..device import resolve_device
from ..models.mnist_vae import (MNISTMoGVAE, MNISTSNISVAE, MNISTVAE,
                                MNISTVampVAE, proposal_shape)
from ..train.state import Optimizer
from ..utils.logging import setup_logger

PRIORS = {"gaussian": MNISTVAE, "mog": MNISTMoGVAE, "vamp": MNISTVampVAE,
          "snis": MNISTSNISVAE}
MAX_NAN_STEPS = 50


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prior", choices=sorted(PRIORS), default="gaussian")
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--latents", type=int, default=50)
    ap.add_argument("--hidden", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-kl", type=float, default=None,
                    help="soft max-KL regularizer target (nats)")
    ap.add_argument("--log-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Trains and returns the run's numbers: steps, seconds, the rate
    without the first step, the final loss and the skipped steps."""
    args = parse_args(argv)
    log = setup_logger("mnist_emp_bayes")
    dev = resolve_device(args.device)
    model = PRIORS[args.prior](latents=args.latents,
                               hidden_size=args.hidden, seed=args.seed,
                               device=dev)
    batches = iterate_batches(
        DatasetConfig(dataset="binarized_mnist", normalize="unit"),
        args.batch)
    params = dict(model.named_parameters())
    tx = Optimizer("adam", lambda step: args.lr)
    opt_state = tx.init(params)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pshape = proposal_shape(model)

    nan_steps, loss_value, steps, first_s = 0, math.nan, 0, 0.0
    t0 = time.perf_counter()
    for i in range(args.iters):
        steps = i + 1
        x = torch.from_numpy(np.asarray(next(batches), np.float32)).to(dev)
        eps = torch.randn((x.shape[0], args.latents), generator=gen,
                          device=dev)
        proposals = (None if pshape is None
                     else torch.randn(pshape, generator=gen, device=dev))
        out = model(x, eps, proposals)
        kl = torch.mean(out["kl"])
        loss = -torch.mean(out["log_likelihood"] - out["kl"])
        if args.max_kl is not None:
            loss = loss + torch.clamp_min(kl - args.max_kl, 0.0)
        loss_value = float(loss.detach())
        if not math.isfinite(loss_value):
            nan_steps += 1
            if nan_steps > MAX_NAN_STEPS:
                log.error("too many NaN steps; aborting")
                break
            continue
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        opt_state = tx.update(dict(zip(params, grads)), opt_state, params)
        if i == 0:
            first_s = time.perf_counter() - t0
        if i % args.log_every == 0:
            log.info(f"step {i}: loss={loss_value:.2f} "
                     f"kl={float(kl.detach()):.2f}")
    seconds = time.perf_counter() - t0
    log.info(f"done: final loss={loss_value:.2f}, nan steps={nan_steps}")
    return {"prior": args.prior, "steps": steps, "seconds": seconds,
            "first_step_s": first_s,
            "steps_per_s": ((steps - 1) / (seconds - first_s)
                            if steps > 1 else math.nan),
            "final_loss": loss_value, "nan_steps": nan_steps}


if __name__ == "__main__":
    main(sys.argv[1:])
