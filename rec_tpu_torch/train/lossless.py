"""Lossless (RVAE) training step (port of rec_tpu/train/lossless.py).

The free-bits KL floor (``lamb``), the linear beta anneal, the optional
target-bpp beta controller, the EMA update after the optimizer step and the
staircase learning rate, as ``rec_tpu``'s step has them.  The step runs on
the model's device: every metric stays a device tensor until the caller
reads it, so a step that is not logged never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from .state import Optimizer, TrainState, ema_update

LOG2 = 0.6931471805599453


@dataclasses.dataclass(frozen=True)
class LosslessTrainConfig:
    beta: float = 1.0
    lamb: float = 0.1              # free-bits per-channel floor (nats)
    anneal: bool = False
    annealing_end: int = 100_000
    ema_decay: float = 0.999
    target_bpp: Optional[float] = None
    adjust_beta_after_iters: int = 0


def objective(model, cfg: LosslessTrainConfig, state: TrainState,
              images: torch.Tensor, noise: torch.Tensor, num_pixels: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss -mean(log_lik) + beta * sum(max(kld_channelwise, lamb)),
    differentiable in the model's parameters, and the step's metrics
    (detached): nll, kl (the floored KL), true_kl, bpp, beta (annealed),
    elbo_bpd (over H*W*C), kl_per_block, expected_max_kl and the
    reconstruction."""
    out = model(images, noise)
    log_lik = torch.mean(out["log_likelihood"])
    kld = torch.sum(torch.clamp_min(out["kld_channelwise"], cfg.lamb))
    true_kl = torch.sum(out["kld_channelwise"])
    num_dims = images[0].numel()
    beta = state.beta
    if cfg.anneal:
        beta = beta * min(1.0, state.step / cfg.annealing_end)
    loss = -log_lik + beta * kld
    ana = out["analytic_kl"].detach()
    metrics = {k: v.detach() for k, v in {
        "loss": loss, "nll": -log_lik, "kl": kld, "true_kl": true_kl,
        "bpp": kld / (num_pixels * LOG2), "beta": beta,
        "elbo_bpd": (-log_lik + true_kl) / (num_dims * LOG2)}.items()}
    metrics["kl_per_block"] = torch.mean(ana, dim=1)
    metrics["expected_max_kl"] = torch.mean(torch.max(ana, dim=0).values)
    metrics["reconstruction"] = out["reconstruction"].detach()
    return loss, metrics


def make_train_step(model, cfg: LosslessTrainConfig, optimizer: Optimizer,
                    num_pixels: int) -> Callable:
    """Returns ``(state, images, noise) -> (state, metrics)``.  ``noise`` is
    the posterior noise (num_res_blocks, B, H/2, W/2, stochastic) on the
    images' device; the state's parameters (the model's), moments and EMA
    shadows change in place, and the returned state carries the new step
    and beta."""

    def step_fn(state: TrainState, images, noise):
        loss, metrics = objective(model, cfg, state, images, noise,
                                  num_pixels)
        names = list(state.params)
        grads = torch.autograd.grad(
            loss, [state.params[k] for k in names], allow_unused=True,
            materialize_grads=True)
        opt_state = optimizer.update(dict(zip(names, grads)),
                                     state.opt_state, state.params)
        ema_update(state.ema_params, state.params, cfg.ema_decay)
        beta = state.beta
        if (cfg.target_bpp is not None
                and state.step > cfg.adjust_beta_after_iters):
            # Multiplicative controller pushing the rate to target_bpp.
            bpp = metrics["bpp"]
            factor = torch.where(
                bpp > cfg.target_bpp + 1e-2, 1.001,
                torch.where(bpp < cfg.target_bpp - 1e-2, 1.0 / 1.001, 1.0))
            beta = beta * factor
        return state._replace(step=state.step + 1, opt_state=opt_state,
                              beta=beta), metrics

    return step_fn


def check_finite(metrics) -> None:
    """NaN blow-up guard: raises unless the loss is finite and the KL is
    not 0 (reads the device)."""
    loss = float(metrics["loss"])
    kl = float(metrics["kl"])
    if not math.isfinite(loss) or kl == 0.0:
        raise FloatingPointError(
            f"Loss blew up: loss={loss:.3f}, nll={float(metrics['nll']):.3f},"
            f" kl={kl:.3f}")
