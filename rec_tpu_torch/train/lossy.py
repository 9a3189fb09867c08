"""Lossy VAE training step: loss = beta * distortion + bpp (port of
rec_tpu/train/lossy.py).

Distortions: mse, mae, ms-ssim, mae-ms-ssim and discretized_logistic, each
a per-element mean with the reference's x255 rescaling.  The step runs on
the model's device and keeps its metrics there until the caller reads
them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..models.likelihoods import discretized_logistic as _dlogistic
from ..utils.metrics import ms_ssim
from .state import Optimizer, TrainState, ema_update

LOG2 = 0.6931471805599453


def get_distortion(name: str) -> Callable:
    """(images, reconstruction) -> the scalar distortion ``name``; both
    NHWC in [0, 1]."""

    def mse(x, y):
        return torch.mean(torch.square(x - y)) * 255.0 ** 2

    def mae(x, y):
        return torch.mean(torch.abs(x - y)) * 255.0

    def neg_msssim(x, y):
        return torch.mean(1.0 - ms_ssim(x, y, max_val=1.0)) * 255.0

    def mae_msssim(x, y):
        alpha = 0.84
        return alpha * neg_msssim(x, y) + (1 - alpha) * mae(x, y)

    def discretized_logistic(x, y):
        return -torch.mean(_dlogistic(x - 0.5, y - 0.5, scale=1.0 / 255.0))

    table = {"mse": mse, "mae": mae, "ms-ssim": neg_msssim,
             "mae-ms-ssim": mae_msssim,
             "discretized_logistic": discretized_logistic}
    if name not in table:
        raise ValueError(f"unknown distortion {name!r}; one of "
                         f"{sorted(table)}")
    return table[name]


@dataclasses.dataclass(frozen=True)
class LossyTrainConfig:
    beta: float = 0.01
    distortion: str = "mse"
    ema_decay: float = 0.999


def objective(model, distortion_fn: Callable, state: TrainState,
              images: torch.Tensor, noise, num_pixels: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss ``state.beta * distortion + sum(kls) / (num_pixels ln 2)``,
    differentiable in the model's parameters, and the detached metrics
    loss, distortion and bpp."""
    out = model(images, noise)
    distortion = distortion_fn(images, out["reconstruction"])
    rate_bpp = sum(out["kls"]) / (num_pixels * LOG2)
    loss = state.beta * distortion + rate_bpp
    return loss, {"loss": loss.detach(), "distortion": distortion.detach(),
                  "bpp": rate_bpp.detach()}


def make_train_step(model, cfg: LossyTrainConfig, optimizer: Optimizer,
                    num_pixels: int) -> Callable:
    """Returns ``(state, images, noise) -> (state, metrics)``.  ``noise`` is
    the posterior noise, one standard-normal tensor per latent level in
    coding order on the images' device; the state's parameters (the
    model's), moments and EMA shadows change in place, and the returned
    state carries step + 1."""
    distortion_fn = get_distortion(cfg.distortion)

    def step_fn(state: TrainState, images, noise):
        loss, metrics = objective(model, distortion_fn, state, images, noise,
                                  num_pixels)
        names = list(state.params)
        grads = torch.autograd.grad(
            loss, [state.params[k] for k in names], allow_unused=True,
            materialize_grads=True)
        opt_state = optimizer.update(dict(zip(names, grads)),
                                     state.opt_state, state.params)
        ema_update(state.ema_params, state.params, cfg.ema_decay)
        return state._replace(step=state.step + 1,
                              opt_state=opt_state), metrics

    return step_fn
