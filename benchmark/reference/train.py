"""The RVAE's training step in plain PyTorch: the lossless objective
(-mean log-likelihood under the discretized logistic + beta times the
free-bits-floored per-channel KL), its gradients by autograd, optax's
adamax (b1 0.9, b2 0.999, eps 1e-8) and the EMA of the weights, written
from the formulas one tensor at a time."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import rvae
from .gauss import kl_divergence

B1, B2, EPS = 0.9, 0.999, 1e-8


def discretized_logistic(x, mean, scale, binsize: float = 1.0 / 256.0):
    """Per-image log P(x in its 1/256 bin) under Logistic(mean, scale)."""
    lo = (torch.floor(x / binsize) * binsize - mean) / scale
    p = torch.sigmoid(lo + binsize / scale) - torch.sigmoid(lo)
    return torch.sum(torch.log(p + 1e-7), dim=(-3, -2, -1))


def loss(p: rvae.Params, n_blocks: int, images, noise, lamb: float,
         beta: float = 1.0) -> torch.Tensor:
    """images (B, H, W, C) in [-0.5, 0.5]; noise (n_blocks, B, h, w, c)."""
    B, H, W, _ = images.shape
    stats = rvae.infer(p, n_blocks, rvae.nchw(images))
    t = rvae.base(p, B, H, W)
    kl_ch = []
    for g in range(n_blocks):
        h = F.elu(t)
        pr = rvae.prior(p, g, h)
        post = rvae.posterior(p, g, h, stats[g])
        z = post.loc + post.scale * rvae.nchw(noise[g])
        kl = kl_divergence(post, pr)
        kl_ch.append(torch.mean(torch.sum(kl, dim=(2, 3)), dim=0))
        t = rvae.residual(p, g, t, h, z)
    recon = rvae.nhwc(rvae.reconstruct(p, t))
    ll = discretized_logistic(images, recon,
                              torch.exp(p["likelihood_log_scale"]))
    kld = torch.sum(torch.clamp_min(torch.stack(kl_ch), lamb))
    return -torch.mean(ll) + beta * kld


class Adamax:
    """optax.adamax(lr): mu, nu per weight; one step per ``update``.  A
    state taken from elsewhere starts from its ``mu``, ``nu`` and
    ``count``."""

    def __init__(self, params: rvae.Params, lr: float, mu=None, nu=None,
                 count: int = 0):
        self.lr = lr
        self.count = count
        self.mu = mu or {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = nu or {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: rvae.Params, grads: Dict[str, torch.Tensor]):
        self.count += 1
        for k, g in grads.items():
            self.mu[k] = B1 * self.mu[k] + (1.0 - B1) * g
            self.nu[k] = torch.maximum(B2 * self.nu[k], torch.abs(g) + EPS)
            step = (self.mu[k] / (1.0 - B1 ** self.count)) / self.nu[k]
            params[k] -= self.lr * step


def step(p: rvae.Params, ema: rvae.Params, opt: Adamax, n_blocks: int,
         images, noise, lamb: float, ema_decay: float) -> tuple:
    """One training step on ``p``, ``ema`` and ``opt`` in place; returns
    the loss and the gradients."""
    names = list(p)
    for v in p.values():
        v.requires_grad_(True)
    value = loss(p, n_blocks, images, noise, lamb)
    grads = torch.autograd.grad(value, [p[k] for k in names],
                                allow_unused=True)
    grads = {k: torch.zeros_like(p[k]) if g is None else g
             for k, g in zip(names, grads)}
    for v in p.values():
        v.requires_grad_(False)
    opt.update(p, grads)
    with torch.no_grad():
        for k in names:
            ema[k] -= (1.0 - ema_decay) * (ema[k] - p[k])
    return float(value.detach()), grads


def run_steps(p: rvae.Params, n_blocks: int, feed: List[tuple], lamb: float,
              lr: float, ema_decay: float) -> dict:
    """Steps on ``feed`` [(images, noise), ...] from weights ``p`` (changed
    in place).  Returns each step's loss, the first step's gradients, and
    the weights and EMA after the last step."""
    ema = {k: v.detach().clone() for k, v in p.items()}
    opt = Adamax(p, lr)
    losses, first = [], None
    for images, noise in feed:
        value, grads = step(p, ema, opt, n_blocks, images, noise, lamb,
                            ema_decay)
        losses.append(value)
        if first is None:
            first = grads
    return {"losses": losses, "first_grads": first, "params": p, "ema": ema}
