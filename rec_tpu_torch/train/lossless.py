"""Lossless (RVAE) training step (port of rec_tpu/train/lossless.py).

The free-bits KL floor (``lamb``), the linear beta anneal, the optional
target-bpp beta controller, the EMA update after the optimizer step and the
staircase learning rate, as ``rec_tpu``'s step has them.  The step runs on
the model's device: every metric stays a device tensor until the caller
reads it, so a step that is not logged never waits for the device.

With a mesh of k entries the step is data parallel, as rec_tpu's jitted
step with the batch sharded over its mesh computes it: the batch and its
noise (drawn for the whole batch, as on one device) split into contiguous
equal shares, one forward runs per entry on its device (a replica on
another device computes with copies of the parameters), and the per-image
terms and the batch-mean ``kld_channelwise`` (the shares' mean) come to
the model's device, where the loss is taken once on the whole batch: the
free-bits floor applies to the global batch's KL, not to each share's.
The loss's gradient with respect to each entry's outputs then runs back
through that entry alone, entry after entry, and the entries' parameter
gradients add in entry order: each backward stays on one device, so two
runs from one seed are bitwise equal.  The optimizer and the EMA step on
the model's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from ..coding.gauss import GaussianParams
from ..models.resnet_vae import Uniforms
from ..parallel.mesh import Mesh, replicate
from ..utils.profiling import span
from .state import Optimizer, OptState, TrainState, ema_update

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


def _noise_rows(noise, rows: slice, axis: int):
    """The posterior noise of a slice of the batch's rows: a tensor's
    ``axis`` (the RVAE's (N, B, ...) noise: 1; the dense VAE's: 0), each of
    a list's tensors' axis 0 (the large model's per-group noise), the same
    inside ``Uniforms``."""
    if isinstance(noise, Uniforms):
        return Uniforms(_noise_rows(noise.values, rows, axis))
    if isinstance(noise, (list, tuple)):
        return [n[rows] for n in noise]
    return noise[(slice(None),) * axis + (rows,)]


def _flat(out: dict, keys) -> list:
    """The tensors of ``out[k]`` for ``keys`` (a ``GaussianParams``: its loc
    and scale), in order."""
    flat = []
    for k in keys:
        flat += list(out[k]) if isinstance(out[k], GaussianParams) else [
            out[k]]
    return flat


class ShardedForward:
    """``model``'s forward over a batch sharded on ``mesh``.  A call returns
    the outputs an objective reads on the model's device, as leaves:
    ``gather`` maps each per-image output to its batch axis, and
    ``kld_channelwise``, a batch mean, is the shares' mean.  ``grads`` then
    gives the parameters' gradients of a loss of them (module
    docstring)."""

    def __init__(self, model, mesh: Mesh, gather: Dict[str, int],
                 noise_axis: int):
        self.model, self.mesh = model, mesh
        self.gather, self.noise_axis = gather, noise_axis
        self.replicas = replicate(model, mesh)
        self._entries = []   # per entry: (its parameters, outputs, leaves)

    def __call__(self, images: torch.Tensor, noise) -> dict:
        B, k = images.shape[0], len(self.mesh)
        if B % k:
            raise ValueError(f"batch {B} is not a multiple of the mesh "
                             f"({k} entries)")
        share = B // k
        home = images.device
        params = dict(self.model.named_parameters())
        keys = list(self.gather) + ["kld_channelwise"]
        copies, self._entries = {}, []
        for i, (dev, rep) in enumerate(zip(self.mesh, self.replicas)):
            rows = slice(i * share, (i + 1) * share)
            args = (images[rows].to(dev),
                    _noise_rows(noise, rows, self.noise_axis))
            if rep is self.model:
                weights, out = params, rep(*args)
            else:
                if dev not in copies:
                    copies[dev] = {n: p.detach().to(dev).requires_grad_()
                                   for n, p in params.items()}
                weights = copies[dev]
                out = functional_call(rep, weights, args)
            keys = [key for key in keys if key in out]
            leaves = {key: (GaussianParams(*(t.detach().to(home)
                                             .requires_grad_()
                                             for t in out[key]))
                            if isinstance(out[key], GaussianParams) else
                            out[key].detach().to(home).requires_grad_())
                      for key in keys}
            self._entries.append((weights, out, leaves))
        return self._gathered([e[2] for e in self._entries])

    def _gathered(self, leaves) -> dict:
        def cat(parts, axis):
            if isinstance(parts[0], GaussianParams):
                return GaussianParams(*(cat([p[j] for p in parts], axis)
                                        for j in range(2)))
            return torch.cat(parts, dim=axis)

        out = {key: cat([lv[key] for lv in leaves], axis)
               for key, axis in self.gather.items()}
        if "kld_channelwise" in leaves[0]:
            kld = [lv["kld_channelwise"] for lv in leaves]
            out["kld_channelwise"] = sum(kld[1:], kld[0]) / len(kld)
        return out

    def grads(self, loss: torch.Tensor, names) -> list:
        """The gradients of ``loss`` (a function of the last call's
        outputs) for the model's parameters ``names``: the loss's gradient
        for each entry's outputs, run back through that entry alone, and
        the entries' parameter gradients added in entry order on the
        model's device."""
        leaves = [_flat(lv, lv) for _, _, lv in self._entries]
        g_leaves = torch.autograd.grad(loss, sum(leaves, []),
                                       allow_unused=True)
        total, at = None, 0
        for (weights, out, lv), flat in zip(self._entries, leaves):
            outs = _flat(out, lv)
            g_out = g_leaves[at:at + len(flat)]
            at += len(flat)
            pairs = [(o, g.to(o.device)) for o, g in zip(outs, g_out)
                     if g is not None and o.requires_grad]
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [weights[n] for n in names],
                grad_outputs=[g for _, g in pairs], allow_unused=True,
                materialize_grads=True)
            grads = [g.to(loss.device) for g in grads]
            # Out of place: autograd may hand one tensor to two parameters
            # (seen for two of the large model's posterior-head biases).
            total = grads if total is None else torch._foreach_add(total,
                                                                   grads)
        self._entries = []
        return total


def _forward(model, mesh: Optional[Mesh], gather, noise_axis):
    """The model itself without a mesh or with a one-entry mesh (today's
    step, bit for bit), else its ``ShardedForward``."""
    if mesh is None or len(mesh) == 1:
        if mesh is not None and mesh[0] != next(model.parameters()).device:
            raise ValueError(f"a one-entry mesh on {mesh[0]} for a model on "
                             f"{next(model.parameters()).device}")
        return model
    return ShardedForward(model, mesh, gather, noise_axis)


def objective(model, cfg: LosslessTrainConfig, state: TrainState,
              images: torch.Tensor, noise: torch.Tensor, num_pixels: int
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss -mean(log_lik) + beta * sum(max(kld_channelwise, lamb)),
    differentiable in the model's parameters, and the step's metrics
    (detached): nll, kl (the floored KL), true_kl, bpp, beta (annealed),
    elbo_bpd (over H*W*C), kl_per_block, expected_max_kl and the
    reconstruction.  ``model`` is the model or its ``ShardedForward``."""
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


def _update(state: TrainState, loss: torch.Tensor, optimizer: Optimizer,
            ema_decay: float, forward) -> OptState:
    """The gradients of ``loss`` (through ``forward``: the model, or its
    ``ShardedForward``), one optimizer step on the state's parameters and
    the EMA update, in place; returns the optimizer state with its counts
    advanced."""
    names = list(state.params)
    with span("train.backward"):
        if isinstance(forward, ShardedForward):
            grads = forward.grads(loss, names)
        else:
            grads = torch.autograd.grad(
                loss, [state.params[k] for k in names], allow_unused=True,
                materialize_grads=True)
    with span("train.optimizer"):
        opt_state = optimizer.update(dict(zip(names, grads)),
                                     state.opt_state, state.params)
    with span("train.ema"):
        ema_update(state.ema_params, state.params, ema_decay)
    return opt_state


# The per-image forward outputs each objective reads, by batch axis.
_LOSSLESS_GATHER = {"log_likelihood": 0, "analytic_kl": 1,
                    "reconstruction": 0}
_VAE_GATHER = {"log_likelihood": 0, "kl": 0, "posterior": 0,
               "reconstruction": 0}


def make_train_step(model, cfg: LosslessTrainConfig, optimizer: Optimizer,
                    num_pixels: int, mesh: Optional[Mesh] = None
                    ) -> Callable:
    """Returns ``(state, images, noise) -> (state, metrics)``.  ``noise`` is
    the posterior noise (num_res_blocks, B, H/2, W/2, stochastic; the large
    model's: one (B, ...) tensor per group) on the images' device; the
    state's parameters (the model's), moments and EMA shadows change in
    place, and the returned state carries the new step and beta.  With a
    ``mesh`` of several entries the step is data parallel (module
    docstring)."""
    forward = _forward(model, mesh, _LOSSLESS_GATHER, noise_axis=1)
    dev = next(model.parameters()).device

    def step_fn(state: TrainState, images, noise):
        with span("train.step", card=dev):
            with span("train.forward"):
                loss, metrics = objective(forward, cfg, state, images, noise,
                                          num_pixels)
            opt_state = _update(state, loss, optimizer, cfg.ema_decay,
                                forward)
            beta = state.beta
            if (cfg.target_bpp is not None
                    and state.step > cfg.adjust_beta_after_iters):
                # Multiplicative controller pushing the rate to target_bpp.
                bpp = metrics["bpp"]
                factor = torch.where(
                    bpp > cfg.target_bpp + 1e-2, 1.001,
                    torch.where(bpp < cfg.target_bpp - 1e-2, 1.0 / 1.001,
                                1.0))
                beta = beta * factor
            return state._replace(step=state.step + 1, opt_state=opt_state,
                                  beta=beta), metrics

    return step_fn


def vae_objective(model, cfg: LosslessTrainConfig, state: TrainState,
                  images: torch.Tensor, noise: torch.Tensor, num_pixels: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The dense MNIST VAE's loss -mean(log_lik) + beta * mean(kl) (no
    free-bits floor) and its metrics, as ``objective`` names them;
    kl_per_block is the batch mean of the per-dimension analytic KL
    against N(0, 1) and expected_max_kl the batch mean of its maximum."""
    out = model(images, noise)
    log_lik = torch.mean(out["log_likelihood"])
    kld = torch.mean(out["kl"])
    num_dims = images[0].numel()
    beta = state.beta
    if cfg.anneal:
        beta = beta * min(1.0, state.step / cfg.annealing_end)
    loss = -log_lik + beta * kld
    post = out["posterior"]
    kl_dim = (0.5 * (torch.square(post.scale) + torch.square(post.loc)
                     - 1.0 - 2.0 * torch.log(post.scale))).detach()
    metrics = {k: v.detach() for k, v in {
        "loss": loss, "nll": -log_lik, "kl": kld, "true_kl": kld,
        "beta": beta, "bpp": kld / (num_pixels * LOG2),
        "elbo_bpd": (-log_lik + kld) / (num_dims * LOG2)}.items()}
    metrics["kl_per_block"] = torch.mean(kl_dim, dim=0)
    metrics["expected_max_kl"] = torch.mean(torch.max(kl_dim, dim=-1).values)
    metrics["reconstruction"] = out["reconstruction"].detach()
    return loss, metrics


def make_vae_train_step(model, cfg: LosslessTrainConfig,
                        optimizer: Optimizer, num_pixels: int,
                        mesh: Optional[Mesh] = None) -> Callable:
    """Train step of the dense MNIST VAE (``model=vae``): returns
    ``(state, images, noise) -> (state, metrics)``, ``noise`` the posterior
    normals (B, latents); the optimizer step, the EMA and the ``mesh`` as
    ``make_train_step``'s, beta unchanged."""
    forward = _forward(model, mesh, _VAE_GATHER, noise_axis=0)
    dev = next(model.parameters()).device

    def step_fn(state: TrainState, images, noise):
        with span("train.step", card=dev):
            with span("train.forward"):
                loss, metrics = vae_objective(forward, cfg, state, images,
                                              noise, num_pixels)
            opt_state = _update(state, loss, optimizer, cfg.ema_decay,
                                forward)
            return state._replace(step=state.step + 1,
                                  opt_state=opt_state), metrics

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
