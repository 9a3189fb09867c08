"""Auxiliary-variance-ratio fitting, the coder's initialisation (port of
rec_tpu/coding/ratio_fit.py).

The coder extrapolates variance ratios by a power law; this fits them to
data instead (``compression_performance mode=initialize``): for each ratio
index r from the deepest one the data reaches down to 2, gradient descent
on a sigmoid-reparameterised ratio makes the first auxiliary variable's KL
hit Omega (hinge losses on aux KL > Omega and remaining KL > Omega (r - 1),
averaged over the blocks that need r partitions), then both distributions
are conditioned on a sampled auxiliary variable and the fit goes one level
down.  Running averages accumulate across calls.

The descent loop.  ``rec_tpu`` runs it as one jitted ``while_loop`` that
stops at the first step whose loss moved by less than the tolerance.  An
eager loop that read the loss back every step would wait on the device
once per step.  Here a chunk of ``STEPS_PER_SYNC`` steps runs with each
step's theta and loss kept on the device, one read brings the chunk to the
host, and the host finds the first step whose stop test holds and takes its
theta: the theta ``rec_tpu`` returns.  The steps of a chunk past that point
are wasted work, not a different answer.  The gradient of the scalar theta
comes from autograd.  On the card a chunk is one CUDA graph, captured once
per block shape and replayed for every fit: a step is ~100 small kernels,
and launching them one by one from Python costs far more than running
them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .gauss import (GaussianParams, auxiliary_coder, auxiliary_target,
                    conditional_coder, conditional_target, kl_divergence)
from .partition import aux_variance_ratio

# Descent steps run between two reads of their losses on the host.
STEPS_PER_SYNC = 32


def sigmoid_inverse(x) -> torch.Tensor:
    x = torch.clamp(torch.as_tensor(x, dtype=torch.float32), 1e-10,
                    1.0 - 1e-10)
    return torch.log(x) - torch.log1p(-x)


@dataclasses.dataclass(frozen=True)
class RatioFitConfig:
    kl_per_partition: float = 3.0
    learning_rate: float = 1e-3
    max_iters: int = 10_000
    relative_tolerance: float = 1e-4


class RatioFit(NamedTuple):
    ratio: float
    target: GaussianParams      # conditioned where the mask selects
    coder: GaussianParams
    steps: int                  # descent steps the fit took
    steps_run: int              # steps computed, those past the stop too
    syncs: int                  # reads of the losses on the host


def _stop_step(losses: np.ndarray, tol: np.float32, max_iters: int,
               start: int) -> Optional[int]:
    """The while_loop's exit: the first i >= ``start`` (i >= 1) at which
    ``i >= max_iters`` or not |L[i-2] - L[i-1]| >= tol (L[-1] = inf; a NaN
    difference stops), given losses L[0 .. len-1]; None if no step up to
    len(losses) stops."""
    for i in range(start, len(losses) + 1):
        if i >= max_iters:
            return i
        prev = np.float32(np.inf) if i == 1 else losses[i - 2]
        with np.errstate(invalid="ignore"):
            if not np.abs(np.float32(prev - losses[i - 1])) >= tol:
                return i
    return None


def _descend(cfg: RatioFitConfig, target: GaussianParams,
             coder: GaussianParams, mask: torch.Tensor,
             rem_budget: torch.Tensor, theta: torch.Tensor, steps: int):
    """``steps`` descent steps from ``theta`` (0-d) on the hinge loss of the
    masked blocks (N, D), with no host synchronisation.  Returns the
    (steps, 2) losses L_k and thetas theta_{k+1}, and the last theta."""
    omega = cfg.kl_per_partition
    total_kl = torch.sum(kl_divergence(target, coder), dim=-1)
    zero = torch.zeros_like(total_kl)
    # Mean over the selected blocks only.
    n_sel = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)

    def loss_of(theta):
        aux_var = torch.sigmoid(theta) * coder.var
        aux_kl = torch.sum(kl_divergence(
            auxiliary_target(target, coder, aux_var),
            auxiliary_coder(coder, aux_var)), dim=-1)
        aux_loss = torch.where(aux_kl > omega,
                               torch.square(aux_kl - omega), zero)
        rem = total_kl - aux_kl
        rem_loss = torch.where(rem > rem_budget,
                               torch.square(rem - rem_budget), zero)
        return torch.sum(torch.where(mask, aux_loss + rem_loss, zero)) / n_sel

    chunk = []
    for _ in range(steps):
        th = theta.detach().requires_grad_(True)
        loss = loss_of(th)
        (grad,) = torch.autograd.grad(loss, th)
        theta = (th - cfg.learning_rate * grad).detach()
        chunk.append(torch.stack([loss.detach(), theta]))
    return torch.stack(chunk), theta


class _GraphedDescent:
    """``STEPS_PER_SYNC`` descent steps captured once as a CUDA graph for
    block sets of one shape on one card: a call copies its inputs into the
    graph's buffers and replays the kernels of every step without the host
    launching each of them."""

    def __init__(self, cfg: RatioFitConfig, *inputs):
        self.inputs = [x.clone() for x in inputs]
        t_loc, t_scale, c_loc, c_scale, mask, rem_budget, theta = self.inputs
        args = (cfg, GaussianParams(t_loc, t_scale),
                GaussianParams(c_loc, c_scale), mask, rem_budget)
        side = torch.cuda.Stream(theta.device)
        side.wait_stream(torch.cuda.current_stream(theta.device))
        with torch.cuda.stream(side):   # warm-up outside the capture
            _descend(*args, theta, 2)
        torch.cuda.current_stream(theta.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out, self.theta = _descend(*args, theta, STEPS_PER_SYNC)

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        return self.out, self.theta


def _fit_one_ratio(cfg: RatioFitConfig, target: GaussianParams,
                   coder: GaussianParams, mask: torch.Tensor,
                   ratio_index: int, init_ratio: float, generator,
                   graphs: Optional[dict] = None) -> RatioFit:
    """Descend on the scalar ratio for partition count ``ratio_index`` over
    all masked blocks (N, D) at once, then condition the masked blocks on a
    sampled auxiliary variable.  Given ``graphs``, a cache of captured
    descents keyed by config, block shape and card (the learning rate and
    Omega are baked into a capture), a descent on CUDA tensors replays one
    (capturing it on first use); otherwise it launches the same kernels
    eagerly."""
    dev = target.loc.device
    rem_budget = (torch.tensor(cfg.kl_per_partition, dtype=torch.float32)
                  * (torch.tensor(float(ratio_index)) - 1.0)).to(dev)
    tol = np.float32(cfg.relative_tolerance)
    theta = sigmoid_inverse(init_ratio).to(dev)
    inputs = (target.loc, target.scale, coder.loc, coder.scale, mask,
              rem_budget)
    graphed = None
    if target.loc.is_cuda and graphs is not None:
        key = (cfg, tuple(target.loc.shape), dev)
        if key not in graphs:
            graphs[key] = _GraphedDescent(cfg, *inputs, theta)
        graphed = graphs[key]
    losses = np.zeros(0, np.float32)    # L[k] = loss(theta_k)
    thetas = np.zeros(0, np.float32)    # theta_{k+1}
    stop, syncs = None, 0
    while stop is None:
        if graphed is not None:
            out, theta = graphed(*inputs, theta)
        else:
            out, theta = _descend(cfg, target, coder, mask, rem_budget, theta,
                                  min(STEPS_PER_SYNC,
                                      cfg.max_iters - len(losses)))
        got = out.cpu().numpy()
        syncs += 1
        start = len(losses) + 1
        losses = np.concatenate([losses, got[:, 0]])
        thetas = np.concatenate([thetas, got[:, 1]])
        stop = _stop_step(losses, tol, cfg.max_iters, start)
    ratio = torch.sigmoid(torch.tensor(thetas[stop - 1]))

    aux_var = ratio.to(dev) * coder.var
    aux_sample = auxiliary_target(target, coder, aux_var).sample(generator)
    new_t = conditional_target(target, coder, aux_var, aux_sample)
    new_c = conditional_coder(coder, aux_var, aux_sample)
    keep = mask[:, None]

    def where(a: GaussianParams, b: GaussianParams) -> GaussianParams:
        return GaussianParams(torch.where(keep, a.loc, b.loc),
                              torch.where(keep, a.scale, b.scale))

    return RatioFit(float(ratio), where(new_t, target), where(new_c, coder),
                    stop, len(losses), syncs)


class RatioFitter:
    """Accumulates fitted ratios across calls (running averages).
    ``steps``, ``steps_run``, ``syncs`` and ``fits`` count the descent
    steps taken and computed, the host reads and the ratio fits so far."""

    def __init__(self, cfg: Optional[RatioFitConfig] = None,
                 max_partitions: int = 32):
        self.cfg = cfg or RatioFitConfig()
        self.ratios = np.zeros(max_partitions)
        self.counts = np.zeros(max_partitions)
        self.ratios[0] = 1.0
        self.counts[0] = 1.0
        self.steps = self.steps_run = self.syncs = self.fits = 0
        self._graphs = {}

    def update(self, target: GaussianParams, coder: GaussianParams,
               generator) -> None:
        """``target``/``coder``: stacked blocks (num_blocks, D);
        ``generator`` feeds the auxiliary samples (``gauss.standard_normal``),
        one draw per fitted ratio."""
        total_kl = torch.sum(kl_divergence(target, coder), dim=-1)
        n_aux = (1 + torch.floor(total_kl / self.cfg.kl_per_partition)
                 .to(torch.int32)).cpu().numpy()
        self.syncs += 1
        max_n = min(int(n_aux.max()), len(self.ratios))
        for r in range(max_n, 1, -1):
            sel = n_aux >= r
            n_sel = int(sel.sum())
            if n_sel == 0:
                continue
            if self.counts[r - 1] > 0 and self.ratios[r - 1] > 0:
                init = self.ratios[r - 1]
            elif r < max_n and self.ratios[r] > 0:
                init = self.ratios[r]
            else:
                init = 1.0 / r
            fit = _fit_one_ratio(self.cfg, target, coder,
                                 torch.from_numpy(sel).to(target.loc.device),
                                 r, init, generator, self._graphs)
            target, coder = fit.target, fit.coder
            self.ratios[r - 1] = ((self.ratios[r - 1] * self.counts[r - 1]
                                   + fit.ratio * n_sel)
                                  / (self.counts[r - 1] + n_sel))
            self.counts[r - 1] += n_sel
            self.steps += fit.steps
            self.steps_run += fit.steps_run
            self.syncs += fit.syncs
            self.fits += 1

    def fitted(self) -> Tuple[float, ...]:
        """Ratio table usable as ``aux_variance_ratios`` on a coder;
        unfitted entries fall back to the power law."""
        return tuple(float(r) if c > 0 and r > 0
                     else float(aux_variance_ratio(i))
                     for i, (r, c) in enumerate(zip(self.ratios,
                                                    self.counts)))
