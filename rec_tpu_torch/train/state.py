"""Train state: params, optimizer, EMA shadow params and the KL weight
(port of rec_tpu/train/state.py).

The parameters are the model's own tensors (name -> ``nn.Parameter``, the
model's state-dict names); a step updates them in place, and every other
tensor of the state lives on their device.  The optimizer is optax's
``adam``/``adamax`` with a learning-rate schedule and optional global-norm
clipping, written out with the same formulas and the same state: a count
with first and second moments per parameter, and the schedule's own count.
``OptState.layout`` gives optax's state-dict layout, which checkpoints
store.  Step counts are host integers, so no step reads the device to know
its learning rate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    step: int
    params: Tensors          # the model's parameters, updated in place
    opt_state: "OptState"
    ema_params: Tensors
    beta: torch.Tensor       # 0-d float32 on the parameters' device


@dataclasses.dataclass
class OptState:
    """``scale_by_adam``/``scale_by_adamax``'s (count, mu, nu) and
    ``scale_by_schedule``'s count; ``clipped`` adds optax's stateless
    ``clip_by_global_norm`` in front of them."""

    count: int
    mu: Tensors
    nu: Tensors
    schedule_count: int
    clipped: bool

    def layout(self, tree: Callable[[Tensors], dict]) -> dict:
        """optax's state dict of this state, moments mapped by ``tree``:
        ``{"0": adam, "1": schedule}``, or ``{"0": {}, "1": that}`` with
        clipping."""
        inner = {"0": {"count": np.asarray(self.count, np.int32),
                       "mu": tree(self.mu), "nu": tree(self.nu)},
                 "1": {"count": np.asarray(self.schedule_count, np.int32)}}
        return {"0": {}, "1": inner} if self.clipped else inner

    def load_layout(self, raw: dict, untree: Callable[[dict], Tensors]
                    ) -> "OptState":
        """This state with ``raw`` (optax's layout) copied into it; raises
        when the layout is the other clipping setting's."""
        clipped = set(raw) == {"0", "1"} and raw["0"] == {}
        if clipped != self.clipped:
            raise ValueError(
                f"checkpoint optimizer state was written with clipping "
                f"{'on' if clipped else 'off'}; this optimizer has it "
                f"{'on' if self.clipped else 'off'}")
        inner = raw["1"] if clipped else raw
        for mine, theirs in ((self.mu, inner["0"]["mu"]),
                             (self.nu, inner["0"]["nu"])):
            copy_into(mine, untree(theirs))
        return dataclasses.replace(
            self, count=int(inner["0"]["count"]),
            schedule_count=int(inner["1"]["count"]))


def copy_into(dst: Tensors, src: Tensors) -> None:
    if set(dst) != set(src):
        raise ValueError(f"tensor names differ: "
                         f"{sorted(set(dst) ^ set(src))[:4]}")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def staircase_schedule(base_lr: float, drop_after: int, drop_rate: float,
                       num_drops: int = 4) -> Callable[[int], float]:
    """LR drops by ``drop_rate`` at k, 2k, 3k, 4k iters."""

    def schedule(step: int) -> float:
        n = min(max(step // drop_after, 0), num_drops)
        return base_lr * (drop_rate ** n)

    return schedule


class Optimizer:
    """optax's ``adam``/``adamax(schedule)``, chained after
    ``clip_by_global_norm(clip_norm)`` when ``clip_norm > 0``; b1 = 0.9,
    b2 = 0.999, eps = 1e-8.  The updates run as multi-tensor (``_foreach``)
    operations on the parameters' device."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, name: str, schedule: Callable[[int], float],
                 clip_norm: float = 0.0):
        if name not in ("adam", "adamax"):
            raise ValueError(f"optimizer must be adam or adamax, got {name}")
        self.name = name
        self.schedule = schedule
        self.clip_norm = float(clip_norm or 0.0)

    def init(self, params: Tensors) -> OptState:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        return OptState(count=0, mu=zeros(), nu=zeros(), schedule_count=0,
                        clipped=self.clip_norm > 0)

    def _clip(self, grads: List[torch.Tensor]) -> None:
        """``clip_by_global_norm``: grads unchanged when the global norm is
        below ``clip_norm``, else ``(g / norm) * clip_norm`` (no epsilon;
        decided on the device)."""
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < self.clip_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one,
                                               one * self.clip_norm))

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors
               ) -> OptState:
        """One step: the moments and ``params`` change in place; returns
        the state with its counts advanced."""
        names = list(params)
        g = [grads[k] for k in names]
        p = [params[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        if state.clipped:
            self._clip(g)
        b1, b2, eps = self.b1, self.b2, self.eps
        count = state.count + 1
        # mu = (1 - b1) g + b1 mu, as optax rounds it.
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        bc1 = 1.0 - b1 ** count
        if self.name == "adamax":
            # nu = max(|g| + eps, b2 nu); update = (mu / bc1) / nu
            a = torch._foreach_abs(g)
            torch._foreach_add_(a, eps)
            torch._foreach_mul_(nu, b2)
            torch._foreach_maximum_(nu, a)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, nu)
        else:
            # nu = (1 - b2) g^2 + b2 nu;
            # update = (mu / bc1) / (sqrt(nu / bc2) + eps)
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq)
            den = torch._foreach_div(nu, 1.0 - b2 ** count)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
        # scale_by_schedule: -lr at the schedule's count before it advances.
        torch._foreach_mul_(upd, -self.schedule(state.schedule_count))
        torch._foreach_add_(p, upd)
        return dataclasses.replace(state, count=count,
                                   schedule_count=state.schedule_count + 1)


def make_optimizer(name: str, schedule: Callable[[int], float],
                   clip_norm: float = 0.0) -> Optimizer:
    """adam/adamax with optional global-norm gradient clipping
    (``clip_norm=0`` is off; the checkpointed optimizer layout differs
    between the two settings)."""
    return Optimizer(name, schedule, clip_norm)


def init_state(model: torch.nn.Module, tx: Optimizer, beta: float
               ) -> TrainState:
    """The state at step 0 of ``model``'s parameters; the EMA shadows start
    as copies."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      ema_params={k: p.detach().clone()
                                  for k, p in params.items()},
                      beta=torch.tensor(beta, dtype=torch.float32,
                                        device=dev))


@torch.no_grad()
def ema_update(ema_params: Tensors, params: Tensors, decay: float
               ) -> Tensors:
    """shadow = shadow - (1 - decay) * (shadow - value), in place; returns
    ``ema_params``."""
    names = list(ema_params)
    e = [ema_params[k] for k in names]
    d = torch._foreach_sub(e, [params[k] for k in names])
    torch._foreach_mul_(d, 1.0 - decay)
    torch._foreach_sub_(e, d)
    return ema_params
