"""Diagonal-Gaussian math for relative entropy coding (port of
rec_tpu/coding/gauss.py).

A KL-partitioned auxiliary-variable decomposition of a Gaussian channel:
given a target q = N(mu_q, s_q^2) and a coding distribution
p = N(mu_p, s_p^2), a zero-mean auxiliary variable A ~ N(0, s_a^2) has the
auxiliary target q(A) below; candidates are scored by the log density ratio
of q(A) to the cumulative coder.  Pure functions on tensors.  (The
conditionals and samplers of rec_tpu's gauss.py serve the importance and
rejection coders, which later slices port.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2 * pi)


class GaussianParams(NamedTuple):
    """A diagonal Gaussian as a (loc, scale) pair of tensors."""

    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def var(self) -> torch.Tensor:
        return torch.square(self.scale)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * torch.square(z) - torch.log(self.scale) - _HALF_LOG_2PI


def kl_divergence(q: GaussianParams, p: GaussianParams) -> torch.Tensor:
    """Elementwise KL[q || p] in nats for diagonal Gaussians."""
    var_ratio = torch.square(q.scale / p.scale)
    mean_term = torch.square((q.loc - p.loc) / p.scale)
    return 0.5 * (var_ratio + mean_term - 1.0 - torch.log(var_ratio))


def auxiliary_target(target: GaussianParams, coder: GaussianParams,
                     aux_var: torch.Tensor) -> GaussianParams:
    """q(A): marginal of the auxiliary variable under the target.

    mean = (mu_q - mu_p) * s_a^2 / s_p^2
    var  = s_q^2 s_a^4 / s_p^4 + s_a^2 (s_p^2 - s_a^2) / s_p^2
    """
    p_var = coder.var
    t_var = target.var
    ratio = aux_var / p_var
    mean = (target.loc - coder.loc) * ratio
    var = t_var * torch.square(ratio) + aux_var * (p_var - aux_var) / p_var
    return GaussianParams(mean, torch.sqrt(var))


def log_density_ratio(x: torch.Tensor, num: GaussianParams,
                      den: GaussianParams) -> torch.Tensor:
    """log num(x) - log den(x), elementwise, as the per-dim quadratic
    a*x^2 + b*x + c."""
    inv_n = 1.0 / torch.square(num.scale)
    inv_d = 1.0 / torch.square(den.scale)
    a = -0.5 * (inv_n - inv_d)
    b = num.loc * inv_n - den.loc * inv_d
    c = (-0.5 * (torch.square(num.loc) * inv_n
                 - torch.square(den.loc) * inv_d)
         - torch.log(num.scale / den.scale))
    return (a * x + b) * x + c
