"""Diagonal-Gaussian math for relative entropy coding (port of
rec_tpu/coding/gauss.py).

A KL-partitioned auxiliary-variable decomposition of a Gaussian channel:
given a target q = N(mu_q, s_q^2) and a coding distribution
p = N(mu_p, s_p^2), a zero-mean auxiliary variable A ~ N(0, s_a^2) has the
auxiliary target q(A) below; candidates are scored by the log density ratio
of q(A) to the cumulative coder, and the ratio fitter conditions both
distributions on a sampled A (``conditional_target``/``conditional_coder``).
Pure functions on tensors.

Every square root is ``ops.threefry_normal.sqrt_f32``, correctly rounded
on every device as XLA's is (torch's vectorised CPU sqrt is not), so these
functions give the same bits on the CPU and the GPU.

Every random draw goes through ``standard_normal``, so a test can swap in
another generator's normals (``rec_tpu``'s, say) for the same calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .utils import xla_sum_f32
from ..ops.threefry_normal import sqrt_f32

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2 * pi)


def standard_normal(generator: torch.Generator, shape, dtype, device
                    ) -> torch.Tensor:
    """Standard normals of ``shape`` drawn from ``generator`` on its own
    device, then moved to ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


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

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        """loc + scale * eps, eps of ``shape + loc.shape`` from
        ``standard_normal``."""
        eps = standard_normal(generator, tuple(shape) + tuple(self.loc.shape),
                              self.loc.dtype, self.loc.device)
        return self.loc + self.scale * eps


def standard_normal_like(x: torch.Tensor) -> GaussianParams:
    return GaussianParams(torch.zeros_like(x), torch.ones_like(x))


def kl_divergence(q: GaussianParams, p: GaussianParams, log=torch.log
                  ) -> torch.Tensor:
    """Elementwise KL[q || p] in nats for diagonal Gaussians (``log`` is
    the logarithm it takes of the variance ratio)."""
    var_ratio = torch.square(q.scale / p.scale)
    mean_term = torch.square((q.loc - p.loc) / p.scale)
    return 0.5 * (var_ratio + mean_term - 1.0 - log(var_ratio))


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
    return GaussianParams(mean, sqrt_f32(var))


def auxiliary_coder(coder: GaussianParams, aux_var: torch.Tensor
                    ) -> GaussianParams:
    """p(A) = N(0, aux_var)."""
    return GaussianParams(torch.zeros_like(coder.loc), sqrt_f32(aux_var))


def conditional_coder(coder: GaussianParams, aux_var: torch.Tensor,
                      aux_sample: torch.Tensor) -> GaussianParams:
    """p(Z | A=a) = N(mu_p + a, s_p^2 - s_a^2), the variance clamped at 0
    so the last partition (aux_var == p_var) stays NaN-free."""
    var = torch.clamp(coder.var - aux_var, min=0.0)
    return GaussianParams(coder.loc + aux_sample, sqrt_f32(var))


def conditional_target(target: GaussianParams, coder: GaussianParams,
                       aux_var: torch.Tensor, aux_sample: torch.Tensor
                       ) -> GaussianParams:
    """q(Z | A=a) for the joint that q implies over Z and the aux split."""
    p_var = coder.var
    t_var = target.var
    resid = p_var - aux_var
    denom = t_var * aux_var + p_var * resid
    mean = coder.loc + (aux_sample * t_var * p_var
                        + (target.loc - coder.loc) * resid * p_var) / denom
    var = t_var * p_var * resid / denom
    return GaussianParams(mean, sqrt_f32(torch.clamp(var, min=0.0)))


def _quadratic_terms(num: GaussianParams, den: GaussianParams):
    """Per-dimension (a, b, c) of log num(x) - log den(x) = (a x + b) x + c."""
    inv_n = 1.0 / torch.square(num.scale)
    inv_d = 1.0 / torch.square(den.scale)
    a = -0.5 * (inv_n - inv_d)
    b = num.loc * inv_n - den.loc * inv_d
    c = (-0.5 * (torch.square(num.loc) * inv_n
                 - torch.square(den.loc) * inv_d)
         - torch.log(num.scale / den.scale))
    return a, b, c


def quadratic_coeffs(num: GaussianParams, den: GaussianParams):
    """(a, b, c_sum) of log N(x; num) - log N(x; den) = sum (a x + b) x + c,
    over the last axis; c_sum is added in XLA-CPU's order, as ``rec_tpu``'s
    ``jnp.sum`` adds it."""
    a, b, c = _quadratic_terms(num, den)
    return a, b, xla_sum_f32(c)


def log_density_ratio(x: torch.Tensor, num: GaussianParams,
                      den: GaussianParams) -> torch.Tensor:
    """log num(x) - log den(x), elementwise, as the per-dimension quadratic
    a*x^2 + b*x + c."""
    a, b, c = _quadratic_terms(num, den)
    return (a * x + b) * x + c
