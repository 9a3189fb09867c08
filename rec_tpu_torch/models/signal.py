"""Ballé's signal-processing layers for the lossy models (port of
rec_tpu/models/modules.py:192-365): ``GDN`` and ``SignalConv2D`` with their
helpers.

Modules take and return NCHW tensors; the lossy models convert at their
public functions, which keep ``rec_tpu``'s NHWC.  Parameters keep flax's
leaf names and layouts where that costs nothing: ``kernel_rdft`` is the
(kh*kw, in*out) matrix of the RDFT parametrisation, ``gamma_reparam`` GDN's
(C_in, C_out) matrix; a plain ``kernel`` is stored OIHW (the converter
transposes flax's HWIO).

* Padding is reflect padding (the only kind the lossy models use), by
  numpy's rule, which ``jnp.pad`` uses and ``F.pad`` does not: a pad of any
  size reflects again past the edge, and a size-1 axis repeats its value.
  It is index arithmetic and a gather.
* An up-sampling conv is XLA's lhs-dilated convolution written out: the
  input dilated with zeros, padded where the padding is positive and cropped
  where it is negative, correlated with the kernel, then sub-sampled by
  ``strides_down``.
* GDN's 1x1 normalisation is a convolution with gamma transposed (gamma is
  (C_in, C_out)); TF32 stays off (``device.set_deterministic``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def irdft_matrix(shape: Tuple[int, int]) -> np.ndarray:
    """Orthonormal inverse-RDFT basis over the kernel support, (size, size)
    float32 with size = prod(shape)."""
    from scipy.fftpack import rfft

    size = int(np.prod(shape))
    rank = len(shape)
    matrix = np.identity(size, dtype=np.float64).reshape((size,)
                                                         + tuple(shape))
    for axis in range(rank):
        matrix = rfft(matrix, axis=axis + 1)
        slices = [slice(None)] * (rank + 1)
        slices[axis + 1] = (slice(1, None) if shape[axis] % 2 == 1
                            else slice(1, -1))
        matrix[tuple(slices)] *= np.sqrt(2)
    matrix /= np.sqrt(size)
    return matrix.reshape((size, size)).astype(np.float32)


def same_padding_for_kernel(shape, corr: bool, strides_up=None):
    """Per-axis (low, high) padding that keeps a signal conv's output
    aligned with its input."""
    rank = len(shape)
    if strides_up is None:
        strides_up = rank * (1,)
    if corr:
        padding = [(s // 2, (s - 1) // 2) for s in shape]
    else:
        padding = [((s - 1) // 2, s // 2) for s in shape]
    return [((padding[i][0] - 1) // strides_up[i] + 1,
             (padding[i][1] - 1) // strides_up[i] + 1) for i in range(rank)]


class _LowerBound(torch.autograd.Function):
    """max(x, bound) with ``rec_tpu``'s custom gradient: the incoming
    gradient ``g`` passes where ``x >= bound`` or ``g < 0`` (a descent step
    then raises an ``x`` that fell below the bound) and is 0 elsewhere;
    ``bound`` gets none."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound), with the gradient of ``_LowerBound``."""
    return _LowerBound.apply(x, bound)


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of numpy's reflect padding of an axis of length n by
    (lo, hi): the reflection is periodic with period 2 (n - 1)."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m >= n, period - m, m)


def reflect_pad(x: torch.Tensor, pads: Sequence[Tuple[int, int]]
                ) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` of an NCHW tensor's H and W axes by
    ``pads`` = ((h_lo, h_hi), (w_lo, w_hi))."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    if h_lo or h_hi:
        x = x.index_select(2, _reflect_index(x.shape[2], h_lo, h_hi,
                                             x.device))
    if w_lo or w_hi:
        x = x.index_select(3, _reflect_index(x.shape[3], w_lo, w_hi,
                                             x.device))
    return x


def variance_scaling_uniform(shape: Tuple[int, int, int, int],
                             generator: Optional[torch.Generator]
                             ) -> torch.Tensor:
    """flax's ``variance_scaling(1.0, "fan_avg", "uniform")`` for an HWIO
    kernel shape, drawn from ``generator``."""
    kh, kw, cin, cout = shape
    fan_avg = (kh * kw * cin + kh * kw * cout) / 2.0
    limit = math.sqrt(3.0 / fan_avg)
    u = torch.rand(shape, generator=generator)
    return (2.0 * u - 1.0) * limit


# GDN's reparameterisation (flax's defaults, which every model keeps).
_PEDESTAL = (2.0 ** -18) ** 2
_BETA_BOUND = (1e-6 + _PEDESTAL) ** 0.5
_GAMMA_BOUND = (0.0 + _PEDESTAL) ** 0.5
_GAMMA_INIT = 0.1


class GDN(nn.Module):
    """Generalized divisive normalization, y = x (beta + gamma^T x^2)^(-1/2)
    (or ^(+1/2) when ``inverse``), with beta and gamma reparameterised as
    squares of values clamped by ``lower_bound`` minus a pedestal."""

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta_reparam = nn.Parameter(
            torch.sqrt(torch.ones(channels) + _PEDESTAL))
        self.gamma_reparam = nn.Parameter(torch.sqrt(
            _GAMMA_INIT * torch.eye(channels) + _PEDESTAL))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = torch.square(lower_bound(self.beta_reparam, _BETA_BOUND)
                            ) - _PEDESTAL
        gamma = torch.square(lower_bound(self.gamma_reparam, _GAMMA_BOUND)
                             ) - _PEDESTAL
        norm = F.conv2d(torch.square(x), gamma.t()[:, :, None, None], beta)
        norm = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
        return x * norm


class SignalConv2D(nn.Module):
    """Ballé's signal-processing conv: correlation or convolution, integer
    up- and down-sampling, reflect padding and the RDFT kernel
    parametrisation (not for 1x1 kernels)."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (5, 5), corr: bool = False,
                 strides_down: int = 1, strides_up: int = 1,
                 use_bias: bool = True, dft_parametrization: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_ch, self.features = in_ch, features
        self.kernel_size = tuple(kernel)
        self.corr = corr
        self.strides_down, self.strides_up = strides_down, strides_up
        kh, kw = self.kernel_size
        init = variance_scaling_uniform((kh, kw, in_ch, features), generator)
        self.use_dft = dft_parametrization and self.kernel_size != (1, 1)
        if self.use_dft:
            basis = torch.from_numpy(irdft_matrix(self.kernel_size))
            self.register_buffer("basis", basis, persistent=False)
            self.kernel_rdft = nn.Parameter(
                basis.t() @ init.reshape(kh * kw, -1))
        else:
            self.kernel = nn.Parameter(init.permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def hwio_kernel(self) -> torch.Tensor:
        """The kernel as flax computes it, (kh, kw, in, out)."""
        if self.use_dft:
            kh, kw = self.kernel_size
            return (self.basis @ self.kernel_rdft).reshape(
                kh, kw, self.in_ch, self.features)
        return self.kernel.permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.hwio_kernel()
        corr, up, down = self.corr, self.strides_up, self.strides_down
        # Flip so that correlation implements both modes.
        if not corr and up == 1:
            corr = True
            kernel = torch.flip(kernel, (0, 1))
        elif corr and up != 1:
            corr = False
            kernel = torch.flip(kernel, (0, 1))
        pad = same_padding_for_kernel(self.kernel_size, corr, (up, up))
        x = reflect_pad(x, pad)
        if up == 1:
            out = F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=down)
        else:
            # The input dilated by ``up``, padded (k-1-p_lo, k-1-p_hi+up-1)
            # with p = pad*up + same-padding offsets (negative values
            # crop), correlated with the twice-flipped kernel.
            pads = []
            for i in range(2):
                k = self.kernel_size[i]
                p_lo = pad[i][0] * up + k // 2
                p_hi = pad[i][1] * up + (k - 1) // 2
                pads.append((k - 1 - p_lo, k - 1 - p_hi + up - 1))
            n, c, h, w = x.shape
            dil = x.new_zeros((n, c, (h - 1) * up + 1, (w - 1) * up + 1))
            dil[:, :, ::up, ::up] = x
            (h_lo, h_hi), (w_lo, w_hi) = pads
            dil = F.pad(dil, (w_lo, w_hi, h_lo, h_hi))
            kernel = torch.flip(kernel, (0, 1))
            out = F.conv2d(dil, kernel.permute(3, 2, 0, 1))
            if down > 1:
                out = out[:, :, ::down, ::down]
        if self.bias is not None:
            out = out + self.bias[None, :, None, None]
        return out
