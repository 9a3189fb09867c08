"""Weight-normalised convolutions with data-dependent init (port of
rec_tpu/models/modules.py, ``ReparameterizedConv2D`` and
``ReparameterizedConv2DTranspose``).

kernel = l2_normalize(v over (H, W, I)) * exp(log_scale) per output channel,
plus a bias; on the first batch, ``log_scale`` = clip(log(init_scale /
std(out)), -4.6, 4.6) and ``bias`` = -mean(out) from the normalised-kernel
output's per-channel statistics.

Modules take and return NCHW tensors; the models convert at their public
functions, which keep ``rec_tpu``'s NHWC.  Padding follows XLA's "SAME"
rule, which pads the 5x5 stride-2 convolution asymmetrically (low 1, high 2),
so it is applied with ``F.pad``.  ``lax.conv_transpose`` does not flip the
kernel, so the transposed convolution is written as XLA lowers it: the input
dilated by the stride, padded, and correlated with the kernel as stored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """``lax._conv_transpose_padding`` for "SAME"."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalise an OIHW kernel over (I, H, W) per output channel."""
    return v * torch.rsqrt(torch.sum(torch.square(v), dim=(1, 2, 3),
                                     keepdim=True) + eps)


class _WeightNormConv(nn.Module):
    def __init__(self, in_ch: int, features: int,
                 kernel_size: Tuple[int, int], strides: Tuple[int, int],
                 use_bias: bool, init_scale: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.init_scale = init_scale
        self.v = nn.Parameter(0.05 * torch.randn(
            (features, in_ch) + self.kernel_size, generator=generator))
        self.log_scale = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        # Set by the owner for the data-dependent init pass.
        self.ddi = False

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._conv(x, _l2_normalize(self.v))
        if self.ddi:
            with torch.no_grad():
                var = torch.var(out, dim=(0, 2, 3), unbiased=False)
                self.log_scale.copy_(torch.clamp(
                    torch.log(self.init_scale * torch.rsqrt(var + 1e-10)),
                    -4.6, 4.6))
        out = out * torch.exp(self.log_scale)[None, :, None, None]
        if self.bias is not None:
            if self.ddi:
                with torch.no_grad():
                    self.bias.copy_(-torch.mean(out, dim=(0, 2, 3)))
            out = out + self.bias[None, :, None, None]
        return out


class ReparameterizedConv2D(_WeightNormConv):
    """Weight-norm conv, XLA "SAME" padding."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size=(3, 3), strides=(1, 1), use_bias: bool = True,
                 init_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, features, kernel_size, strides, use_bias,
                         init_scale, generator)

    def _conv(self, x, w):
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        ph = _same_pads(x.shape[2], kh, sh)
        pw = _same_pads(x.shape[3], kw, sw)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, stride=self.strides)


class ReparameterizedConv2DTranspose(_WeightNormConv):
    """Weight-norm transposed conv (``lax.conv_transpose``, "SAME", kernel
    not flipped); the kernel is stored OIHW with I = input channels."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size=(5, 5), strides=(2, 2), use_bias: bool = True,
                 init_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, features, kernel_size, strides, use_bias,
                         init_scale, generator)

    def _conv(self, x, w):
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        n, c, h, wd = x.shape
        dil = x.new_zeros((n, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
        dil[:, :, ::sh, ::sw] = x
        ph, pw = _transpose_pads(kh, sh), _transpose_pads(kw, sw)
        dil = F.pad(dil, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(dil, w)
