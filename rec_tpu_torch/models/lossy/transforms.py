"""Ballé-style analysis and synthesis stacks shared by the lossy VAEs (port
of rec_tpu/models/lossy/transforms.py).

Every module here is NCHW and names its sub-modules as flax does
(``conv_0``, ``gdn_0``, ``posterior_loc_head``, ...), so a flax params tree
maps onto the state dict by a walk (``convert.py``).  Weights are drawn
from the ``torch.Generator`` the model passes down, with flax's
initialisers: variance-scaling kernels, zero biases and prior base.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..signal import GDN, SignalConv2D


def softplus_scale(log_scale: torch.Tensor) -> torch.Tensor:
    """Positive scale with the reference's 1e-7 floor."""
    return F.softplus(log_scale) + 1e-7


def _down(in_ch, features, kernel, stride, generator, use_bias=True,
          dft=True):
    return SignalConv2D(in_ch, features, kernel=(kernel, kernel), corr=True,
                        strides_down=stride, use_bias=use_bias,
                        dft_parametrization=dft, generator=generator)


def _up(in_ch, features, kernel, stride, generator, use_bias=True,
        dft=True):
    return SignalConv2D(in_ch, features, kernel=(kernel, kernel),
                        corr=False, strides_up=stride, use_bias=use_bias,
                        dft_parametrization=dft, generator=generator)


class AnalysisTransform(nn.Module):
    """(down-sampling SignalConv + GDN) per stage, then the posterior loc
    and log-scale heads at the head's geometry."""

    def __init__(self, in_ch: int, num_filters: int,
                 stages: Sequence[Tuple[int, int]] = ((5, 2),) * 3,
                 head_kernel: int = 5, head_stride: int = 2,
                 head_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_stages = len(stages)
        ch = in_ch
        for i, (k, s) in enumerate(stages):
            self.add_module(f"conv_{i}", _down(ch, num_filters, k, s,
                                               generator))
            self.add_module(f"gdn_{i}", GDN(num_filters))
            ch = num_filters
        self.posterior_loc_head = _down(ch, num_filters, head_kernel,
                                        head_stride, generator, head_bias)
        self.posterior_log_scale_head = _down(ch, num_filters, head_kernel,
                                              head_stride, generator,
                                              head_bias)

    def forward(self, x):
        for i in range(self.n_stages):
            x = getattr(self, f"gdn_{i}")(getattr(self, f"conv_{i}")(x))
        return self.posterior_loc_head(x), self.posterior_log_scale_head(x)


class SynthesisTransform(nn.Module):
    """(up-sampling SignalConv + inverse GDN) per stage, then the output
    conv to ``out_channels``."""

    def __init__(self, in_ch: int, num_filters: int,
                 stages: Sequence[Tuple[int, int]] = ((5, 2),) * 3,
                 final_kernel: int = 5, final_stride: int = 2,
                 out_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_stages = len(stages)
        ch = in_ch
        for i, (k, s) in enumerate(stages):
            self.add_module(f"conv_{i}", _up(ch, num_filters, k, s,
                                             generator))
            self.add_module(f"igdn_{i}", GDN(num_filters, inverse=True))
            ch = num_filters
        self.conv_out = _up(ch, out_channels, final_kernel, final_stride,
                            generator)

    def forward(self, x):
        for i in range(self.n_stages):
            x = getattr(self, f"igdn_{i}")(getattr(self, f"conv_{i}")(x))
        return self.conv_out(x)


class HyperAnalysisTransform(nn.Module):
    """(3,3)/s1 + relu + (5,5)/s2 + relu, then bias-free (5,5)/s2 heads."""

    def __init__(self, in_ch: int, num_filters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_0 = _down(in_ch, num_filters, 3, 1, generator)
        self.conv_1 = _down(num_filters, num_filters, 5, 2, generator)
        self.posterior_loc_head = _down(num_filters, num_filters, 5, 2,
                                        generator, use_bias=False)
        self.posterior_log_scale_head = _down(num_filters, num_filters, 5, 2,
                                              generator, use_bias=False)

    def forward(self, x):
        x = F.relu(self.conv_0(x))
        x = F.relu(self.conv_1(x))
        return self.posterior_loc_head(x), self.posterior_log_scale_head(x)


class HyperSynthesisTransform(nn.Module):
    """2x ((5,5)/s2 up + relu), then (3,3) prior heads; plain kernels (no
    DFT parametrisation)."""

    def __init__(self, in_ch: int, num_filters: int,
                 num_output_filters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_0 = _up(in_ch, num_filters, 5, 2, generator, dft=False)
        self.conv_1 = _up(num_filters, num_filters, 5, 2, generator,
                          dft=False)
        self.prior_loc_head = _up(num_filters, num_output_filters, 3, 1,
                                  generator, dft=False)
        self.prior_log_scale_head = _up(num_filters, num_output_filters, 3, 1,
                                        generator, dft=False)

    def forward(self, x):
        x = F.relu(self.conv_0(x))
        x = F.relu(self.conv_1(x))
        return self.prior_loc_head(x), self.prior_log_scale_head(x)


class EmpiricalPrior(nn.Module):
    """A learned spatially constant prior: a (F,) base tiled to the latent
    grid, conv + elu, then the loc and log-scale heads; with
    ``return_features`` also the elu'd features (the 4-level model's
    hyperprior)."""

    def __init__(self, num_filters: int,
                 generator: Optional[torch.Generator] = None,
                 return_features: bool = False):
        super().__init__()
        self.num_filters = num_filters
        self.return_features = return_features
        self.prior_base = nn.Parameter(torch.zeros(num_filters))
        self.prior_conv = _down(num_filters, num_filters, 3, 1, generator)
        self.prior_loc_head = _down(num_filters, num_filters, 3, 1,
                                    generator)
        self.prior_log_scale_head = _down(num_filters, num_filters, 3, 1,
                                          generator)

    def forward(self, batch: int, height: int, width: int):
        t = self.prior_base[None, :, None, None].expand(
            batch, self.num_filters, height, width)
        t = F.elu(self.prior_conv(t))
        if self.return_features:
            return self.prior_loc_head(t), self.prior_log_scale_head(t), t
        return self.prior_loc_head(t), self.prior_log_scale_head(t)


class Conv1x1(nn.Module):
    """flax's ``nn.Conv`` with a (1, 1) kernel: ``kernel`` (out, in, 1, 1)
    from a truncated LeCun normal, zero ``bias``."""

    def __init__(self, in_ch: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = math.sqrt(1.0 / in_ch) / 0.87962566103423978
        kernel = torch.empty(features, in_ch, 1, 1)
        nn.init.trunc_normal_(kernel, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.conv2d(x, self.kernel, self.bias)
