"""Weight-normalised convolutions with data-dependent init and the
autoregressive convolutions of the IAF posterior (port of
rec_tpu/models/modules.py: ``ReparameterizedConv2D``,
``ReparameterizedConv2DTranspose``, ``linear_ar_mask``, ``conv_ar_mask``
and ``AutoRegressiveMultiConv2D``).

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

A masked convolution (``mask="a"`` or ``"b"``) multiplies the normalised
kernel by the autoregressive mask, so the norm counts the weights the mask
zeroes, as in ``rec_tpu``; the masks are built in ``rec_tpu``'s HWIO layout
and transposed to OIHW.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
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


def linear_ar_mask(n_in: int, n_out: int,
                   zerodiagonal: bool = False) -> np.ndarray:
    """(n_in, n_out) mask: output group j sees input groups <= j (< j with
    ``zerodiagonal``); one width must divide the other."""
    if not (n_in % n_out == 0 or n_out % n_in == 0):
        raise ValueError(f"AR mask widths {n_in}, {n_out}: one must divide "
                         "the other")
    mask = np.ones([n_in, n_out], dtype=np.float32)
    if n_out >= n_in:
        k = n_out // n_in
        for i in range(n_in):
            mask[i + 1:, i * k:(i + 1) * k] = 0
            if zerodiagonal:
                mask[i:i + 1, i * k:(i + 1) * k] = 0
    else:
        k = n_in // n_out
        for i in range(n_out):
            mask[(i + 1) * k:, i:i + 1] = 0
            if zerodiagonal:
                mask[i * k:(i + 1) * k, i:i + 1] = 0
    return mask


def conv_ar_mask(h: int, w: int, n_in: int, n_out: int,
                 zerodiagonal: bool = False) -> np.ndarray:
    """HWIO mask of an (h, w) kernel: rows above the centre and the centre
    row left of the centre pass, the centre tap is ``linear_ar_mask``;
    "a" = ``zerodiagonal`` (strictly causal), "b" = includes self."""
    l, m = (h - 1) // 2, (w - 1) // 2
    mask = np.ones([h, w, n_in, n_out], dtype=np.float32)
    mask[:l] = 0
    mask[l, :m] = 0
    mask[l, m] = linear_ar_mask(n_in, n_out, zerodiagonal)
    return mask


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalise an OIHW kernel over (I, H, W) per output channel."""
    return v * torch.rsqrt(torch.sum(torch.square(v), dim=(1, 2, 3),
                                     keepdim=True) + eps)


class _WeightNormConv(nn.Module):
    def __init__(self, in_ch: int, features: int,
                 kernel_size: Tuple[int, int], strides: Tuple[int, int],
                 use_bias: bool, init_scale: float,
                 generator: Optional[torch.Generator],
                 mask: Optional[str] = None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.init_scale = init_scale
        self.v = nn.Parameter(0.05 * torch.randn(
            (features, in_ch) + self.kernel_size, generator=generator))
        self.log_scale = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        if mask not in (None, "a", "b"):
            raise ValueError(f"mask must be None, 'a' or 'b', got {mask!r}")
        if mask is not None:
            hwio = conv_ar_mask(*self.kernel_size, in_ch, features,
                                zerodiagonal=mask == "a")
            mask = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy())
        self.register_buffer("mask", mask, persistent=False)
        # Set by the owner for the data-dependent init pass.
        self.ddi = False

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _l2_normalize(self.v)
        if self.mask is not None:
            w = w * self.mask
        out = self._conv(x, w)
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
    """Weight-norm conv, XLA "SAME" padding; ``mask`` None, "a" or "b"
    makes it autoregressive over channels."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size=(3, 3), strides=(1, 1), use_bias: bool = True,
                 init_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 mask: Optional[str] = None):
        super().__init__(in_ch, features, kernel_size, strides, use_bias,
                         init_scale, generator, mask)

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


class AutoRegressiveMultiConv2D(nn.Module):
    """The IAF posterior's masked multi-conv: "b"-masked convolutions (the
    context added after the first), each followed by elu, then one
    "a"-masked head per entry of ``head_features``.  Output channel j of a
    head depends on input channels < j only (in groups, where the widths
    differ)."""

    def __init__(self, in_ch: int, convolution_features: Sequence[int],
                 head_features: Sequence[int], kernel_size=(3, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        convs = []
        for feats in convolution_features:
            convs.append(ReparameterizedConv2D(in_ch, feats, kernel_size,
                                               generator=generator,
                                               mask="b"))
            in_ch = feats
        for i, conv in enumerate(convs):
            self.add_module(f"conv_{i}", conv)
        self.n_convs = len(convs)
        for i, feats in enumerate(head_features):
            self.add_module(f"head_{i}", ReparameterizedConv2D(
                in_ch, feats, kernel_size, generator=generator, mask="a"))
        self.n_heads = len(head_features)

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> List[torch.Tensor]:
        for i in range(self.n_convs):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = x + context
            x = F.elu(x)
        return [getattr(self, f"head_{i}")(x) for i in range(self.n_heads)]
