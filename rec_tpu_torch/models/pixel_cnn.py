"""Masked-convolution residual PixelCNN (port of rec_tpu/models/pixel_cnn.py).

A 7x7 mask-"a" first convolution, residual blocks of mask-"b" 1x1 -> 3x3
-> 1x1 convolutions (elu before each, the branch scaled by 0.1) and two 1x1
mask-"b" heads: per-pixel parameters of a discretized logistic, ``loc`` =
tanh(head) / 2 and ``log_scale`` clipped to [-7, 2].  Images are NHWC in
[-0.5, 0.5] at the public functions; the convolutions run NCHW inside.

``sample`` generates one channel per step in the masks' AR order (rows
from H-1 down, columns from W-1 down, channels ascending), with
``rec_tpu``'s draws: the scan's key chain (``rng.split_chain``) and
``jax.random.uniform(sub, (), 1e-5, 1 - 1e-5)`` (``rng.uniform``), turned
into logistic noise with XLA-CPU's float32 log and log1p.  Each step runs
the whole forward, as ``rec_tpu``'s scan does; the normalised, masked
kernels are computed once per call (the same bits as the forward's).  A
forward that rounds differently (another device, another package) can
move a value across a quantisation bin edge, and the samples then part
there: ``parted_steps`` and ``edge_distance`` find such steps, and
``replay_values`` gives each step's draw given another sample's earlier
pixels, from one forward.

Fresh weights come from a ``torch.Generator`` seeded by ``seed`` (``v``
~ N(0, 0.05^2), not flax's draws); ``data_dependent_init`` then sets every
``log_scale`` and ``bias`` from a first batch, as flax's init does, or
``pixel_cnn_convert.load_flax_params`` imports a flax params tree.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..coding import rng
from ..device import resolve_device, set_deterministic
from ..ops.threefry_normal import _log1p_f32, _log_f32
from .likelihoods import discretized_logistic
from .modules import ReparameterizedConv2D

# The sampler's uniform range and its quantisation to 8-bit bins.
U_MIN, U_MAX = 1e-5, 1 - 1e-5
BINS = 256.0

Kernels = Optional[Dict[nn.Module, torch.Tensor]]


def _conv(m: ReparameterizedConv2D, x: torch.Tensor, kernels: Kernels):
    return m(x, None if kernels is None else kernels[m])


class PixelCNNResidualBlock(nn.Module):
    """elu -> 1x1 -> elu -> 3x3 -> elu -> 1x1, all mask "b", + 0.1 of the
    branch; ``in_ch`` -> ``filters`` -> ``filters`` ->
    ``filters * residual_filter_factor`` channels."""

    def __init__(self, in_ch: int, filters: int,
                 residual_filter_factor: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [(filters, (1, 1)), (filters, (3, 3)),
                (filters * residual_filter_factor, (1, 1))]
        for i, (f, k) in enumerate(dims):
            self.add_module(f"conv_{i}", ReparameterizedConv2D(
                in_ch, f, k, generator=generator, mask="b"))
            in_ch = f

    def forward(self, x: torch.Tensor, kernels: Kernels = None
                ) -> torch.Tensor:
        t = x
        for i in range(3):
            t = _conv(getattr(self, f"conv_{i}"), F.elu(t), kernels)
        return x + 0.1 * t


class PixelCNN(nn.Module):
    """Autoregressive density over (H, W, in_ch) images in [-0.5, 0.5].

    ``filters`` must be divisible by ``in_ch`` (the AR masks split the
    features into channel groups); the blocks run at ``filters // 2``."""

    def __init__(self, in_ch: int, filters: int = 60,
                 num_residual_blocks: int = 5, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if filters % in_ch != 0:
            raise ValueError(
                f"PixelCNN filters ({filters}) must be divisible by the "
                f"channel count ({in_ch}) for the autoregressive masks")
        g = torch.Generator().manual_seed(int(seed))
        self.in_ch = in_ch
        self.num_residual_blocks = num_residual_blocks
        self.first_conv = ReparameterizedConv2D(in_ch, filters, (7, 7),
                                                generator=g, mask="a")
        for i in range(num_residual_blocks):
            self.add_module(f"res_block_{i}", PixelCNNResidualBlock(
                filters, filters // 2, generator=g))
        # Mask "b" heads: output channel i reads feature groups <= i, which
        # after the mask-"a" first layer carry input channels < i only.
        self.loc_head = ReparameterizedConv2D(filters, in_ch, (1, 1),
                                              generator=g, mask="b")
        self.log_scale_head = ReparameterizedConv2D(filters, in_ch, (1, 1),
                                                    generator=g, mask="b")
        self.device = resolve_device(device)
        self.to(self.device)
        self.initialized = False

    def _enter(self):
        if not self.initialized:
            raise RuntimeError(
                "run data_dependent_init (or load converted weights) first")
        if self.device.type == "cuda":
            set_deterministic()

    def _forward(self, x: torch.Tensor, kernels: Kernels = None):
        """NCHW image -> NCHW (loc, log_scale)."""
        t = _conv(self.first_conv, x, kernels)
        for i in range(self.num_residual_blocks):
            t = getattr(self, f"res_block_{i}")(t, kernels)
        t = F.elu(t)
        loc = _conv(self.loc_head, t, kernels)
        log_scale = _conv(self.log_scale_head, t, kernels)
        return torch.tanh(loc) * 0.5, torch.clamp(log_scale, -7.0, 2.0)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loc, log_scale) of each pixel's conditional discretized
        logistic, NHWC like ``x`` (B, H, W, in_ch)."""
        self._enter()
        return self._forward_nhwc(x)

    def _forward_nhwc(self, x: torch.Tensor):
        loc, log_scale = self._forward(x.permute(0, 3, 1, 2))
        return loc.permute(0, 2, 3, 1), log_scale.permute(0, 2, 3, 1)

    def log_likelihood(self, x: torch.Tensor) -> torch.Tensor:
        """Per-image log likelihood in nats (B,)."""
        loc, log_scale = self(x)
        return discretized_logistic(x, loc, torch.exp(log_scale))

    @torch.no_grad()
    def data_dependent_init(self, x: torch.Tensor):
        """Set every convolution's log_scale and bias from its output's
        statistics on this first batch (the flax init pass), with the
        forward's fixed numerics on the card.  Returns the forward's
        outputs."""
        if self.device.type == "cuda":
            set_deterministic()
        convs = self._convs()
        for m in convs:
            m.ddi = True
        try:
            out = self._forward_nhwc(x)
        finally:
            for m in convs:
                m.ddi = False
        self.initialized = True
        return out

    def _convs(self):
        return [m for m in self.modules()
                if isinstance(m, ReparameterizedConv2D)]

    def _noise(self, key: torch.Tensor, n: int) -> torch.Tensor:
        """Each step's logistic noise log(u) - log1p(-u), (n,)."""
        u = rng.uniform(rng.split_chain(key.to(self.device), n), 1,
                        minval=U_MIN, maxval=U_MAX)[:, 0]
        return _log_f32(u) - _log1p_f32(-u)

    def _check_shape(self, shape):
        if len(shape) != 3 or shape[-1] != self.in_ch:
            raise ValueError(f"sample shape {tuple(shape)}: the model has "
                             f"{self.in_ch} channels")

    @torch.no_grad()
    def sample_values(self, key: torch.Tensor, shape: Tuple[int, int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sample`` and the value each step drew before quantisation, in
        AR order: ((H, W, C) image, (H * W * C,) float32)."""
        self._enter()
        self._check_shape(shape)
        H, W, C = shape
        noise = self._noise(key, H * W * C)
        kernels = {m: m.kernel() for m in self._convs()}
        img = torch.zeros((1, C, H, W), device=self.device)
        values = torch.empty(H * W * C, device=self.device)
        for i, k, r, c in _steps(H, W, C):
            loc, log_scale = self._forward(img, kernels)
            values[i], img[0, k, r, c] = _draw(loc[0, k, r, c],
                                               log_scale[0, k, r, c],
                                               noise[i])
        return img[0].permute(1, 2, 0), values

    def sample(self, key: torch.Tensor, shape: Tuple[int, int, int]
               ) -> torch.Tensor:
        """One (H, W, C) image from key (2,) (``rng.root_key``), JAX's
        ``PixelCNN.sample(key, shape)`` step for step."""
        return self.sample_values(key, shape)[0]

    @torch.no_grad()
    def replay_values(self, key: torch.Tensor, img: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """What each step of ``sample(key, img.shape)`` draws when every
        step before it drew ``img``'s pixel, from one forward of ``img``:
        ((H, W, C) image of the drawn pixels, (H * W * C,) values in AR
        order), with the sampler's own operations.  The masks hide a
        step's own and later pixels from its output; where the
        convolutions add the masked products' zeros exactly (the CPU's
        do), each step's value is the sampler's bit for bit, so the
        pixels equal ``img`` wherever the sampler, given ``img``'s earlier
        pixels, would draw ``img``'s."""
        self._enter()
        self._check_shape(img.shape)
        H, W, C = img.shape
        x = img.to(self.device, torch.float32).permute(2, 0, 1)[None]
        loc, log_scale = self._forward(x)
        noise = self._noise(key, H * W * C)
        out = torch.empty((C, H, W), device=self.device)
        values = torch.empty(H * W * C, device=self.device)
        for i, k, r, c in _steps(H, W, C):
            values[i], out[k, r, c] = _draw(loc[0, k, r, c],
                                            log_scale[0, k, r, c], noise[i])
        return out.permute(1, 2, 0), values


def _steps(H: int, W: int, C: int):
    """(step, channel, row, column) in the AR order: rows from H-1 down,
    columns from W-1 down, channels ascending."""
    for i in range(H * W * C):
        pix, k = divmod(i, C)
        yield i, k, H - 1 - pix // W, W - 1 - pix % W


def _draw(loc, log_scale, noise):
    """One step's logistic value and its quantised pixel (0-dim)."""
    val = loc + torch.exp(log_scale) * noise
    return val, torch.clamp(torch.floor((val + 0.5) * BINS) / BINS - 0.5,
                            -0.5, 0.5 - 1.0 / BINS)


def _ar_order(img) -> torch.Tensor:
    """An (H, W, C) image's values in the sampler's AR order."""
    t = (img.cpu() if isinstance(img, torch.Tensor)
         else torch.from_numpy(np.array(img)))
    return t.flip(0).flip(1).reshape(-1)


def parted_steps(a, b) -> list:
    """The AR-order steps at which two (H, W, C) images differ."""
    return torch.nonzero(_ar_order(a) != _ar_order(b))[:, 0].tolist()


def edge_distance(value) -> float:
    """Distance of a drawn value from the nearest quantisation bin edge, in
    bins: |(v + 0.5) * 256 - round(...)| in float32.  Two draws whose
    values differ by ~1e-7 quantise apart only where this is ~1e-5."""
    x = (torch.as_tensor(value, dtype=torch.float32).cpu() + 0.5) * BINS
    return float(torch.abs(x - torch.round(x)))
