"""Large ResNet VAE — the lossless model for Kodak- and CLIC-sized images
(port of rec_tpu/models/large_resnet_vae.py).

Two stochastic bidirectional blocks behind aggressive down-sampling:

    x --[4x (5,5)/s2 conv + GDN]--> /16 --[res block 1: 128 stochastic]-->
      --[(3,3)/s1 + 2x (5,5)/s2 conv + elu]--> /64 --[res block 2: 32]-->

and the generative pass back up from a learned base at /64.  The blocks are
the RVAE's ``InferBlock``/``GenBlock`` used standalone with one res block
each; the stacks are ``SignalConv2D`` and ``GDN`` (``signal.py``), or the
weight-norm convolutions with ``use_sig_convs=False``.  The module names
are flax's, so ``large_convert.py`` maps the weights both ways.

Group order, as ``rec_tpu`` has it:
* the training forward's noise is (block 2's, block 1's) — generative,
  top-down order, the order of ``posterior_prior_pairs`` and of the coded
  latents;
* ``kld_channelwise`` is block 1's channels then block 2's, and
  ``analytic_kl``/``empirical_kld`` are stacked (2, B) with block 1 first,
  the layouts the lossless trainer's free bits read;
* ``compress`` codes block 2 with ``seed + 7919``, then block 1 with
  ``seed``, and returns the latents top-down, ``[block 2, block 1]``.

Five likelihoods: the discretized logistic (the reconstruction clipped
again), a gaussian and a laplace over 255-scaled pixels with their
normalisers, MS-SSIM with unit weights (H, W >= 176), and 0.84 MS-SSIM +
0.16 laplace of a blurred error.  The scale is ``lower_bound(exp(log
scale), 1/512)`` with ``rec_tpu``'s gradient.  Images, latents and
reconstructions are NHWC at the public functions; ``compress`` and
``decompress`` take one image, as ``rec_tpu``'s do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..coding import Coder
from ..device import resolve_device, set_deterministic
from ..utils.logging import gaussian_blur
from ..utils.metrics import ms_ssim
from ..utils.profiling import span
from .likelihoods import discretized_logistic
from .modules import ReparameterizedConv2D, ReparameterizedConv2DTranspose
from .resnet_vae import (GenBlock, InferBlock, ResNetVAEConfig, _nchw,
                         _nhwc, noise_variates)
from .signal import GDN, SignalConv2D, lower_bound

LIKELIHOODS = ("discretized_logistic", "gaussian", "laplace", "ms-ssim",
               "ms-ssim-laplace")
_CLIP = 0.5 - 1.0 / 512.0


@dataclasses.dataclass(frozen=True)
class LargeResNetVAEConfig:
    first_deterministic_filters: int = 160
    second_deterministic_filters: int = 160
    first_stochastic_filters: int = 128
    second_stochastic_filters: int = 32
    kernel_size: Tuple[int, int] = (3, 3)
    use_gdn: bool = True
    use_sig_convs: bool = True
    likelihood: str = "discretized_logistic"
    likelihood_log_scale_init: float = 0.0


class _DownStack(nn.Module):
    """``stages`` of (5,5)/s2 conv + GDN-or-elu, after an optional (3,3)
    conv + elu."""

    def __init__(self, in_ch: int, filters: int, stages: int, use_gdn: bool,
                 use_sig: bool, lead_3x3: bool = False, generator=None):
        super().__init__()

        def conv(i, o, k, s):
            if use_sig:
                return SignalConv2D(i, o, (k, k), corr=True, strides_down=s,
                                    generator=generator)
            return ReparameterizedConv2D(i, o, (k, k), (s, s),
                                         generator=generator)

        self.conv_pre = conv(in_ch, filters, 3, 1) if lead_3x3 else None
        in_ch = filters if lead_3x3 else in_ch
        self.stages = stages
        self.use_gdn = use_gdn
        for i in range(stages):
            self.add_module(f"conv_{i}", conv(in_ch, filters, 5, 2))
            if use_gdn:
                self.add_module(f"gdn_{i}", GDN(filters))
            in_ch = filters

    def forward(self, x):
        if self.conv_pre is not None:
            x = F.elu(self.conv_pre(x))
        for i in range(self.stages):
            x = getattr(self, f"conv_{i}")(x)
            x = getattr(self, f"gdn_{i}")(x) if self.use_gdn else F.elu(x)
        return x


class _UpStack(nn.Module):
    """``stages`` of (5,5)/s2 up-sampling conv, each but the last followed
    by inverse GDN or elu (the last one too when a (3,3) tail conv ends the
    stack); the last conv gives ``out_filters``."""

    def __init__(self, in_ch: int, filters: int, stages: int,
                 out_filters: int, use_gdn: bool, use_sig: bool,
                 tail_3x3: bool = False, generator=None):
        super().__init__()

        def conv(i, o, k, s):
            if use_sig:
                return SignalConv2D(i, o, (k, k), corr=False, strides_up=s,
                                    generator=generator)
            return ReparameterizedConv2DTranspose(i, o, (k, k), (s, s),
                                                  generator=generator)

        self.stages = stages
        self.use_gdn = use_gdn
        self.last = stages - 1 if not tail_3x3 else None
        for i in range(stages):
            feats = out_filters if i == self.last else filters
            self.add_module(f"conv_{i}", conv(in_ch, feats, 5, 2))
            if i != self.last and use_gdn:
                self.add_module(f"igdn_{i}", GDN(filters, inverse=True))
            in_ch = feats
        self.conv_tail = (conv(filters, out_filters, 3, 1) if tail_3x3
                          else None)

    def forward(self, x):
        for i in range(self.stages):
            x = getattr(self, f"conv_{i}")(x)
            if i != self.last:
                x = (getattr(self, f"igdn_{i}")(x) if self.use_gdn
                     else F.elu(x))
        if self.conv_tail is not None:
            x = self.conv_tail(x)
        return x


class LargeResNetVAE(nn.Module):
    """The large lossless VAE (ref large_resnet_vae_new.py)."""

    def __init__(self, cfg: LargeResNetVAEConfig = LargeResNetVAEConfig(),
                 coder: Optional[Coder] = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if cfg.likelihood not in LIKELIHOODS:
            raise ValueError(f"likelihood must be one of {LIKELIHOODS}, got "
                             f"{cfg.likelihood!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.coder = coder
        g = torch.Generator().manual_seed(int(seed))
        det1, det2 = (cfg.first_deterministic_filters,
                      cfg.second_deterministic_filters)
        self.block_cfgs = [ResNetVAEConfig(
            num_res_blocks=1, deterministic_filters=det,
            stochastic_filters=sto, kernel_size=cfg.kernel_size)
            for det, sto in ((det1, cfg.first_stochastic_filters),
                             (det2, cfg.second_stochastic_filters))]
        sig = cfg.use_sig_convs
        self.first_infer_block = _DownStack(3, det1, 4, cfg.use_gdn, sig,
                                            generator=g)
        self.first_gen_block = _UpStack(det1, det1, 4, 3, cfg.use_gdn, sig,
                                        generator=g)
        self.second_infer_block = _DownStack(det1, det2, 2, False, sig,
                                             lead_3x3=True, generator=g)
        self.second_gen_block = _UpStack(det2, det2, 2, det1, False, sig,
                                         tail_3x3=True, generator=g)
        c1, c2 = self.block_cfgs
        self.infer_block_1 = InferBlock(c1, g)
        self.infer_block_2 = InferBlock(c2, g)
        self.gen_block_1 = GenBlock(c1, g)
        self.gen_block_2 = GenBlock(c2, g)
        self.generative_base = nn.Parameter(
            0.1 * torch.randn((det2,), generator=g))
        self.likelihood_log_scale = nn.Parameter(
            torch.tensor(float(cfg.likelihood_log_scale_init)))
        self.initialized = False
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.generative_base.device

    def _enter(self):
        if not self.initialized:
            raise RuntimeError(
                "run data_dependent_init (or load converted weights) first")
        if self.device.type == "cuda":
            set_deterministic()

    def latent_shapes(self, height: int, width: int) -> List[tuple]:
        """(h, w, channels) of block 2's and block 1's latents of an image,
        top-down: the noise's and the coded latents' order."""
        c1, c2 = self.block_cfgs
        return [(height // 64, width // 64, c2.stochastic_filters),
                (height // 16, width // 16, c1.stochastic_filters)]

    # -- likelihood -------------------------------------------------------

    def _log_likelihood(self, reference, reconstruction):
        """Per-image log likelihood (B,) of NHWC images in [-0.5, 0.5]."""
        c = self.cfg
        # Floored at half a quantisation bin, with rec_tpu's gradient.
        scale = lower_bound(torch.exp(self.likelihood_log_scale),
                            1.0 / 512.0)
        num_dims = float(reference.shape[1] * reference.shape[2]
                         * reference.shape[3])

        def laplace(blur=False):
            lp = torch.abs(reconstruction - reference) / scale
            if blur:
                lp = gaussian_blur(lp, kernel_size=11, sigma=8.0)
            return (-torch.sum(lp, dim=(1, 2, 3)) * 255.0
                    - num_dims * torch.log(2.0 * scale))

        def msssim_ll():
            v = ms_ssim(reference + 0.5, reconstruction + 0.5, max_val=1.0,
                        weights=(1.0, 1.0, 1.0, 1.0, 1.0))
            return (v - 1.0) * num_dims * 255.0

        if c.likelihood == "discretized_logistic":
            recon = torch.clamp(reconstruction, -_CLIP, _CLIP)
            return discretized_logistic(reference, recon, scale)
        if c.likelihood == "gaussian":
            return (-0.5 * torch.sum(
                torch.square(reference - reconstruction) / scale,
                dim=(1, 2, 3)) * 255.0 ** 2
                - 0.5 * num_dims * torch.log(2.0 * math.pi * scale))
        if c.likelihood == "laplace":
            return laplace()
        if c.likelihood == "ms-ssim":
            return msssim_ll()
        alpha = 0.84
        return alpha * msssim_ll() + (1 - alpha) * laplace(blur=True)

    # -- passes (NCHW inside) ---------------------------------------------

    def _base(self, batch, height, width):
        return self.generative_base[None, :, None, None].expand(
            batch, -1, height // 64, width // 64)

    def _infer(self, x):
        """Block 1's and block 2's inference stats of NCHW images."""
        t = self.first_infer_block(x)
        t, stats1 = self.infer_block_1(t)
        _, stats2 = self.infer_block_2(self.second_infer_block(t))
        return stats1, stats2

    def _reconstruct(self, t):
        return _nhwc(torch.clamp(self.first_gen_block(t), -_CLIP, _CLIP))

    def _forward(self, images, noise):
        B, H, W, _ = images.shape
        eps2, eps1 = noise_variates(noise, "gaussian", images.device)
        stats1, stats2 = self._infer(_nchw(images))
        t, out2 = self.gen_block_2.sample(self._base(B, H, W), stats2,
                                          _nchw(eps2))
        t, out1 = self.gen_block_1.sample(self.second_gen_block(t), stats1,
                                          _nchw(eps1))
        recon = self._reconstruct(t)
        return {
            "reconstruction": recon + 0.5,
            "log_likelihood": self._log_likelihood(images, recon),
            "kld_channelwise": torch.cat([out1["kld_channelwise"],
                                          out2["kld_channelwise"]]),
            "analytic_kl": torch.stack([out1["analytic_kl"],
                                        out2["analytic_kl"]]),
            "empirical_kld": torch.stack([out1["empirical_kld"],
                                          out2["empirical_kld"]]),
            "posterior_prior_pairs": ((out2["posterior"], out2["prior"]),
                                      (out1["posterior"], out1["prior"])),
        }

    def forward(self, images: torch.Tensor, noise) -> dict:
        """Training/eval forward pass, differentiable in the weights.
        ``images`` (B, H, W, 3) in [-0.5, 0.5], H and W multiples of 64;
        ``noise`` = the standard normals of block 2's and block 1's
        posterior samples, top-down, each (B, h, w, channels) as
        ``latent_shapes`` gives them (tensors on the images' device or
        arrays).  ``posterior_prior_pairs`` are each block's NHWC
        (posterior, prior), top-down."""
        self._enter()
        return self._forward(images, noise)

    @torch.no_grad()
    def data_dependent_init(self, images: torch.Tensor, noise) -> dict:
        """Set every weight-norm convolution's log_scale and bias from its
        output's statistics on this first batch (the flax init pass).
        On the card it runs with the forward's fixed numerics
        (``set_deterministic``), so fresh weights do not depend on what ran
        before in the process.  A set-up span, ``setup.ddi``."""
        if self.device.type == "cuda":
            set_deterministic()
        convs = [m for m in self.modules() if hasattr(m, "ddi")]
        for m in convs:
            m.ddi = True
        try:
            with span("setup.ddi", card=self.device, setup=True):
                out = self._forward(images, noise)
        finally:
            for m in convs:
                m.ddi = False
        self.initialized = True
        return out

    @torch.no_grad()
    def compress(self, image: torch.Tensor, seed: int) -> dict:
        """REC-encode one image (1, H, W, 3): block 2 with ``seed + 7919``,
        then block 1 with ``seed``.  Returns the reconstruction (1, H, W,
        3) in [0, 1], ``latents`` = [(indices (blocks, P), counts
        (blocks,)) of block 2, of block 1] and the two blocks' KLs, in that
        order.  A root span, ``model.compress``."""
        self._enter()
        B, H, W, _ = image.shape
        if B != 1:
            raise ValueError("compress expects batch size 1")
        with span("model.compress", card=self.device, images=1):
            stats1, stats2 = self._infer(_nchw(image))
            t, coded2, kl2 = self.gen_block_2.encode(
                self._base(1, H, W), stats2, self.coder, [int(seed) + 7919])
            t, coded1, kl1 = self.gen_block_1.encode(
                self.second_gen_block(t), stats1, self.coder, [int(seed)])
            return {"reconstruction": self._reconstruct(t) + 0.5,
                    "latents": [(coded2.indices[0], coded2.counts[0]),
                                (coded1.indices[0], coded1.counts[0])],
                    "kl": torch.cat([kl2, kl1])}

    @torch.no_grad()
    def decompress(self, shape: Sequence[int], latents, seed: int
                   ) -> torch.Tensor:
        """The reconstruction (1, H, W, 3) in [0, 1] from the top-down
        latents ``[(indices, counts) of block 2, of block 1]`` and the
        seed; ``shape`` = (H, W).  A root span, ``model.decompress``."""
        self._enter()
        H, W = shape
        dev = self.device
        with span("model.decompress", card=dev, images=1):
            (ind2, cnt2), (ind1, cnt1) = [
                (torch.as_tensor(i, device=dev)[None],
                 torch.as_tensor(c, device=dev)[None]) for i, c in latents]
            t = self.gen_block_2.decode(self._base(1, H, W), self.coder,
                                        ind2, cnt2, [int(seed) + 7919])
            t = self.gen_block_1.decode(self.second_gen_block(t),
                                        self.coder, ind1, cnt1, [int(seed)])
            return self._reconstruct(t) + 0.5
