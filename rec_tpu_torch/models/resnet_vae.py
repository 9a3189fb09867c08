"""Bidirectional ResNet VAE (RVAE) — the lossless flagship model (port of
rec_tpu/models/resnet_vae.py, gaussian latents without IAF).

* 24 residual blocks, each an inference block (run bottom-up) and a
  generative block (run top-down); generative block g pairs with the
  inference block run N-1-g, as ``rec_tpu`` reverses its inference scan's
  outputs.
* posterior = N(infer_loc + gen_loc, exp(infer_ls + gen_ls)), scale heads
  through ``_bounded_exp``; residual update x + 0.1 f(x); a learned "h_top"
  generative base.
* ``compress``/``decompress`` run the generative pass with the beam-search
  coder per block, block g coding with seed ``seed + 7919 g``.

Images and latents are NHWC at every public function, as in ``rec_tpu``;
the convolutions run NCHW inside.  A latent is flattened in HWC order before
the coder's split permutation — an NCHW flatten would change every stream.
Weights are drawn from a ``torch.Generator`` seeded by the caller, then set
by ``data_dependent_init`` on a first batch (or imported from a flax params
tree, ``convert.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..coding import BeamSearchCoder
from ..coding.gauss import GaussianParams, kl_divergence
from ..device import resolve_device, set_deterministic
from .likelihoods import get_likelihood
from .modules import ReparameterizedConv2D, ReparameterizedConv2DTranspose


@dataclasses.dataclass(frozen=True)
class ResNetVAEConfig:
    num_res_blocks: int = 24
    deterministic_filters: int = 160
    stochastic_filters: int = 32
    kernel_size: Tuple[int, int] = (3, 3)
    first_kernel_size: Tuple[int, int] = (5, 5)
    first_strides: Tuple[int, int] = (2, 2)
    likelihood: str = "discretized_logistic"
    distribution: str = "gaussian"
    use_iaf: bool = False
    output_channels: int = 3


def _bounded_exp(log_scale: torch.Tensor) -> torch.Tensor:
    """Scale head: exp with the log-scale clipped to +-12, so off-
    distribution inputs keep every KL term finite."""
    return torch.exp(torch.clamp(log_scale, -12.0, 12.0))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class InferBlock(nn.Module):
    """One inference-pass block: posterior head stats + residual features."""

    def __init__(self, cfg: ResNetVAEConfig, generator=None):
        super().__init__()
        det, sto, k = (cfg.deterministic_filters, cfg.stochastic_filters,
                       cfg.kernel_size)

        def conv(i, o):
            return ReparameterizedConv2D(i, o, k, generator=generator)

        self.infer_posterior_loc_head = conv(det, sto)
        self.infer_posterior_log_scale_head = conv(det, sto)
        self.infer_conv_0 = conv(det, det)
        self.infer_conv_1 = conv(det, det)

    def forward(self, x):
        h = F.elu(x)
        loc = self.infer_posterior_loc_head(h)
        log_scale = self.infer_posterior_log_scale_head(h)
        t = self.infer_conv_1(F.elu(self.infer_conv_0(h)))
        return x + 0.1 * t, (loc, log_scale)


class GenBlock(nn.Module):
    """One generative-pass block: prior heads, posterior heads, residual."""

    def __init__(self, cfg: ResNetVAEConfig, generator=None):
        super().__init__()
        det, sto, k = (cfg.deterministic_filters, cfg.stochastic_filters,
                       cfg.kernel_size)

        def conv(i, o):
            return ReparameterizedConv2D(i, o, k, generator=generator)

        self.prior_loc_head = conv(det, sto)
        self.prior_log_scale_head = conv(det, sto)
        self.gen_posterior_loc_head = conv(det, sto)
        self.gen_posterior_log_scale_head = conv(det, sto)
        self.gen_conv_0 = conv(det, det)
        self.gen_conv_1 = conv(det + sto, det)

    def prior(self, h) -> GaussianParams:
        return GaussianParams(self.prior_loc_head(h),
                              _bounded_exp(self.prior_log_scale_head(h)))

    def posterior(self, h, infer_loc, infer_log_scale) -> GaussianParams:
        return GaussianParams(
            infer_loc + self.gen_posterior_loc_head(h),
            _bounded_exp(infer_log_scale
                         + self.gen_posterior_log_scale_head(h)))

    def residual(self, x, h, z):
        t = torch.cat([self.gen_conv_0(h), z], dim=1)
        return x + 0.1 * self.gen_conv_1(F.elu(t))


def _hwc(p: GaussianParams) -> GaussianParams:
    """Batch-1 NCHW distribution -> HWC (the coder's flatten order)."""
    return GaussianParams(p.loc[0].permute(1, 2, 0),
                          p.scale[0].permute(1, 2, 0))


class BidirectionalResNetVAE(nn.Module):
    """The full RVAE (ref resnet_vae.py:512-860), gaussian latents."""

    def __init__(self, cfg: ResNetVAEConfig = ResNetVAEConfig(),
                 coder: Optional[BeamSearchCoder] = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if cfg.distribution != "gaussian" or cfg.use_iaf:
            raise NotImplementedError(
                "rec_tpu_torch ports the gaussian RVAE without IAF")
        dev = resolve_device(device)
        self.cfg = cfg
        self.coder = coder
        g = torch.Generator().manual_seed(int(seed))
        det = cfg.deterministic_filters
        self.first_infer_conv = ReparameterizedConv2D(
            cfg.output_channels, det, cfg.first_kernel_size,
            cfg.first_strides, generator=g)
        self.infer_blocks = nn.ModuleList(
            InferBlock(cfg, g) for _ in range(cfg.num_res_blocks))
        self.gen_blocks = nn.ModuleList(
            GenBlock(cfg, g) for _ in range(cfg.num_res_blocks))
        self.last_gen_conv = ReparameterizedConv2DTranspose(
            det, cfg.output_channels, cfg.first_kernel_size,
            cfg.first_strides, generator=g)
        self.generative_base = nn.Parameter(
            0.1 * torch.randn((det,), generator=g))
        self.likelihood_log_scale = nn.Parameter(torch.zeros(()))
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

    def _base(self, batch, height, width):
        sh, sw = self.cfg.first_strides
        return self.generative_base[None, :, None, None].expand(
            batch, -1, height // sh, width // sw)

    def _infer(self, x):
        """Bottom-up pass on NCHW images; per-block (loc, log_scale) in
        generative order."""
        t = self.first_infer_conv(x)
        outs = []
        for blk in self.infer_blocks:
            t, o = blk(t)
            outs.append(o)
        return outs[::-1]

    def _reconstruct(self, t):
        r = self.last_gen_conv(F.elu(t))
        return torch.clamp(r, -0.5 + 1.0 / 512.0, 0.5 - 1.0 / 512.0)

    def _forward(self, images, noise):
        cfg = self.cfg
        B, H, W, _ = images.shape
        infer_outs = self._infer(_nchw(images))
        t = self._base(B, H, W)
        posts, priors, kl_ch, emp, ana = [], [], [], [], []
        for g, blk in enumerate(self.gen_blocks):
            h = F.elu(t)
            prior = blk.prior(h)
            post = blk.posterior(h, *infer_outs[g])
            z = post.loc + post.scale * _nchw(
                torch.as_tensor(noise[g], dtype=torch.float32,
                                device=images.device))
            empirical = post.log_prob(z) - prior.log_prob(z)
            kld = kl_divergence(post, prior)
            kl_ch.append(torch.mean(torch.sum(kld, dim=(2, 3)), dim=0))
            emp.append(torch.sum(empirical, dim=(1, 2, 3)))
            ana.append(torch.sum(kld, dim=(1, 2, 3)))
            posts.append(post)
            priors.append(prior)
            t = blk.residual(t, h, z)
        recon = _nhwc(self._reconstruct(t))
        scale = torch.exp(self.likelihood_log_scale)
        ll = get_likelihood(cfg.likelihood)(images, recon, scale)

        def stack(ps):
            return GaussianParams(torch.stack([_nhwc(p.loc) for p in ps]),
                                  torch.stack([_nhwc(p.scale) for p in ps]))

        return {
            "reconstruction": recon + 0.5,
            "log_likelihood": ll,
            "kld_channelwise": torch.stack(kl_ch),
            "empirical_kld": torch.stack(emp),
            "analytic_kl": torch.stack(ana),
            "posterior": stack(posts),
            "prior": stack(priors),
        }

    def forward(self, images: torch.Tensor, noise) -> dict:
        """Training/eval forward pass.  ``images`` (B, H, W, C) in
        [-0.5, 0.5]; ``noise`` (num_res_blocks, B, H/2, W/2, stochastic)
        standard normals for the posterior samples (NHWC)."""
        self._enter()
        return self._forward(images, noise)

    @torch.no_grad()
    def data_dependent_init(self, images: torch.Tensor, noise) -> dict:
        """Set every convolution's log_scale and bias from the statistics of
        its output on this first batch (the flax init pass)."""
        convs = [m for m in self.modules() if hasattr(m, "ddi")]
        for m in convs:
            m.ddi = True
        try:
            out = self._forward(images, noise)
        finally:
            for m in convs:
                m.ddi = False
        self.initialized = True
        return out

    @torch.no_grad()
    def compress(self, image: torch.Tensor, seed: int) -> dict:
        """REC-encode one image (1, H, W, C).  Returns per-res-block
        indices (N, num_latent_blocks, P), counts (N, num_latent_blocks),
        per-block KLs and the reconstruction (NHWC, in [0, 1])."""
        self._enter()
        B, H, W, _ = image.shape
        if B != 1:
            raise ValueError("compress expects batch size 1")
        infer_outs = self._infer(_nchw(image))
        t = self._base(1, H, W)
        indices, counts, kls = [], [], []
        for g, blk in enumerate(self.gen_blocks):
            h = F.elu(t)
            prior = _hwc(blk.prior(h))
            post = _hwc(blk.posterior(h, *infer_outs[g]))
            coded = self.coder.encode(post, prior, seed + 7919 * g)
            indices.append(coded.indices)
            counts.append(coded.counts)
            kls.append(torch.sum(kl_divergence(post, prior)))
            z = coded.sample.permute(2, 0, 1)[None]
            t = blk.residual(t, h, z)
        return {
            "indices": torch.stack(indices),
            "counts": torch.stack(counts),
            "kl": torch.stack(kls),
            "reconstruction": _nhwc(self._reconstruct(t)) + 0.5,
        }

    @torch.no_grad()
    def decompress(self, shape: Sequence[int], indices, counts,
                   seed: int) -> torch.Tensor:
        """Regenerate the reconstruction (1, H, W, C) in [0, 1] from the
        transmitted (indices, counts, seed); ``shape`` = (H, W)."""
        self._enter()
        H, W = shape
        dev = self.device
        t = self._base(1, H, W)
        for g, blk in enumerate(self.gen_blocks):
            h = F.elu(t)
            prior = _hwc(blk.prior(h))
            z = self.coder.decode(prior, torch.as_tensor(indices[g],
                                                         device=dev),
                                  torch.as_tensor(counts[g], device=dev),
                                  seed + 7919 * g)
            t = blk.residual(t, h, z.permute(2, 0, 1)[None])
        return _nhwc(self._reconstruct(t)) + 0.5


def latents_for_rec(comp: dict) -> List[tuple]:
    """``compress`` output -> the per-res-block (indices, counts) numpy pairs
    that ``io.write_rec`` takes."""
    return [(comp["indices"][g].cpu().numpy(), comp["counts"][g].cpu().numpy())
            for g in range(comp["indices"].shape[0])]
