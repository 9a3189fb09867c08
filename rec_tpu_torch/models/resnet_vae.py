"""Bidirectional ResNet VAE (RVAE) — the lossless flagship model (port of
rec_tpu/models/resnet_vae.py, gaussian latents without IAF).

* 24 residual blocks, each an inference block (run bottom-up) and a
  generative block (run top-down); generative block g pairs with the
  inference block run N-1-g, as ``rec_tpu`` reverses its inference scan's
  outputs.
* posterior = N(infer_loc + gen_loc, exp(infer_ls + gen_ls)), scale heads
  through ``_bounded_exp``; residual update x + 0.1 f(x); a learned "h_top"
  generative base.
* ``compress_batch``/``decompress_batch`` run the generative pass for B
  images with the beam-search coder per res block, block g of image i coding
  with seed ``seeds[i] + 7919 g``: convolutions at batch B, and one
  block-codec call per res block over all images' latent blocks
  (``BeamSearchCoder.encode_batch``).  ``compress``/``decompress`` are the
  canonical single-image programs: the batch programs at B = 1.

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
    learn_likelihood_scale: bool = True
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


def _bhwc(p: GaussianParams) -> GaussianParams:
    """NCHW distribution -> (B, H, W, C): each image in the coder's HWC
    flatten order."""
    return GaussianParams(_nhwc(p.loc), _nhwc(p.scale))


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
        noise = torch.as_tensor(noise, dtype=torch.float32,
                                device=images.device)
        infer_outs = self._infer(_nchw(images))
        t = self._base(B, H, W)
        posts, priors, kl_ch, emp, ana = [], [], [], [], []
        for g, blk in enumerate(self.gen_blocks):
            h = F.elu(t)
            prior = blk.prior(h)
            post = blk.posterior(h, *infer_outs[g])
            z = post.loc + post.scale * _nchw(noise[g])
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
        if not cfg.learn_likelihood_scale:
            scale = scale.detach()
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
        """Training/eval forward pass, differentiable in the weights.
        ``images`` (B, H, W, C) in [-0.5, 0.5]; ``noise`` (num_res_blocks,
        B, H/2, W/2, stochastic) standard normals for the posterior samples
        (NHWC), a tensor on the images' device (used as is) or an array
        (copied there once)."""
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
        """REC-encode one image (1, H, W, C): ``compress_batch`` of one
        image.  Returns per-res-block indices (N, num_latent_blocks, P),
        counts (N, num_latent_blocks), per-block KLs (N,) and the
        reconstruction (1, H, W, C) in [0, 1]."""
        if image.shape[0] != 1:
            raise ValueError("compress expects batch size 1")
        out = self.compress_batch(image, [seed])
        return {k: v if k == "reconstruction" else v[0]
                for k, v in out.items()}

    @torch.no_grad()
    def decompress(self, shape: Sequence[int], indices, counts,
                   seed: int) -> torch.Tensor:
        """Regenerate the reconstruction (1, H, W, C) in [0, 1] from the
        transmitted per-res-block (indices, counts) and seed:
        ``decompress_batch`` of one image; ``shape`` = (H, W)."""
        dev = self.device

        def stack(xs):
            return torch.stack([torch.as_tensor(x, device=dev)
                                for x in xs])[None]

        return self.decompress_batch(shape, stack(indices), stack(counts),
                                     [seed])

    @torch.no_grad()
    def compress_batch(self, images: torch.Tensor, seeds) -> dict:
        """REC-encode B images (B, H, W, C); image i codes res block g with
        seed ``seeds[i] + 7919 g``, the contract of ``compress``.  Returns
        indices (B, N, num_latent_blocks, P), counts (B, N,
        num_latent_blocks), per-block KLs (B, N) and the reconstructions
        (B, H, W, C) in [0, 1]."""
        self._enter()
        B, H, W, _ = images.shape
        seeds = [int(s) for s in seeds]
        if len(seeds) != B:
            raise ValueError(f"{B} images but {len(seeds)} seeds")
        infer_outs = self._infer(_nchw(images))
        t = self._base(B, H, W)
        indices, counts, kls = [], [], []
        for g, blk in enumerate(self.gen_blocks):
            h = F.elu(t)
            prior = _bhwc(blk.prior(h))
            post = _bhwc(blk.posterior(h, *infer_outs[g]))
            coded = self.coder.encode_batch(
                post, prior, [s + 7919 * g for s in seeds])
            indices.append(coded.indices)
            counts.append(coded.counts)
            kls.append(torch.sum(kl_divergence(post, prior), dim=(1, 2, 3)))
            t = blk.residual(t, h, _nchw(coded.sample))
        return {
            "indices": torch.stack(indices, dim=1),
            "counts": torch.stack(counts, dim=1),
            "kl": torch.stack(kls, dim=1),
            "reconstruction": _nhwc(self._reconstruct(t)) + 0.5,
        }

    @torch.no_grad()
    def decompress_batch(self, shape: Sequence[int], indices, counts,
                         seeds) -> torch.Tensor:
        """Batched ``decompress``: indices (B, N, num_latent_blocks, P),
        counts (B, N, num_latent_blocks), per-image seeds -> (B, H, W, C)
        reconstructions in [0, 1]."""
        self._enter()
        H, W = shape
        dev = self.device
        indices = torch.as_tensor(indices, device=dev)
        counts = torch.as_tensor(counts, device=dev)
        seeds = [int(s) for s in seeds]
        t = self._base(len(seeds), H, W)
        for g, blk in enumerate(self.gen_blocks):
            h = F.elu(t)
            prior = _bhwc(blk.prior(h))
            z = self.coder.decode_batch(prior, indices[:, g], counts[:, g],
                                        [s + 7919 * g for s in seeds])
            t = blk.residual(t, h, _nchw(z))
        return _nhwc(self._reconstruct(t)) + 0.5


def latents_for_rec(comp: dict) -> List[tuple]:
    """``compress`` output -> the per-res-block (indices, counts) numpy pairs
    that ``io.write_rec`` takes."""
    return [(comp["indices"][g].cpu().numpy(), comp["counts"][g].cpu().numpy())
            for g in range(comp["indices"].shape[0])]
