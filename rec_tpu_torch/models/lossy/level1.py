"""One-level lossy VAE: Ballé's factorized-prior analogue with a learned
spatially constant empirical prior (port of rec_tpu/models/lossy/level1.py).
Latents at H/16 (9x9/s4 + 5x5/s2 analysis, 5x5/s2 heads); the latent codes
with the image's seed."""

from __future__ import annotations

from typing import Optional

import torch

from ...coding import Coder
from ...coding.gauss import GaussianParams, kl_divergence
from ...device import resolve_device
from ...utils.profiling import span
from .base import LossyModel, bhwc, nchw, nhwc
from .transforms import (AnalysisTransform, EmpiricalPrior,
                         SynthesisTransform, softplus_scale)


class Large1LevelVAE(LossyModel):
    def __init__(self, num_filters: int = 196,
                 coder: Optional[Coder] = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        self.coder = coder
        self.analysis = AnalysisTransform(
            3, num_filters, stages=((9, 4), (5, 2)), head_kernel=5,
            head_stride=2, head_bias=False, generator=g)
        self.synthesis = SynthesisTransform(
            num_filters, num_filters, stages=((5, 2), (5, 2)),
            final_kernel=9, final_stride=4, generator=g)
        self.prior = EmpiricalPrior(num_filters, generator=g)
        self.num_filters = num_filters
        self.to(dev)

    def latent_shapes(self, height, width):
        return [(height // 16, width // 16, self.num_filters)]

    def _prior(self, batch, height, width) -> GaussianParams:
        loc, log_scale = self.prior(batch, height // 16, width // 16)
        return GaussianParams(loc, softplus_scale(log_scale))

    def _dists(self, images):
        B, H, W, _ = images.shape
        loc, log_scale = self.analysis(nchw(images))
        return (GaussianParams(loc, softplus_scale(log_scale)),
                self._prior(B, H, W))

    def forward(self, images: torch.Tensor, noise) -> dict:
        """Training forward of (B, H, W, 3) images in [0, 1]; ``noise`` =
        [standard normals (B, H/16, W/16, F)]."""
        self._enter()
        post, prior = self._dists(images)
        (eps,) = self._noise(noise)
        z = post.loc + post.scale * eps
        kl = torch.sum(kl_divergence(post, prior), dim=(1, 2, 3))
        return {"reconstruction": nhwc(self.synthesis(z)),
                "kls": [torch.mean(kl)], "latents": [nhwc(z)],
                "posteriors": [bhwc(post)], "priors": [bhwc(prior)]}

    @torch.no_grad()
    def rec_forward_batch(self, images: torch.Tensor, seeds) -> dict:
        self._enter()
        seeds = [int(s) for s in seeds]
        with span("model.rec_forward_batch", card=self.device,
                  images=len(seeds)):
            post, prior = (bhwc(p) for p in self._dists(images))
            coded = self.coder.encode_batch(post, prior, seeds)
            return {"reconstruction": nhwc(self.synthesis(
                        nchw(coded.sample))),
                    "latents": [(coded.indices, coded.counts)],
                    "kls": [torch.sum(kl_divergence(post, prior),
                                      dim=(1, 2, 3))]}

    @torch.no_grad()
    def rec_decode_batch(self, shape, latents, seeds) -> torch.Tensor:
        self._enter()
        H, W = shape
        seeds = [int(s) for s in seeds]
        prior = bhwc(self._prior(len(seeds), H, W))
        ((ind, cnt),) = latents
        z = self.coder.decode_batch(prior, ind, cnt, seeds)
        return nhwc(self.synthesis(nchw(z)))
