"""Two-level lossy VAE, the paper's lossy model: Ballé's hyperprior
analogue (port of rec_tpu/models/lossy/level2.py).

Level-1 latents at H/16 with ``level_1_filters`` channels, level-2 (hyper)
latents at H/64.  The level-1 posterior combines the analysis stats with the
hyper-synthesised prior stats through elu and two 1x1 convolutions (plain
convolutions, as flax's ``nn.Conv``).  REC codes z2 against the empirical
prior with the image's seed, then z1 against the hyper-synthesised prior
with seed + 1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...coding import Coder
from ...coding.gauss import GaussianParams, kl_divergence
from ...device import resolve_device
from ...utils.profiling import span
from .base import LossyModel, bhwc, nchw, nhwc
from .transforms import (AnalysisTransform, Conv1x1, EmpiricalPrior,
                         HyperAnalysisTransform, HyperSynthesisTransform,
                         SynthesisTransform, softplus_scale)


class Large2LevelVAE(LossyModel):
    def __init__(self, level_1_filters: int = 196,
                 level_2_filters: int = 128,
                 coder: Optional[Coder] = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        f1, f2 = level_1_filters, level_2_filters
        self.coder = coder
        self.analysis = AnalysisTransform(3, f1, stages=((5, 2),) * 3,
                                          generator=g)
        self.synthesis = SynthesisTransform(f1, f1, stages=((5, 2),) * 3,
                                            generator=g)
        self.hyper_analysis = HyperAnalysisTransform(f1, f2, generator=g)
        self.hyper_synthesis = HyperSynthesisTransform(f2, f2, f1,
                                                       generator=g)
        self.level_2_prior = EmpiricalPrior(f2, generator=g)
        self.level_1_posterior_loc_combiner = Conv1x1(2 * f1, f1, g)
        self.level_1_posterior_log_scale_combiner = Conv1x1(2 * f1, f1, g)
        self.filters = (f1, f2)
        self.to(dev)

    def latent_shapes(self, height, width):
        f1, f2 = self.filters
        return [(height // 64, width // 64, f2),
                (height // 16, width // 16, f1)]

    # -- pieces (NCHW) ----------------------------------------------------

    def _level2_posterior(self, images):
        l1_loc, l1_log_scale = self.analysis(nchw(images))
        l2_loc, l2_log_scale = self.hyper_analysis(l1_loc)
        return (GaussianParams(l2_loc, softplus_scale(l2_log_scale)),
                l1_loc, l1_log_scale)

    def _level2_prior(self, batch, height, width) -> GaussianParams:
        loc, log_scale = self.level_2_prior(batch, height // 64, width // 64)
        return GaussianParams(loc, softplus_scale(log_scale))

    def _level1_prior(self, z2):
        p_loc, p_log_scale = self.hyper_synthesis(z2)
        return p_loc, p_log_scale, GaussianParams(
            p_loc, softplus_scale(p_log_scale))

    def _level1_dists(self, z2, l1_loc, l1_log_scale):
        p_loc, p_log_scale, prior = self._level1_prior(z2)
        loc = F.elu(torch.cat([l1_loc, p_loc], dim=1))
        log_scale = F.elu(torch.cat([l1_log_scale, p_log_scale], dim=1))
        post = GaussianParams(
            self.level_1_posterior_loc_combiner(loc),
            softplus_scale(self.level_1_posterior_log_scale_combiner(
                log_scale)))
        return post, prior

    # -- training forward -------------------------------------------------

    def forward(self, images: torch.Tensor, noise) -> dict:
        """Training forward of (B, H, W, 3) images in [0, 1]; ``noise`` =
        [level-2 normals (B, H/64, W/64, F2), level-1 normals (B, H/16,
        W/16, F1)], coding order."""
        self._enter()
        B, H, W, _ = images.shape
        eps2, eps1 = self._noise(noise)
        l2_post, l1_loc, l1_log_scale = self._level2_posterior(images)
        l2_prior = self._level2_prior(B, H, W)
        z2 = l2_post.loc + l2_post.scale * eps2
        l1_post, l1_prior = self._level1_dists(z2, l1_loc, l1_log_scale)
        z1 = l1_post.loc + l1_post.scale * eps1
        kls = [torch.mean(torch.sum(kl_divergence(q, p), dim=(1, 2, 3)))
               for q, p in ((l2_post, l2_prior), (l1_post, l1_prior))]
        return {"reconstruction": nhwc(self.synthesis(z1)), "kls": kls,
                "latents": [nhwc(z2), nhwc(z1)],
                "posteriors": [bhwc(l2_post), bhwc(l1_post)],
                "priors": [bhwc(l2_prior), bhwc(l1_prior)]}

    # -- REC compression --------------------------------------------------

    @torch.no_grad()
    def rec_forward_batch(self, images: torch.Tensor, seeds) -> dict:
        """Code z2 (seeds), then z1 (seeds + 1), each level of all B
        images in one block-codec call."""
        self._enter()
        B, H, W, _ = images.shape
        seeds = [int(s) for s in seeds]
        with span("model.rec_forward_batch", card=self.device, images=B):
            l2_post, l1_loc, l1_log_scale = self._level2_posterior(images)
            l2_post = bhwc(l2_post)
            l2_prior = bhwc(self._level2_prior(B, H, W))
            coded2 = self.coder.encode_batch(l2_post, l2_prior, seeds)
            l1_post, l1_prior = (bhwc(p) for p in self._level1_dists(
                nchw(coded2.sample), l1_loc, l1_log_scale))
            coded1 = self.coder.encode_batch(l1_post, l1_prior,
                                             [s + 1 for s in seeds])
            return {"reconstruction": nhwc(self.synthesis(
                        nchw(coded1.sample))),
                    "latents": [(coded2.indices, coded2.counts),
                                (coded1.indices, coded1.counts)],
                    "kls": [torch.sum(kl_divergence(q, p), dim=(1, 2, 3))
                            for q, p in ((l2_post, l2_prior),
                                         (l1_post, l1_prior))]}

    @torch.no_grad()
    def rec_decode_batch(self, shape, latents, seeds) -> torch.Tensor:
        self._enter()
        H, W = shape
        seeds = [int(s) for s in seeds]
        (ind2, cnt2), (ind1, cnt1) = latents
        l2_prior = bhwc(self._level2_prior(len(seeds), H, W))
        z2 = self.coder.decode_batch(l2_prior, ind2, cnt2, seeds)
        l1_prior = bhwc(self._level1_prior(nchw(z2))[2])
        z1 = self.coder.decode_batch(l1_prior, ind1, cnt1,
                                     [s + 1 for s in seeds])
        return nhwc(self.synthesis(nchw(z1)))
