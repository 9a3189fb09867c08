"""Four-level lossy VAE: a deep hyperprior ladder with skip connectors
between the levels in both passes (port of rec_tpu/models/lossy/level4.py).

Levels 1 and 2 sit at H/16, levels 3 and 4 at H/64, so H and W must be
multiples of 64.  The inference pass combines down-sampled input and
feature skips; the generative pass runs top-down, each level's posterior
combining its inference stats with its synthesised prior stats through elu
and a 1x1 convolution.  REC codes the levels in the order 4, 3, 2, 1, level
``l`` with the image's seed + (4 - l), one ``coder.encode_batch`` per level.

Every sub-module carries the attribute name of its flax counterpart
(``infer_combiner_1.Conv_0``, ``level_4_to_level_1_connector``,
``hyper_prior.prior_base``, ...), so ``convert.py`` maps the flax tree onto
the state dict by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...coding import Coder
from ...coding.gauss import GaussianParams, kl_divergence
from ...device import resolve_device
from ...utils.profiling import span
from ..signal import GDN
from .base import LossyModel, bhwc, nchw, nhwc
from .transforms import Conv1x1, EmpiricalPrior, _down, _up, softplus_scale

LEVELS = (4, 3, 2, 1)   # coding order


class _Analysis(nn.Module):
    """3x (5x5/s2 + GDN), then 5x5/s2 loc, log-scale and feature heads;
    also returns the first stage's output (at H/2) for the input skip."""

    def __init__(self, num_filters: int, generator):
        super().__init__()
        f = num_filters
        for i in range(3):
            self.add_module(f"conv_{i}", _down(3 if i == 0 else f, f, 5, 2,
                                               generator))
            self.add_module(f"gdn_{i}", GDN(f))
        self.posterior_loc_head = _down(f, f, 5, 2, generator)
        self.posterior_log_scale_head = _down(f, f, 5, 2, generator)
        self.features_head = _down(f, f, 5, 2, generator)

    def forward(self, x):
        first = self.gdn_0(self.conv_0(x))
        t = self.gdn_2(self.conv_2(self.gdn_1(self.conv_1(first))))
        return (self.posterior_loc_head(t), self.posterior_log_scale_head(t),
                self.features_head(t), first)


class _Synthesis(nn.Module):
    """3x (5x5/s2 up + inverse GDN), then a 5x5/s2 up conv to 3
    channels."""

    def __init__(self, num_filters: int, generator):
        super().__init__()
        f = num_filters
        for i in range(3):
            self.add_module(f"conv_{i}", _up(f, f, 5, 2, generator))
            self.add_module(f"igdn_{i}", GDN(f, inverse=True))
        self.conv_3 = _up(f, 3, 5, 2, generator)

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"igdn_{i}")(getattr(self, f"conv_{i}")(x))
        return self.conv_3(x)


class _SameResStack(nn.Module):
    """2x (3x3/s1 + GDN, or up-mode conv + inverse GDN), then 3x3/s1 loc
    and log-scale heads and, ``with_features``, a feature head."""

    def __init__(self, in_ch: int, num_filters: int, out_filters: int,
                 generator, inverse: bool = False,
                 with_features: bool = True):
        super().__init__()
        conv = _up if inverse else _down
        f = num_filters
        for i in range(2):
            self.add_module(f"conv_{i}", conv(in_ch if i == 0 else f, f, 3,
                                              1, generator))
            self.add_module(f"gdn_{i}", GDN(f, inverse=inverse))
        self.loc_head = conv(f, out_filters, 3, 1, generator)
        self.log_scale_head = conv(f, out_filters, 3, 1, generator)
        self.with_features = with_features
        if with_features:
            self.features_head = conv(f, out_filters, 3, 1, generator)

    def forward(self, x):
        x = self.gdn_1(self.conv_1(self.gdn_0(self.conv_0(x))))
        out = (self.loc_head(x), self.log_scale_head(x))
        if self.with_features:
            out += (self.features_head(x),)
        return out


class _HyperAnalysis(nn.Module):
    """3x3/s1 + relu, 5x5/s2 + relu, then 5x5/s2 loc, log-scale and
    feature heads."""

    def __init__(self, in_ch: int, num_filters: int, generator):
        super().__init__()
        f = num_filters
        self.conv_0 = _down(in_ch, f, 3, 1, generator)
        self.conv_1 = _down(f, f, 5, 2, generator)
        self.loc_head = _down(f, f, 5, 2, generator)
        self.log_scale_head = _down(f, f, 5, 2, generator)
        self.features_head = _down(f, f, 5, 2, generator)

    def forward(self, x):
        x = F.relu(self.conv_1(F.relu(self.conv_0(x))))
        return self.loc_head(x), self.log_scale_head(x), self.features_head(x)


class _HyperSynthesis(nn.Module):
    """2x (5x5/s2 up + relu), then 3x3 loc, log-scale and feature heads;
    plain kernels (no RDFT parametrisation)."""

    def __init__(self, in_ch: int, num_filters: int, out_filters: int,
                 generator):
        super().__init__()
        f = num_filters
        self.conv_0 = _up(in_ch, f, 5, 2, generator, dft=False)
        self.conv_1 = _up(f, f, 5, 2, generator, dft=False)
        self.loc_head = _up(f, out_filters, 3, 1, generator, dft=False)
        self.log_scale_head = _up(f, out_filters, 3, 1, generator, dft=False)
        self.features_head = _up(f, out_filters, 3, 1, generator, dft=False)

    def forward(self, x):
        x = F.relu(self.conv_1(F.relu(self.conv_0(x))))
        return self.loc_head(x), self.log_scale_head(x), self.features_head(x)


class _Combiner(nn.Module):
    """elu of the channel concatenation, then a 1x1 convolution (flax's
    unnamed ``nn.Conv`` inside the combiner is ``Conv_0``)."""

    def __init__(self, in_ch: int, features: int, generator):
        super().__init__()
        self.Conv_0 = Conv1x1(in_ch, features, generator)

    def forward(self, *tensors):
        return self.Conv_0(F.elu(torch.cat(tensors, dim=1)))


class Large4LevelVAE(LossyModel):
    def __init__(self, level_1_filters: int = 192,
                 level_2_filters: int = 192, level_3_filters: int = 128,
                 level_4_filters: int = 128,
                 coder: Optional[Coder] = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        f1, f2, f3, f4 = (level_1_filters, level_2_filters, level_3_filters,
                          level_4_filters)
        self.coder = coder
        self.filters = (f1, f2, f3, f4)
        self.analysis = _Analysis(f1, g)
        self.synthesis = _Synthesis(f1, g)
        self.ext_analysis = _SameResStack(f1, f2, f2, g)
        self.ext_synthesis = _SameResStack(f2, f2, f1, g, inverse=True)
        self.hyper_analysis = _HyperAnalysis(f2, f3, g)
        self.hyper_synthesis = _HyperSynthesis(f3, f3, f2, g)
        self.ext_hyper_analysis = _SameResStack(f3, f4, f4, g,
                                                with_features=False)
        self.ext_hyper_synthesis = _SameResStack(f4, f4, f3, g, inverse=True)
        self.hyper_prior = EmpiricalPrior(f4, g, return_features=True)

        self.inputs_to_level_1_connector = _down(f1, f1, 9, 8, g)
        self.inputs_to_level_2_connector = Conv1x1(f1, f2, g)
        self.level_1_to_level_2_connector = Conv1x1(f1, f2, g)
        self.inputs_to_level_3_connector = _down(f1, f3, 5, 4, g)
        self.level_1_to_level_3_connector = _down(f1, f3, 5, 4, g)
        self.level_2_to_level_3_connector = _down(f2, f3, 5, 4, g)
        for i, (f, n_in) in enumerate(((f1, 2), (f2, 3), (f3, 4))):
            self.add_module(f"infer_combiner_{i + 1}",
                            _Combiner(n_in * f, f, g))

        self.level_4_to_level_3_connector = Conv1x1(f4, f3, g)
        self.level_4_to_level_2_connector = _up(f4, f2, 5, 4, g)
        self.level_4_to_level_1_connector = _up(f4, f1, 5, 4, g)
        self.level_3_to_level_2_connector = _up(f3, f2, 5, 4, g)
        self.level_3_to_level_1_connector = _up(f3, f1, 5, 4, g)
        self.level_2_to_level_1_connector = Conv1x1(f2, f1, g)
        for i, (f, n_in) in enumerate(((f1, 5), (f2, 4), (f3, 3), (f4, 2))):
            self.add_module(f"gen_combiner_{i + 1}",
                            _Combiner(n_in * f, f, g))
        for kind in ("loc", "log_scale"):
            for i, f in enumerate((f1, f2, f3, f4)):
                self.add_module(f"post_{kind}_combiner_{i + 1}",
                                _Combiner(2 * f, f, g))
        self.to(dev)

    def latent_shapes(self, height, width):
        f1, f2, f3, f4 = self.filters
        return [(height // 64, width // 64, f4),
                (height // 64, width // 64, f3),
                (height // 16, width // 16, f2),
                (height // 16, width // 16, f1)]

    def _combiner(self, kind: str, level: int) -> _Combiner:
        return getattr(self, f"{kind}_combiner_{level}")

    # -- inference side (NCHW) --------------------------------------------

    def _inference_stats(self, images) -> dict:
        """Per level, the (loc, log_scale) of the inference pass."""
        loc1, ls1, feat1, first = self.analysis(nchw(images))
        res1 = self.inputs_to_level_1_connector(first)
        t = self.infer_combiner_1(res1, feat1)
        loc2, ls2, feat2 = self.ext_analysis(t)
        t = self.infer_combiner_2(self.inputs_to_level_2_connector(res1),
                                  self.level_1_to_level_2_connector(feat1),
                                  feat2)
        loc3, ls3, feat3 = self.hyper_analysis(t)
        t = self.infer_combiner_3(self.inputs_to_level_3_connector(res1),
                                  self.level_1_to_level_3_connector(feat1),
                                  self.level_2_to_level_3_connector(feat2),
                                  feat3)
        loc4, ls4 = self.ext_hyper_analysis(t)
        return {1: (loc1, ls1), 2: (loc2, ls2), 3: (loc3, ls3),
                4: (loc4, ls4)}

    # -- generative ladder ------------------------------------------------

    def _ladder(self, batch, height, width, infer_stats, sample_fn) -> dict:
        """The top-down pass.  ``sample_fn(level, post, prior)`` returns
        level's latent (NCHW); ``post`` is None without ``infer_stats`` (a
        decode).  Returns the reconstruction (NCHW) and, per level in coding
        order, the posterior, prior and per-image KL (B,)."""
        out = {"posteriors": [], "priors": [], "kls": []}

        def level(lvl, p_loc, p_ls):
            prior = GaussianParams(p_loc, softplus_scale(p_ls))
            post = None
            if infer_stats is not None:
                q_loc, q_ls = infer_stats[lvl]
                post = GaussianParams(
                    self._combiner("post_loc", lvl)(p_loc, q_loc),
                    softplus_scale(self._combiner("post_log_scale", lvl)(
                        p_ls, q_ls)))
                out["posteriors"].append(post)
                out["kls"].append(torch.sum(kl_divergence(post, prior),
                                            dim=(1, 2, 3)))
            out["priors"].append(prior)
            return sample_fn(lvl, post, prior)

        p_loc4, p_ls4, gfeat4 = self.hyper_prior(batch, height // 64,
                                                 width // 64)
        z4 = level(4, p_loc4, p_ls4)
        t = self.gen_combiner_4(z4, gfeat4)

        p_loc3, p_ls3, gfeat3 = self.ext_hyper_synthesis(t)
        z3 = level(3, p_loc3, p_ls3)
        t = self.gen_combiner_3(z3, gfeat3,
                                self.level_4_to_level_3_connector(gfeat4))

        p_loc2, p_ls2, gfeat2 = self.hyper_synthesis(t)
        z2 = level(2, p_loc2, p_ls2)
        t = self.gen_combiner_2(z2, gfeat2,
                                self.level_4_to_level_2_connector(gfeat4),
                                self.level_3_to_level_2_connector(gfeat3))

        p_loc1, p_ls1, gfeat1 = self.ext_synthesis(t)
        z1 = level(1, p_loc1, p_ls1)
        t = self.gen_combiner_1(z1, gfeat1,
                                self.level_4_to_level_1_connector(gfeat4),
                                self.level_3_to_level_1_connector(gfeat3),
                                self.level_2_to_level_1_connector(gfeat2))
        out["reconstruction"] = self.synthesis(t)
        return out

    # -- training forward -------------------------------------------------

    def forward(self, images: torch.Tensor, noise) -> dict:
        """Training forward of (B, H, W, 3) images in [0, 1]; ``noise`` =
        the standard normals of levels 4, 3, 2, 1 (coding order), each
        (B, h, w, filters) as ``latent_shapes`` gives them."""
        self._enter()
        B, H, W, _ = images.shape
        eps = dict(zip(LEVELS, self._noise(noise)))
        latents = []

        def sample(lvl, post, prior):
            latents.append(post.loc + post.scale * eps[lvl])
            return latents[-1]

        out = self._ladder(B, H, W, self._inference_stats(images), sample)
        return {"reconstruction": nhwc(out["reconstruction"]),
                "kls": [torch.mean(k) for k in out["kls"]],
                "latents": [nhwc(z) for z in latents],
                "posteriors": [bhwc(p) for p in out["posteriors"]],
                "priors": [bhwc(p) for p in out["priors"]]}

    # -- REC compression --------------------------------------------------

    @torch.no_grad()
    def rec_forward_batch(self, images: torch.Tensor, seeds) -> dict:
        """Code levels 4, 3, 2, 1, level l of all B images in one
        block-codec call with seeds + (4 - l)."""
        self._enter()
        B, H, W, _ = images.shape
        seeds = [int(s) for s in seeds]
        codes = []

        def sample(lvl, post, prior):
            coded = self.coder.encode_batch(bhwc(post), bhwc(prior),
                                            [s + 4 - lvl for s in seeds])
            codes.append((coded.indices, coded.counts))
            return nchw(coded.sample)

        with span("model.rec_forward_batch", card=self.device, images=B):
            out = self._ladder(B, H, W, self._inference_stats(images),
                               sample)
            return {"reconstruction": nhwc(out["reconstruction"]),
                    "latents": codes, "kls": out["kls"]}

    @torch.no_grad()
    def rec_decode_batch(self, shape, latents, seeds) -> torch.Tensor:
        self._enter()
        H, W = shape
        seeds = [int(s) for s in seeds]
        per_level = dict(zip(LEVELS, latents))

        def sample(lvl, post, prior):
            ind, cnt = per_level[lvl]
            return nchw(self.coder.decode_batch(
                bhwc(prior), ind, cnt, [s + 4 - lvl for s in seeds]))

        out = self._ladder(len(seeds), H, W, None, sample)
        return nhwc(out["reconstruction"])
