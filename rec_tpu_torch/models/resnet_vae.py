"""Bidirectional ResNet VAE (RVAE) — the lossless flagship model (port of
rec_tpu/models/resnet_vae.py).

* 24 residual blocks, each an inference block (run bottom-up) and a
  generative block (run top-down); generative block g pairs with the
  inference block run N-1-g, as ``rec_tpu`` reverses its inference scan's
  outputs.
* posterior = N(infer_loc + gen_loc, exp(infer_ls + gen_ls)), scale heads
  through ``_bounded_exp``; residual update x + 0.1 f(x); a learned "h_top"
  generative base.
* latents are gaussian or cauchy (``distribution``; cauchy trains only —
  the coder codes the gaussian posterior); ``use_iaf`` adds an IAF step to
  the gaussian posterior sample in training: z <- (z - 0.1 m) /
  exp(0.1 s) with (m, s) from an ``AutoRegressiveMultiConv2D`` fed the
  inference and generative contexts.  With IAF or cauchy latents the
  per-channel and analytic KLs are the empirical ones.  Encode and decode
  apply no IAF: a ``use_iaf`` model codes as the plain one, and its IAF
  weights exist (a checkpoint restores them) but go unused there.
* ``compress_batch``/``decompress_batch`` run the generative pass for B
  images with the coder (beam search or importance) per res block, block g
  of image i coding with seed ``seeds[i] + 7919 g``: convolutions at batch
  B, and one block-codec call per res block over all images' latent blocks
  (the coder's ``encode_batch``).  ``compress``/``decompress`` are the
  canonical single-image programs: the batch programs at B = 1.

``InferBlock`` and ``GenBlock`` also serve ``LargeResNetVAE``
(``large_resnet_vae.py``), one block per stochastic group.

Images and latents are NHWC at every public function, as in ``rec_tpu``;
the convolutions run NCHW inside.  A latent is flattened in HWC order before
the coder's split permutation — an NCHW flatten would change every stream.
The training forward takes its posterior noise from the caller: an array of
standard normals, or ``Uniforms`` for cauchy latents.  Weights are drawn
from a ``torch.Generator`` seeded by the caller, then set by
``data_dependent_init`` on a first batch (or imported from a flax params
tree, ``convert.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..coding import Coder
from ..coding.gauss import GaussianParams, kl_divergence
from ..device import resolve_device, set_deterministic
from ..utils.profiling import span
from .likelihoods import get_likelihood
from .modules import (AutoRegressiveMultiConv2D, ReparameterizedConv2D,
                      ReparameterizedConv2DTranspose)

DISTRIBUTIONS = ("gaussian", "cauchy")


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


class Uniforms(NamedTuple):
    """Posterior noise given as uniforms in [1e-6, 1 - 1e-6], the draw of
    cauchy latents (z = loc + scale tan(pi (u - 1/2))).  A plain array of
    noise is standard normals, the draw of gaussian latents."""

    values: Any


def noise_variates(noise, distribution: str, device) -> Any:
    """The standard variates of posterior ``noise`` on ``device`` (float32,
    in the noise's own layout and nesting): normals as given, or
    tan(pi (u - 1/2)) of ``Uniforms``.  Raises if the noise's form does not
    match ``distribution``."""
    uniform = isinstance(noise, Uniforms)
    if uniform != (distribution == "cauchy"):
        raise ValueError(
            f"{distribution} latents take "
            f"{'Uniforms' if distribution == 'cauchy' else 'standard normals'}"
            f" as their noise, got {type(noise).__name__}")

    def convert(a):
        if isinstance(a, (list, tuple)):
            return [convert(b) for b in a]
        t = torch.as_tensor(a, dtype=torch.float32, device=device)
        return torch.tan(math.pi * (t - 0.5)) if uniform else t

    return convert(noise.values if uniform else noise)


def _cauchy_log_prob(z: torch.Tensor, d: GaussianParams) -> torch.Tensor:
    x = (z - d.loc) / d.scale
    return -torch.log(math.pi * d.scale * (1.0 + torch.square(x)))


class InferStats(NamedTuple):
    """An inference block's posterior heads (NCHW) and, with IAF, its
    context."""

    loc: torch.Tensor
    log_scale: torch.Tensor
    iaf_context: Optional[torch.Tensor]


class InferBlock(nn.Module):
    """One inference-pass block: posterior head stats + residual features
    (+ the IAF context with ``use_iaf``)."""

    def __init__(self, cfg: ResNetVAEConfig, generator=None):
        super().__init__()
        det, sto, k = (cfg.deterministic_filters, cfg.stochastic_filters,
                       cfg.kernel_size)

        def conv(i, o):
            return ReparameterizedConv2D(i, o, k, generator=generator)

        self.infer_posterior_loc_head = conv(det, sto)
        self.infer_posterior_log_scale_head = conv(det, sto)
        self.infer_iaf_context = conv(det, det) if cfg.use_iaf else None
        self.infer_conv_0 = conv(det, det)
        self.infer_conv_1 = conv(det, det)

    def forward(self, x) -> Tuple[torch.Tensor, InferStats]:
        h = F.elu(x)
        stats = InferStats(
            self.infer_posterior_loc_head(h),
            self.infer_posterior_log_scale_head(h),
            None if self.infer_iaf_context is None
            else self.infer_iaf_context(h))
        t = self.infer_conv_1(F.elu(self.infer_conv_0(h)))
        return x + 0.1 * t, stats


class GenBlock(nn.Module):
    """One generative-pass block: prior heads, posterior heads, residual;
    with ``use_iaf`` and gaussian latents, the IAF context and multi-conv.
    ``sample`` is the training step, ``encode``/``decode`` the coded
    ones."""

    def __init__(self, cfg: ResNetVAEConfig, generator=None):
        super().__init__()
        det, sto, k = (cfg.deterministic_filters, cfg.stochastic_filters,
                       cfg.kernel_size)
        self.distribution = cfg.distribution
        self.use_iaf = cfg.use_iaf and cfg.distribution == "gaussian"

        def conv(i, o):
            return ReparameterizedConv2D(i, o, k, generator=generator)

        self.prior_loc_head = conv(det, sto)
        self.prior_log_scale_head = conv(det, sto)
        self.gen_posterior_loc_head = conv(det, sto)
        self.gen_posterior_log_scale_head = conv(det, sto)
        if self.use_iaf:
            self.gen_iaf_context = conv(det, det)
            self.iaf_posterior_multiconv = AutoRegressiveMultiConv2D(
                sto, [det] * 2, [sto] * 2, k, generator=generator)
        self.gen_conv_0 = conv(det, det)
        self.gen_conv_1 = conv(det + sto, det)

    def prior(self, h) -> GaussianParams:
        return GaussianParams(self.prior_loc_head(h),
                              _bounded_exp(self.prior_log_scale_head(h)))

    def posterior(self, h, stats: InferStats) -> GaussianParams:
        return GaussianParams(
            stats.loc + self.gen_posterior_loc_head(h),
            _bounded_exp(stats.log_scale
                         + self.gen_posterior_log_scale_head(h)))

    def residual(self, x, h, z):
        t = torch.cat([self.gen_conv_0(h), z], dim=1)
        return x + 0.1 * self.gen_conv_1(F.elu(t))

    def sample(self, x, stats: InferStats, eps) -> Tuple[torch.Tensor, dict]:
        """The training step on NCHW ``x``: the posterior sample from the
        standard variates ``eps`` (NCHW), the IAF step, the KLs; returns
        the next carry and the block's outputs."""
        h = F.elu(x)
        prior = self.prior(h)
        post = self.posterior(h, stats)
        z = post.loc + post.scale * eps
        if self.distribution == "cauchy":
            post_lp = _cauchy_log_prob(z, post)
            prior_lp = _cauchy_log_prob(z, prior)
        else:
            post_lp = post.log_prob(z)
        if self.use_iaf:
            context = stats.iaf_context + self.gen_iaf_context(h)
            iaf_mean, iaf_log_scale = self.iaf_posterior_multiconv(z, context)
            iaf_mean, iaf_log_scale = 0.1 * iaf_mean, 0.1 * iaf_log_scale
            z = (z - iaf_mean) / torch.exp(iaf_log_scale)
            post_lp = post_lp + iaf_log_scale
        if self.distribution == "gaussian":
            prior_lp = prior.log_prob(z)
        empirical = post_lp - prior_lp
        # The per-channel KL of the free-bits floor: summed over H, W and
        # averaged over the batch; the analytic KL where it exists.
        if self.distribution == "gaussian" and not self.use_iaf:
            kld = kl_divergence(post, prior)
        else:
            kld = empirical
        return self.residual(x, h, z), {
            "kld_channelwise": torch.mean(torch.sum(kld, dim=(2, 3)), dim=0),
            "empirical_kld": torch.sum(empirical, dim=(1, 2, 3)),
            "analytic_kl": torch.sum(kld, dim=(1, 2, 3)),
            "posterior": _bhwc(post), "prior": _bhwc(prior)}

    def encode(self, x, stats: InferStats, coder, seeds):
        """The coded step for B images: the posterior coded against the
        prior with per-image ``seeds`` in one block-codec call; returns the
        next carry, the ``CodedLatent`` and per-image KLs (B,)."""
        h = F.elu(x)
        prior = _bhwc(self.prior(h))
        post = _bhwc(self.posterior(h, stats))
        coded = coder.encode_batch(post, prior, seeds)
        kl = torch.sum(kl_divergence(post, prior), dim=(1, 2, 3))
        return self.residual(x, h, _nchw(coded.sample)), coded, kl

    def decode(self, x, coder, indices, counts, seeds):
        """The replayed step for B images from their (indices, counts)."""
        h = F.elu(x)
        z = coder.decode_batch(_bhwc(self.prior(h)), indices, counts, seeds)
        return self.residual(x, h, _nchw(z))


def _bhwc(p: GaussianParams) -> GaussianParams:
    """NCHW distribution -> (B, H, W, C): each image in the coder's HWC
    flatten order."""
    return GaussianParams(_nhwc(p.loc), _nhwc(p.scale))


class BidirectionalResNetVAE(nn.Module):
    """The full RVAE (ref resnet_vae.py:512-860)."""

    def __init__(self, cfg: ResNetVAEConfig = ResNetVAEConfig(),
                 coder: Optional[Coder] = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if cfg.distribution not in DISTRIBUTIONS:
            raise ValueError(f"distribution must be one of {DISTRIBUTIONS}, "
                             f"got {cfg.distribution!r}")
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

    def _infer(self, x) -> List[InferStats]:
        """Bottom-up pass on NCHW images; per-block stats in generative
        order."""
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
        eps = noise_variates(noise, cfg.distribution, images.device)
        infer_outs = self._infer(_nchw(images))
        t = self._base(B, H, W)
        outs = []
        for g, blk in enumerate(self.gen_blocks):
            t, o = blk.sample(t, infer_outs[g], _nchw(eps[g]))
            outs.append(o)
        recon = _nhwc(self._reconstruct(t))
        scale = torch.exp(self.likelihood_log_scale)
        if not cfg.learn_likelihood_scale:
            scale = scale.detach()
        ll = get_likelihood(cfg.likelihood)(images, recon, scale)

        def stack(key):
            return torch.stack([o[key] for o in outs])

        def stack_dist(key):
            return GaussianParams(torch.stack([o[key].loc for o in outs]),
                                  torch.stack([o[key].scale for o in outs]))

        return {
            "reconstruction": recon + 0.5,
            "log_likelihood": ll,
            "kld_channelwise": stack("kld_channelwise"),
            "empirical_kld": stack("empirical_kld"),
            "analytic_kl": stack("analytic_kl"),
            "posterior": stack_dist("posterior"),
            "prior": stack_dist("prior"),
        }

    def forward(self, images: torch.Tensor, noise) -> dict:
        """Training/eval forward pass, differentiable in the weights.
        ``images`` (B, H, W, C) in [-0.5, 0.5]; ``noise`` (num_res_blocks,
        B, H/2, W/2, stochastic) standard normals for the posterior samples
        (NHWC), or ``Uniforms`` of that shape for cauchy latents: a tensor
        on the images' device (used as is) or an array (copied there
        once)."""
        self._enter()
        return self._forward(images, noise)

    @torch.no_grad()
    def data_dependent_init(self, images: torch.Tensor, noise) -> dict:
        """Set every convolution's log_scale and bias from the statistics of
        its output on this first batch (the flax init pass).
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
        with span("model.compress_batch", card=self.device, images=B):
            infer_outs = self._infer(_nchw(images))
            t = self._base(B, H, W)
            indices, counts, kls = [], [], []
            for g, blk in enumerate(self.gen_blocks):
                t, coded, kl = blk.encode(t, infer_outs[g], self.coder,
                                          [s + 7919 * g for s in seeds])
                indices.append(coded.indices)
                counts.append(coded.counts)
                kls.append(kl)
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
        seeds = [int(s) for s in seeds]
        with span("model.decompress_batch", card=dev,
                  images=len(seeds)):
            indices = torch.as_tensor(indices, device=dev)
            counts = torch.as_tensor(counts, device=dev)
            t = self._base(len(seeds), H, W)
            for g, blk in enumerate(self.gen_blocks):
                t = blk.decode(t, self.coder, indices[:, g], counts[:, g],
                               [s + 7919 * g for s in seeds])
            return _nhwc(self._reconstruct(t)) + 0.5


def latents_for_rec(comp: dict) -> List[tuple]:
    """``compress`` output -> the per-res-block (indices, counts) numpy pairs
    that ``io.write_rec`` takes."""
    return [(comp["indices"][g].cpu().numpy(), comp["counts"][g].cpu().numpy())
            for g in range(comp["indices"].shape[0])]
