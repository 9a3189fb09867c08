"""The large lossless VAE (``LargeResNetVAE``, the reference's
``rec/models/large_resnet_vae_new.py``) in plain PyTorch over a flat dict
of weights: the data-dependent init, the inference pass, each group's
posterior and prior top-down, the generative decode from replayed latents
and the discretized-logistic reconstruction; with ``ac.py``'s residual
decoder, a ``.rec`` file down to its 8-bit pixels.

    x --[4x (5,5)/s2 signal conv + GDN]--> /16 --[res block 1]-->
      --[(3,3) + 2x (5,5)/s2 signal conv, elu]--> /64 --[res block 2]

and back up from a learned base at /64: res block 2, two (5,5) up-sampling
convs with elu and a (3,3) conv to /16, res block 1, three (5,5)
up-sampling convs with inverse GDN and a last one to 3 channels.  The res
blocks are the RVAE's (``rvae.conv``, weight-normalised, set by the
data-dependent init), the stacks Balle's signal convolutions and GDN
(``lossy.Model.conv`` and ``.gdn``).  Group 2 (the top) codes with seed +
7919, group 1 with the seed.  It follows the port's operation order
(``models/large_resnet_vae.py``, ``models/resnet_vae.py``,
``models/signal.py``) so that on one device it gives the port's bits.
Weights are keyed as the port's ``state_dict``; NCHW inside, NHWC at the
functions below, images in [-0.5, 0.5].

Departures from ``large_resnet_vae_new.py``:

* only the configuration the benchmark runs: ``use_gdn`` and
  ``use_sig_convs`` on and a discretized logistic likelihood (the
  weight-norm stacks and the gaussian, laplace and MS-SSIM likelihoods are
  not here);
* the likelihood's scale is floored at 1/512, half a quantisation bin, as
  the port floors it;
* fresh weights come from one normal and one uniform draw of a generator
  seeded on the device, with the model's initialisers (flax draws them
  from a key per leaf);
* the posterior noise of a forward pass is the caller's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import ac, beam, lossy, rvae
from .gauss import GaussianParams, kl_divergence
from .partition import merge_batch
from .rvae import bhwc, nchw, nhwc
from .train import discretized_logistic

Params = Dict[str, torch.Tensor]
_CLIP = 0.5 - 1.0 / 512.0


def _widths(cfg: dict):
    return (cfg["first_deterministic_filters"],
            cfg["second_deterministic_filters"],
            cfg["first_stochastic_filters"],
            cfg["second_stochastic_filters"])


def signal_convs(cfg: dict) -> List[tuple]:
    """(name, c_in, c_out, kernel, corr, down, up, bias, dft) of every
    signal convolution, as ``lossy.signal_convs`` lists them."""
    d1, d2, _, _ = _widths(cfg)
    out = [(f"first_infer_block.conv_{i}", 3 if i == 0 else d1, d1, 5,
            True, 2, 1, True, True) for i in range(4)]
    out += [(f"first_gen_block.conv_{i}", d1, 3 if i == 3 else d1, 5,
             False, 1, 2, True, True) for i in range(4)]
    out.append(("second_infer_block.conv_pre", d1, d2, 3, True, 1, 1, True,
                True))
    out += [(f"second_infer_block.conv_{i}", d2, d2, 5, True, 2, 1, True,
             True) for i in range(2)]
    out += [(f"second_gen_block.conv_{i}", d2, d2, 5, False, 1, 2, True,
             True) for i in range(2)]
    out.append(("second_gen_block.conv_tail", d2, d1, 3, False, 1, 1, True,
                True))
    return out


GDNS = ([f"first_infer_block.gdn_{i}" for i in range(4)]
        + [f"first_gen_block.igdn_{i}" for i in range(3)])


def weight_norm_convs(cfg: dict) -> List[tuple]:
    """(name, c_in, c_out, kernel) of every weight-normalised convolution
    of the two res blocks."""
    d1, d2, s1, s2 = _widths(cfg)
    k = cfg["kernel_size"][0]
    out = []
    for g, det, sto in ((1, d1, s1), (2, d2, s2)):
        b = f"infer_block_{g}."
        out += [(b + "infer_posterior_loc_head", det, sto, k),
                (b + "infer_posterior_log_scale_head", det, sto, k),
                (b + "infer_conv_0", det, det, k),
                (b + "infer_conv_1", det, det, k)]
    for g, det, sto in ((1, d1, s1), (2, d2, s2)):
        b = f"gen_block_{g}."
        out += [(b + "prior_loc_head", det, sto, k),
                (b + "prior_log_scale_head", det, sto, k),
                (b + "gen_posterior_loc_head", det, sto, k),
                (b + "gen_posterior_log_scale_head", det, sto, k),
                (b + "gen_conv_0", det, det, k),
                (b + "gen_conv_1", det + sto, det, k)]
    return out


def fresh_weights(cfg: dict, seed: int, device) -> Params:
    """Weights before the data-dependent init, from ``seed`` on
    ``device``: the res blocks' kernels ``v`` and the generative base
    from one draw of standard normals (scaled 0.05 and 0.1, as the
    model's own init), their log-scales and biases zero; the signal
    kernels variance-scaling uniform (as their RDFT coefficients) from one
    uniform draw, their biases zero; GDN at beta 1 and gamma 0.1 I; the
    likelihood's log-scale 0."""
    d2 = cfg["second_deterministic_filters"]
    wn = weight_norm_convs(cfg)
    sig = signal_convs(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normals = torch.randn(sum(k * k * i * o for _, i, o, k in wn) + d2,
                          generator=gen, device=device)
    uniforms = torch.rand(sum(k * k * i * o for _, i, o, k, *_ in sig),
                          generator=gen, device=device)
    p, off = {}, 0
    for name, cin, cout, k in wn:
        n = k * k * cin * cout
        p[name + ".v"] = 0.05 * normals[off:off + n].reshape(cout, cin, k, k)
        p[name + ".log_scale"] = torch.zeros(cout, device=device)
        p[name + ".bias"] = torch.zeros(cout, device=device)
        off += n
    p["generative_base"] = 0.1 * normals[off:off + d2]
    off = 0
    for name, cin, cout, k, *_ in sig:
        n = k * k * cin * cout
        limit = math.sqrt(3.0 / ((k * k * cin + k * k * cout) / 2.0))
        hwio = (2.0 * uniforms[off:off + n] - 1.0) * limit
        basis = torch.from_numpy(lossy.irdft_matrix((k, k))).to(device)
        p[name + ".kernel_rdft"] = basis.t() @ hwio.reshape(k * k, -1)
        p[name + ".bias"] = torch.zeros(cout, device=device)
        off += n
    c = cfg["first_deterministic_filters"]
    for name in GDNS:
        p[name + ".beta_reparam"] = torch.sqrt(
            torch.ones(c, device=device) + lossy._PEDESTAL)
        p[name + ".gamma_reparam"] = torch.sqrt(
            0.1 * torch.eye(c, device=device) + lossy._PEDESTAL)
    p["likelihood_log_scale"] = torch.zeros((), device=device)
    return p


class Model(lossy.Model):
    """The weights ``p`` of a configuration ``cfg`` (``model`` of
    ``configs/large.json``); the signal convolutions and GDN are
    ``lossy.Model``'s."""

    def __init__(self, p: Params, cfg: dict):
        self.p = p
        self.spec = {c[0]: c[1:] for c in signal_convs(cfg)}
        self.basis = {}

    # -- the stacks ------------------------------------------------------

    def first_infer(self, x):
        for i in range(4):
            x = self.gdn(f"first_infer_block.gdn_{i}", False,
                         self.conv(f"first_infer_block.conv_{i}", x))
        return x

    def second_infer(self, x):
        x = F.elu(self.conv("second_infer_block.conv_pre", x))
        for i in range(2):
            x = F.elu(self.conv(f"second_infer_block.conv_{i}", x))
        return x

    def second_gen(self, x):
        for i in range(2):
            x = F.elu(self.conv(f"second_gen_block.conv_{i}", x))
        return self.conv("second_gen_block.conv_tail", x)

    def reconstruct(self, t):
        for i in range(3):
            t = self.gdn(f"first_gen_block.igdn_{i}", True,
                         self.conv(f"first_gen_block.conv_{i}", t))
        return torch.clamp(self.conv("first_gen_block.conv_3", t),
                           -_CLIP, _CLIP)

    # -- the res blocks --------------------------------------------------

    def infer_block(self, g: int, x, ddi=False):
        b = f"infer_block_{g}."
        h = F.elu(x)
        stats = (rvae.conv(self.p, b + "infer_posterior_loc_head", h,
                           ddi=ddi),
                 rvae.conv(self.p, b + "infer_posterior_log_scale_head", h,
                           ddi=ddi))
        r = rvae.conv(self.p, b + "infer_conv_1", F.elu(
            rvae.conv(self.p, b + "infer_conv_0", h, ddi=ddi)), ddi=ddi)
        return x + 0.1 * r, stats

    def infer(self, x, ddi=False):
        """Block 1's and block 2's posterior heads of NCHW images."""
        t, stats1 = self.infer_block(1, self.first_infer(x), ddi)
        _, stats2 = self.infer_block(2, self.second_infer(t), ddi)
        return stats1, stats2

    def prior(self, g: int, h, ddi=False) -> GaussianParams:
        b = f"gen_block_{g}."
        return GaussianParams(
            rvae.conv(self.p, b + "prior_loc_head", h, ddi=ddi),
            rvae.bounded_exp(rvae.conv(self.p, b + "prior_log_scale_head",
                                       h, ddi=ddi)))

    def posterior(self, g: int, h, stats, ddi=False) -> GaussianParams:
        b = f"gen_block_{g}."
        return GaussianParams(
            stats[0] + rvae.conv(self.p, b + "gen_posterior_loc_head", h,
                                 ddi=ddi),
            rvae.bounded_exp(stats[1] + rvae.conv(
                self.p, b + "gen_posterior_log_scale_head", h, ddi=ddi)))

    def residual(self, g: int, x, h, z, ddi=False):
        b = f"gen_block_{g}."
        t = torch.cat([rvae.conv(self.p, b + "gen_conv_0", h, ddi=ddi), z],
                      dim=1)
        return x + 0.1 * rvae.conv(self.p, b + "gen_conv_1", F.elu(t),
                                   ddi=ddi)

    def base(self, batch: int, height: int, width: int):
        return self.p["generative_base"][None, :, None, None].expand(
            batch, -1, height // 64, width // 64)


def _forward(m: Model, images, noise, ddi: bool) -> dict:
    B, H, W, _ = images.shape
    eps2, eps1 = (torch.as_tensor(n, dtype=torch.float32,
                                  device=images.device) for n in noise)
    stats1, stats2 = m.infer(nchw(images), ddi)
    t = m.base(B, H, W)
    groups = []
    for g, stats, eps in ((2, stats2, eps2), (1, stats1, eps1)):
        if g == 1:
            t = m.second_gen(t)
        h = F.elu(t)
        prior = m.prior(g, h, ddi)
        post = m.posterior(g, h, stats, ddi)
        t = m.residual(g, t, h, post.loc + post.scale * nchw(eps), ddi)
        groups.append((post, prior))
    recon = nhwc(m.reconstruct(t))
    scale = torch.clamp(torch.exp(m.p["likelihood_log_scale"]),
                        min=1.0 / 512.0)
    kl = [torch.sum(kl_divergence(q, p), dim=(1, 2, 3)) for q, p in groups]
    return {"reconstruction": recon + 0.5,
            "log_likelihood": discretized_logistic(
                images, torch.clamp(recon, -_CLIP, _CLIP), scale),
            "analytic_kl": torch.stack([kl[1], kl[0]]),
            "posterior_prior_pairs": [(bhwc(q), bhwc(p)) for q, p in groups]}


@torch.no_grad()
def forward(m: Model, images, noise) -> dict:
    """One forward pass of ``images`` (B, H, W, 3): the reconstruction in
    [0, 1], the per-image log-likelihood, ``analytic_kl`` (2, B) with block
    1 first, and each group's NHWC (posterior, prior), top-down.  ``noise``
    is the standard normals of block 2's and block 1's posterior samples,
    (B, h, w, c) each."""
    return _forward(m, images, noise, ddi=False)


@torch.no_grad()
def data_dependent_init(m: Model, images, noise) -> None:
    """Set every weight-normalised convolution's log_scale and bias from
    its output on ``images``, the posterior samples drawn with ``noise``
    (the port's ``data_dependent_init``)."""
    _forward(m, images, noise, ddi=True)


@torch.no_grad()
def decode(m: Model, replay, shape, seed: int, image=None):
    """The reconstruction (1, H, W, 3) in [0, 1] of one image from its
    file: ``replay(group, prior, posterior, seed)``, each (1, h, w, c),
    gives a group's sample, group 0 the top (block 2, seed + 7919), group
    1 block 1 (the seed).  The posteriors are those of the served
    ``image`` (1, H, W, 3) in [-0.5, 0.5], given the samples of the group
    before; without an image they are None."""
    H, W = shape
    stats = (m.infer(nchw(image)) if image is not None else (None, None))
    t = m.base(1, H, W)
    for group, (g, seed_g) in enumerate(((2, seed + 7919), (1, seed))):
        if g == 1:
            t = m.second_gen(t)
        h = F.elu(t)
        post = (bhwc(m.posterior(g, h, stats[g - 1]))
                if image is not None else None)
        z = replay(group, bhwc(m.prior(g, h)), post, seed_g)
        t = m.residual(g, t, h, nchw(z))
    return nhwc(m.reconstruct(t)) + 0.5


def decode_file(m: Model, data: bytes, cfg: beam.BeamConfig) -> np.ndarray:
    """A ``.rec`` file's 8-bit pixels (H, W, 3): the header, the latents
    replayed from seed and indices, the generative pass, the residual."""
    rec = ac.read_rec(data, cfg.max_partitions)
    dev = m.p["generative_base"].device

    def replay(group, prior, posterior, seed):
        shape = prior.loc.shape[1:]
        sp = beam.split_setup(cfg, shape, [seed], dev)
        ind, cnt = rec.latents[group]
        z = beam.replay_blocks(cfg, beam.split_blocks(prior, sp), ind, cnt,
                               sp.bkeys)
        return merge_batch(z, shape, sp.plan, sp.perms)

    recon = decode(m, replay, rec.shape[:2], rec.seed)
    return ac.decode_residual(rec.residual, recon[0].cpu().numpy())
