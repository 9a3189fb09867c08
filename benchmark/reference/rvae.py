"""The RVAE (bidirectional ResNet VAE, Kingma et al. 2016's IAF-free
variant that iREC codes) in plain PyTorch over a flat dict of weights.

It follows the port's operation order (``models/resnet_vae.py`` and
``models/modules.py``), so that on one device its generative pass gives
the port's bits: a lossless file's residual is coded against the decoder's
reconstruction, and only an exact one decodes it.  Weights are keyed as
the port's ``state_dict`` (``first_infer_conv.v``, ``gen_blocks.3.
gen_conv_1.bias``, ...); the weight-normalised kernel is
``v / ||v||`` per output channel times ``exp(log_scale)``, plus a bias, and
the data-dependent init sets ``log_scale`` and ``bias`` from the first
batch's statistics.  Tensors are NCHW inside and NHWC at the functions
below.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .gauss import GaussianParams

Params = Dict[str, torch.Tensor]
INIT_SCALE = 0.1


def full_precision() -> None:
    """float32 as stated: no TF32, fixed cuDNN algorithms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _kernel(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(torch.square(v), dim=(1, 2, 3),
                                     keepdim=True) + 1e-12)


def _scale_bias(p: Params, name: str, out: torch.Tensor, ddi: bool):
    if ddi:
        var = torch.var(out, dim=(0, 2, 3), unbiased=False)
        p[name + ".log_scale"].copy_(torch.clamp(
            torch.log(INIT_SCALE * torch.rsqrt(var + 1e-10)), -4.6, 4.6))
    out = out * torch.exp(p[name + ".log_scale"])[None, :, None, None]
    if ddi:
        p[name + ".bias"].copy_(-torch.mean(out, dim=(0, 2, 3)))
    return out + p[name + ".bias"][None, :, None, None]


def conv(p: Params, name: str, x, stride: int = 1, ddi: bool = False):
    w = _kernel(p[name + ".v"])
    kh, kw = w.shape[2:]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return _scale_bias(p, name, F.conv2d(x, w, stride=stride), ddi)


def conv_transpose(p: Params, name: str, x, stride: int = 2,
                   ddi: bool = False):
    """XLA's "SAME" transposed convolution, kernel not flipped: the input
    dilated by the stride, padded, correlated with the kernel as stored."""
    w = _kernel(p[name + ".v"])
    k = w.shape[2]
    n, c, h, wd = x.shape
    dil = x.new_zeros((n, c, (h - 1) * stride + 1, (wd - 1) * stride + 1))
    dil[:, :, ::stride, ::stride] = x
    pad_len = k + stride - 2
    lo = k - 1 if stride > k - 1 else -(-pad_len // 2)
    dil = F.pad(dil, (lo, pad_len - lo, lo, pad_len - lo))
    return _scale_bias(p, name, F.conv2d(dil, w), ddi)


def bounded_exp(x):
    return torch.exp(torch.clamp(x, -12.0, 12.0))


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def infer(p: Params, n_blocks: int, x, ddi: bool = False) -> List[tuple]:
    """Bottom-up pass on NCHW images: per-block (loc, log_scale) heads, in
    generative order."""
    t = conv(p, "first_infer_conv", x, stride=2, ddi=ddi)
    outs = []
    for i in range(n_blocks):
        b = f"infer_blocks.{i}."
        h = F.elu(t)
        outs.append((conv(p, b + "infer_posterior_loc_head", h, ddi=ddi),
                     conv(p, b + "infer_posterior_log_scale_head", h,
                          ddi=ddi)))
        r = conv(p, b + "infer_conv_1",
                 F.elu(conv(p, b + "infer_conv_0", h, ddi=ddi)), ddi=ddi)
        t = t + 0.1 * r
    return outs[::-1]


def prior(p: Params, g: int, h, ddi=False) -> GaussianParams:
    b = f"gen_blocks.{g}."
    return GaussianParams(conv(p, b + "prior_loc_head", h, ddi=ddi),
                          bounded_exp(conv(p, b + "prior_log_scale_head", h,
                                           ddi=ddi)))


def posterior(p: Params, g: int, h, stats, ddi=False) -> GaussianParams:
    b = f"gen_blocks.{g}."
    return GaussianParams(
        stats[0] + conv(p, b + "gen_posterior_loc_head", h, ddi=ddi),
        bounded_exp(stats[1] + conv(p, b + "gen_posterior_log_scale_head",
                                    h, ddi=ddi)))


def residual(p: Params, g: int, x, h, z, ddi=False):
    b = f"gen_blocks.{g}."
    t = torch.cat([conv(p, b + "gen_conv_0", h, ddi=ddi), z], dim=1)
    return x + 0.1 * conv(p, b + "gen_conv_1", F.elu(t), ddi=ddi)


def base(p: Params, batch: int, height: int, width: int):
    return p["generative_base"][None, :, None, None].expand(
        batch, -1, height // 2, width // 2)


def reconstruct(p: Params, t, ddi=False):
    r = conv_transpose(p, "last_gen_conv", F.elu(t), ddi=ddi)
    return torch.clamp(r, -0.5 + 1.0 / 512.0, 0.5 - 1.0 / 512.0)


def bhwc(d: GaussianParams) -> GaussianParams:
    return GaussianParams(nhwc(d.loc), nhwc(d.scale))


@torch.no_grad()
def data_dependent_init(p: Params, n_blocks: int, images, noise) -> None:
    """Set every convolution's log_scale and bias from its output on
    ``images`` (B, H, W, C) in [-0.5, 0.5], with posterior samples drawn
    from the standard normals ``noise`` (n_blocks, B, H/2, W/2, C_z)."""
    B, H, W, _ = images.shape
    stats = infer(p, n_blocks, nchw(images), ddi=True)
    t = base(p, B, H, W)
    for g in range(n_blocks):
        h = F.elu(t)
        prior(p, g, h, ddi=True)
        post = posterior(p, g, h, stats[g], ddi=True)
        z = post.loc + post.scale * nchw(noise[g])
        t = residual(p, g, t, h, z, ddi=True)
    reconstruct(p, t, ddi=True)


def decode(p: Params, n_blocks: int, replay, shape, seeds, images) -> list:
    """The generative pass of M images from their files, each at batch 1
    as the port's canonical decode runs it; ``replay(g, priors (M, h, w,
    c), posteriors (M, h, w, c), seeds_g)`` gives res block g's latent
    samples of all M at once (the replay is blockwise, so batching it
    changes no bit).  The posteriors are those of the served ``images``
    (M, H, W, C) in [-0.5, 0.5], given the samples of the blocks before.
    Returns M reconstructions (1, H, W, C) in [0, 1]."""
    H, W = shape
    M = len(seeds)
    stats = [infer(p, n_blocks, nchw(images[i:i + 1])) for i in range(M)]
    ts = [base(p, 1, H, W) for _ in range(M)]
    for g in range(n_blocks):
        hs = [F.elu(t) for t in ts]
        prs = [bhwc(prior(p, g, h)) for h in hs]
        pos = [bhwc(posterior(p, g, h, s[g])) for h, s in zip(hs, stats)]
        z = replay(g, GaussianParams(torch.cat([d.loc for d in prs]),
                                     torch.cat([d.scale for d in prs])),
                   GaussianParams(torch.cat([d.loc for d in pos]),
                                  torch.cat([d.scale for d in pos])),
                   [s + 7919 * g for s in seeds])
        for i in range(M):
            ts[i] = residual(p, g, ts[i], hs[i], nchw(z[i:i + 1].clone()))
    return [nhwc(reconstruct(p, t)) + 0.5 for t in ts]


def param_shapes(cfg: dict) -> List[tuple]:
    """(name, shape) of every weight, in one fixed order: the kernels
    ``v`` (OIHW), their ``log_scale`` and ``bias``, the generative base and
    the likelihood's log-scale."""
    det, sto, n = (cfg["deterministic_filters"], cfg["stochastic_filters"],
                   cfg["num_res_blocks"])
    k, fk, c = (cfg["kernel_size"][0], cfg["first_kernel_size"][0],
                cfg["output_channels"])
    convs = [("first_infer_conv", c, det, fk)]
    for i in range(n):
        b = f"infer_blocks.{i}."
        convs += [(b + "infer_posterior_loc_head", det, sto, k),
                  (b + "infer_posterior_log_scale_head", det, sto, k),
                  (b + "infer_conv_0", det, det, k),
                  (b + "infer_conv_1", det, det, k)]
    for i in range(n):
        b = f"gen_blocks.{i}."
        convs += [(b + "prior_loc_head", det, sto, k),
                  (b + "prior_log_scale_head", det, sto, k),
                  (b + "gen_posterior_loc_head", det, sto, k),
                  (b + "gen_posterior_log_scale_head", det, sto, k),
                  (b + "gen_conv_0", det, det, k),
                  (b + "gen_conv_1", det + sto, det, k)]
    convs.append(("last_gen_conv", det, c, fk))
    out = []
    for name, cin, cout, kk in convs:
        out += [(name + ".v", (cout, cin, kk, kk)),
                (name + ".log_scale", (cout,)), (name + ".bias", (cout,))]
    return out + [("generative_base", (det,)), ("likelihood_log_scale", ())]


def fresh_weights(cfg: dict, seed: int, device) -> Params:
    """Weights before the data-dependent init, from ``seed`` on
    ``device``: every kernel ``v`` and the generative base from one draw of
    standard normals (scaled 0.05 and 0.1, as the model's own init), the
    log-scales and biases zero."""
    shapes = param_shapes(cfg)
    drawn = [(n, s) for n, s in shapes
             if n.endswith(".v") or n == "generative_base"]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    p, off = {}, 0
    for name, shape in shapes:
        if name.endswith(".v") or name == "generative_base":
            size = math.prod(shape)
            scale = 0.05 if name.endswith(".v") else 0.1
            p[name] = scale * flat[off:off + size].reshape(shape)
            off += size
        else:
            p[name] = torch.zeros(shape, device=device)
    return p
