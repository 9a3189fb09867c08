"""The two-level lossy VAE (Ballé et al.'s hyperprior analogue that iREC
codes, ``Large2LevelVAE``) in plain PyTorch over a flat dict of weights:
the decode from a file's two latent levels (the empirical level-2 prior,
the hyper-synthesis that gives the level-1 prior, the synthesis
transform).  It follows the port's operation order
(``models/lossy/{level2,transforms}.py``, ``models/signal.py``) so that on
one device it gives the port's bits.  Weights are keyed as the port's
``state_dict``; NCHW inside, NHWC at the functions below."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .gauss import GaussianParams

Params = Dict[str, torch.Tensor]
_PEDESTAL = (2.0 ** -18) ** 2
_BETA_BOUND = (1e-6 + _PEDESTAL) ** 0.5
_GAMMA_BOUND = (0.0 + _PEDESTAL) ** 0.5


def irdft_matrix(shape: Tuple[int, int]) -> np.ndarray:
    """Orthonormal inverse-RDFT basis over a kernel's support."""
    from scipy.fftpack import rfft

    size = int(np.prod(shape))
    matrix = np.identity(size, dtype=np.float64).reshape((size,)
                                                         + tuple(shape))
    for axis in range(2):
        matrix = rfft(matrix, axis=axis + 1)
        slices = [slice(None)] * 3
        slices[axis + 1] = (slice(1, None) if shape[axis] % 2 == 1
                            else slice(1, -1))
        matrix[tuple(slices)] *= np.sqrt(2)
    matrix /= np.sqrt(size)
    return matrix.reshape((size, size)).astype(np.float32)


def _same_padding(k: int, corr: bool, up: int) -> Tuple[int, int]:
    lo, hi = (k // 2, (k - 1) // 2) if corr else ((k - 1) // 2, k // 2)
    return (lo - 1) // up + 1, (hi - 1) // up + 1


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m >= n, period - m, m)


def reflect_pad(x, pad_h, pad_w):
    if pad_h[0] or pad_h[1]:
        x = x.index_select(2, _reflect_index(x.shape[2], *pad_h, x.device))
    if pad_w[0] or pad_w[1]:
        x = x.index_select(3, _reflect_index(x.shape[3], *pad_w, x.device))
    return x


# (name, c_in, c_out, kernel, corr, down, up, bias, dft) of every signal
# convolution of the model at widths f1, f2.
def signal_convs(f1: int, f2: int) -> List[tuple]:
    out = []
    for i in range(3):
        out.append((f"analysis.conv_{i}", 3 if i == 0 else f1, f1, 5, True,
                    2, 1, True, True))
    for head in ("posterior_loc_head", "posterior_log_scale_head"):
        out.append((f"analysis.{head}", f1, f1, 5, True, 2, 1, True, True))
    for i in range(3):
        out.append((f"synthesis.conv_{i}", f1, f1, 5, False, 1, 2, True,
                    True))
    out.append(("synthesis.conv_out", f1, 3, 5, False, 1, 2, True, True))
    out += [("hyper_analysis.conv_0", f1, f2, 3, True, 1, 1, True, True),
            ("hyper_analysis.conv_1", f2, f2, 5, True, 2, 1, True, True)]
    for head in ("posterior_loc_head", "posterior_log_scale_head"):
        out.append((f"hyper_analysis.{head}", f2, f2, 5, True, 2, 1, False,
                    True))
    out += [("hyper_synthesis.conv_0", f2, f2, 5, False, 1, 2, True, False),
            ("hyper_synthesis.conv_1", f2, f2, 5, False, 1, 2, True, False)]
    for head in ("prior_loc_head", "prior_log_scale_head"):
        out.append((f"hyper_synthesis.{head}", f2, f1, 3, False, 1, 1, True,
                    False))
    for name in ("prior_conv", "prior_loc_head", "prior_log_scale_head"):
        out.append((f"level_2_prior.{name}", f2, f2, 3, True, 1, 1, True,
                    True))
    return out


GDNS = [(f"analysis.gdn_{i}", False) for i in range(3)] + [
    (f"synthesis.igdn_{i}", True) for i in range(3)]


def fresh_weights(f1: int, f2: int, seed: int, device) -> Params:
    """Fresh weights from ``seed`` on ``device``, with the model's own
    initialisers: variance-scaling uniform kernels (as their RDFT
    coefficients where the kernel is so parametrised), zero biases and
    prior base, GDN at beta 1 and gamma 0.1 I, the 1x1 combiners uniform
    at the truncated LeCun normal's standard deviation.  One uniform draw
    on the device serves every random weight."""
    convs = signal_convs(f1, f2)
    sizes = [k * k * cin * cout for _, cin, cout, k, *_ in convs]
    comb = 2 * f1 * f1
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes) + 2 * comb, generator=gen, device=device)
    p, off = {}, 0
    for (name, cin, cout, k, corr, down, up, bias, dft), n in zip(convs,
                                                                  sizes):
        limit = math.sqrt(3.0 / ((k * k * cin + k * k * cout) / 2.0))
        hwio = ((2.0 * u[off:off + n] - 1.0) * limit).reshape(k, k, cin,
                                                               cout)
        off += n
        if dft:
            basis = torch.from_numpy(irdft_matrix((k, k))).to(device)
            p[name + ".kernel_rdft"] = basis.t() @ hwio.reshape(k * k, -1)
        else:
            p[name + ".kernel"] = hwio.permute(3, 2, 0, 1).contiguous()
        if bias:
            p[name + ".bias"] = torch.zeros(cout, device=device)
    for name, _ in GDNS:
        p[name + ".beta_reparam"] = torch.sqrt(
            torch.ones(f1, device=device) + _PEDESTAL)
        p[name + ".gamma_reparam"] = torch.sqrt(
            0.1 * torch.eye(f1, device=device) + _PEDESTAL)
    p["level_2_prior.prior_base"] = torch.zeros(f2, device=device)
    std = math.sqrt(1.0 / (2 * f1)) / 0.87962566103423978
    for name in ("level_1_posterior_loc_combiner",
                 "level_1_posterior_log_scale_combiner"):
        w = (2.0 * u[off:off + comb] - 1.0) * (std * math.sqrt(3.0))
        off += comb
        p[name + ".kernel"] = w.reshape(f1, 2 * f1, 1, 1)
        p[name + ".bias"] = torch.zeros(f1, device=device)
    return p


class Model:
    def __init__(self, p: Params, f1: int, f2: int):
        self.p = p
        self.spec = {c[0]: c[1:] for c in signal_convs(f1, f2)}
        self.basis = {}

    def _hwio(self, name):
        cin, cout, k, corr, down, up, bias, dft = self.spec[name]
        if dft:
            if k not in self.basis:
                self.basis[k] = torch.from_numpy(irdft_matrix((k, k))).to(
                    self.p[name + ".kernel_rdft"].device)
            return (self.basis[k] @ self.p[name + ".kernel_rdft"]).reshape(
                k, k, cin, cout)
        return self.p[name + ".kernel"].permute(2, 3, 1, 0)

    def conv(self, name, x):
        cin, cout, k, corr, down, up, bias, dft = self.spec[name]
        kernel = self._hwio(name)
        if not corr and up == 1:
            corr = True
            kernel = torch.flip(kernel, (0, 1))
        elif corr and up != 1:
            corr = False
            kernel = torch.flip(kernel, (0, 1))
        pad = _same_padding(k, corr, up)
        x = reflect_pad(x, pad, pad)
        if up == 1:
            out = F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=down)
        else:
            lo = k - 1 - (pad[0] * up + k // 2)
            hi = k - 1 - (pad[1] * up + (k - 1) // 2) + up - 1
            n, c, h, w = x.shape
            dil = x.new_zeros((n, c, (h - 1) * up + 1, (w - 1) * up + 1))
            dil[:, :, ::up, ::up] = x
            dil = F.pad(dil, (lo, hi, lo, hi))
            kernel = torch.flip(kernel, (0, 1))
            out = F.conv2d(dil, kernel.permute(3, 2, 0, 1))
            if down > 1:
                out = out[:, :, ::down, ::down]
        if bias:
            out = out + self.p[name + ".bias"][None, :, None, None]
        return out

    def gdn(self, name, inverse, x):
        beta = torch.square(torch.clamp(self.p[name + ".beta_reparam"],
                                        min=_BETA_BOUND)) - _PEDESTAL
        gamma = torch.square(torch.clamp(self.p[name + ".gamma_reparam"],
                                         min=_GAMMA_BOUND)) - _PEDESTAL
        norm = F.conv2d(torch.square(x), gamma.t()[:, :, None, None], beta)
        norm = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
        return x * norm

    def level2_prior(self, batch, h, w) -> GaussianParams:
        f2 = self.p["level_2_prior.prior_base"].shape[0]
        t = self.p["level_2_prior.prior_base"][None, :, None, None].expand(
            batch, f2, h, w)
        t = F.elu(self.conv("level_2_prior.prior_conv", t))
        return GaussianParams(
            self.conv("level_2_prior.prior_loc_head", t),
            F.softplus(self.conv("level_2_prior.prior_log_scale_head", t))
            + 1e-7)

    def _hyper_synthesis(self, z2):
        x = F.relu(self.conv("hyper_synthesis.conv_0", z2))
        x = F.relu(self.conv("hyper_synthesis.conv_1", x))
        return (self.conv("hyper_synthesis.prior_loc_head", x),
                self.conv("hyper_synthesis.prior_log_scale_head", x))

    def level1_prior(self, z2) -> GaussianParams:
        loc, log_scale = self._hyper_synthesis(z2)
        return GaussianParams(loc, F.softplus(log_scale) + 1e-7)

    def analysis(self, x):
        """The level-1 heads (loc, log_scale) of images (NCHW, [0, 1])."""
        for i in range(3):
            x = self.gdn(f"analysis.gdn_{i}", False,
                         self.conv(f"analysis.conv_{i}", x))
        return (self.conv("analysis.posterior_loc_head", x),
                self.conv("analysis.posterior_log_scale_head", x))

    def level2_posterior(self, l1_loc) -> GaussianParams:
        x = F.relu(self.conv("hyper_analysis.conv_0", l1_loc))
        x = F.relu(self.conv("hyper_analysis.conv_1", x))
        return GaussianParams(
            self.conv("hyper_analysis.posterior_loc_head", x),
            F.softplus(self.conv("hyper_analysis.posterior_log_scale_head",
                                 x)) + 1e-7)

    def level1_posterior(self, z2, l1_loc, l1_log_scale) -> GaussianParams:
        """The level-1 posterior: the analysis heads and the prior's, each
        concatenated and through elu, combined by 1x1 convolutions."""
        p_loc, p_log_scale = self._hyper_synthesis(z2)
        loc = F.elu(torch.cat([l1_loc, p_loc], dim=1))
        log_scale = F.elu(torch.cat([l1_log_scale, p_log_scale], dim=1))
        comb = "level_1_posterior_{}_combiner."
        return GaussianParams(
            F.conv2d(loc, self.p[comb.format("loc") + "kernel"],
                     self.p[comb.format("loc") + "bias"]),
            F.softplus(F.conv2d(
                log_scale, self.p[comb.format("log_scale") + "kernel"],
                self.p[comb.format("log_scale") + "bias"])) + 1e-7)

    def synthesis(self, z1):
        x = z1
        for i in range(3):
            x = self.gdn(f"synthesis.igdn_{i}", True,
                         self.conv(f"synthesis.conv_{i}", x))
        return self.conv("synthesis.conv_out", x)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def bhwc(d: GaussianParams) -> GaussianParams:
    return GaussianParams(nhwc(d.loc), nhwc(d.scale))


@torch.no_grad()
def decode(m: Model, replay, shape, seed: int, image):
    """The reconstruction (1, H, W, 3) of one image from its file:
    ``replay(level, prior, posterior, seed)``, each (1, h, w, c), gives a
    level's sample; the posteriors are those of the served ``image`` (1,
    H, W, 3) in [0, 1], the level-1 one given the level-2 sample.  Level 2
    codes with the image's seed, level 1 with seed + 1."""
    H, W = shape
    l1_loc, l1_log_scale = m.analysis(nchw(image))
    z2 = replay(0, bhwc(m.level2_prior(1, H // 64, W // 64)),
                bhwc(m.level2_posterior(l1_loc)), seed)
    z2 = nchw(z2)
    z1 = replay(1, bhwc(m.level1_prior(z2)),
                bhwc(m.level1_posterior(z2, l1_loc, l1_log_scale)), seed + 1)
    return nhwc(m.synthesis(nchw(z1)))
