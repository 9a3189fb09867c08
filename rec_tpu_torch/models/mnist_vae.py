"""MNIST dense VAEs and their priors (port of rec_tpu/models/mnist_vae.py):
the Lawson et al. encoder and decoder (784-300-300-50), a standard-normal
prior (``MNISTVAE``), the VampPrior (``MNISTVampVAE``, 500 inducing
pseudo-images), a per-dimension mixture of Gaussians (``MNISTMoGVAE``, a
50 x 100 component grid) and an SNIS prior (``MNISTSNISVAE``,
``SNISDistribution`` with K = 1024 and a 100-wide energy net).

The modules carry flax's names (``encoder.Dense_0``, ``prior.energy_head``,
...), so ``models/mnist_convert.py`` maps a flax tree onto them.  Fresh
weights come from a ``torch.Generator`` seeded by ``seed`` with torch's
``nn.Linear`` initialisation, not flax's; ``inducing_points`` and the MoG
grid are drawn as ``rec_tpu`` draws them (uniform on [0, 1) and [-1, 1)).
Every draw is an argument: the posterior noise ``eps`` (B, latents), the
SNIS bound's proposals (K - 1, latents) and, for ``SNISDistribution.
sample_from``, the proposals and their Gumbel noise.  Images are NHWC in
[0, 1].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..coding.gauss import GaussianParams
from ..device import resolve_device

_HALF_LOG_2PI = 0.9189385332046727


def dense(n_in: int, n_out: int, g: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with torch's default initialisation (uniform on
    +-1/sqrt(n_in), weight and bias) drawn from ``g``."""
    layer = nn.Linear(n_in, n_out)
    bound = 1.0 / math.sqrt(n_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=g)
        layer.bias.uniform_(-bound, bound, generator=g)
    return layer


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _uniform(shape, lo: float, hi: float, g: torch.Generator):
    return nn.Parameter(torch.empty(shape).uniform_(lo, hi, generator=g))


class MNISTEncoder(nn.Module):
    """Flatten -> 2 x (Dense hidden + tanh) -> (loc, softplus scale)."""

    def __init__(self, latents: int = 50, hidden_size: int = 300,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or _generator(0)
        self.Dense_0 = dense(28 * 28, hidden_size, g)
        self.Dense_1 = dense(hidden_size, hidden_size, g)
        self.Dense_2 = dense(hidden_size, latents, g)
        self.Dense_3 = dense(hidden_size, latents, g)

    def forward(self, x: torch.Tensor) -> GaussianParams:
        h = x.reshape(x.shape[0], -1)
        h = torch.tanh(self.Dense_0(h))
        h = torch.tanh(self.Dense_1(h))
        pre = self.Dense_3(h)
        scale = torch.logaddexp(pre, torch.zeros_like(pre)) + 1e-5
        return GaussianParams(self.Dense_2(h), scale)


class MNISTDecoder(nn.Module):
    """2 x (Dense hidden + tanh) -> 784 logits -> sigmoid image."""

    def __init__(self, latents: int = 50, hidden_size: int = 300,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or _generator(0)
        self.Dense_0 = dense(latents, hidden_size, g)
        self.Dense_1 = dense(hidden_size, hidden_size, g)
        self.Dense_2 = dense(hidden_size, 28 * 28, g)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.Dense_0(z))
        h = torch.tanh(self.Dense_1(h))
        return torch.sigmoid(self.Dense_2(h)).reshape(-1, 28, 28, 1)


def bernoulli_log_prob(probs: torch.Tensor, x: torch.Tensor,
                       eps: float = 1e-10) -> torch.Tensor:
    """sum over (H, W, C) of x log p + (1 - x) log(1 - p), p clipped to
    [eps, 1 - eps] (1 - eps rounds to 1 in float32, as in rec_tpu)."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    lp = x * torch.log(p) + (1.0 - x) * torch.log1p(-p)
    return torch.sum(lp, dim=(-3, -2, -1))


def _log_prob(p: GaussianParams, z: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(z; p), as rec_tpu's ``GaussianParams.log_prob``."""
    zz = (z - p.loc) / p.scale
    return -0.5 * torch.square(zz) - torch.log(p.scale) - _HALF_LOG_2PI


class _VAE(nn.Module):
    """Encoder, decoder, and the forward pass every prior shares."""

    def __init__(self, latents: int, hidden_size: int, g: torch.Generator):
        super().__init__()
        self.latents = latents
        self.encoder = MNISTEncoder(latents, hidden_size, g)
        self.decoder = MNISTDecoder(latents, hidden_size, g)

    @property
    def device(self) -> torch.device:
        return self.encoder.Dense_0.weight.device

    def posterior(self, x: torch.Tensor) -> GaussianParams:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def kl(self, post: GaussianParams, z: torch.Tensor, proposals=None
           ) -> torch.Tensor:
        """The single-sample KL estimate log q(z) - log p(z), (B,)."""
        return (torch.sum(_log_prob(post, z), dim=-1)
                - self.prior_log_prob(z, proposals))

    def forward(self, x: torch.Tensor, eps: torch.Tensor,
                proposals: Optional[torch.Tensor] = None) -> dict:
        """``eps`` (B, latents) standard normals: z = loc + scale * eps."""
        post = self.encoder(x)
        z = post.loc + post.scale * eps
        recon = self.decoder(z)
        return {"reconstruction": recon, "kl": self.kl(post, z, proposals),
                "log_likelihood": bernoulli_log_prob(recon, x),
                "posterior": post, "latent": z}


class MNISTVAE(_VAE):
    """Standard-normal-prior dense VAE."""

    def __init__(self, latents: int = 50, hidden_size: int = 300, *,
                 seed: int = 0, device="cuda"):
        super().__init__(latents, hidden_size, _generator(seed))
        self.to(resolve_device(device))

    def kl(self, post, z, proposals=None):
        # Summed after the difference, against an N(0, 1) of zeros and
        # ones, as rec_tpu's MNISTVAE sums it.
        prior = GaussianParams(torch.zeros_like(z), torch.ones_like(z))
        return torch.sum(_log_prob(post, z) - _log_prob(prior, z), dim=-1)


class MNISTVampVAE(_VAE):
    """VampPrior VAE: the prior is a uniform mixture of the encoder pushed
    through learned inducing pseudo-images."""

    def __init__(self, latents: int = 50, hidden_size: int = 300,
                 num_vamp_components: int = 500, *, seed: int = 0,
                 device="cuda"):
        g = _generator(seed)
        super().__init__(latents, hidden_size, g)
        self.inducing_points = _uniform((num_vamp_components, 28, 28, 1),
                                        0.0, 1.0, g)
        self.to(resolve_device(device))

    def prior_log_prob(self, z: torch.Tensor, proposals=None):
        comp = self.encoder(self.inducing_points)                 # (K, L)
        lp = torch.sum(_log_prob(comp, z[:, None, :]), dim=-1)    # (B, K)
        return (torch.logsumexp(lp, dim=-1)
                - math.log(self.inducing_points.shape[0]))


class MNISTMoGVAE(_VAE):
    """Mixture-of-Gaussians prior: per dimension a learned uniform mixture
    of ``num_components`` Gaussians (loc and log-scale grids initialised
    uniform on [-1, 1))."""

    def __init__(self, latents: int = 50, hidden_size: int = 300,
                 num_components: int = 100, *, seed: int = 0,
                 device="cuda"):
        g = _generator(seed)
        super().__init__(latents, hidden_size, g)
        self.mog_loc = _uniform((latents, num_components), -1.0, 1.0, g)
        self.mog_log_scale = _uniform((latents, num_components), -1.0, 1.0,
                                      g)
        self.to(resolve_device(device))

    def prior_log_prob(self, z: torch.Tensor, proposals=None):
        """Sum over dims of log (1/K) sum_k N(z_d | loc_dk, scale_dk)."""
        scale = torch.exp(self.mog_log_scale)                     # (L, K)
        comp = (-0.5 * torch.square((z[..., None] - self.mog_loc) / scale)
                - torch.log(scale) - _HALF_LOG_2PI)               # (B, L, K)
        per_dim = (torch.logsumexp(comp, dim=-1)
                   - math.log(self.mog_loc.shape[1]))
        return torch.sum(per_dim, dim=-1)


class SNISDistribution(nn.Module):
    """Self-normalized importance-sampling distribution over a
    standard-normal proposal with a learned energy network."""

    def __init__(self, dim: int, K: int = 128, hidden: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or _generator(0)
        self.dim, self.K = dim, K
        self.energy_0 = dense(dim, hidden, g)
        self.energy_1 = dense(hidden, hidden, g)
        self.energy_head = dense(hidden, 1, g)

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.energy_0(x))
        h = torch.tanh(self.energy_1(h))
        return self.energy_head(h)

    def sample_from(self, proposals: torch.Tensor, gumbel: torch.Tensor
                    ) -> torch.Tensor:
        """One sample: proposals (K, dim) and Gumbel noise (K,), the
        categorical over the energies as a Gumbel argmax."""
        i = torch.argmax(self.energy(proposals)[:, 0] + gumbel)
        return proposals[i]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        dev = self.energy_0.weight.device
        proposals = torch.randn((self.K, self.dim), generator=generator,
                                device=generator.device).to(dev)
        u = torch.rand((self.K,), generator=generator,
                       device=generator.device).to(dev)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        return self.sample_from(proposals, gumbel)

    def log_prob_lower_bound(self, x: torch.Tensor, proposals: torch.Tensor
                             ) -> torch.Tensor:
        """IWAE-style lower bound on log density (B, 1), from K - 1
        standard-normal proposals (K - 1, dim)."""
        x = x.reshape(-1, self.dim)
        weights = self.energy(proposals)[:, 0]                    # (K-1,)
        x_energy = self.energy(x)                                 # (B, 1)
        x_pi = torch.sum(-0.5 * torch.square(x) - _HALF_LOG_2PI, dim=1,
                         keepdim=True)
        tiled = weights[None, :].expand(x.shape[0], self.K - 1)
        norm = torch.logsumexp(torch.cat([tiled, x_energy], dim=1), dim=1,
                               keepdim=True)
        return x_energy + x_pi + math.log(self.K) - norm

    def forward(self, x, proposals):
        return self.log_prob_lower_bound(x, proposals)


class MNISTSNISVAE(_VAE):
    """SNIS-prior VAE: the prior density is the SNIS IWAE-style lower
    bound of a learned energy tilt over a standard-normal proposal; the
    forward pass needs the bound's proposals (snis_K - 1, latents)."""

    def __init__(self, latents: int = 50, hidden_size: int = 300,
                 snis_K: int = 1024, snis_hidden: int = 100, *,
                 seed: int = 0, device="cuda"):
        g = _generator(seed)
        super().__init__(latents, hidden_size, g)
        self.prior = SNISDistribution(latents, snis_K, snis_hidden, g)
        self.to(resolve_device(device))

    def prior_log_prob(self, z: torch.Tensor, proposals=None):
        if proposals is None:
            raise ValueError("MNISTSNISVAE needs the SNIS proposals")
        return self.prior.log_prob_lower_bound(z, proposals)[:, 0]


def proposal_shape(model: nn.Module):
    """The (K - 1, latents) shape of an SNIS model's per-step proposals,
    or None for the other priors."""
    if isinstance(model, MNISTSNISVAE):
        return (model.prior.K - 1, model.latents)
    return None
