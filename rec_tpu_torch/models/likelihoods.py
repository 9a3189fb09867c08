"""Reconstruction likelihoods for the lossless models (port of
rec_tpu/models/likelihoods.py).

Images are normalised to [-0.5, 0.5]; each function maps (reference,
reconstruction, scale) -> per-image log likelihood in nats, summed over the
last three (H, W, C) axes.
"""

from __future__ import annotations

import torch

from ..utils.metrics import ms_ssim

AVAILABLE_LIKELIHOODS = ("discretized_logistic", "gaussian", "laplace",
                         "ms-ssim")


def discretized_logistic(reference, reconstruction, scale,
                         binsize: float = 1.0 / 256.0):
    """P(x in [floor(x/b)*b, +b)) under Logistic(reconstruction, scale)."""
    x = torch.floor(reference / binsize) * binsize
    x = (x - reconstruction) / scale
    p = torch.sigmoid(x + binsize / scale) - torch.sigmoid(x)
    return torch.sum(torch.log(p + 1e-7), dim=(-3, -2, -1))


def gaussian(reference, reconstruction, scale):
    z = (reference - reconstruction) / scale
    log_p = -0.5 * torch.square(z) - torch.log(scale) - 0.9189385332046727
    return torch.sum(log_p, dim=(-3, -2, -1))


def laplace(reference, reconstruction, scale):
    log_p = (-torch.abs(reference - reconstruction) / scale
             - torch.log(2.0 * scale))
    return torch.sum(log_p, dim=(-3, -2, -1))


def ms_ssim_pseudo(reference, reconstruction, scale):
    """Pseudo log-likelihood proportional to MS-SSIM."""
    return ms_ssim(reference / scale, reconstruction / scale,
                   max_val=1.0) / scale


def get_likelihood(name: str):
    table = {
        "discretized_logistic": discretized_logistic,
        "gaussian": gaussian,
        "laplace": laplace,
        "ms-ssim": ms_ssim_pseudo,
    }
    if name not in table:
        raise ValueError(
            f"likelihood must be one of {AVAILABLE_LIKELIHOODS}, got {name}")
    return table[name]
