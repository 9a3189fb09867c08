"""Image quality metrics: PSNR, SSIM and MS-SSIM (port of
rec_tpu/utils/metrics.py).

Wang et al.'s multi-scale SSIM: per-scale SSIM with an 11x11 Gaussian
window (sigma 1.5, VALID), 2x2 average pooling between scales and the five
canonical scale weights.  Images are NHWC (any leading batch axes) at every
function here; the filtering inside is a depthwise ``F.conv2d`` on NCHW.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio over (H, W, C); batched over leading
    axes."""
    mse = torch.mean(torch.square(a - b), dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (prod(...), C, H, W)."""
    return x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor, lead) -> torch.Tensor:
    x = x.permute(0, 2, 3, 1)
    return x.reshape(tuple(lead) + tuple(x.shape[1:]))


def _filter2d(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Depthwise VALID filtering, NHWC."""
    C = x.shape[-1]
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    w = k[None, None].expand(C, 1, *k.shape)
    return _nhwc(F.conv2d(_nchw(x), w, groups=C), x.shape[:-3])


def _ssim_per_scale(a, b, max_val, k1=0.01, k2=0.03, size=11, sigma=1.5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean luminance x contrast-structure term, mean
    contrast-structure term)."""
    kernel = _gaussian_kernel(size, sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu_a = _filter2d(a, kernel)
    mu_b = _filter2d(b, kernel)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = _filter2d(a * a, kernel) - mu_aa
    sigma_bb = _filter2d(b * b, kernel) - mu_bb
    sigma_ab = _filter2d(a * b, kernel) - mu_ab

    lum = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    cs = (2.0 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    dims = (-3, -2, -1)
    return torch.mean(lum * cs, dim=dims), torch.mean(cs, dim=dims)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling, NHWC; an odd H or W is first padded by
    repeating its last row or column (edge padding)."""
    h, w = x.shape[-3], x.shape[-2]
    y = F.pad(_nchw(x), (0, w % 2, 0, h % 2), mode="replicate")
    return _nhwc(F.avg_pool2d(y, 2), x.shape[:-3])


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Single-scale SSIM, batched over leading axes (NHWC)."""
    ssim_val, _ = _ssim_per_scale(a, b, max_val)
    return ssim_val


def ms_ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
            weights=_MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003).  H and W must be at least
    11 * 2^(scales - 1); callers with smaller images pass fewer
    weights."""
    weights = torch.as_tensor(np.asarray(weights), dtype=a.dtype,
                              device=a.device)
    mcs = []
    lum_cs = None
    for i in range(len(weights)):
        lum_cs, cs = _ssim_per_scale(a, b, max_val)
        if i < len(weights) - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            a, b = _avg_pool2(a), _avg_pool2(b)
    terms = torch.stack(mcs + [torch.clamp(lum_cs, min=0.0)], dim=0)
    w = weights.reshape((-1,) + (1,) * (terms.ndim - 1))
    return torch.prod(terms ** w, dim=0)


def ms_ssim_db(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0
               ) -> torch.Tensor:
    """-10 log10(1 - MS-SSIM), the reporting scale of the literature."""
    return -10.0 * torch.log10(
        torch.clamp(1.0 - ms_ssim(a, b, max_val), min=1e-10))
