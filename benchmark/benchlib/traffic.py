"""The one generator of inputs: every mix's images come from here, drawn
from the run's seed and the mix's parameters (``images`` in the traffic
file), so that two runs of one seed get the same inputs and every seed the
same sizes."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter

# Width in pixels of the box filter that smooths the noise.
FILTER = 5


def smooth_images(seed: int, stream: int, count: int, shape) -> np.ndarray:
    """``count`` images (count, H, W, C) in [0, 255] float32: uniform noise
    box-filtered over ``FILTER`` pixels with wrap-around, each
    image stretched to the full range (the synthetic stand-in the port's
    datasets use when no data is on disk).  ``stream`` numbers the draws of
    one run (a batch, an image)."""
    rs = np.random.default_rng([int(seed) & (2 ** 63 - 1), int(stream) + 1])
    x = rs.random((count,) + tuple(shape), dtype=np.float64)
    x = uniform_filter(x, size=(1, FILTER, FILTER, 1), mode="wrap")
    lo = x.min(axis=(1, 2, 3), keepdims=True)
    hi = x.max(axis=(1, 2, 3), keepdims=True)
    return (255.0 * (x - lo) / (hi - lo)).astype(np.float32)


def image_seeds(seed: int, first: int, count: int, stride: int) -> list:
    """Per-image coder seeds ``seed + stride * i`` as the CLIs give them,
    folded into the 32 bits a ``.rec`` header holds."""
    return [(int(seed) + stride * i) % (2 ** 32)
            for i in range(first, first + count)]
