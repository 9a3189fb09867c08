"""The yardstick: the card's peaks, the beam-search kernel's bound (frozen
from ``chip_smoke.py``'s ``card_rates`` and ``mega_beam_bound``) and the
FLOPs the RVAE's images need, counted from the published layer shapes
whatever the program runs (a lossy model's count is in its own module,
``lossy_models/<kind>.py``)."""

from __future__ import annotations

import subprocess
from typing import List

import numpy as np
import torch

# One H100 SXM (NVIDIA data sheet, dense, 700 W).  The float32 rate counts
# an FMA as two operations.
H100_F32_OPS = 67e12
H100_BYTES_PER_S = 3.35e12
LANES_PER_SM = 128       # lane instructions per clock per SM
INT_LANES_PER_SM = 64    # on the INT32 pipe
# Lane instructions per candidate element, counted off csrc/mega_beam.cu
# with Hopper's fused forms (see chip_smoke.py): the bits, the normal map
# (15, one on the INT32 pipe), 3 per scored and 2 per carried element.
BITS_OPS = {"fmix": 18, "threefry": 69}
BITS_INT_OPS = {"fmix": 13, "threefry": 69}
NORMAL_OPS, NORMAL_INT_OPS = 15, 1
SCORE_OPS, CARRY_OPS = 3, 2


def card_rates() -> dict:
    """The card's SM count and top SM clock, and the lane-instruction rates
    they give: all lanes, and the INT32 pipe."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(sms=sms, clock_max_sm_mhz=mhz,
                lane_ops_per_s=sms * LANES_PER_SM * mhz * 1e6,
                int_ops_per_s=sms * INT_LANES_PER_SM * mhz * 1e6)


def mega_beam_bound(counts, N, D, B, S, P, stream, rates) -> dict:
    """The least time for one launch on these inputs: the data-dependent
    work (at t = 0 one beam scores S rows, at every later live step B beams
    do; each live step regenerates B winning rows) in lane instructions
    over all lanes, its integer part over the INT32 pipe, and the bytes;
    the largest of the three."""
    counts = np.asarray(counts, np.int64)
    live = counts > 0
    scored = int(np.sum(live * S * D + np.maximum(counts - 1, 0) * B * S * D))
    carried = int(np.sum(counts * B * D))
    elements = scored + carried
    ops = (elements * (BITS_OPS[stream] + NORMAL_OPS)
           + scored * SCORE_OPS + carried * CARRY_OPS)
    int_ops = elements * (BITS_INT_OPS[stream] + NORMAL_INT_OPS)
    nbytes = 3 * N * P * D * 4 + N * 4 + N * 8 + N * P * 4
    parts = dict(bound_ops_ms=1e3 * ops / rates["lane_ops_per_s"],
                 bound_int_ms=1e3 * int_ops / rates["int_ops_per_s"],
                 bound_bytes_ms=1e3 * nbytes / H100_BYTES_PER_S)
    return dict(parts, bound_ms=max(parts.values()))


# --- FLOPs from the published shapes ----------------------------------------

def conv_flops(c_in: int, c_out: int, k: int, out_h: int, out_w: int) -> int:
    """A convolution's multiply-adds, each two operations."""
    return 2 * k * k * c_in * c_out * out_h * out_w


def rvae_pass_flops(cfg: dict, H: int, W: int) -> dict:
    """One image's inference pass (bottom-up) and generative pass
    (top-down) of the RVAE: 3x3 convolutions at H/2 x W/2, the 5x5
    stride-2 first and last convolutions.  The last is a transposed
    convolution, counted as one: each output pixel takes k^2 / s^2 taps.
    Elementwise work is left out (under 1% of these)."""
    det, sto, n = (cfg["deterministic_filters"], cfg["stochastic_filters"],
                   cfg["num_res_blocks"])
    k, fk, c = (cfg["kernel_size"][0], cfg["first_kernel_size"][0],
                cfg["output_channels"])
    s = cfg["first_strides"][0]
    h, w = H // s, W // s
    block_in = (2 * conv_flops(det, sto, k, h, w)
                + 2 * conv_flops(det, det, k, h, w))
    block_gen = (4 * conv_flops(det, sto, k, h, w)
                 + conv_flops(det, det, k, h, w)
                 + conv_flops(det + sto, det, k, h, w))
    first = conv_flops(c, det, fk, h, w)
    last = conv_flops(det, c, fk, H, W) // (s * s)
    return {"inference": first + n * block_in, "generative": n * block_gen
            + last}


def gdn_flops(channels: int, h: int, w: int) -> int:
    """GDN's normalisation pool, a 1x1 convolution of the squares (C^2
    multiply-adds per pixel), and the square, root and product (3 C)."""
    return 2 * channels * channels * h * w + 3 * channels * h * w


def rvae_image_flops(cfg: dict, H: int, W: int) -> int:
    return sum(rvae_pass_flops(cfg, H, W).values())


def mfu_percent(flops: float, seconds: float, cards: int) -> float:
    return 100.0 * flops / (seconds * H100_F32_OPS * cards)


def launches_bound_ms(launch_counts: List[np.ndarray], cfg: dict,
                      rates: dict) -> float:
    """Sum of the bound over launches, each given by its blocks' counts."""
    total = 0.0
    for counts in launch_counts:
        counts = np.asarray(counts).reshape(-1)
        total += mega_beam_bound(
            counts, len(counts), cfg["block_size"], cfg["n_beams"],
            cfg["n_samples"], cfg["max_partitions"], cfg["stream"],
            rates)["bound_ms"]
    return total
