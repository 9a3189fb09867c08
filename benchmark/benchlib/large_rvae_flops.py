"""The FLOPs one photo of the ``large`` configuration needs on the
lossless photo path (``lossless_photo.py``), counted from the model's
layer shapes whatever the program runs: the compress's inference and
generative passes, and the canonical decode's generative pass, which
computes the priors alone."""

from __future__ import annotations

from .yardstick import conv_flops, gdn_flops


def pass_flops(cfg: dict, H: int, W: int) -> dict:
    """One photo's passes at H x W (``model`` of ``configs/large.json``).
    The inference pass: four 5x5 stride-2 convolutions with GDN to /16,
    res block 1's two heads and two 3x3 convolutions, a 3x3 and two 5x5
    stride-2 convolutions to /64, res block 2's.  A generative pass: res
    block 2 (two prior heads, with the posterior two posterior heads, a
    3x3 convolution and one over the carry and the sample), two 5x5
    up-samplings and a 3x3 to /16, res block 1, three 5x5 up-samplings
    with inverse GDN and one to 3 channels.  An up-sampling convolution
    is counted as the transposed convolution it is: k^2 / s^2 taps per
    output pixel.  Elementwise work is left out."""
    d1, d2 = (cfg["first_deterministic_filters"],
              cfg["second_deterministic_filters"])
    s1, s2 = cfg["first_stochastic_filters"], cfg["second_stochastic_filters"]
    k = cfg["kernel_size"][0]
    h = [H // 2 ** i for i in range(7)]
    w = [W // 2 ** i for i in range(7)]

    def infer_block(det, sto, i):
        return (2 * conv_flops(det, sto, k, h[i], w[i])
                + 2 * conv_flops(det, det, k, h[i], w[i]))

    def gen_block(det, sto, i, heads):
        return (heads * conv_flops(det, sto, k, h[i], w[i])
                + conv_flops(det, det, k, h[i], w[i])
                + conv_flops(det + sto, det, k, h[i], w[i]))

    inference = (conv_flops(3, d1, 5, h[1], w[1])
                 + sum(conv_flops(d1, d1, 5, h[i], w[i]) for i in (2, 3, 4))
                 + sum(gdn_flops(d1, h[i], w[i]) for i in (1, 2, 3, 4))
                 + infer_block(d1, s1, 4)
                 + conv_flops(d1, d2, 3, h[4], w[4])
                 + sum(conv_flops(d2, d2, 5, h[i], w[i]) for i in (5, 6))
                 + infer_block(d2, s2, 6))
    up = (conv_flops(d2, d2, 5, h[5], w[5]) // 4
          + conv_flops(d2, d2, 5, h[4], w[4]) // 4
          + conv_flops(d2, d1, 3, h[4], w[4])
          + sum(conv_flops(d1, d1, 5, h[i], w[i]) // 4
                + gdn_flops(d1, h[i], w[i]) for i in (3, 2, 1))
          + conv_flops(d1, 3, 5, h[0], w[0]) // 4)
    return {"inference": inference,
            "generative_encode": (gen_block(d2, s2, 6, 4)
                                  + gen_block(d1, s1, 4, 4) + up),
            "generative_decode": (gen_block(d2, s2, 6, 2)
                                  + gen_block(d1, s1, 4, 2) + up)}


def image_flops(cfg: dict, H: int, W: int) -> int:
    return sum(pass_flops(cfg, H, W).values())
