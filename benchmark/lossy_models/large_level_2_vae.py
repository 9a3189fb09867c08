"""The lossy model of kind ``large_level_2_vae`` (``model.kind`` in a
configuration file): the port's ``Large2LevelVAE`` at the file's widths,
its fresh weights, its plain reference and the FLOPs an image needs.  The
lossy driver finds this module by the kind's name, so that another lossy
model is one more module here and its reference beside it."""

from __future__ import annotations

from reference import lossy

from benchlib.yardstick import conv_flops, gdn_flops

LEVELS = 2


def _widths(cfg: dict):
    return cfg["level_1_filters"], cfg["level_2_filters"]


def build(cfg: dict, coder, device):
    """The port's model, weights still its own init."""
    from rec_tpu_torch.models.lossy import Large2LevelVAE

    return Large2LevelVAE(*_widths(cfg), coder, seed=0, device=device)


def fresh_weights(cfg: dict, seed: int, device) -> dict:
    return lossy.fresh_weights(*_widths(cfg), seed, device)


def reference(weights: dict, cfg: dict) -> lossy.Model:
    return lossy.Model(weights, *_widths(cfg))


decode = lossy.decode


def pass_flops(cfg: dict, H: int, W: int) -> dict:
    """One image's ``rec_forward`` passes at H x W: the analysis (three
    5x5 stride-2 convolutions with GDN, two 5x5 stride-2 heads), the
    hyper-analysis (3x3, 5x5 stride 2, two 5x5 stride-2 heads), the
    level-2 prior (three 3x3 at H/64), the hyper-synthesis (two 5x5
    up-samplings by 2, two 3x3 heads), the level-1 combiners (two 1x1) and
    the synthesis (three 5x5 up-samplings with inverse GDN, a 5x5
    up-sampling to 3 channels).  An up-sampling convolution is counted as
    the transposed convolution it is: k^2 / s^2 taps per output pixel."""
    f1, f2 = _widths(cfg)
    h = [H // 2 ** i for i in range(7)]
    w = [W // 2 ** i for i in range(7)]
    analysis = (conv_flops(3, f1, 5, h[1], w[1])
                + sum(conv_flops(f1, f1, 5, h[i], w[i]) for i in (2, 3))
                + sum(gdn_flops(f1, h[i], w[i]) for i in (1, 2, 3))
                + 2 * conv_flops(f1, f1, 5, h[4], w[4]))
    hyper_analysis = (conv_flops(f1, f2, 3, h[4], w[4])
                      + conv_flops(f2, f2, 5, h[5], w[5])
                      + 2 * conv_flops(f2, f2, 5, h[6], w[6]))
    prior = 3 * conv_flops(f2, f2, 3, h[6], w[6])
    hyper_synthesis = (conv_flops(f2, f2, 5, h[5], w[5]) // 4
                       + conv_flops(f2, f2, 5, h[4], w[4]) // 4
                       + 2 * conv_flops(f2, f1, 3, h[4], w[4])
                       + 2 * conv_flops(2 * f1, f1, 1, h[4], w[4]))
    synthesis = (sum(conv_flops(f1, f1, 5, h[i], w[i]) // 4
                     + gdn_flops(f1, h[i], w[i]) for i in (3, 2, 1))
                 + conv_flops(f1, 3, 5, h[0], w[0]) // 4)
    return {"analysis": analysis, "hyper_analysis": hyper_analysis,
            "level_2_prior": prior, "hyper_synthesis": hyper_synthesis,
            "synthesis": synthesis}


def image_flops(cfg: dict, H: int, W: int) -> int:
    return sum(pass_flops(cfg, H, W).values())
