"""The FLOP counts of both configurations against a count by hand from
their published layer shapes."""

from __future__ import annotations

import json
import os

from benchlib import yardstick
from lossy_models import large_level_2_vae


def _config(root, name):
    with open(os.path.join(root, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def test_rvae24_by_hand(root):
    cfg = _config(root, "rvae24")["model"]
    # 16x16 latent grid; per res block: inference 2 heads (160->32) and 2
    # convolutions (160->160), generative 4 heads, 160->160 and 192->160,
    # all 3x3; the 5x5 stride-2 first (3->160, at 16x16) and last
    # (160->3, 32x32 outputs at 25/4 taps each) convolutions.
    px = 16 * 16
    head, body = 2 * 9 * 160 * 32 * px, 2 * 9 * 160 * 160 * px
    inference = 2 * 25 * 3 * 160 * px + 24 * (2 * head + 2 * body)
    generative = (24 * (4 * head + body + 2 * 9 * 192 * 160 * px)
                  + 2 * 25 * 160 * 3 * 32 * 32 // 4)
    got = yardstick.rvae_pass_flops(cfg, 32, 32)
    assert got == {"inference": inference, "generative": generative}
    # 15.5 GFLOP per image, as the issue's count of 24 x 256 x 2.49 MFLOP.
    assert abs(sum(got.values()) / 15.56e9 - 1) < 0.05


def test_lossy2_by_hand(root):
    cfg = _config(root, "lossy2")["model"]
    H, W, f1, f2 = 512, 768, 196, 128

    def conv(cin, cout, k, h, w, up=1):
        return 2 * k * k * cin * cout * h * w // (up * up)

    def gdn(c, h, w):
        return 2 * c * c * h * w + 3 * c * h * w

    analysis = (conv(3, f1, 5, 256, 384) + conv(f1, f1, 5, 128, 192)
                + conv(f1, f1, 5, 64, 96) + gdn(f1, 256, 384)
                + gdn(f1, 128, 192) + gdn(f1, 64, 96)
                + 2 * conv(f1, f1, 5, 32, 48))
    hyper_analysis = (conv(f1, f2, 3, 32, 48) + conv(f2, f2, 5, 16, 24)
                      + 2 * conv(f2, f2, 5, 8, 12))
    prior = 3 * conv(f2, f2, 3, 8, 12)
    hyper_synthesis = (conv(f2, f2, 5, 16, 24, 2) + conv(f2, f2, 5, 32, 48, 2)
                       + 2 * conv(f2, f1, 3, 32, 48)
                       + 2 * conv(2 * f1, f1, 1, 32, 48))
    synthesis = (conv(f1, f1, 5, 64, 96, 2) + conv(f1, f1, 5, 128, 192, 2)
                 + conv(f1, f1, 5, 256, 384, 2) + gdn(f1, 64, 96)
                 + gdn(f1, 128, 192) + gdn(f1, 256, 384)
                 + conv(f1, 3, 5, 512, 768, 2))
    got = large_level_2_vae.pass_flops(cfg, H, W)
    assert got == {"analysis": analysis, "hyper_analysis": hyper_analysis,
                   "level_2_prior": prior, "hyper_synthesis": hyper_synthesis,
                   "synthesis": synthesis}


def test_mfu_is_a_share():
    assert yardstick.mfu_percent(67e12, 1.0, 1) == 100.0
    assert yardstick.mfu_percent(67e12, 1.0, 4) == 25.0
