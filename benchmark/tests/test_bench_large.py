"""The cell ``large.kodak_lossless_b1`` (``benchlib/lossless_photo.py``,
``reference/large_rvae.py``): on the CPU at a small size it is
``correct``, its traced run reads every metric that reads the program's
spans, and ``correct`` comes out false under the bfloat16 control, the
planted search faults and a residual byte flipped where the program
produces it; the reference loads nothing of the port; the FLOP count
against a count by hand; and on a card the TF32 control at the cell's own
size."""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys

import pytest
import torch

import planted

WORKLOAD = "large.kodak_lossless_b1"
SEED = 2 ** 31 + 777


def tiny(cell):
    """The cell at a size the CPU runs in seconds: 12/12/8/4 filters,
    128x128 photos (latents of one and eight 64-dim blocks), B = 3, S = 7
    (Omega 0.5, extra 4, as ``conftest.tiny`` gives the lossy cell: the
    small latents hold little KL, a smaller Omega gives their blocks
    several partitions, so that the beams matter), three photos."""
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(first_deterministic_filters=12,
                        second_deterministic_filters=12,
                        first_stochastic_filters=8,
                        second_stochastic_filters=4)
    cfg["image_shape"] = [128, 128, 3]
    cfg["coder"].update(n_beams=3, kl_per_partition=0.5, extra_samples=4.0,
                        block_size=64, max_partitions=32)
    traffic = dict(cell.traffic, images=3, check_photos=2, rate=50.0)
    return cell._replace(config=cfg, traffic=traffic)


def _run(root, seed=SEED, around=contextlib.nullcontext, trace=False,
         tweak=tiny):
    import run

    torch.set_num_threads(2)
    return run.run_cell(root, WORKLOAD, seed, 0.06, trace, device="cpu",
                        tweak=tweak, around=around)


@pytest.mark.parametrize("seed", [SEED, 5])
def test_tiny_cell_is_correct(root, seed):
    line = _run(root, seed)
    assert line["correct"], line["checks"]
    assert line["checks"]["pixel_errors"]["value"] == 0
    assert line["units_in_window"] >= 2 and line["saturated_blocks"] == 0


def test_traced_run_reads_the_program_metrics(root, monkeypatch):
    from benchlib import devtrace, manifest, yardstick
    from rec_tpu_torch.coding import rng
    from test_bench_program_trace import _CpuTrace

    # Every metric the cell lists but the kernel's roofline: the CPU runs
    # the kernels' plain versions.
    want = {m["name"] for m in manifest.load_cell(root, WORKLOAD).per_layer
            } - {"mega_beam_roofline.encode_p95"}
    assert {"residual_ms_per_image.encode_p95",
            "decode_ms_per_image.encode_p95",
            "encode_ms_per_image.encode_p95", "ddi_s.setup"} <= want
    monkeypatch.setattr(devtrace, "DeviceTrace", _CpuTrace)
    monkeypatch.setattr(yardstick, "card_rates", dict)
    rng.normal_table.cache_clear()
    rng.erfinv_table.cache_clear()

    def small(cell):
        cell = tiny(cell)
        return cell._replace(traffic=dict(cell.traffic, trace_units=2))

    line = _run(root, trace=True, tweak=small)
    assert want <= set(line["metrics"]), line["metrics"]
    assert line["metrics"]["mfu.encode_p95"]["value"] > 0


@contextlib.contextmanager
def residual():
    """One byte of the residual payload flipped where the program codes
    it (``io/lossless.py``)."""
    import rec_tpu_torch.io.lossless as lossless

    encode = lossless.encode_residual

    def altered(*args, **kw):
        payload, n = encode(*args, **kw)
        return payload[:-1] + bytes([payload[-1] ^ 0x5A]), n

    with planted._patched(lossless, "encode_residual", altered):
        yield


CONTROLS = {"bf16": planted.CONTROLS["bf16"],
            "beams1": planted.CONTROLS["beams1"],
            "prior": planted.CONTROLS["prior"], "residual": residual}


@pytest.mark.parametrize("fault", sorted(CONTROLS))
def test_fault_is_not_correct(root, fault):
    line = _run(root, around=CONTROLS[fault])
    assert not line["correct"], line["checks"]


def test_reference_loads_nothing_of_the_port(root):
    bench = os.path.join(root, "benchmark")
    code = (f"import sys\nsys.path[:0] = [{bench!r}]\n"
            "import reference.large_rvae\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=""),
                         cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "rec_tpu", "rec_tpu_torch"}


def test_flops_by_hand(root):
    from benchlib import large_rvae_flops

    with open(os.path.join(root, "benchmark", "configs", "large.json")) as f:
        cfg = json.load(f)["model"]

    def conv(cin, cout, k, h, w, up=1):
        return 2 * k * k * cin * cout * h * w // (up * up)

    def gdn(c, h, w):
        return 2 * c * c * h * w + 3 * c * h * w

    # 512 x 768: /2 256x384, /4 128x192, /8 64x96, /16 32x48, /32 16x24,
    # /64 8x12.  Res block 1 at /16 (160 -> 128), res block 2 at /64
    # (160 -> 32), 3x3 convolutions.
    s16, s64 = (32, 48), (8, 12)
    inference = (conv(3, 160, 5, 256, 384) + conv(160, 160, 5, 128, 192)
                 + conv(160, 160, 5, 64, 96) + conv(160, 160, 5, *s16)
                 + gdn(160, 256, 384) + gdn(160, 128, 192)
                 + gdn(160, 64, 96) + gdn(160, *s16)
                 + 2 * conv(160, 128, 3, *s16) + 2 * conv(160, 160, 3, *s16)
                 + conv(160, 160, 3, *s16) + conv(160, 160, 5, 16, 24)
                 + conv(160, 160, 5, *s64)
                 + 2 * conv(160, 32, 3, *s64) + 2 * conv(160, 160, 3, *s64))
    up = (conv(160, 160, 5, 16, 24, 2) + conv(160, 160, 5, *s16, 2)
          + conv(160, 160, 3, *s16)
          + conv(160, 160, 5, 64, 96, 2) + gdn(160, 64, 96)
          + conv(160, 160, 5, 128, 192, 2) + gdn(160, 128, 192)
          + conv(160, 160, 5, 256, 384, 2) + gdn(160, 256, 384)
          + conv(160, 3, 5, 512, 768, 2))

    def blocks(heads):
        return (heads * conv(160, 32, 3, *s64) + conv(160, 160, 3, *s64)
                + conv(192, 160, 3, *s64) + heads * conv(160, 128, 3, *s16)
                + conv(160, 160, 3, *s16) + conv(288, 160, 3, *s16))

    got = large_rvae_flops.pass_flops(cfg, 512, 768)
    assert got == {"inference": inference,
                   "generative_encode": blocks(4) + up,
                   "generative_decode": blocks(2) + up}


@contextlib.contextmanager
def tf32():
    """``planted.tf32`` with the large model's own numerics switch let
    loose too (it imports ``set_deterministic`` by name)."""
    import rec_tpu_torch.device as device_mod
    import rec_tpu_torch.models.large_resnet_vae as large

    with planted.tf32():
        with planted._patched(large, "set_deterministic",
                              device_mod.set_deterministic):
            yield


@pytest.mark.cuda
def test_tf32_control_on_card(root, card):
    import run

    line = run.run_cell(root, WORKLOAD, 2 ** 31 + 4242, 5.0, False,
                        around=tf32)
    assert not line["correct"], line["checks"]
