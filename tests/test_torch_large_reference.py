"""rec_tpu_torch's ``LargeResNetVAE`` against the benchmark's plain
reference (``benchmark/reference/large_rvae.py``, loaded by path; it
imports nothing of the port or of JAX) on seeded random weights at
12/12/8/4 filters and 128x128 images: the data-dependent init, the
forward's likelihood, KLs and both groups' posterior and prior, and a
``.rec`` file of ``io/lossless.py::compress_to_file`` that the reference
decodes to the exact 8-bit pixels.  Then ``compress_to_file`` against the
inline sequence the compress CLI ran before it (encode, canonical decode,
``encode_residual``, ``write_rec``): the same bytes for both lossless
models, and the CLI's CSV rows unchanged; and the spans a photo records."""

import csv
import importlib
import importlib.machinery
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rec_tpu_torch.cli import compression_performance as cp
from rec_tpu_torch.coding import BeamSearchCoder
from rec_tpu_torch.io import lossless, write_rec
from rec_tpu_torch.io.residual import encode_residual, quantize
from rec_tpu_torch.models.large_resnet_vae import (LargeResNetVAE,
                                                   LargeResNetVAEConfig)
from rec_tpu_torch.models.resnet_vae import (BidirectionalResNetVAE,
                                             ResNetVAEConfig)
from rec_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(first_deterministic_filters=12, second_deterministic_filters=12,
           first_stochastic_filters=8, second_stochastic_filters=4,
           kernel_size=[3, 3], use_gdn=True, use_sig_convs=True,
           likelihood="discretized_logistic", likelihood_log_scale_init=0.0)
HW = (128, 128)           # latents 2x2x4 (one block) and 8x8x8 (8 blocks)
# S = floor(e^(1.0 * 1.1)) = 3 candidates a beam, B = 3 beams.
CODER = dict(kl_per_partition=1.0, n_beams=3, extra_samples=1.1,
             block_size=64, max_partitions=32, stream="fmix")
SEEDS = [3, 2 ** 31 + 11, 77]


def _reference():
    """``benchmark/reference`` as the package ``bench_reference`` and its
    ``large_rvae`` module."""
    if "bench_reference" not in sys.modules:
        spec = importlib.machinery.ModuleSpec("bench_reference", None,
                                              is_package=True)
        spec.submodule_search_locations = [
            os.path.join(REPO, "benchmark", "reference")]
        sys.modules["bench_reference"] = importlib.util.module_from_spec(
            spec)
    return importlib.import_module("bench_reference.large_rvae")


ref = _reference()


def _port_cfg():
    return LargeResNetVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in CFG.items()})


def _coder():
    return BeamSearchCoder(**CODER)


def _inputs(seed: int, batch: int = 1):
    """Images (batch, H, W, 3) in [-0.5, 0.5] on the 1/256 grid's bin
    centres, and block 2's and block 1's posterior noise."""
    g = torch.Generator().manual_seed(seed)
    levels = torch.randint(0, 256, (batch,) + HW + (3,), generator=g)
    images = (levels.float() + 0.5) / 256.0 - 0.5
    H, W = HW
    noise = [torch.randn((batch, H // 64, W // 64, 4), generator=g),
             torch.randn((batch, H // 16, W // 16, 8), generator=g)]
    return images, noise


def _pair(seed: int):
    """The port's model and the reference's, both with the reference's
    fresh weights from ``seed``, before the data-dependent init."""
    weights = ref.fresh_weights(CFG, seed, "cpu")
    model = LargeResNetVAE(_port_cfg(), _coder(), seed=0, device="cpu")
    model.requires_grad_(False)
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    for name, t in params.items():
        t.copy_(weights[name])
    return model, ref.Model({k: v.clone() for k, v in weights.items()}, CFG)


@pytest.fixture(scope="module", params=SEEDS)
def initialised(request):
    """(seed, port model, reference model) after each side's own
    data-dependent init on the same image and noise."""
    seed = request.param
    model, m = _pair(seed)
    images, noise = _inputs(seed + 1)
    model.data_dependent_init(images, noise)
    ref.data_dependent_init(m, images, noise)
    return seed, model, m


# Tolerances.  Both sides run the same float32 operations in the same
# order on the CPU, so the init's scales and biases and the forward's
# tensors agree to the last bit; the KLs and the likelihood, sums over
# thousands of terms, are held to 1e-6 relative in case a reduction is
# split otherwise.
SUM_RTOL = 1e-6


def test_ddi_sets_the_references_scales_and_biases(initialised):
    _, model, m = initialised
    names = [n for n, _ in model.named_parameters()
             if n.endswith((".log_scale", ".bias"))]
    assert any(n.endswith(".log_scale") for n in names)
    params = dict(model.named_parameters())
    for name in names:
        assert torch.equal(params[name], m.p[name]), name


def test_forward_matches_the_reference(initialised):
    seed, model, m = initialised
    images, noise = _inputs(seed + 2, batch=2)
    got = model(images, noise)
    want = ref.forward(m, images, noise)
    torch.testing.assert_close(got["reconstruction"],
                               want["reconstruction"], rtol=0, atol=0)
    for key in ("log_likelihood", "analytic_kl"):
        torch.testing.assert_close(got[key], want[key], rtol=SUM_RTOL,
                                   atol=0)
    for (gq, gp), (wq, wp) in zip(got["posterior_prior_pairs"],
                                  want["posterior_prior_pairs"]):
        for a, b in ((gq, wq), (gp, wp)):
            torch.testing.assert_close(a.loc, b.loc, rtol=0, atol=0)
            torch.testing.assert_close(a.scale, b.scale, rtol=0, atol=0)


def test_reference_decodes_the_file_to_the_pixels(initialised, tmp_path):
    """The port's file, read by the reference alone: every 8-bit pixel."""
    seed, model, m = initialised
    images, _ = _inputs(seed + 3)
    path = str(tmp_path / "photo.rec")
    coded = lossless.compress_to_file(
        model, path, images, seed, block_size=CODER["block_size"],
        max_index=model.coder.max_index)
    assert coded.nbytes == os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    beam = importlib.import_module("bench_reference.beam")
    cfg = beam.BeamConfig(**CODER)
    levels = ref.decode_file(m, data, cfg)
    np.testing.assert_array_equal(levels, quantize(images[0].numpy() + 0.5))


# --- compress_to_file against the CLI's former inline sequence -----------

RVAE = ResNetVAEConfig(num_res_blocks=2, deterministic_filters=8,
                       stochastic_filters=4)


def _model(kind: str):
    """A tiny initialised model of the compress CLI's ``kind``."""
    images, noise = _inputs(5)
    if kind == "large_resnet_vae":
        model, _ = _pair(5)
        model.data_dependent_init(images, noise)
        return model, images
    model = BidirectionalResNetVAE(RVAE, _coder(), seed=3, device="cpu")
    model.requires_grad_(False)
    x = images[:, :16, :16]
    g = torch.Generator().manual_seed(9)
    model.data_dependent_init(x, torch.randn((2, 1, 8, 8, 4), generator=g))
    return model, x


def _inline(model, path, x, seed, codec="ac"):
    """The compress CLI's coding of one image before ``compress_to_file``:
    compress, the indices to the host, the canonical decode, the residual,
    the container."""
    comp = model.compress(x, seed)
    groups = (comp["latents"] if "latents" in comp
              else zip(comp["indices"], comp["counts"]))
    latents = [(i.cpu().numpy(), c.cpu().numpy()) for i, c in groups]
    h, w = int(x.shape[1]), int(x.shape[2])
    if isinstance(model, LargeResNetVAE):
        dec = model.decompress((h, w), latents, seed)
    else:
        dec = model.decompress((h, w), *zip(*latents), seed)
    scale = float(torch.exp(model.likelihood_log_scale))
    residual, _ = encode_residual(x[0].cpu().numpy() + 0.5,
                                  dec[0].cpu().numpy(), scale)
    nbytes = write_rec(path, seed=seed, image_shape=(h, w, 3),
                       block_size=CODER["block_size"],
                       max_index=model.coder.max_index, latents=latents,
                       residual=residual, codec=codec)
    return lossless.Compressed(latents, comp["kl"], comp["reconstruction"],
                               residual, nbytes,
                               {"encode": 0.0, "residual": 0.0,
                                "container_write": 0.0})


@pytest.mark.parametrize("codec", ["ac", "rans"])
@pytest.mark.parametrize("kind", ["resnet_vae", "large_resnet_vae"])
def test_compress_to_file_writes_the_inline_bytes(kind, codec, tmp_path):
    model, x = _model(kind)
    for seed in (17, 2 ** 31 + 5):
        a, b = str(tmp_path / "new.rec"), str(tmp_path / "inline.rec")
        got = lossless.compress_to_file(
            model, a, x, seed, block_size=CODER["block_size"],
            max_index=model.coder.max_index, codec=codec)
        want = _inline(model, b, x, seed, codec)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert got.nbytes == want.nbytes
        assert got.residual == want.residual
        torch.testing.assert_close(got.reconstruction, want.reconstruction,
                                   rtol=0, atol=0)


TIME_COLUMNS = {"comp_time", "decomp_time"}


def _cli(kind, root, out):
    widths = (["large_cfg.first_deterministic_filters=12",
               "large_cfg.second_deterministic_filters=12",
               "large_cfg.first_stochastic_filters=8",
               "large_cfg.second_stochastic_filters=4"]
              if kind == "large_resnet_vae" else
              ["model_cfg.num_res_blocks=2",
               "model_cfg.deterministic_filters=8",
               "model_cfg.stochastic_filters=4"])
    stats = cp.main(widths + [
        f"model={kind}", "n_beams=3", "block_size=64", "max_partitions=4",
        "num_images=2", "device=cpu", "dataset.dataset=tiny",
        f"dataset.data_dir={root}", f"model_save_dir={root / 'none'}",
        f"output_dir={out}"])
    with open(stats["csv"]) as f:
        rows = list(csv.DictReader(f))
    files = {n: open(os.path.join(out, n), "rb").read()
             for n in sorted(os.listdir(out)) if n.endswith(".rec")}
    return rows, files


@pytest.mark.parametrize("kind", ["resnet_vae", "large_resnet_vae"])
def test_cli_rows_and_files_are_the_inline_ones(kind, tmp_path,
                                                monkeypatch):
    """``compression_performance`` through ``compress_to_file``, and again
    with the inline sequence in its place: the same ``.rec`` bytes and
    the same CSV rows, times aside."""
    side = 128 if kind == "large_resnet_vae" else 16
    rs = np.random.RandomState(0)
    np.savez(tmp_path / "tiny_test.npz",
             images=rs.randint(0, 256, (2, side, side, 3)).astype(np.uint8))
    rows, files = _cli(kind, tmp_path, tmp_path / "new")

    def inline(model, path, image, seed, *, block_size, max_index,
               codec="ac", true_lossless=True):
        assert true_lossless and block_size == CODER["block_size"]
        return _inline(model, path, image, seed, codec)

    monkeypatch.setattr(cp, "compress_to_file", inline)
    rows_inline, files_inline = _cli(kind, tmp_path, tmp_path / "inline")
    assert len(files) == 2 and files == files_inline
    assert len(rows) == 2
    for got, want in zip(rows, rows_inline):
        assert got["roundtrip_ok"] == "True"
        assert ({k: v for k, v in got.items() if k not in TIME_COLUMNS}
                == {k: v for k, v in want.items() if k not in TIME_COLUMNS})


# --- spans -----------------------------------------------------------------

def test_a_photo_records_its_spans(tmp_path):
    """One photo through ``compress_to_file`` under a profiler session:
    one ``model.compress`` and one ``model.decompress`` root (a request id
    each, images=1), one ``io.residual`` with subpixels = H W 3; and the
    data-dependent init one ``setup.ddi`` with no session."""
    model, m = _pair(4)
    images, noise = _inputs(6)
    n = len(profiling.collect()["spans"])
    model.data_dependent_init(images, noise)
    ddi = [s for s in profiling.collect()["spans"][n:]
           if s.name == "setup.ddi"]
    assert len(ddi) == 1 and ddi[0].t1_ns is not None
    n = len(profiling.collect()["spans"])
    with profile(activities=[ProfilerActivity.CPU]):
        lossless.compress_to_file(model, str(tmp_path / "p.rec"), images, 8,
                                  block_size=CODER["block_size"],
                                  max_index=model.coder.max_index)
    spans = profiling.collect()["spans"][n:]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    roots = [s for s in spans if s.parent < 0]
    for name in ("model.compress", "model.decompress"):
        (s,) = by_name[name]
        assert s.parent < 0 and s.counts == {"images": 1} and s.card == -1
    assert len({s.request for s in roots}) == len(roots)
    (res,) = by_name["io.residual"]
    assert res.counts == {"subpixels": HW[0] * HW[1] * 3}
    (to_host,) = by_name["io.to_host"]
    assert to_host.parent < 0
    assert "setup.ddi" not in by_name
