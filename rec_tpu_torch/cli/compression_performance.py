"""Lossless compression evaluation on the GPU (port of
examples/lossless/compression_performance.py with the beam-search coder):
``model=resnet_vae`` (the RVAE, CIFAR-sized images) or
``model=large_resnet_vae`` (``LargeResNetVAE``, Kodak- and CLIC-sized
images padded to a multiple of 64; its config is ``large_cfg``).

    python -m rec_tpu_torch.cli.compression_performance mode=initialize ...
    python -m rec_tpu_torch.cli.compression_performance mode=compress ...
    python -m rec_tpu_torch.cli.compression_performance mode=update_sampler

* ``mode=initialize`` fits the coder's auxiliary-variance ratios on test
  images (``coding.ratio_fit``) and saves them as
  ``<model_save_dir>/coder_ratios_<Omega>.npy``, the file ``rec_tpu``
  writes; each package loads the other's.
* ``mode=compress`` loads that table when it exists and, per test image:
  the ideal-ELBO pass (bits/dim, PSNR, MS-SSIM of the uncoded
  reconstruction), a probe of the partition budget the image needs (the
  budget grows to fit it, 25% headroom, capped at ``max_budget``), REC
  compress, a ``.rec`` file with the coded residual, a read-back with an
  index round-trip assertion, decode and exact pixel recovery.  It writes
  one CSV row per image (``<output_dir>/<dataset>.csv``, ``rec_tpu``'s 18
  columns), ``block_indices_<i>.npz`` and ``phase_times.json``.  With
  ``tile=t > 0`` each image (padded to a multiple of t) is compressed as
  independent t x t tiles, each a unit with its own seed, file and row
  (``<i>_t<r>_<c>``), and one ``<i>_total`` row per image sums them.

Each stochastic group (the RVAE's res blocks, the large model's two
blocks) is one latent of the ``.rec`` file, top-down; the large model's
groups have latents of different shapes.

Weights come from ``model_save_dir`` when it holds a ``rec_tpu``
checkpoint, else fresh weights from ``seed`` with data-dependent
initialisation.  A checkpoint's ``model_config.json`` of the same model
kind overrides ``model_cfg`` or ``large_cfg`` (a laplace-trained large
model is read as laplace).  The posterior noise of each forward pass comes
from ``forward_noise``.  ``device=cpu`` runs on the CPU (the tests do); by
default the run needs a GPU and raises without one.

``matmul_precision=highest`` is accepted and changes nothing: the port's
convolutions already run in float32 with TF32 off
(``device.set_deterministic``).  ``sampler=importance`` codes with the
importance coder (``GaussianCoder``, 2^coding_bits indices per partition).
``mode=update_sampler`` runs the rejection coder's update pass
(``coding.RejectionCoder``) over the first latent block of each group of
each test image (the split of ``seed + i``, coder seed ``seed + 64 i +
n``) and saves the averaged acceptance probabilities as
``<model_save_dir>/rejection_acceptance.npy``, logging the spillover
probability.

Unlike the reference, ``grow_budget`` never shrinks a budget the user set:
when the probed need passes ``max_budget`` it keeps
``max(max_budget, max_partitions)``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..coding import CodedLatent, RejectionCoder
from ..coding import rng
from ..coding.gauss import GaussianParams
from ..coding.partition import plan_split, split_coders, split_permutations
from ..coding.ratio_fit import RatioFitConfig, RatioFitter
from ..data.datasets import (DatasetConfig, load_images, normalize,
                             pad_to_multiple, write_png)
from ..io import read_rec, write_rec
from ..io.residual import decode_residual, encode_residual, quantize
from ..models import large_convert
from ..models.large_resnet_vae import LargeResNetVAE, LargeResNetVAEConfig
from ..models.likelihoods import discretized_logistic
from ..models.resnet_vae import ResNetVAEConfig
from ..train import CheckpointManager, reconcile_model_config
from ..utils.config import apply_overrides, print_config
from ..utils.logging import setup_logger
from ..utils.metrics import _MSSSIM_WEIGHTS, ms_ssim, psnr
from ..utils.profiling import PhaseTimer, device_fence
from . import serve
from .serve import build_coder, process_device

LOG2 = float(np.log(2.0))
FIELDS = ["index", "width", "height", "seed", "total_kl",
          "ideal_elbo_bpd", "ideal_psnr", "ideal_ms_ssim",
          "latent_code_bits", "file_bits",
          "total_bits_per_dim", "residual_bits", "psnr", "ms_ssim",
          "comp_time", "decomp_time", "roundtrip_ok",
          "saturated_blocks"]


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "compress"           # compress | initialize | update_sampler
    model: str = "resnet_vae"       # resnet_vae | large_resnet_vae
    dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(dataset="cifar10",
                                              split="test"))
    model_cfg: ResNetVAEConfig = dataclasses.field(
        default_factory=ResNetVAEConfig)
    large_cfg: LargeResNetVAEConfig = dataclasses.field(
        default_factory=lambda: LargeResNetVAEConfig(
            likelihood="discretized_logistic"))
    sampler: str = "beam_search"
    n_beams: int = 20
    extra_samples: float = 1.2
    kl_per_partition: float = 3.0
    coding_bits: int = 12
    block_size: int = 1000
    max_partitions: int = 24
    stream: str = "fmix"             # candidate bit generator: fmix | threefry
    codec: str = "ac"                # .rec entropy codec: ac | rans
    num_images: int = 10
    pad_multiple: int = 0            # 0 = the model's default (x2, x64)
    seed: int = 42
    # Grow max_partitions to fit each image's probed per-block KL, up to
    # max_budget; past it over-budget blocks saturate (counts clamp, the
    # CSV reports them) and the residual stream keeps the file lossless.
    auto_max_partitions: bool = True
    max_budget: int = 8192
    probe_every_image: bool = True
    true_lossless: bool = True       # code the residual stream too
    tile: int = 0                    # > 0: compress t x t tiles of each
                                     # image, with per-image totals
    use_ema: bool = True
    model_save_dir: str = "checkpoints/lossless"
    output_dir: str = "results/lossless"
    save_reconstructions: bool = False
    device: str = "cuda"


def check_supported(cfg: Config) -> None:
    """Options of the reference that the port does not have yet raise (they
    never fall back to something else)."""
    if cfg.mode not in ("compress", "initialize", "update_sampler"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.model not in ("resnet_vae", "large_resnet_vae"):
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.sampler not in ("beam_search", "importance"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")


def forward_noise(cfg: Config, image_shape, seed: int,
                  fold: Optional[int] = None):
    """The posterior noise of one forward pass of a (1, H, W, C) image, as
    float32 standard normals from ``seed``, or from (``seed``, ``fold``)
    where the reference folds an image index into its key
    (``mode=initialize``): for the RVAE one array (num_res_blocks, 1,
    H/sh, W/sw, stochastic); for the large model block 2's and block 1's,
    top-down.  ``rec_tpu`` draws them from ``jax.random`` keys; a test
    replaces this function to feed the port the same draws."""
    _, H, W, _ = image_shape
    rs = np.random.default_rng([seed] if fold is None else [seed, fold])
    if cfg.model == "large_resnet_vae":
        lc = cfg.large_cfg
        return [rs.standard_normal(shape, dtype=np.float32) for shape in (
            (1, H // 64, W // 64, lc.second_stochastic_filters),
            (1, H // 16, W // 16, lc.first_stochastic_filters))]
    mc = cfg.model_cfg
    sh, sw = mc.first_strides
    return rs.standard_normal(
        (mc.num_res_blocks, 1, H // sh, W // sw, mc.stochastic_filters),
        dtype=np.float32)


def fit_generator(cfg: Config, image: int, group: int) -> torch.Generator:
    """The generator of the auxiliary samples of the ratio fit on group
    ``group`` (top-down) of image ``image`` (the reference folds
    ``1000 + 64 image + group`` into its key); a test replaces it."""
    return torch.Generator().manual_seed(
        cfg.seed * 1_000_003 + 1000 + image * 64 + group)


def pairs(out: dict) -> list:
    """Per-group (posterior, prior) GaussianParams of one image's forward
    pass, top-down, each (1, h, w, c)."""
    if "posterior_prior_pairs" in out:
        return list(out["posterior_prior_pairs"])
    post, prior = out["posterior"], out["prior"]
    return [(GaussianParams(post.loc[n], post.scale[n]),
             GaussianParams(prior.loc[n], prior.scale[n]))
            for n in range(post.loc.shape[0])]


def pad_multiple_for(cfg: Config) -> int:
    if cfg.pad_multiple:
        return cfg.pad_multiple
    return 64 if cfg.model == "large_resnet_vae" else 2


def load_model(cfg: Config, coder, example: np.ndarray, device):
    """The model of ``cfg.model`` for inference with restored weights (the
    EMA shadows with ``use_ema``), or fresh ones from ``cfg.seed`` with
    data-dependent init on ``example``.  Returns (model, restored)."""
    if cfg.model == "resnet_vae":
        return serve.load_model(cfg, coder, example, device)
    model = LargeResNetVAE(cfg.large_cfg, coder, seed=cfg.seed,
                           device=device).requires_grad_(False)
    restored = CheckpointManager(cfg.model_save_dir).restore_params()
    if restored is not None:
        large_convert.load_flax_params(
            model, restored["ema_params" if cfg.use_ema else "params"])
        return model, True
    rs = np.random.RandomState(cfg.seed + 1)
    noise = [rs.randn(example.shape[0], *shape).astype(np.float32)
             for shape in model.latent_shapes(*example.shape[1:3])]
    model.data_dependent_init(
        torch.as_tensor(example, dtype=torch.float32, device=device), noise)
    return model, False


def compress_latents(model, x: torch.Tensor, seed: int):
    """One image's coded groups, top-down, as numpy (indices, counts)
    pairs (the ``.rec`` file's latents), and its per-group KLs."""
    comp = model.compress(x, seed)
    groups = (comp["latents"] if "latents" in comp
              else zip(comp["indices"], comp["counts"]))
    return [(ind.cpu().numpy(), cnt.cpu().numpy())
            for ind, cnt in groups], comp["kl"]


def decompress_latents(model, shape, latents, seed: int) -> torch.Tensor:
    """The reconstruction (1, H, W, 3) from top-down (indices, counts)."""
    if isinstance(model, LargeResNetVAE):
        return model.decompress(shape, latents, seed)
    return model.decompress(shape, *zip(*latents), seed)


def ratio_path(cfg: Config) -> str:
    return os.path.join(cfg.model_save_dir,
                        f"coder_ratios_{cfg.kl_per_partition}.npy")


def _images(cfg: Config, log):
    images, synthetic = load_images(cfg.dataset)
    if synthetic:
        log.warning("using SYNTHETIC data (no local dataset found)")
    return normalize(images, "centered")[: cfg.num_images], synthetic


def _padded(cfg: Config, img: np.ndarray) -> np.ndarray:
    """One (H, W, C) image as the (1, H', W', C) float32 input of the
    model, padded to ``pad_multiple_for``."""
    return np.asarray(pad_to_multiple(img[None], pad_multiple_for(cfg)),
                      np.float32)


def _units(cfg: Config, images) -> list:
    """(label, model input) of each unit of work: whole images, or with
    ``tile`` each image's tiles, row-major, labelled ``<i>_t<r>_<c>``."""
    units = []
    for i, img in enumerate(images):
        if not cfg.tile:
            units.append((i, _padded(cfg, img)))
            continue
        t = cfg.tile
        padded = np.asarray(pad_to_multiple(img[None], t))[0]
        for r in range(0, padded.shape[0], t):
            for c in range(0, padded.shape[1], t):
                units.append((f"{i}_t{r // t}_{c // t}",
                              _padded(cfg, padded[r:r + t, c:c + t])))
    return units


def initialize_coder_ratios(cfg: Config, log, device) -> dict:
    """mode=initialize: fit aux-variance ratios on the test images' per-
    group (posterior, prior) pairs, split into the coder's latent blocks,
    and save the table (``max(192, max_partitions)`` entries: fitted where
    the data reaches, the power law beyond)."""
    images = [_padded(cfg, img) for img in _images(cfg, log)[0]]
    model, restored = load_model(cfg, None, images[0], device)
    log.info(f"params restored from checkpoint: {restored}")
    fitter = RatioFitter(RatioFitConfig(kl_per_partition=cfg.kl_per_partition),
                         max_partitions=max(192, cfg.max_partitions))
    t0 = time.perf_counter()
    for i, x in enumerate(images):
        xt = torch.as_tensor(x, device=device)
        out = model(xt, forward_noise(cfg, x.shape, cfg.seed, fold=i))
        log.info(f"init image {i}: "
                 f"total kl={float(torch.sum(out['analytic_kl'])):.0f}")
        for n, (p_n, c_n) in enumerate(pairs(out)):
            plan = plan_split(int(p_n.loc.numel()), cfg.block_size)
            perms = split_permutations(
                rng.root_keys([cfg.seed + i], device=device), plan)
            fitter.update(split_coders(p_n, plan, perms),
                          split_coders(c_n, plan, perms),
                          fit_generator(cfg, i, n))
    seconds = time.perf_counter() - t0
    path = ratio_path(cfg)
    os.makedirs(cfg.model_save_dir, exist_ok=True)
    table = np.asarray(fitter.fitted())
    np.save(path, table)
    log.info(f"saved fitted ratios to {path} ({fitter.fits} fits, "
             f"{fitter.steps} steps, {fitter.syncs} host syncs, "
             f"{seconds:.1f} s)")
    return {"path": path, "table": table,
            "fitted": int(np.sum((fitter.counts > 0) & (fitter.ratios > 0))),
            "fits": fitter.fits, "steps": fitter.steps,
            "steps_run": fitter.steps_run, "syncs": fitter.syncs,
            "fit_s": seconds, "restored": restored}


def update_rejection_sampler(cfg: Config, log, device) -> dict:
    """mode=update_sampler: the rejection coder's update pass over the
    first latent block of each group of each test image (a running
    average), saving the averaged acceptance probabilities."""
    images = [_padded(cfg, img) for img in _images(cfg, log)[0]]
    model, restored = load_model(cfg, None, images[0], device)
    log.info(f"params restored from checkpoint: {restored}")
    rc = RejectionCoder(kl_per_partition=cfg.kl_per_partition)
    seconds, updates = [], []
    for i, x in enumerate(images):
        t0 = time.perf_counter()
        before = rc.sampler.average_count
        xt = torch.as_tensor(x, device=device)
        out = model(xt, forward_noise(cfg, x.shape, cfg.seed + i))
        for n, (p_n, c_n) in enumerate(pairs(out)):
            plan = plan_split(int(p_n.loc.numel()), cfg.block_size)
            perms = split_permutations(
                rng.root_keys([cfg.seed + i], device=device), plan)
            tb = split_coders(p_n, plan, perms)
            cb = split_coders(c_n, plan, perms)
            # The first block stands for the group; update averages.
            rc.encode_block(GaussianParams(tb.loc[0], tb.scale[0]),
                            GaussianParams(cb.loc[0], cb.scale[0]),
                            seed=cfg.seed + i * 64 + n, update_sampler=True)
        seconds.append(time.perf_counter() - t0)
        updates.append(int(rc.sampler.average_count - before))
        log.info(f"update_sampler image {i} done ({updates[-1]} partition "
                 f"updates, {seconds[-1]:.1f} s)")
    path = os.path.join(cfg.model_save_dir, "rejection_acceptance.npy")
    os.makedirs(cfg.model_save_dir, exist_ok=True)
    np.save(path, rc.sampler.acceptance_probabilities)
    log.info(f"saved acceptance probabilities to {path} "
             f"(spillover p={rc.sampler.spillover_probability:.3e})")
    return {"path": path, "seconds": seconds, "updates": updates,
            "acceptance": rc.sampler.acceptance_probabilities,
            "spillover_probability": rc.sampler.spillover_probability,
            "restored": restored}


def required_budget(cfg: Config, model, coder, x, seed) -> int:
    """Probe one image's per-group KL and return the partition budget it
    needs: the largest ceil(KL / Omega) over its latent blocks."""
    out = model(x, forward_noise(cfg, tuple(x.shape), seed))
    need = 1
    for p_n, c_n in pairs(out):
        need = max(need, coder.required_partitions(p_n, c_n, seed))
    return need


def grow_budget(cfg: Config, log, coder, need: int):
    """Grow the static partition budget to fit a probed need (25% headroom,
    rounded up to a multiple of 8); a too-small budget truncates blocks.
    Past ``max_budget`` the budget is capped, but never below the one the
    coder already has."""
    budget = -(-int(need * 1.25) // 8) * 8
    if budget > cfg.max_budget:
        log.warning(
            f"probed requirement {need} exceeds max_budget="
            f"{cfg.max_budget}; capping (over-budget blocks will saturate "
            f"— lossless via the residual stream, but inspect "
            f"saturated_blocks in the CSV)")
        budget = max(cfg.max_budget, coder.max_partitions)
    log.warning(
        f"max_partitions={coder.max_partitions} < required {need}; "
        f"auto-sizing to {budget} (disable with auto_max_partitions=False)")
    return dataclasses.replace(coder, max_partitions=budget)


def main(argv) -> dict:
    argv = [a for a in argv if a != "matmul_precision=highest"]
    cfg = apply_overrides(Config(), argv)
    check_supported(cfg)
    device = process_device(cfg.device, 0)   # device=cuda: card 0
    if device.type == "cuda":
        torch.cuda.set_device(device)
    log = setup_logger("compression_performance")
    # The checkpoint's recorded training config wins over the defaults.
    if cfg.model == "large_resnet_vae":
        cfg = dataclasses.replace(cfg, large_cfg=reconcile_model_config(
            cfg.model_save_dir, "large_resnet_vae", cfg.large_cfg, log))
    else:
        cfg = dataclasses.replace(cfg, model_cfg=reconcile_model_config(
            cfg.model_save_dir, "resnet_vae", cfg.model_cfg, log))
    print_config(cfg)
    os.makedirs(cfg.output_dir, exist_ok=True)

    if cfg.mode == "initialize":
        return initialize_coder_ratios(cfg, log, device)
    if cfg.mode == "update_sampler":
        return update_rejection_sampler(cfg, log, device)

    coder = build_coder(cfg)
    if os.path.exists(ratio_path(cfg)):
        coder = dataclasses.replace(
            coder, aux_variance_ratios=tuple(np.load(ratio_path(cfg))
                                             .tolist()))
        log.info(f"using fitted aux ratios from {ratio_path(cfg)}")

    images, synthetic = _images(cfg, log)
    model, restored = load_model(cfg, coder, _padded(cfg, images[0]),
                                 device)
    log.info(f"params restored from checkpoint: {restored}")

    timer = PhaseTimer()
    csv_path = os.path.join(cfg.output_dir, f"{cfg.dataset.dataset}.csv")
    rows, needs, budgets = [], [], []
    crashes = 0
    for u, (label, x) in enumerate(_units(cfg, images)):
        xt = torch.as_tensor(x, device=device)
        seed = cfg.seed + u
        # Size the static budget to the data; a later unit may need more
        # than the first, so every unit is probed.  It grows, never
        # shrinks.
        if cfg.auto_max_partitions and (u == 0 or cfg.probe_every_image):
            need = required_budget(cfg, model, coder, xt, seed)
            needs.append(need)
            if need > coder.max_partitions:
                coder = grow_budget(cfg, log, coder, need)
                model.coder = coder
        budgets.append(coder.max_partitions)
        try:
            rows.append(_compress_one(cfg, log, model, coder, label, seed,
                                      xt, timer))
        except Exception as e:  # one unit's failure does not stop the run
            crashes += 1
            log.error(f"unit {label} failed: {type(e).__name__}: {e}")
    if cfg.tile and rows:
        rows += _aggregate_tiles(cfg, log, rows, images)

    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    timer.dump(os.path.join(cfg.output_dir, "phase_times.json"))
    log.info("phase times: " + ", ".join(
        f"{k}={v['mean_ms']:.0f}ms" for k, v in timer.report().items()))
    mean_bpd = (float(np.mean([r["total_bits_per_dim"] for r in rows]))
                if rows else float("nan"))
    log.info(f"wrote {csv_path}; images={len(rows)} crashes={crashes}; "
             f"mean bpd={mean_bpd:.3f}")
    return {"csv": csv_path, "rows": rows, "crashes": crashes,
            "needs": needs, "budgets": budgets,
            "phase_times": timer.report(), "mean_bpd": mean_bpd,
            "synthetic": synthetic, "restored": restored}


def _ms_ssim_auto(a: torch.Tensor, b: torch.Tensor) -> float:
    """MS-SSIM with the scale count sized to the image (5 scales need
    min(H, W) >= 176; smaller images use fewer, the weights renormalised)."""
    scales = 1
    side = min(a.shape[1], a.shape[2])
    while scales < 5 and side >= 11 * (2 ** scales):
        scales += 1
    w = np.asarray(_MSSSIM_WEIGHTS[:scales])
    return float(ms_ssim(a, b, weights=w / w.sum())[0])


def _aggregate_tiles(cfg: Config, log, rows, images) -> list:
    """One row per image from its tiles' rows: bits, KL, times and
    saturated blocks summed, quality metrics weighted by the tiles' dims;
    ``roundtrip_ok`` if every tile's is (each tile is exact, so the image
    is)."""
    out = []
    for i, img in enumerate(images):
        tr = [r for r in rows if str(r["index"]).startswith(f"{i}_t")]
        if not tr:
            continue
        dims = np.asarray([r["width"] * r["height"] * 3.0 for r in tr])
        bits = sum(r["latent_code_bits"] + r["residual_bits"] for r in tr)

        def wmean(k):
            return float(np.sum([r[k] * d for r, d in zip(tr, dims)])
                         / dims.sum())

        def total(k):
            return sum(r[k] for r in tr)

        row = dict(index=f"{i}_total", width=img.shape[1],
                   height=img.shape[0], seed=cfg.seed,
                   total_kl=total("total_kl"),
                   ideal_elbo_bpd=wmean("ideal_elbo_bpd"),
                   ideal_psnr=wmean("ideal_psnr"),
                   ideal_ms_ssim=wmean("ideal_ms_ssim"),
                   latent_code_bits=total("latent_code_bits"),
                   file_bits=total("file_bits"),
                   total_bits_per_dim=bits / dims.sum(),
                   residual_bits=total("residual_bits"),
                   psnr=wmean("psnr"), ms_ssim=wmean("ms_ssim"),
                   comp_time=total("comp_time"),
                   decomp_time=total("decomp_time"),
                   roundtrip_ok=all(r["roundtrip_ok"] for r in tr),
                   saturated_blocks=total("saturated_blocks"))
        log.info(f"image {i} TOTAL over {len(tr)} tiles: "
                 f"bpd={row['total_bits_per_dim']:.3f} "
                 f"ideal={row['ideal_elbo_bpd']:.3f} "
                 f"lossless={row['roundtrip_ok']}")
        out.append(row)
    return out


def _compress_one(cfg: Config, log, model, coder, i, seed: int,
                  x: torch.Tensor, timer: PhaseTimer) -> dict:
    h, w = int(x.shape[1]), int(x.shape[2])
    num_dims = float(np.prod(x.shape[1:]))
    scale = float(torch.exp(model.likelihood_log_scale))

    # Ideal pass: ELBO bits/dim and the uncoded reconstruction's quality.
    with timer.phase("forward"):
        out = model(x, forward_noise(cfg, tuple(x.shape), seed))
        ideal_elbo_bpd = float(
            (-torch.mean(out["log_likelihood"])
             + torch.sum(torch.mean(out["analytic_kl"], dim=1)))
            / (num_dims * LOG2))
    ideal_psnr = float(psnr(x + 0.5, out["reconstruction"])[0])
    ideal_ms = _ms_ssim_auto(x + 0.5, out["reconstruction"])

    t0 = time.time()
    with timer.phase("encode"):
        latents, kl = compress_latents(model, x, seed)
    comp_time = time.time() - t0
    total_kl = float(torch.sum(kl))

    # A block whose count hits the static budget was truncated: its sample
    # is a poor posterior approximation and the residual grows.
    saturated = int(sum(np.sum(c == coder.max_partitions)
                        for _, c in latents))
    if saturated:
        log.warning(
            f"image {i}: {saturated} latent block(s) hit "
            f"max_partitions={coder.max_partitions} — the KL budget is too "
            f"small for this model; rerun with a larger max_partitions")

    rec_path = os.path.join(cfg.output_dir, f"img_{i}.rec")
    np.savez(os.path.join(cfg.output_dir, f"block_indices_{i}.npz"),
             **{f"indices_{g}": ind for g, (ind, _) in enumerate(latents)})
    x01 = x[0].cpu().numpy() + 0.5

    residual = None
    if cfg.true_lossless:
        # Scored against the decode replay's reconstruction (the encoder
        # embeds the decoder), so the file alone is lossless.
        with timer.phase("residual"):
            dec_recon = decompress_latents(model, (h, w), latents, seed)
            residual, _ = encode_residual(x01, dec_recon[0].cpu().numpy(),
                                          scale)

    with timer.phase("container_write"):
        nbytes = write_rec(rec_path, seed=seed, image_shape=(h, w, 3),
                           block_size=cfg.block_size,
                           max_index=coder.max_index, latents=latents,
                           residual=residual, codec=cfg.codec)

    with timer.phase("container_read"):
        rseed, _, _, latents2, residual2 = read_rec(
            rec_path, max_partitions=coder.max_partitions,
            with_residual=True)
    ok = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
             for a, b in zip(latents, latents2))
    assert ok, "index round trip failed"

    t0 = time.time()
    with timer.phase("decode"):
        recon = decompress_latents(model, (h, w), latents2, rseed)
        device_fence(recon)
    decomp_time = time.time() - t0

    if residual is not None:
        out01 = decode_residual(residual2, recon[0].cpu().numpy(), scale)
        assert np.array_equal(quantize(out01), quantize(x01)), \
            "lossless pixel recovery failed"
        residual_bits = len(residual2.data) * 8.0
    else:
        residual_bits = float(-discretized_logistic(
            x, recon - 0.5, scale)[0] / LOG2)

    latent_bits = float(sum(
        coder.codelength_nats(CodedLatent(None, torch.as_tensor(cnt), None))
        for _, cnt in latents) / LOG2)
    total_bpd = (latent_bits + residual_bits) / num_dims

    row = dict(index=i, width=w, height=h, seed=seed,
               total_kl=total_kl,
               ideal_elbo_bpd=ideal_elbo_bpd,
               ideal_psnr=ideal_psnr, ideal_ms_ssim=ideal_ms,
               latent_code_bits=latent_bits,
               file_bits=nbytes * 8,
               total_bits_per_dim=total_bpd,
               residual_bits=residual_bits,
               psnr=float(psnr(x + 0.5, recon)[0]),
               ms_ssim=_ms_ssim_auto(x + 0.5, recon),
               comp_time=comp_time,
               decomp_time=decomp_time, roundtrip_ok=ok,
               saturated_blocks=saturated)
    log.info(f"image {i}: kl={total_kl:.0f} bpd={total_bpd:.3f} "
             f"ideal={ideal_elbo_bpd:.3f} comp={comp_time:.2f}s ok={ok}")
    if cfg.save_reconstructions:
        write_png(os.path.join(cfg.output_dir, f"recon_{i}.png"),
                  recon[0].cpu().numpy())
    return row


if __name__ == "__main__":
    main(sys.argv[1:])
