"""Lossy compression evaluation on the GPU (port of
examples/lossy/compress_with_lossy_model.py: ``large_level_1_vae``,
``large_level_2_vae`` and ``large_level_4_vae`` with the beam-search
coder).

    python -m rec_tpu_torch.cli.compress_with_lossy_model key=value ...

Per test image (padded to a multiple of 64 by reflection, seed
``seed + i``): the ideal pass (posterior samples; bits per pixel from the
KLs, PSNR and MS-SSIM of its reconstruction), REC compress into
``<output_dir>/img_<i>.rec`` (every latent level through the beam-search
kernel on the card), decompress from the file alone, which must match the
encoder's reconstruction within rtol 1e-4 / atol 1e-5, and the file's bits
per pixel, PSNR and MS-SSIM.  It writes ``<output_dir>/<model>_<dataset>.csv``
with the reference's columns in its order (``examples/lossy/rd_curves.py``
reads it) and, with ``save_reconstructions``, ``recon_<i>.png``.

A ``model_config.json`` in ``model_save_dir`` overrides the model kind and
filter widths, and its newest checkpoint supplies the weights (EMA by
default); without one the weights are fresh, drawn from ``seed``.  The ideal
pass draws its noise from numpy (``forward_noise``; the reference uses JAX
keys).  ``device=cpu`` runs on the CPU (the tests do); by default the run
needs a GPU and raises without one.  ``sampler=importance`` codes with the
importance coder (``GaussianCoder``, ``max_index = 2^coding_bits``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..coding import Coder
from ..coding.gauss import GaussianParams
from ..data.datasets import (DatasetConfig, load_images, normalize,
                             pad_to_multiple, write_png)
from ..io import read_rec
from ..models.lossy import (Large1LevelVAE, Large2LevelVAE, Large4LevelVAE,
                            compress_to_file, decompress_from_file)
from ..models.lossy.base import saturated_blocks
from ..models.lossy.convert import load_flax_params
from ..train import CheckpointManager, load_model_config
from ..utils.config import apply_overrides, print_config
from ..utils.logging import setup_logger
from ..utils.metrics import ms_ssim, ms_ssim_db, psnr
from .serve import build_coder, process_device

LOG2 = float(np.log(2.0))
MODELS = {"large_level_1_vae": Large1LevelVAE,
          "large_level_2_vae": Large2LevelVAE,
          "large_level_4_vae": Large4LevelVAE}


@dataclasses.dataclass(frozen=True)
class Config:
    model: str = "large_level_2_vae"
    dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(dataset="kodak",
                                              normalize="unit",
                                              split="test"))
    level_1_filters: int = 196
    level_2_filters: int = 128
    level_3_filters: int = 128
    level_4_filters: int = 128
    sampler: str = "beam_search"
    n_beams: int = 10
    extra_samples: float = 1.0
    kl_per_partition: float = 3.0
    coding_bits: int = 12
    block_size: int = 1000
    max_partitions: int = 24
    stream: str = "fmix"            # candidate bit-generator: fmix | threefry
    codec: str = "ac"               # .rec entropy codec: ac | rans
    num_images: int = 4
    seed: int = 42
    use_ema: bool = True
    model_save_dir: str = "checkpoints/lossy"
    output_dir: str = "results/lossy"
    save_reconstructions: bool = False
    device: str = "cuda"


def check_model(kind: str) -> None:
    """An unknown model kind raises."""
    if kind not in MODELS:
        raise ValueError(f"unknown model {kind!r}")


def check_supported(cfg: Config) -> None:
    if cfg.sampler not in ("beam_search", "importance"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    check_model(cfg.model)


def make_model(kind: str, coder: Coder, seed: int, device,
               level_1_filters: int = 0, level_2_filters: int = 0,
               level_3_filters: int = 0, level_4_filters: int = 0):
    """A lossy model for inference (no autograd on its weights), fresh
    weights from ``seed``; a filter width of 0 keeps the model's default,
    and a model without that level ignores it."""
    check_model(kind)
    kwargs = {}
    if level_1_filters:
        kwargs["num_filters" if kind == "large_level_1_vae"
               else "level_1_filters"] = level_1_filters
    if level_2_filters and kind != "large_level_1_vae":
        kwargs["level_2_filters"] = level_2_filters
    for level, width in ((3, level_3_filters), (4, level_4_filters)):
        if width and kind == "large_level_4_vae":
            kwargs[f"level_{level}_filters"] = width
    model = MODELS[kind](coder=coder, seed=seed, device=device, **kwargs)
    return model.requires_grad_(False)


def restore_weights(model, model_save_dir: str, use_ema: bool) -> bool:
    """Load the newest checkpoint's weights (its EMA shadows with
    ``use_ema``) into ``model``; False when the directory holds none."""
    restored = CheckpointManager(model_save_dir).restore_params()
    if restored is None:
        return False
    load_flax_params(model, restored["ema_params"] if use_ema
                     else restored["params"])
    return True


def reconcile(cfg: Config, log) -> Config:
    """Correct the model kind and filter widths to the checkpoint's
    recorded config (a structurally compatible checkpoint would otherwise
    restore silently onto the wrong model)."""
    saved = load_model_config(cfg.model_save_dir)
    if saved is None:
        return cfg
    if saved.get("kind") != cfg.model:
        log.warning(f"checkpoint {cfg.model_save_dir} was trained as "
                    f"{saved.get('kind')}, not {cfg.model} — overriding "
                    f"model")
        cfg = dataclasses.replace(cfg, model=saved["kind"])
    filt = {k: v for k, v in saved["cfg"].items()
            if k.endswith("_filters") and getattr(cfg, k, v) != v}
    if filt:
        log.warning(f"overriding filters to match checkpoint: {filt}")
        cfg = dataclasses.replace(cfg, **filt)
    return cfg


def forward_noise(model, image_shape, seed: int) -> list:
    """The ideal pass's standard normals for a (1, H, W, 3) image, one
    float32 array per latent level in coding order, from numpy's
    ``default_rng(seed)``; a test replaces this to feed JAX's draws."""
    _, H, W, _ = image_shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1,) + shape, dtype=np.float32)
            for shape in model.latent_shapes(H, W)]


def main(argv) -> dict:
    cfg = apply_overrides(Config(), argv)
    log = setup_logger("compress_lossy")
    cfg = reconcile(cfg, log)
    check_supported(cfg)
    device = process_device(cfg.device, 0)   # device=cuda: card 0
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print_config(cfg)
    os.makedirs(cfg.output_dir, exist_ok=True)

    coder = build_coder(cfg)
    max_index = coder.max_index
    model = make_model(cfg.model, coder, cfg.seed, device,
                       cfg.level_1_filters, cfg.level_2_filters,
                       cfg.level_3_filters, cfg.level_4_filters)

    images, synthetic = load_images(cfg.dataset)
    if synthetic:
        log.warning("using SYNTHETIC data (no local dataset found)")
    images = normalize(images, "unit")[: cfg.num_images]
    restored = restore_weights(model, cfg.model_save_dir, cfg.use_ema)
    if restored:
        log.info("restored trained params")

    rows, counts, needs = [], [], []
    for i, img in enumerate(images):
        x = torch.as_tensor(np.asarray(pad_to_multiple(img[None], 64),
                                       np.float32), device=device)
        num_pixels = float(x.shape[1] * x.shape[2])
        seed = cfg.seed + i

        with torch.no_grad():
            ideal = model(x, forward_noise(model, tuple(x.shape), seed))
        ideal_recon = torch.clamp(ideal["reconstruction"], 0.0, 1.0)
        ideal_bpp = float(sum(ideal["kls"])) / (num_pixels * LOG2)
        # The partitions each level would need at the ideal pass's
        # posterior and prior (level l codes with seed + l).
        needs.append(max(
            coder.required_partitions(GaussianParams(q.loc[0], q.scale[0]),
                                      GaussianParams(p.loc[0], p.scale[0]),
                                      seed + lvl)
            for lvl, (q, p) in enumerate(zip(ideal["posteriors"],
                                             ideal["priors"]))))

        path = os.path.join(cfg.output_dir, f"img_{i}.rec")
        t0 = time.time()
        recon = compress_to_file(model, path, x[0], seed=seed,
                                 block_size=cfg.block_size,
                                 max_index=max_index, codec=cfg.codec)
        comp_time = time.time() - t0
        recon2 = decompress_from_file(model, path,
                                      max_partitions=cfg.max_partitions)
        np.testing.assert_allclose(recon2.cpu().numpy(), recon.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
        recon = torch.clamp(recon[None], 0.0, 1.0)
        counts.append([c for _, c in read_rec(
            path, max_partitions=cfg.max_partitions)[3]])
        saturated = saturated_blocks(counts[-1], coder.max_partitions)

        file_bits = os.path.getsize(path) * 8
        rows.append(dict(
            index=i, seed=seed,
            ideal_bpp=ideal_bpp,
            actual_bpp=file_bits / num_pixels,
            ideal_psnr=float(psnr(x, ideal_recon)[0]),
            psnr=float(psnr(x, recon)[0]),
            ideal_ms_ssim=float(ms_ssim(x, ideal_recon)[0]),
            ms_ssim=float(ms_ssim(x, recon)[0]),
            ms_ssim_db=float(ms_ssim_db(x, recon)[0]),
            comp_time=comp_time))
        log.info(f"image {i}: bpp={rows[-1]['actual_bpp']:.4f} "
                 f"(ideal {ideal_bpp:.4f}) psnr={rows[-1]['psnr']:.2f} "
                 f"ms-ssim={rows[-1]['ms_ssim']:.4f} t={comp_time:.1f}s "
                 f"saturated {saturated}/{sum(map(len, counts[-1]))} "
                 f"blocks")
        if cfg.save_reconstructions:
            write_png(os.path.join(cfg.output_dir, f"recon_{i}.png"),
                      recon[0].cpu().numpy())

    csv_path = os.path.join(cfg.output_dir,
                            f"{cfg.model}_{cfg.dataset.dataset}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    log.info(f"wrote {csv_path}")
    return {"csv": csv_path, "rows": rows, "counts": counts,
            "required_partitions": needs, "synthetic": synthetic,
            "restored": restored}


if __name__ == "__main__":
    main(sys.argv[1:])
