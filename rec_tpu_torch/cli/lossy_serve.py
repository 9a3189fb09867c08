"""Batched lossy compression serving on the GPU (port of
examples/lossy/serve.py; ``cli/serve.py`` is the lossless one).

    python -m rec_tpu_torch.cli.lossy_serve key=value ...

Images (padded to a multiple of ``pad_multiple``) are encoded a global
batch at a time, padded to a multiple of the global mesh: each device of
each process takes its contiguous rows of the batch
(``parallel.local_rows``) and codes them with one
``make_batch_rec_forward`` call, which launches the beam-search kernel once
per latent level per device.  Image i gets seed ``seed + 101 * i``
and a ``.rec`` file ``img_<i>.rec`` in ``output_dir``.  ``verify`` reads
every written file back and checks the index round trip, and that the
canonical single-image decode of the file matches the batched
reconstruction within atol 1e-4 (batch-B and batch-1 convolutions round
differently; the latent replay itself is bitwise).  The last line is
``served N lossy images at X images/sec, Y bpp``; the first batch is left
out of the rate.

Weights come from ``model_save_dir`` when it holds a checkpoint, else fresh
ones from ``seed``; filter widths of 0 keep the model's defaults.
``n_devices``, ``device`` and multi-process serving (``coordinator``,
``num_processes``, ``process_id``) work as in ``cli/serve.py``: one
process serves on every visible card by default.  ``model`` is
``large_level_1_vae``, ``large_level_2_vae`` or ``large_level_4_vae`` (one
launch per latent level per device and batch); only levels 1 and 2 take a
filter width here, as in the reference.
``device=cpu`` runs on the CPU (the tests do).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..data.datasets import (DatasetConfig, load_images, normalize,
                             pad_to_multiple)
from ..io import read_rec, write_rec
from ..parallel import (init_distributed, make_batch_rec_forward,
                        process_rows, rank, world_size)
from ..utils.config import apply_overrides, print_config
from ..utils.logging import setup_logger
from ..utils.metrics import psnr
from ..utils.profiling import device_fence
from .compress_with_lossy_model import (check_model, make_model,
                                        restore_weights)
from .serve import build_coder, serving_mesh


@dataclasses.dataclass(frozen=True)
class Config:
    model: str = "large_level_2_vae"
    dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(dataset="clic2019",
                                              split="test",
                                              normalize="unit"))
    # 0 = the model family's default filter widths (196/128; 192/192 for
    # the 4-level model, whose levels 3 and 4 keep 128).
    level_1_filters: int = 0
    level_2_filters: int = 0
    n_beams: int = 10
    extra_samples: float = 1.0
    kl_per_partition: float = 3.0
    block_size: int = 1000
    max_partitions: int = 32
    stream: str = "fmix"
    codec: str = "ac"
    batch_size: int = 8
    num_images: int = 16
    n_devices: int = 0               # devices (0 = every visible card)
    pad_multiple: int = 64
    seed: int = 42
    verify: bool = True
    use_ema: bool = True
    model_save_dir: str = "checkpoints/lossy"
    output_dir: str = "results/lossy_serve"
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = -1
    device: str = "cuda"


def main(argv) -> dict:
    cfg = apply_overrides(Config(), argv)
    check_model(cfg.model)
    init_distributed(cfg.coordinator, cfg.num_processes, cfg.process_id)
    pid, world = rank(), world_size()
    mesh = serving_mesh(cfg.device, cfg.n_devices, pid, world)
    device, n_dev = mesh[0], len(mesh)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if pid == 0:
        print_config(cfg)
    log = setup_logger(f"lossy_serve[{pid}]")
    os.makedirs(cfg.output_dir, exist_ok=True)
    batch = -(-cfg.batch_size // (world * n_dev)) * (world * n_dev)
    rows = process_rows(batch, pid, world, n_dev)
    log.info(f"mesh: {mesh.describe()}; {world} process(es), global batch "
             f"{batch}, rows {rows.start}..{rows.stop - 1} here")

    coder = build_coder(cfg)
    model = make_model(cfg.model, coder, cfg.seed, device,
                       cfg.level_1_filters, cfg.level_2_filters)
    images, synthetic = load_images(cfg.dataset)
    if synthetic:
        log.warning("using SYNTHETIC data (no local dataset found)")
    images = normalize(images, "unit")[: cfg.num_images]
    images = np.asarray(pad_to_multiple(images, cfg.pad_multiple),
                        np.float32)
    H, W = images.shape[1:3]
    restored = restore_weights(model, cfg.model_save_dir, cfg.use_ema)
    log.info(f"params restored from checkpoint: {restored}")
    rec_forward = make_batch_rec_forward(model, mesh if n_dev > 1 else None)

    my_images = total_bytes = 0
    t_encode = 0.0
    psnrs, counts = [], []
    for start in range(0, len(images), batch):
        chunk = images[start: start + batch]
        valid = len(chunk)
        if valid < batch:  # pad the tail batch
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch - valid, axis=0)])
        seeds = cfg.seed + 101 * np.arange(start, start + batch)
        device_fence(next(model.parameters()))
        t0 = time.perf_counter()
        out = rec_forward(chunk[rows.start:rows.stop],
                          seeds[rows.start:rows.stop])
        device_fence(out)
        if start > 0:  # the first batch warms up; leave it out
            t_encode += time.perf_counter() - t0
        levels = [(ind.cpu().numpy(), cnt.cpu().numpy())
                  for ind, cnt in out["latents"]]
        rec_all = out["reconstruction"].cpu().numpy()
        for k, j in enumerate(rows):
            if j >= valid:
                continue
            i = start + j
            latents = [(ind[k], cnt[k]) for ind, cnt in levels]
            counts.append([cnt for _, cnt in latents])
            path = os.path.join(cfg.output_dir, f"img_{i}.rec")
            total_bytes += write_rec(
                path, seed=int(seeds[j]), image_shape=(H, W, 3),
                block_size=cfg.block_size, max_index=coder.max_index,
                latents=latents, codec=cfg.codec)
            my_images += 1
            if cfg.verify:
                recon = verify_file(cfg, model, path, latents,
                                    rec_all[k][0])
                psnrs.append(float(psnr(torch.from_numpy(chunk[j]),
                                        torch.from_numpy(recon))))

    steady = max(my_images - len(rows), 0)
    ips = steady / t_encode if steady and t_encode > 0 else float("nan")
    bpp = (total_bytes * 8.0 / (my_images * H * W)
           if my_images else float("nan"))
    if cfg.verify:
        log.info(f"verified {my_images} file(s): index round trip + "
                 f"decode coherence; mean PSNR "
                 f"{np.mean(psnrs) if psnrs else float('nan'):.2f} dB")
    log.info(f"process {pid}: {my_images} images -> {total_bytes} bytes "
             f"({bpp:.4f} bpp, codec={cfg.codec}; {ips / n_dev:.2f} "
             f"images/sec/chip over {n_dev} device(s))")
    print(f"served {my_images} lossy images at {ips:.2f} images/sec, "
          f"{bpp:.4f} bpp", flush=True)
    return {"images": my_images, "bytes": total_bytes, "images_per_s": ips,
            "images_per_s_per_device": ips / n_dev,
            "mesh": [str(d) for d in mesh],
            "bpp": bpp, "encode_s": t_encode, "steady_images": steady,
            "counts": counts, "psnr": psnrs, "synthetic": synthetic,
            "restored": restored}


def verify_file(cfg: Config, model, path: str, enc_latents,
                enc_recon: np.ndarray) -> np.ndarray:
    """Check one written file from the file alone: the index round trip,
    and the canonical single-image decode against the encoder's batched
    reconstruction.  Returns the decode (H, W, 3); raises on a mismatch."""
    rseed, shape, _, latents = read_rec(path,
                                        max_partitions=cfg.max_partitions)
    for (a, ca), (b, cb) in zip(enc_latents, latents):
        if not np.array_equal(ca, cb):
            raise AssertionError(f"{path}: .rec counts")
        for blk, c in enumerate(cb):
            if not np.array_equal(a[blk, :c], b[blk, :c]):
                raise AssertionError(f"{path}: .rec indices")
    recon = model.rec_decode(shape[:2], latents, rseed)[0].cpu().numpy()
    # The latent replay is bitwise; the batch-B convolutions of the encoder
    # and the batch-1 ones of the decoder agree to float rounding.
    if not np.allclose(recon, enc_recon, atol=1e-4):
        raise AssertionError(
            f"{path}: decode diverged from the encoder's reconstruction")
    return recon


if __name__ == "__main__":
    main(sys.argv[1:])
