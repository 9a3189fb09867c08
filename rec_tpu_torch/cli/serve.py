"""Batched lossless compression serving on the GPU (port of
examples/lossless/serve.py).

    python -m rec_tpu_torch.cli.serve key=value ...

Images are encoded a global batch at a time, padded to a multiple of the
global mesh: each device of each process takes its contiguous rows of the
batch (``parallel.local_rows``) and encodes them with one
``compress_batch`` call, one block-codec call per res block for all its
images: one launch of the beam-search kernel with ``sampler=beam_search``,
the eager scan path with ``shared_pool=true``, the importance coder with
``sampler=importance``.  Each image gets seed ``seed + 101 * i`` and a
``.rec`` file ``img_<i>.rec`` in ``output_dir``; with ``true_lossless`` the
file carries the coded residual, scored against the canonical single-image
decode (the program the decoder runs).  ``verify`` reads every written file
back, decodes it and checks the container round trip, the decode against
the encoder's reconstruction and (true_lossless) exact pixels.  The last
line is ``served N images at X images/sec, Y bits/dim``; the first batch is
left out of the throughput.

Weights come from ``model_save_dir`` (a rec_tpu checkpoint directory) when
it holds one, else fresh weights from ``seed`` with data-dependent
initialisation on the first image.  One process serves on ``n_devices``
cards (0 = every visible card; more than are visible raises), each with a
replica of the model; ``device=cuda:k`` names one card, and ``device=cpu
n_devices=k`` runs k shards one after the other on the CPU (the tests do).
Multi-process serving: every process passes the same
``coordinator=host:port`` and ``num_processes`` and its own
``process_id``, and serves on card ``process_id % device_count`` unless
``device=cuda:k`` names one; ``n_devices`` is then the global mesh, 0 or
``num_processes``.  The rate per card divides a process's rate by its
cards.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..coding import BeamSearchCoder, Coder, GaussianCoder
from ..data.datasets import (DatasetConfig, load_images, normalize,
                             pad_to_multiple)
from ..device import resolve_device
from ..io import read_rec, write_rec
from ..io.residual import decode_residual, encode_residual, quantize
from ..models.convert import load_flax_params
from ..models.resnet_vae import BidirectionalResNetVAE, ResNetVAEConfig
from ..parallel import (Mesh, init_distributed, make_batch_compress,
                        make_mesh, process_rows, rank, world_size)
from ..train import CheckpointManager, reconcile_model_config
from ..utils.config import apply_overrides, print_config
from ..utils.logging import setup_logger
from ..utils.profiling import device_fence


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(dataset="cifar10",
                                              split="test"))
    model_cfg: ResNetVAEConfig = dataclasses.field(
        default_factory=ResNetVAEConfig)
    sampler: str = "beam_search"     # beam_search | importance
    n_beams: int = 20
    extra_samples: float = 1.2
    kl_per_partition: float = 3.0
    coding_bits: int = 12
    block_size: int = 1000
    max_partitions: int = 24
    stream: str = "fmix"
    shared_pool: bool = False
    codec: str = "ac"                # .rec entropy codec: ac | rans
    batch_size: int = 8              # global batch (padded to a multiple
                                     # of the process count)
    num_images: int = 16
    n_devices: int = 0               # devices (0 = every visible card)
    pad_multiple: int = 2
    seed: int = 42
    verify: bool = True
    true_lossless: bool = True
    use_ema: bool = True
    model_save_dir: str = "checkpoints/lossless"
    output_dir: str = "results/serve"
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = -1
    device: str = "cuda"


def check_supported(cfg: Config) -> None:
    """Options of rec_tpu's serve that the port does not have yet raise
    (they never fall back to something else)."""
    if cfg.sampler not in ("beam_search", "importance"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")


def process_device(device: str, pid: int) -> torch.device:
    """The device process ``pid`` serves on: ``device=cuda`` without an
    index gives each process card ``pid % device_count`` (one process per
    card on one host); an explicit ``cuda:k`` or ``cpu`` is kept."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", pid % torch.cuda.device_count())
    return dev


def serving_mesh(device: str, n_devices: int, pid: int, world: int
                 ) -> Mesh:
    """The devices process ``pid`` of ``world`` serves on.  One process:
    ``device=cuda`` gives the first ``n_devices`` visible cards (0 = every
    one; more than are visible raises), ``cuda:k`` that card alone, and
    ``cpu`` ``n_devices`` CPU entries (0 = one).  Several processes: each
    its own device (``process_device``), ``n_devices`` the global mesh, 0
    or ``world``."""
    if world > 1:
        if n_devices not in (0, world):
            raise ValueError(f"with {world} processes of one device each, "
                             f"n_devices is 0 or {world}, got {n_devices}")
        return Mesh([process_device(device, pid)])
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is None:
        return make_mesh(n_devices or None, dev.type)
    if n_devices > 1:
        raise ValueError(f"device={device} names one card; n_devices="
                         f"{n_devices} asks for more")
    return Mesh([dev])


def build_coder(cfg) -> Coder:
    """The coder of a CLI config: ``sampler=importance`` gives the
    importance coder (``GaussianCoder``), ``beam_search`` the beam-search
    coder.  A config without a ``sampler`` field (lossy_serve's) gets beam
    search, one without ``shared_pool`` (the compress CLIs') the default."""
    sampler = getattr(cfg, "sampler", "beam_search")
    if sampler == "importance":
        return GaussianCoder(kl_per_partition=cfg.kl_per_partition,
                             coding_bits=cfg.coding_bits,
                             block_size=cfg.block_size,
                             max_partitions=cfg.max_partitions,
                             stream=cfg.stream)
    if sampler != "beam_search":
        raise ValueError(f"unknown sampler {sampler!r}")
    return BeamSearchCoder(kl_per_partition=cfg.kl_per_partition,
                           n_beams=cfg.n_beams,
                           extra_samples=cfg.extra_samples,
                           block_size=cfg.block_size,
                           max_partitions=cfg.max_partitions,
                           stream=cfg.stream,
                           shared_pool=getattr(cfg, "shared_pool", False))


def load_model(cfg, coder, example: np.ndarray, device):
    """The model for inference (no autograd on its weights) with restored
    weights, or fresh ones (seeded from ``cfg.seed``, data-dependent init on
    ``example``).  Returns (model, restored)."""
    model = BidirectionalResNetVAE(cfg.model_cfg, coder, seed=cfg.seed,
                                   device=device)
    model.requires_grad_(False)
    restored = CheckpointManager(cfg.model_save_dir).restore_params()
    if restored is not None:
        load_flax_params(model, restored["ema_params"] if cfg.use_ema
                         else restored["params"])
        return model, True
    mc = cfg.model_cfg
    H, W = example.shape[1:3]
    sh, sw = mc.first_strides
    noise = np.random.RandomState(cfg.seed + 1).randn(
        mc.num_res_blocks, example.shape[0], H // sh, W // sw,
        mc.stochastic_filters).astype(np.float32)
    model.data_dependent_init(
        torch.as_tensor(example, dtype=torch.float32, device=device), noise)
    return model, False


def main(argv) -> dict:
    cfg = apply_overrides(Config(), argv)
    check_supported(cfg)
    init_distributed(cfg.coordinator, cfg.num_processes, cfg.process_id)
    pid, world = rank(), world_size()
    mesh = serving_mesh(cfg.device, cfg.n_devices, pid, world)
    device, n_dev = mesh[0], len(mesh)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if pid == 0:
        print_config(cfg)
    log = setup_logger(f"serve[{pid}]")
    os.makedirs(cfg.output_dir, exist_ok=True)
    cfg = dataclasses.replace(cfg, model_cfg=reconcile_model_config(
        cfg.model_save_dir, "resnet_vae", cfg.model_cfg, log))
    batch = -(-cfg.batch_size // (world * n_dev)) * (world * n_dev)
    rows = process_rows(batch, pid, world, n_dev)
    log.info(f"mesh: {mesh.describe()}; {world} process(es), global batch "
             f"{batch}, rows {rows.start}..{rows.stop - 1} here")

    coder = build_coder(cfg)
    images, synthetic = load_images(cfg.dataset)
    if synthetic:
        log.warning("using SYNTHETIC data (no local dataset found)")
    images = normalize(images, "centered")[: cfg.num_images]
    images = np.asarray(pad_to_multiple(images, cfg.pad_multiple),
                        np.float32)
    H, W = images.shape[1:3]
    model, restored = load_model(cfg, coder, images[:1], device)
    log.info(f"params restored from checkpoint: {restored}")
    scale = float(torch.exp(model.likelihood_log_scale.detach()))
    compress = make_batch_compress(model, mesh if n_dev > 1 else None)

    def decompress_one(ind, cnt, seed):
        """The canonical single-image decode, as numpy (H, W, C)."""
        return model.decompress((H, W), ind, cnt, seed)[0].cpu().numpy()

    my_images = total_bytes = 0
    t_encode = 0.0
    for start in range(0, len(images), batch):
        chunk = images[start: start + batch]
        valid = len(chunk)
        if valid < batch:  # pad the tail batch
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch - valid, axis=0)])
        seeds = cfg.seed + 101 * np.arange(start, start + batch)
        device_fence(model.generative_base)
        t0 = time.perf_counter()
        out = compress(chunk[rows.start:rows.stop],
                       seeds[rows.start:rows.stop])
        device_fence(out)
        if start > 0:  # the first batch warms up; leave it out
            t_encode += time.perf_counter() - t0
        ind_all = out["indices"].cpu().numpy()
        cnt_all = out["counts"].cpu().numpy()
        rec_all = out["reconstruction"].cpu().numpy()
        for k, j in enumerate(rows):
            if j >= valid:
                continue
            i = start + j
            ind, counts = ind_all[k], cnt_all[k]
            latents = [(ind[g], counts[g])
                       for g in range(cfg.model_cfg.num_res_blocks)]
            residual = None
            if cfg.true_lossless:
                canon = decompress_one(ind, counts, int(seeds[j]))
                residual, _ = encode_residual(chunk[j] + 0.5, canon, scale)
            path = os.path.join(cfg.output_dir, f"img_{i}.rec")
            total_bytes += write_rec(
                path, seed=int(seeds[j]), image_shape=(H, W, 3),
                block_size=cfg.block_size, max_index=coder.max_index,
                latents=latents, residual=residual, codec=cfg.codec)
            my_images += 1
            if cfg.verify:
                verify_file(cfg, path, decompress_one, (ind, counts),
                            chunk[j], rec_all[k][0], scale)

    if cfg.verify:
        log.info(f"verified {my_images} file(s): container round trip, "
                 f"bit-exact decode"
                 + (", exact pixel recovery" if cfg.true_lossless else ""))
    steady = max(my_images - len(rows), 0)
    ips = steady / t_encode if steady and t_encode > 0 else float("nan")
    bpd = (total_bytes * 8.0 / (my_images * H * W * 3)
           if my_images else float("nan"))
    log.info(f"encode throughput: {ips:.2f} images/sec ({ips / n_dev:.2f} "
             f"images/sec/chip over {n_dev} device(s), global batch "
             f"{batch})")
    log.info(f"process {pid}: {my_images} images -> {total_bytes} bytes "
             f"({bpd:.3f} bits/dim incl. container, codec={cfg.codec})")
    print(f"served {my_images} images at {ips:.2f} images/sec, "
          f"{bpd:.3f} bits/dim", flush=True)
    return {"images": my_images, "bytes": total_bytes,
            "images_per_s": ips, "images_per_s_per_device": ips / n_dev,
            "mesh": [str(d) for d in mesh], "bits_per_dim": bpd,
            "encode_s": t_encode, "steady_images": steady,
            "synthetic": synthetic, "restored": restored}


def verify_file(cfg: Config, path: str, decompress_one, enc_latents,
                img_centered: np.ndarray, enc_recon: np.ndarray,
                scale: float) -> None:
    """Check one written file from the file alone: container round trip,
    the canonical decode against the encoder's reconstruction, and
    (true_lossless) exact 8-bit pixels.  Raises on any mismatch."""
    rseed, _, _, latents, residual = read_rec(
        path, max_partitions=cfg.max_partitions, with_residual=True)
    enc_ind, enc_cnt = enc_latents
    ind = np.stack([a for a, _ in latents])
    cnt = np.stack([c for _, c in latents])
    if not np.array_equal(cnt, enc_cnt):
        raise AssertionError(f"{path}: .rec counts")
    for g in range(ind.shape[0]):
        for blk, c in enumerate(cnt[g]):
            if not np.array_equal(enc_ind[g, blk, :c], ind[g, blk, :c]):
                raise AssertionError(f"{path}: .rec indices")
    recon = decompress_one(ind, cnt, rseed)
    # The latent replay is bitwise; the batch-B convolutions of the encoder
    # and the batch-1 ones of the decoder agree to float rounding.
    if not np.allclose(recon, enc_recon, atol=1e-4):
        raise AssertionError(
            f"{path}: decode diverged from the encoder's reconstruction")
    if cfg.true_lossless:
        out01 = decode_residual(residual, recon, scale)
        if not np.array_equal(quantize(out01), quantize(img_centered + 0.5)):
            raise AssertionError(f"{path}: lossless pixel recovery failed")


if __name__ == "__main__":
    main(sys.argv[1:])
