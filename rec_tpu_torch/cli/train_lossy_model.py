"""Lossy VAE training on the GPU (port of
examples/lossy/train_lossy_model.py).

    python -m rec_tpu_torch.cli.train_lossy_model key=value ...

Trains ``large_level_1_vae``, ``large_level_2_vae`` (the default, 196/128
filters) or ``large_level_4_vae`` on random crops (CLIC, 256x256 by
default) with the loss ``beta * distortion + bpp`` (``train/lossy.py``),
adam or adamax at a constant learning rate (a staircase with drop rate 1)
and EMA shadow weights.  Start-up: a first batch is drawn for the model's
shapes and not trained on, fresh weights come from ``seed``,
``model_config.json`` is written to ``model_save_dir`` and the newest
checkpoint there (written by either package) is restored, with this run's
``beta`` in place of the restored one (a neighbour's checkpoint starts a new
rate-distortion point).  Every ``log_freq`` steps the metrics are read once,
go to ``<log_dir>/metrics.jsonl`` (and TensorBoard where it is installed),
and a checkpoint is saved; a last one is saved at the end.  Checkpoints are
rec_tpu's files, so either package resumes or evaluates them.

A non-finite loss stops the run with ``FloatingPointError`` and saves
nothing more: the reference logs and stops, then saves the non-finite
state as its newest checkpoint.  Each step's posterior noise is standard
normals from one ``torch.Generator`` on the device seeded from ``seed``: a
resumed run draws other noise than an unbroken one (rec_tpu folds the step
into its key).  Training runs on one device: rec_tpu's data-parallel mesh
on one card is the same computation.  ``device=cpu`` trains on the CPU (the
tests do); by default the run needs a GPU and raises without one.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from ..data.datasets import DatasetConfig, iterate_batches, load_images
from ..models.lossy import Large1LevelVAE, Large2LevelVAE, Large4LevelVAE
from ..models.lossy import convert as lossy_convert
from ..train import (CheckpointManager, init_state, make_optimizer,
                     save_model_config, staircase_schedule)
from ..train.lossy import LossyTrainConfig, make_train_step
from ..utils.config import apply_overrides, print_config
from ..utils.logging import setup_logger
from ..utils.profiling import device_fence
from ..utils.summary import SummaryWriter
from . import train_generative_model as lossless_cli
from .serve import process_device

MODELS = {
    "large_level_1_vae": lambda cfg, **kw: Large1LevelVAE(
        num_filters=cfg.level_1_filters, **kw),
    "large_level_2_vae": lambda cfg, **kw: Large2LevelVAE(
        level_1_filters=cfg.level_1_filters,
        level_2_filters=cfg.level_2_filters, **kw),
    "large_level_4_vae": lambda cfg, **kw: Large4LevelVAE(
        level_1_filters=cfg.level_1_filters,
        level_2_filters=cfg.level_2_filters,
        level_3_filters=cfg.level_3_filters,
        level_4_filters=cfg.level_4_filters, **kw),
}


@dataclasses.dataclass(frozen=True)
class Config:
    model: str = "large_level_2_vae"
    dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(dataset="clic2019",
                                              normalize="unit",
                                              crop_size=256))
    level_1_filters: int = 196
    level_2_filters: int = 128
    level_3_filters: int = 128
    level_4_filters: int = 128
    loss_fn: str = "mse"
    beta: float = 0.01
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    iters: int = 200_000
    batch_size: int = 8
    ema_decay: float = 0.999
    log_freq: int = 500
    model_save_dir: str = "checkpoints/lossy"
    log_dir: str = "logs/lossy"
    seed: int = 42
    device: str = "cuda"


# The lossless trainer's run state; ``noise_shape`` is one (B, h, w,
# filters) shape per latent level in coding order.
Trainer = lossless_cli.Trainer


def build(cfg: Config, log) -> Trainer:
    """Model, optimizer and state for ``cfg``, restored from the newest
    checkpoint in ``cfg.model_save_dir`` when there is one."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")
    device = process_device(cfg.device, 0)   # device=cuda: card 0
    if device.type == "cuda":
        torch.cuda.set_device(device)
    synthetic = load_images(cfg.dataset)[1]
    if synthetic:
        log.warning("using SYNTHETIC data (no local dataset found)")
    batches = iterate_batches(cfg.dataset, cfg.batch_size, seed=cfg.seed)
    first = next(batches)   # the model's shapes; not trained on
    h, w = first.shape[1:3]
    model = MODELS[cfg.model](cfg, seed=cfg.seed, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    log.info(f"{cfg.model}: {n_params / 1e6:.2f}M params")

    tx = make_optimizer(cfg.optimizer,
                        staircase_schedule(cfg.learning_rate, cfg.iters, 1.0))
    state = init_state(model, tx, beta=cfg.beta)
    ckpt = CheckpointManager(cfg.model_save_dir, convert=lossy_convert)
    save_model_config(cfg.model_save_dir, cfg.model, {
        "level_1_filters": cfg.level_1_filters,
        "level_2_filters": cfg.level_2_filters,
        "level_3_filters": cfg.level_3_filters,
        "level_4_filters": cfg.level_4_filters,
        "loss_fn": cfg.loss_fn, "beta": cfg.beta})
    restored = ckpt.restore(state)
    if restored is not None:
        # This run's beta wins over the restored one: a neighbour's
        # checkpoint fine-tuned at another beta builds the beta sweep.
        state = restored._replace(beta=restored.beta.new_tensor(cfg.beta))
        log.info(f"restored step {state.step} (beta={cfg.beta})")
    step_fn = make_train_step(
        model, LossyTrainConfig(beta=cfg.beta, distortion=cfg.loss_fn,
                                ema_decay=cfg.ema_decay),
        tx, num_pixels=h * w)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    noise_shape = [(cfg.batch_size,) + s for s in model.latent_shapes(h, w)]
    return Trainer(model=model, state=state, step_fn=step_fn,
                   batches=batches, generator=generator,
                   noise_shape=noise_shape, ckpt=ckpt, device=device,
                   restored=restored is not None, synthetic=synthetic)


def train(cfg: Config, run: Trainer, log) -> dict:
    """Steps from the state's step to ``cfg.iters``, logging and saving
    every ``log_freq`` steps and at the end.  Each step's loss, distortion
    and bpp are kept on the device and read once at the end; a non-finite
    loss raises ``FloatingPointError`` before anything more is saved."""
    writer = SummaryWriter(cfg.log_dir)
    state = run.state
    start = state.step
    history = torch.zeros((max(cfg.iters - start, 0), 3), device=run.device)
    first_s = log_s = 0.0
    t0 = time.perf_counter()
    for n, i in enumerate(range(start, cfg.iters)):
        state, metrics = run.step_fn(state, run.batch(), run.noise())
        history[n] = torch.stack([metrics["loss"], metrics["distortion"],
                                  metrics["bpp"]])
        if n == 0:
            device_fence(history)
            first_s = time.perf_counter() - t0
        if i % cfg.log_freq == 0:
            t_log = time.perf_counter()
            scalars = {k: float(v) for k, v in zip(
                ("loss", "distortion", "bpp"), history[n].tolist())}
            if not math.isfinite(scalars["loss"]):
                log.error(f"non-finite loss at step {i}; stopping")
                raise FloatingPointError(f"loss is {scalars['loss']} at "
                                         f"step {i}")
            writer.scalars(i, scalars)
            log.info(f"step {i}: loss={scalars['loss']:.4f} "
                     f"distortion={scalars['distortion']:.3f} "
                     f"bpp={scalars['bpp']:.4f}")
            run.ckpt.save(state)
            log_s += time.perf_counter() - t_log
    hist = history.cpu().numpy()
    seconds = time.perf_counter() - t0
    bad = np.flatnonzero(~np.isfinite(hist[:, 0]))
    if bad.size:
        raise FloatingPointError(f"loss is {hist[bad[0], 0]} at step "
                                 f"{start + bad[0]}")
    path = run.ckpt.save(state)
    writer.close()
    run.state = state
    return {"start_step": start, "steps": len(hist), "final_step": state.step,
            "seconds": seconds, "first_step_s": first_s, "log_s": log_s,
            "loss": hist[:, 0].tolist(), "distortion": hist[:, 1].tolist(),
            "bpp": hist[:, 2].tolist(), "checkpoint": path,
            "restored": run.restored, "synthetic": run.synthetic,
            "batch_size": cfg.batch_size}


def main(argv) -> dict:
    cfg = apply_overrides(Config(), argv)
    if "print_config" in argv:
        print_config(cfg)
        return {}
    log = setup_logger("train_lossy")
    print_config(cfg)
    return train(cfg, build(cfg, log), log)


if __name__ == "__main__":
    main(sys.argv[1:])
