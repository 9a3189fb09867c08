"""Lossless generative model training on the GPU (port of
examples/lossless/train_generative_model.py: ``model=resnet_vae``,
``model=large_resnet_vae`` and ``model=vae``).

    python -m rec_tpu_torch.cli.train_generative_model key=value ...

Trains ``BidirectionalResNetVAE`` (24 res blocks, 160/32 filters by
default; ``model_cfg.use_iaf`` and ``model_cfg.distribution=cauchy`` too)
or ``LargeResNetVAE`` (``large_cfg``, laplace likelihood by default) with
adamax or adam at a staircase learning rate, the free-bits floor ``lamb``,
the optional beta anneal and target-bpp controller, and EMA shadow weights
(``train/lossless.py``).  ``model=large_resnet_vae`` takes the reference's
defaults where the command line does not set them: adam, ``lamb=0.01`` and
256-crops of clic2019, kodak and hopper512.  ``model=vae`` trains the
dense MNIST VAE (``models/mnist_vae.py``, ``latent_size`` latents) with
its own step (``train/lossless.py::make_vae_train_step``) and defaults:
adam at 3e-4, ``lamb=0`` and ``mnist`` in [0, 1].  Start-up: the weights
are seeded from ``seed`` (the convolutional models are then set by
data-dependent initialisation on the first batch), ``model_config.json`` is written to ``model_save_dir``, and the
newest checkpoint there (written by either package) is restored.  Every
``log_freq`` steps the loss is checked for blow-up, the scalars (with
``KL/dim_<b>`` per res block or group) go to ``<log_dir>/metrics.jsonl``
and TensorBoard, the first four originals and reconstructions to
TensorBoard, and a checkpoint is saved; a last one is saved at the end.
Checkpoints are rec_tpu's files, so either package resumes, serves or
evaluates them.

The posterior noise of each step (standard normals, or uniforms for cauchy
latents; one tensor per group for the large model) comes from one
``torch.Generator`` on the first device seeded from ``seed``: a resumed run
draws other noise than an unbroken one (rec_tpu folds the step into its
key).  ``device=cuda`` trains data parallel over every visible card, as
rec_tpu's jitted step shards the batch over its mesh
(``train/lossless.py``: the batch and its noise split into equal shares,
the loss taken once on the first card; one visible card runs the
one-device step); a batch that is not a multiple of the card count raises.
``device=cuda:k`` trains on that card and ``device=cpu`` on the CPU (the
tests do); by default the run needs a GPU and raises without one.
Checkpoints hold the first card's state, so one-card and data-parallel
runs resume from each other's.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..data.datasets import DatasetConfig, iterate_batches, load_images
from ..device import resolve_device
from ..models import convert as lossless_convert
from ..models import large_convert, mnist_convert
from ..models.large_resnet_vae import LargeResNetVAE, LargeResNetVAEConfig
from ..models.mnist_vae import MNISTVAE
from ..models.resnet_vae import (BidirectionalResNetVAE, ResNetVAEConfig,
                                 Uniforms)
from ..parallel import Mesh, make_mesh
from ..train import (CheckpointManager, TrainState, init_state,
                     make_optimizer, save_model_config, staircase_schedule)
from ..train.lossless import (LosslessTrainConfig, check_finite,
                              make_train_step, make_vae_train_step)
from ..utils.config import apply_overrides, print_config
from ..utils.logging import setup_logger
from ..utils.profiling import device_fence
from ..utils.summary import SummaryWriter


@dataclasses.dataclass(frozen=True)
class Config:
    model: str = "resnet_vae"  # resnet_vae | large_resnet_vae | vae
    dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(dataset="cifar10"))
    model_cfg: ResNetVAEConfig = dataclasses.field(
        default_factory=ResNetVAEConfig)
    large_cfg: LargeResNetVAEConfig = dataclasses.field(
        default_factory=lambda: LargeResNetVAEConfig(likelihood="laplace"))
    latent_size: int = 50            # model=vae
    optimizer: str = "adamax"
    learning_rate: float = 1e-3
    grad_clip_norm: float = 0.0   # 0 = off; global-norm clip before adam
    drop_learning_rate_after_iter: int = 200_000
    learning_rate_drop_rate: float = 0.316
    iters: int = 500_000
    batch_size: int = 8
    beta: float = 1.0
    lamb: float = 0.1
    anneal: bool = False
    annealing_end: int = 100_000
    ema_decay: float = 0.999
    target_bpp: Optional[float] = None
    adjust_beta_after_iters: int = 0
    log_freq: int = 500
    model_save_dir: str = "checkpoints/lossless"
    log_dir: str = "logs/lossless"
    seed: int = 42
    device: str = "cuda"


def check_supported(cfg: Config) -> None:
    if cfg.model not in ("resnet_vae", "large_resnet_vae", "vae"):
        raise ValueError(f"unknown model {cfg.model!r}")


def _model_defaults(cfg: Config, argv) -> Config:
    """Per-model defaults, without overriding what the command line set:
    the MNIST VAE's (adam, lr 3e-4, lamb 0, mnist in [0, 1]) and the
    large model's (adam, lamb 0.01, 256-crops of the big-image
    datasets)."""
    given = {a.split("=", 1)[0] for a in argv if "=" in a}

    def maybe(c, **kw):
        return dataclasses.replace(
            c, **{k: v for k, v in kw.items() if k not in given})

    if cfg.model == "vae":
        cfg = maybe(cfg, learning_rate=3e-4, lamb=0.0, optimizer="adam")
        data = {"normalize": "unit"}
        if "dataset.dataset" not in given:
            data["dataset"] = "mnist"
        elif "dataset.normalize" in given:
            data = {}
        cfg = dataclasses.replace(
            cfg, dataset=dataclasses.replace(cfg.dataset, **data))
    elif cfg.model == "large_resnet_vae":
        cfg = maybe(cfg, optimizer="adam", lamb=0.01)
        if "dataset.crop_size" not in given and cfg.dataset.dataset in (
                "clic2019", "kodak", "hopper512"):
            cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
                cfg.dataset, crop_size=256))
    return cfg


@dataclasses.dataclass
class Trainer:
    """What a training run holds: the model and its train state, the step,
    the batch stream, the noise generator and the checkpoint directory."""

    model: torch.nn.Module
    state: TrainState
    step_fn: object
    batches: Iterator[np.ndarray]
    generator: torch.Generator
    noise_shape: object   # one shape, or a list of shapes (one per group)
    ckpt: CheckpointManager
    device: torch.device
    restored: bool
    synthetic: bool
    uniform: bool = False  # cauchy latents: uniforms, not normals

    def batch(self) -> torch.Tensor:
        """The next batch on the device; from pinned memory without a wait
        on a GPU."""
        x = torch.from_numpy(np.ascontiguousarray(next(self.batches),
                                                  np.float32))
        if self.device.type != "cuda":
            return x
        return x.pin_memory().to(self.device, non_blocking=True)

    def noise(self):
        """One step's posterior noise of ``noise_shape``, drawn on the
        device: standard normals, or ``Uniforms`` in [1e-6, 1 - 1e-6] for
        cauchy latents."""
        def draw(shape):
            if self.uniform:
                return 1e-6 + (1.0 - 2e-6) * torch.rand(
                    shape, generator=self.generator, device=self.device)
            return torch.randn(shape, generator=self.generator,
                               device=self.device)

        eps = ([draw(s) for s in self.noise_shape]
               if isinstance(self.noise_shape, list)
               else draw(self.noise_shape))
        return Uniforms(eps) if self.uniform else eps


def init_noise(seed: int, noise_shape, uniform: bool):
    """The data-dependent init's noise, as ``Trainer.noise`` shapes it,
    from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)

    def draw(shape):
        a = (rs.uniform(1e-6, 1.0 - 1e-6, shape) if uniform
             else rs.randn(*shape))
        return a.astype(np.float32)

    eps = ([draw(s) for s in noise_shape] if isinstance(noise_shape, list)
           else draw(noise_shape))
    return Uniforms(eps) if uniform else eps


def build_model(cfg: Config, batch: int, h: int, w: int, device):
    """The model of ``cfg.model`` with fresh weights from ``seed``, its
    per-step noise shape, whether that noise is uniforms, its config for
    ``model_config.json`` and its checkpoint converter."""
    if cfg.model == "vae":
        model = MNISTVAE(latents=cfg.latent_size, seed=cfg.seed,
                         device=device)
        return (model, (batch, cfg.latent_size), False,
                {"latent_size": cfg.latent_size}, mnist_convert)
    if cfg.model == "large_resnet_vae":
        model = LargeResNetVAE(cfg.large_cfg, None, seed=cfg.seed,
                               device=device)
        shape = [(batch,) + s for s in model.latent_shapes(h, w)]
        return (model, shape, False, cfg.large_cfg, large_convert)
    mc = cfg.model_cfg
    sh, sw = mc.first_strides
    shape = (mc.num_res_blocks, batch, h // sh, w // sw,
             mc.stochastic_filters)
    model = BidirectionalResNetVAE(mc, None, seed=cfg.seed, device=device)
    return (model, shape, mc.distribution == "cauchy", mc,
            lossless_convert)


def train_mesh(device: str) -> Optional[Mesh]:
    """Every visible card for ``device=cuda``; None (one device) for
    ``cuda:k`` and ``cpu``."""
    dev = resolve_device(device)
    return make_mesh() if dev.type == "cuda" and dev.index is None else None


def build(cfg: Config, log, mesh: Optional[Mesh] = None) -> Trainer:
    """Model, optimizer and state for ``cfg``, restored from the newest
    checkpoint in ``cfg.model_save_dir`` when there is one.  The step is
    data parallel over ``mesh`` (by default ``train_mesh(cfg.device)``);
    the model, its state and the noise live on its first device."""
    if mesh is None:
        mesh = train_mesh(cfg.device)
    device = mesh[0] if mesh else resolve_device(cfg.device)
    if mesh and cfg.batch_size % len(mesh):
        raise ValueError(f"batch_size {cfg.batch_size} is not a multiple of "
                         f"the {len(mesh)} training device(s)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    synthetic = load_images(cfg.dataset)[1]
    if synthetic:
        log.warning("using SYNTHETIC data (no local dataset found)")
    batches = iterate_batches(cfg.dataset, cfg.batch_size, seed=cfg.seed)
    first = np.asarray(next(batches), np.float32)
    h, w = first.shape[1:3]
    model, noise_shape, uniform, model_cfg, convert = build_model(
        cfg, cfg.batch_size, h, w, device)
    if cfg.model != "vae":   # the dense VAE has no data-dependent init
        model.data_dependent_init(
            torch.as_tensor(first, device=device),
            init_noise(cfg.seed + 1, noise_shape, uniform))
    n_params = sum(p.numel() for p in model.parameters())
    log.info(f"model={cfg.model} initialized: {n_params / 1e6:.2f}M params; "
             f"mesh: {mesh.describe() if mesh else device}")

    tx = make_optimizer(cfg.optimizer,
                        staircase_schedule(cfg.learning_rate,
                                           cfg.drop_learning_rate_after_iter,
                                           cfg.learning_rate_drop_rate),
                        clip_norm=cfg.grad_clip_norm)
    state = init_state(model, tx, beta=cfg.beta)
    ckpt = CheckpointManager(cfg.model_save_dir, convert=convert)
    # The trained architecture beside the checkpoints, for the evaluation
    # CLIs to restore onto.
    save_model_config(cfg.model_save_dir, cfg.model, model_cfg)
    restored = ckpt.restore(state)
    if restored is not None:
        state = restored
        log.info(f"restored checkpoint at step {state.step}")
    train_cfg = LosslessTrainConfig(
        beta=cfg.beta, lamb=cfg.lamb, anneal=cfg.anneal,
        annealing_end=cfg.annealing_end, ema_decay=cfg.ema_decay,
        target_bpp=cfg.target_bpp,
        adjust_beta_after_iters=cfg.adjust_beta_after_iters)
    make_step = make_vae_train_step if cfg.model == "vae" else make_train_step
    step_fn = make_step(model, train_cfg, tx, num_pixels=h * w, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return Trainer(model=model, state=state, step_fn=step_fn,
                   batches=batches, generator=generator,
                   noise_shape=noise_shape, ckpt=ckpt, device=device,
                   restored=restored is not None, synthetic=synthetic,
                   uniform=uniform)


def train(cfg: Config, run: Trainer, log) -> dict:
    """Steps from the state's step to ``cfg.iters``, logging and saving
    every ``log_freq`` steps and at the end.  Each step's loss and
    elbo_bpd are kept on the device and read once at the end."""
    writer = SummaryWriter(cfg.log_dir)
    state = run.state
    start = state.step
    history = torch.zeros((max(cfg.iters - start, 0), 2), device=run.device)
    shift = 0.0 if cfg.dataset.normalize == "unit" else 0.5
    first_s = log_s = 0.0
    t0 = time.perf_counter()
    for n, i in enumerate(range(start, cfg.iters)):
        batch = run.batch()
        state, metrics = run.step_fn(state, batch, run.noise())
        history[n, 0] = metrics["loss"]
        history[n, 1] = metrics["elbo_bpd"]
        if n == 0:
            device_fence(history)
            first_s = time.perf_counter() - t0
        if i % cfg.log_freq == 0:
            device_fence(history)
            t_log = time.perf_counter()
            check_finite(metrics)
            recon = metrics.pop("reconstruction")
            kl_blocks = metrics.pop("kl_per_block").cpu().numpy()
            scalars = {k: float(v) for k, v in metrics.items()}
            # Per-group KL scalars: KL/dim_1 is the RVAE's top res block,
            # the large model's block 1.
            scalars.update({f"KL/dim_{b + 1}": float(v)
                            for b, v in enumerate(kl_blocks)})
            writer.scalars(i, scalars)
            writer.images(i, "Original", batch[:4].cpu().numpy() + shift)
            writer.images(i, "Reconstruction", recon[:4].cpu().numpy())
            log.info(f"step {i}: loss={scalars['loss']:.3f} "
                     f"nll={scalars['nll']:.3f} kl={scalars['kl']:.3f} "
                     f"bpd={scalars['elbo_bpd']:.3f} "
                     f"max_kl={scalars['expected_max_kl']:.3f}")
            run.ckpt.save(state)
            log_s += time.perf_counter() - t_log
    device_fence(history)
    seconds = time.perf_counter() - t0
    path = run.ckpt.save(state)
    writer.close()
    run.state = state
    hist = history.cpu().numpy()
    return {"start_step": start, "steps": len(hist), "final_step": state.step,
            "seconds": seconds, "first_step_s": first_s, "log_s": log_s,
            "loss": hist[:, 0].tolist(), "elbo_bpd": hist[:, 1].tolist(),
            "checkpoint": path, "restored": run.restored,
            "synthetic": run.synthetic, "batch_size": cfg.batch_size}


def main(argv) -> dict:
    cfg = _model_defaults(apply_overrides(Config(), argv), argv)
    check_supported(cfg)
    if "print_config" in argv:
        print_config(cfg)
        return {}
    log = setup_logger("train_lossless")
    print_config(cfg)
    return train(cfg, build(cfg, log), log)


if __name__ == "__main__":
    main(sys.argv[1:])
