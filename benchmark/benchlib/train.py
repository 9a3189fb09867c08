"""Lossless training of the RVAE, as ``cli/train_generative_model.build``
sets it up at its defaults (batch 8, adamax at 1e-3, ``lamb`` 0.1, beta 1,
EMA 0.999, one card) and ``train`` steps it: the window drives
``step_fn(state, batch, noise)``.  The batches (synthetic images) and the
posterior noise come from the seed, made by the benchmark, so that the
reference gets the same.  Set-up builds the one train state, with fresh
weights from the seed and the data-dependent init on the first batch, and
drives it through its first three steps on the window's own call and feed;
the window goes on from step 4 with the same object.  Once the window has
closed, the same object takes one step more on the same call and feed,
from the state the window left, as every step of the window ran.

The check runs the reference's three steps from the same weights and feed
and compares, per step, the loss; by the worst leaf, the first gradient as
the optimizer holds it after step 1 (adamax's first moment is (1 - b1) g),
and the weights' and the EMA's change after step 3.  It redoes the step
after the window from the program's state before it and compares the
same: the loss, the gradient (from the first moment's change), and the
weights' and the EMA's change."""

from __future__ import annotations

import time

import numpy as np
import torch

from .lossless_serve import _model_cfg
from .spans import Spans
from .traffic import smooth_images
from . import yardstick

CHECK_STEPS = 3


class Driver:
    def __init__(self, cell, seed: int, device: str = "cuda"):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.traffic = cell.traffic
        self.config = cell.config
        self.batch = int(self.traffic["batch"])
        self.shape = tuple(self.config["image_shape"])
        self.spans = Spans()

    def feed(self, i: int):
        """Step i's batch (on the device) and posterior noise: smooth images
        of stream i, and normals from a device generator of (seed, i)."""
        dev = self.devs[0]
        imgs = (smooth_images(self.seed, 1000 + i, self.batch, self.shape)
                / 255.0 - 0.5)
        x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32))
        x = (x.pin_memory().to(dev, non_blocking=True)
             if dev.type == "cuda" else x)
        mc = self.config["model"]
        H, W = self.shape[:2]
        gen = torch.Generator(device=dev).manual_seed(
            (self.seed * 7919 + i) % (2 ** 63))
        noise = torch.randn((mc["num_res_blocks"], self.batch, H // 2,
                             W // 2, mc["stochastic_filters"]),
                            generator=gen, device=dev)
        return x, noise

    def setup(self) -> None:
        from rec_tpu_torch.models.resnet_vae import (BidirectionalResNetVAE,
                                                     ResNetVAEConfig)
        from rec_tpu_torch.train import (init_state, make_optimizer,
                                         staircase_schedule)
        from rec_tpu_torch.train.lossless import (LosslessTrainConfig,
                                                  make_train_step)
        from reference.rvae import fresh_weights

        self.devs = [torch.device(self.device, 0)
                     if self.device == "cuda" else torch.device("cpu")]
        dev = self.devs[0]
        mc = _model_cfg(self.config)
        cfg = ResNetVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in mc.items()})
        tc = self.config["train"]
        model = BidirectionalResNetVAE(cfg, None, seed=0, device=dev)
        weights = fresh_weights(mc, self.seed, dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        with torch.no_grad():
            for name, t in model.named_parameters():
                t.copy_(weights[name])
        x0, n0 = self.feed(0)
        model.data_dependent_init(x0, n0)
        tx = make_optimizer(tc["optimizer"], staircase_schedule(
            tc["learning_rate"], tc["drop_learning_rate_after_iter"],
            tc["learning_rate_drop_rate"]))
        self.state = init_state(model, tx, beta=1.0)
        self.step_fn = make_train_step(
            model, LosslessTrainConfig(lamb=tc["lamb"],
                                       ema_decay=tc["ema_decay"]),
            tx, num_pixels=self.shape[0] * self.shape[1])
        self.model = model
        # The first steps, on the window's own call and feed.
        names = list(self.state.params)
        self.p0 = {k: self.state.params[k].detach().cpu().clone()
                   for k in names}
        losses = []
        for i in range(1, CHECK_STEPS + 1):
            _, m = self._step(i)
            losses.append(m["loss"])
            if i == 1:
                mu = self.state.opt_state.mu
                self.g1 = {k: (mu[k] / (1.0 - tx.b1)).cpu() for k in names}
        self.losses = [float(v) for v in losses]
        self.p3 = {k: v.detach().cpu().clone()
                   for k, v in self.state.params.items()}
        self.e3 = {k: v.detach().cpu().clone()
                   for k, v in self.state.ema_params.items()}
        self.next_step = CHECK_STEPS + 1

    def _step(self, i: int):
        with self.spans.span("feed"):
            x, noise = self.feed(i)
        with self.spans.span("step"):
            self.state, metrics = self.step_fn(self.state, x, noise)
        return self.state, metrics

    def _run(self, n_steps=None, seconds=None) -> dict:
        t0 = time.perf_counter()
        n = 0
        while (n < n_steps if n_steps is not None
               else time.perf_counter() - t0 < seconds):
            self._step(self.next_step)
            self.next_step += 1
            n += 1
        for d in self.devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return {"seconds": time.perf_counter() - t0, "units": n}

    def window(self, seconds: float) -> dict:
        return self._run(seconds=seconds)

    def traced(self, units: int) -> dict:
        return self._run(n_steps=units)

    def end_to_end(self, res: dict) -> dict:
        return {"train_images_per_s": res["units"] * self.batch
                / res["seconds"]}

    def extra(self) -> dict:
        """The leaves the check left out of the change (their first
        reference gradient under a thousandth of the median leaf's), and
        the gaps of the step after the window on their own."""
        return {"left_out_leaves": getattr(self, "left_out", []),
                "window_step": getattr(self, "window_step", {})}

    def layer_context(self, res: dict, ctx: dict) -> None:
        # Forward and backward: the backward's input and weight gradients
        # take twice the forward's multiply-adds.
        flops = 3 * yardstick.rvae_image_flops(self.config["model"],
                                               *self.shape[:2])
        ctx.update(units=res["units"],
                   flops=flops * self.batch * res["units"])

    def _window_step(self) -> None:
        """One step after the window from the state it left, with that
        state before the step and the program's loss and state after."""
        def host(d):
            return {k: v.detach().cpu().clone() for k, v in d.items()}

        s = self.state
        before = {"params": host(s.params), "ema": host(s.ema_params),
                  "mu": host(s.opt_state.mu), "nu": host(s.opt_state.nu),
                  "count": int(s.opt_state.count), "step": self.next_step}
        _, m = self._step(self.next_step)
        s = self.state
        self.after = {"loss": float(m["loss"]), "params": host(s.params),
                      "ema": host(s.ema_params), "mu": host(s.opt_state.mu)}
        self.before = before

    def release(self) -> None:
        self._window_step()
        del self.state, self.step_fn, self.model
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from .check_train import check_steps

        return check_steps(self)
