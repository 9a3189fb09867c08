"""Lossless serving of the RVAE, as ``rec_tpu_torch.cli.serve::main`` runs
it: per batch ``parallel.make_batch_compress(model)`` (one beam-search
launch per res block for the whole batch), then per image the canonical
single-image ``model.decompress`` that the residual is scored against,
``io.residual.encode_residual`` and ``io.write_rec``.  Closed loop: the
next batch starts when the last one's files are written.  Verify is left
out; the reference's check replaces it.

The check reads every file of the window back with the reference alone
(``reference/``, ``check_lossless.py``): the container and its arithmetic
streams, each latent replayed from seed and indices, the generative pass,
the residual down to the 8-bit pixels."""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch

from .spans import Spans
from .traffic import image_seeds, smooth_images
from . import yardstick


def _model_cfg(config: dict) -> dict:
    keys = ("num_res_blocks", "deterministic_filters", "stochastic_filters",
            "kernel_size", "first_kernel_size", "first_strides",
            "likelihood", "output_channels")
    return {k: config["model"][k] for k in keys}


class Driver:
    def __init__(self, cell, seed: int, device: str = "cuda"):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.traffic = cell.traffic
        self.config = cell.config
        self.coder_cfg = dict(self.config["coder"])
        self.batch = int(self.traffic["batch"])
        self.n_dev = int(self.traffic.get("devices", 1))
        self.shape = tuple(self.config["image_shape"])
        self.spans = Spans()
        self.done = []          # per image: dict of what the check needs
        self.launch_counts = []  # per beam-search launch: its blocks' counts

    # --- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from rec_tpu_torch.coding import BeamSearchCoder
        from rec_tpu_torch.models.resnet_vae import (BidirectionalResNetVAE,
                                                     ResNetVAEConfig)
        from rec_tpu_torch.parallel import Mesh, make_batch_compress
        from rec_tpu_torch.io import write_rec
        from rec_tpu_torch.io.residual import encode_residual
        from reference.rvae import fresh_weights

        mc = _model_cfg(self.config)
        cfg = ResNetVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in mc.items()})
        c = self.coder_cfg
        coder = BeamSearchCoder(
            kl_per_partition=c["kl_per_partition"], n_beams=c["n_beams"],
            extra_samples=c["extra_samples"], block_size=c["block_size"],
            max_partitions=c["max_partitions"], stream=c["stream"])
        self.max_index = coder.max_index
        if self.device == "cuda":
            devs = [torch.device("cuda", i) for i in range(self.n_dev)]
        else:
            devs = [torch.device(self.device)] * self.n_dev
        self.devs = devs
        dev = devs[0]
        model = BidirectionalResNetVAE(cfg, coder, seed=0, device=dev)
        model.requires_grad_(False)
        weights = fresh_weights(mc, self.seed, dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        state = model.state_dict()
        if set(state) != set(weights):
            raise RuntimeError("the port's weights are not the reference's: "
                               f"{sorted(set(state) ^ set(weights))[:5]}")
        with torch.no_grad():
            for name, t in model.named_parameters():
                t.copy_(weights[name])
        example, noise = self.ddi_inputs(dev)
        model.data_dependent_init(example, noise)
        self.model = model
        self.scale = float(torch.exp(model.likelihood_log_scale))
        self.compress = make_batch_compress(
            model, Mesh(devs) if self.n_dev > 1 else None)
        self.write_rec, self.encode_residual = write_rec, encode_residual
        self.tmp = tempfile.mkdtemp(prefix="rec_bench_")
        # Warm-up: one batch of this cell's shape, not counted.
        self._batch(-1, keep=False)

    def ddi_inputs(self, dev):
        """The data-dependent init's first image and posterior noise, as
        ``cli/serve.py::load_model`` takes them (the first image served,
        standard normals), here from the seed."""
        img = smooth_images(self.seed, -1, 1, self.shape)
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        mc = self.config["model"]
        H, W = self.shape[:2]
        noise = torch.randn((mc["num_res_blocks"], 1, H // 2, W // 2,
                             mc["stochastic_filters"]), generator=gen,
                            device=dev)
        x = torch.as_tensor(img / 255.0 - 0.5, dtype=torch.float32,
                            device=dev)
        return x, noise

    # --- the timed path ------------------------------------------------------

    def _batch(self, b: int, keep: bool = True) -> None:
        B = self.batch
        imgs = smooth_images(self.seed, b, B, self.shape)
        chunk = imgs / 255.0 - 0.5
        first = max(b, 0) * B
        seeds = image_seeds(self.seed, first, B, self.traffic["seed_stride"])
        H, W = self.shape[:2]
        with self.spans.span("compress_batch", fence=self.devs):
            out = self.compress(chunk, seeds)
        ind_all = out["indices"].cpu().numpy()
        cnt_all = out["counts"].cpu().numpy()
        rec_all = out["reconstruction"].cpu().numpy()
        n_res = ind_all.shape[1]
        for k in range(B):
            with self.spans.span("decode"):
                canon = self.model.decompress(
                    (H, W), ind_all[k], cnt_all[k], seeds[k])[0].cpu().numpy()
            path = os.path.join(self.tmp, f"img_{first + k}.rec")
            with self.spans.span("residual"):
                residual, _ = self.encode_residual(chunk[k] + 0.5, canon,
                                                   self.scale)
                self.write_rec(
                    path, seed=seeds[k], image_shape=self.shape,
                    block_size=self.coder_cfg["block_size"],
                    max_index=self.max_index,
                    latents=[(ind_all[k, g], cnt_all[k, g])
                             for g in range(n_res)],
                    residual=residual, codec=self.traffic["codec"])
            if keep:
                self.done.append({"path": path, "seed": seeds[k],
                                  "image": chunk[k],
                                  "enc_recon": rec_all[k, 0]})
        if keep:
            share = B // self.n_dev
            for g in range(n_res):
                for d in range(self.n_dev):
                    self.launch_counts.append(
                        cnt_all[d * share:(d + 1) * share, g])

    def window(self, seconds: float) -> dict:
        """Batches until ``seconds`` have passed; the window ends with the
        last batch begun in it."""
        t0 = time.perf_counter()
        b = 0
        while time.perf_counter() - t0 < seconds:
            self._batch(b)
            b += 1
        return {"seconds": time.perf_counter() - t0, "units": b * self.batch}

    def traced(self, units: int) -> dict:
        t0 = time.perf_counter()
        for b in range(units):
            self._batch(b)
        return {"seconds": time.perf_counter() - t0,
                "units": units * self.batch}

    def end_to_end(self, res: dict) -> dict:
        return {"encode_images_per_s": res["units"] / res["seconds"]}

    def layer_context(self, res: dict, ctx: dict) -> None:
        flops = yardstick.rvae_image_flops(self.config["model"],
                                           *self.shape[:2])
        ctx.update(units=res["units"], flops=flops * res["units"],
                   launch_counts=self.launch_counts,
                   coder=dict(self.coder_cfg,
                              n_samples=self.max_index))

    def release(self) -> None:
        for d in self.done:
            with open(d["path"], "rb") as f:
                d["bytes"] = f.read()
        shutil.rmtree(self.tmp, ignore_errors=True)
        del self.model, self.compress
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------------

    def check(self) -> dict:
        from .check_lossless import check_files

        return check_files(self)
