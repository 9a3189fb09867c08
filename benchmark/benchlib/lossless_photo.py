"""One photo at a time through the large lossless VAE, as
``cli/compression_performance model=large_resnet_vae`` codes each image:
``io/lossless.py::compress_to_file`` (both groups through the beam-search
kernel, the indices to the host, the canonical decode, the residual, the
``.rec`` written), photo i with seed ``seed + i``, without the CLI's ideal
pass, budget probe, read-back and second decode.  The open loop, the
window and the release are ``lossy_image.py``'s: photos due at the mix's
fixed ``rate``, served one at a time in arrival order, each photo's
latency from the time it was due until its file is written.

Weights are the reference's fresh ones from the seed
(``reference/large_rvae.py``), set by the data-dependent init on a photo
and noise drawn from the seed, as ``lossless_serve.py`` does for the RVAE.

The check reads every file of the window back with the reference's
container reader (``unreadable_files``), and judges a sample of
``check_photos`` photos, drawn from the seed before the window, with the
reference alone: both groups replayed from seed and indices, the
generative pass against the encoder's own reconstruction (``recon_gap``),
the residual decoded to the 8-bit pixels (``pixel_errors``), and each
group's blocks held to the reference's posteriors of the served photo and
a plain beam search (``search_gap``, ``count_gap``; ``check_lossless.py``
says what each means)."""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from . import large_rvae_flops, lossy_image
from .spans import Spans
from .traffic import smooth_images

GROUPS = 2


class Driver(lossy_image.Driver):
    def __init__(self, cell, seed: int, device: str = "cuda"):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.traffic = cell.traffic
        self.config = cell.config
        self.coder_cfg = dict(self.config["coder"])
        self.shape = tuple(self.config["image_shape"])
        self.spans = Spans()
        self.done = []
        self.latencies = []
        self.launch_counts = []   # per beam-search launch: its blocks' counts
        self.saturated = 0
        self.late_ms = 0.0
        self.sampled = set()

    # --- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from rec_tpu_torch.io.lossless import compress_to_file
        from rec_tpu_torch.coding import BeamSearchCoder
        from rec_tpu_torch.models.large_resnet_vae import (
            LargeResNetVAE, LargeResNetVAEConfig)
        from reference.large_rvae import fresh_weights

        c = self.coder_cfg
        coder = BeamSearchCoder(
            kl_per_partition=c["kl_per_partition"], n_beams=c["n_beams"],
            extra_samples=c["extra_samples"], block_size=c["block_size"],
            max_partitions=c["max_partitions"], stream=c["stream"])
        self.max_index = coder.max_index
        self.devs = [torch.device(self.device, 0)
                     if self.device == "cuda" else torch.device("cpu")]
        dev = self.devs[0]
        mc = self.config["model"]
        model = LargeResNetVAE(LargeResNetVAEConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in mc.items()}), coder, seed=0, device=dev)
        model.requires_grad_(False)
        weights = fresh_weights(mc, self.seed, dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        state = dict(model.named_parameters())
        if set(state) != set(weights):
            raise RuntimeError("the port's weights are not the reference's: "
                               f"{sorted(set(state) ^ set(weights))[:5]}")
        with torch.no_grad():
            for name, t in state.items():
                t.copy_(weights[name])
        model.data_dependent_init(*self.ddi_inputs(dev))
        self.model = model
        self.compress_to_file = compress_to_file
        self.pool = smooth_images(self.seed, 0, int(self.traffic["images"]),
                                  self.shape) / 255.0 - 0.5
        self.tmp = tempfile.mkdtemp(prefix="rec_bench_")
        self._image(-1, keep=False)   # warm-up: this cell's one shape

    def ddi_inputs(self, dev):
        """The data-dependent init's photo and posterior noise (block 2's,
        block 1's), as the compress CLI takes them (its first image,
        standard normals), here from the seed."""
        img = smooth_images(self.seed, -1, 1, self.shape)
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        mc = self.config["model"]
        H, W = self.shape[:2]
        noise = [torch.randn(shape, generator=gen, device=dev) for shape in (
            (1, H // 64, W // 64, mc["second_stochastic_filters"]),
            (1, H // 16, W // 16, mc["first_stochastic_filters"]))]
        x = torch.as_tensor(img / 255.0 - 0.5, dtype=torch.float32,
                            device=dev)
        return x, noise

    # --- the timed path ------------------------------------------------------

    def _image(self, i: int, keep: bool = True, due_ns: int = None) -> None:
        x = self.pool[i % len(self.pool)][None]
        seed = (self.seed + max(i, 0)) % (2 ** 32)
        path = os.path.join(self.tmp, f"img_{max(i, 0)}.rec")
        t0 = time.perf_counter_ns()
        due_ns = t0 if due_ns is None else due_ns
        coded = self.compress_to_file(
            self.model, path, x, seed,
            block_size=self.coder_cfg["block_size"],
            max_index=self.max_index, codec=self.traffic["codec"],
            true_lossless=self.traffic["true_lossless"])
        t1 = time.perf_counter_ns()
        self.spans.records.append(("compress_to_file", t0, t1))
        if not keep:
            return
        self.latencies.append((t1 - due_ns) / 1e6)
        self.late_ms = max(self.late_ms, (t0 - due_ns) / 1e6)
        budget = self.coder_cfg["max_partitions"]
        for _, cnt in coded.latents:
            self.launch_counts.append(cnt)
            self.saturated += int(np.sum(cnt >= budget))
        d = {"path": path, "seed": seed, "index": i}
        if i in self.sampled:
            d["enc_recon"] = coded.reconstruction[0].cpu().numpy()
        self.done.append(d)

    def extra(self) -> dict:
        """How late the generator ran (the longest wait of a photo between
        its due time and its hand-over), and the window's blocks whose
        count hit the budget."""
        return {"generator_late_ms_max": self.late_ms,
                "saturated_blocks": self.saturated}

    def layer_context(self, res: dict, ctx: dict) -> None:
        flops = large_rvae_flops.image_flops(self.config["model"],
                                             *self.shape[:2])
        ctx.update(units=res["units"], flops=flops * res["units"],
                   launch_counts=self.launch_counts,
                   coder=dict(self.coder_cfg, n_samples=self.max_index))

    # --- the check -----------------------------------------------------------

    def check(self) -> dict:
        from reference import ac, beam, large_rvae, search
        from reference.rvae import full_precision

        full_precision()
        dev = self.devs[0]
        c = self.coder_cfg
        cfg = beam.BeamConfig(c["kl_per_partition"], c["n_beams"],
                              c["extra_samples"], c["block_size"],
                              c["max_partitions"], c["stream"])
        m = large_rvae.Model({k: v.to(dev) for k, v in self.weights.items()},
                             self.config["model"])
        large_rvae.data_dependent_init(m, *self.ddi_inputs(dev))
        H, W = self.shape[:2]
        tally = search.Tally()
        unreadable, pixel_errors, bad, gap, checked = 0, 0, 0, 0.0, 0
        for d in self.done:
            try:
                rec = ac.read_rec(d["bytes"], c["max_partitions"])
            except ac.FormatError:
                unreadable += 1
                continue
            if (rec.seed != d["seed"] or rec.shape != tuple(self.shape)
                    or rec.max_index != cfg.n_samples or rec.residual is None
                    or len(rec.latents) != GROUPS):
                unreadable += 1
                continue
            if "enc_recon" not in d:
                continue

            def replay(group, prior, posterior, seed, rec=rec):
                ind, cnt = rec.latents[group]
                judged = search.judge(cfg, posterior, prior, ind[None],
                                      cnt[None], [seed])
                tally.add(judged)
                return judged["sample"]

            image = self.pool[d["index"] % len(self.pool)]
            x = torch.as_tensor(image[None], dtype=torch.float32, device=dev)
            recon = large_rvae.decode(m, replay, (H, W), rec.seed,
                                      x)[0].cpu().numpy()
            gap = max(gap, float(np.max(np.abs(recon - d["enc_recon"]))))
            checked += 1
            try:
                levels = ac.decode_residual(rec.residual, recon)
                wrong = int(np.sum(levels != ac.quantize(image + 0.5)))
            except ac.FormatError:
                wrong = int(np.prod(self.shape))
            pixel_errors += wrong
            bad += wrong > 0
        return {"numbers": {"unreadable_files": unreadable,
                            "pixel_errors": pixel_errors,
                            "recon_gap": gap if checked else 1.0,
                            **tally.numbers()},
                "checked": len(self.done), "failed": unreadable + bad}
