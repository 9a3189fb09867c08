"""One photo at a time through a lossy VAE, as
``cli/compress_with_lossy_model`` codes each image:
``models/lossy/base.py::compress_to_file`` (every latent level through the
beam-search kernel, the ``.rec`` written), image i with seed ``seed + i``,
without the CLI's ideal pass and evaluation decode.  Open loop: photos
are due at the fixed ``rate`` of the mix (evenly spaced), served one at a
time in arrival order; each image's latency runs from the time it was due
until its bytes are complete, so a stall's wait counts for the photos
behind it.  The window takes the arrivals of ``--seconds``; every photo
due in it is served, also after the window's end.

The model is the module ``lossy_models/<kind>.py`` that the
configuration's ``model.kind`` names: the port's model, its fresh weights,
its plain reference and its FLOP count.

The check reads every file of the window back with the reference's
container reader, and judges a sample of ``check_photos`` photos, drawn
from the seed among the window's, with the reference alone: every level
replayed from seed and indices and decoded against the encoder's own
reconstruction (``recon_gap``), and each level's blocks held to the
reference's posteriors of the served photo and a plain beam search at the
stated B, S and Omega (``search_gap``, ``count_gap``; see
``check_lossless.py``)."""

from __future__ import annotations

import importlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .spans import Spans
from .traffic import smooth_images


class Driver:
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
        self.late_ms = 0.0
        self.sampled = set()
        self.family = importlib.import_module(
            "lossy_models." + self.config["model"]["kind"])

    def setup(self) -> None:
        from rec_tpu_torch.coding import BeamSearchCoder
        from rec_tpu_torch.models.lossy import compress_to_file

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
        model = self.family.build(mc, coder, dev)
        model.requires_grad_(False)
        weights = self.family.fresh_weights(mc, self.seed, dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        state = dict(model.named_parameters())
        if set(state) != set(weights):
            raise RuntimeError("the port's weights are not the reference's: "
                               f"{sorted(set(state) ^ set(weights))[:5]}")
        with torch.no_grad():
            for name, t in state.items():
                t.copy_(weights[name])
        self.model = model
        self.compress_to_file = compress_to_file
        self.pool = smooth_images(self.seed, 0, int(self.traffic["images"]),
                                  self.shape) / 255.0
        self.tmp = tempfile.mkdtemp(prefix="rec_bench_")
        self._image(-1, keep=False)   # warm-up: this cell's one shape

    def _image(self, i: int, keep: bool = True, due_ns: int = None) -> None:
        x = self.pool[i % len(self.pool)]
        seed = (self.seed + max(i, 0)) % (2 ** 32)
        path = os.path.join(self.tmp, f"img_{max(i, 0)}.rec")
        t0 = time.perf_counter_ns()
        due_ns = t0 if due_ns is None else due_ns
        recon = self.compress_to_file(
            self.model, path, x, seed=seed,
            block_size=self.coder_cfg["block_size"],
            max_index=self.max_index, codec=self.traffic["codec"])
        t1 = time.perf_counter_ns()
        self.spans.records.append(("compress_to_file", t0, t1))
        if not keep:
            return
        self.latencies.append((t1 - due_ns) / 1e6)
        self.late_ms = max(self.late_ms, (t0 - due_ns) / 1e6)
        d = {"path": path, "seed": seed, "index": i}
        if i in self.sampled:
            d["enc_recon"] = recon.cpu().numpy()
        self.done.append(d)

    def _run(self, n: int) -> dict:
        """Photos 0..n-1, due every 1 / rate seconds from now; the check's
        sample is drawn from the seed before the first is due."""
        rs = np.random.default_rng([self.seed & (2 ** 63 - 1), 11])
        k = min(int(self.traffic["check_photos"]), n)
        self.sampled = set(rs.choice(n, size=k, replace=False).tolist())
        gap_ns = int(1e9 / float(self.traffic["rate"]))
        t0 = time.perf_counter_ns()
        for i in range(n):
            due = t0 + i * gap_ns
            wait = due - time.perf_counter_ns()
            if wait > 0:
                time.sleep(wait / 1e9)
            self._image(i, due_ns=due)
        return {"seconds": (time.perf_counter_ns() - t0) / 1e9, "units": n}

    def window(self, seconds: float) -> dict:
        return self._run(int(seconds * float(self.traffic["rate"])))

    def traced(self, units: int) -> dict:
        return self._run(units)

    def end_to_end(self, res: dict) -> dict:
        return {"encode_ms_p95": float(np.percentile(self.latencies, 95))}

    def extra(self) -> dict:
        """How late the generator ran: the longest wait of a photo between
        its due time and its hand-over."""
        return {"generator_late_ms_max": self.late_ms}

    def layer_context(self, res: dict, ctx: dict) -> None:
        flops = self.family.image_flops(self.config["model"],
                                        *self.shape[:2])
        self.release_files()
        c = self.coder_cfg
        counts = []
        from reference import ac

        for d in self.done:
            rec = ac.read_rec(d["bytes"], c["max_partitions"])
            counts += [cnt for _, cnt in rec.latents]
        ctx.update(units=res["units"], flops=flops * res["units"],
                   launch_counts=counts,
                   coder=dict(c, n_samples=self.max_index))

    def release_files(self) -> None:
        for d in self.done:
            if "bytes" not in d:
                with open(d["path"], "rb") as f:
                    d["bytes"] = f.read()

    def release(self) -> None:
        self.release_files()
        shutil.rmtree(self.tmp, ignore_errors=True)
        del self.model
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from reference import ac, beam, search

        from reference.rvae import full_precision

        full_precision()
        dev = self.devs[0]
        c = self.coder_cfg
        mc = self.config["model"]
        cfg = beam.BeamConfig(c["kl_per_partition"], c["n_beams"],
                              c["extra_samples"], c["block_size"],
                              c["max_partitions"], c["stream"])
        m = self.family.reference(
            {k: v.to(dev) for k, v in self.weights.items()}, mc)
        H, W = self.shape[:2]
        tally = search.Tally()
        unreadable, gap, checked = 0, 0.0, 0
        for d in self.done:
            try:
                rec = ac.read_rec(d["bytes"], c["max_partitions"])
            except ac.FormatError:
                unreadable += 1
                continue
            if (rec.seed != d["seed"] or rec.shape != tuple(self.shape)
                    or rec.max_index != cfg.n_samples
                    or len(rec.latents) != self.family.LEVELS):
                unreadable += 1
                continue
            if "enc_recon" not in d:
                continue

            def replay(level, prior, posterior, seed, rec=rec):
                ind, cnt = rec.latents[level]
                judged = search.judge(cfg, posterior, prior, ind[None],
                                      cnt[None], [seed])
                tally.add(judged)
                return judged["sample"]

            image = torch.as_tensor(self.pool[d["index"] % len(self.pool)],
                                    dtype=torch.float32, device=dev)
            recon = self.family.decode(m, replay, (H, W), rec.seed,
                                       image[None])[0]
            g = float(np.max(np.abs(recon.cpu().numpy() - d["enc_recon"])))
            gap = max(gap, g)
            checked += 1
        return {"numbers": {"unreadable_files": unreadable,
                            "recon_gap": gap if checked else 1.0,
                            **tally.numbers()},
                "checked": len(self.done), "failed": unreadable}
