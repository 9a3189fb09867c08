"""Smoke run of rec_tpu_torch on one NVIDIA GPU: build both kernels, hold
each against its plain PyTorch version, and drive the port's paths end to
end at full width: the lossless flagship, the importance coder and
shared-pool beam search, the rejection coder and ``mode=update_sampler``,
the MNIST VAE family's trainers, the sharded codec, serving and training
over a mesh of devices, the lossy 2- and 4-level VAEs and their trainer,
the large lossless model (compress, tiles, trainer), the RVAE's IAF
posterior, PixelCNN and the example entry points.

    python3 chip_smoke.py

It takes no arguments and needs one card.  Phases (each prints one JSON
line; any failure raises and exits non-zero):

1. build      nvcc of rec_tpu_torch/csrc/{mega_beam,beam_score}.cu, one
              process per source, started together (timed), and ptxas's
              registers, shared memory and spills per kernel (a spill
              fails the run).
   card       SM count and top SM clock (nvidia-smi clocks.max.sm), and the
              lane-instruction rates they give (all lanes; the INT32 pipe).
2. normal_map the bits -> normal map on all 2^23 inputs, GPU == CPU bitwise,
              and the streams' table of it equal to it on the GPU.
3. kernel     the beam-search kernel vs ``mega_encode_blocks_ref`` at the
              single-image shape (N=9 blocks, D=1000, B=20, S=36, P=24),
              both streams: >= 95% per-index agreement, and the search
              objective of the kernel's samples within OBJECTIVE_TOL nats of
              the plain version's (``max_abs_err``); both timed, beside the
              bound (operations over all lanes, integer operations over the
              INT32 pipe, bytes over HBM; the largest).  Equal counts,
              indices in [0, S), the same indices on a second run and a
              bitwise replay are checked as well; counts come from the
              precompute both versions share, and the reported sample is
              the replay itself.  The CPU tests hold counts, indices and
              the replay against rec_tpu.  Then the edge shapes
              (``EDGES``: one block on the full grid, 133 blocks, B=S=128,
              P=160), both streams, with the same checks (kernel_edge).
4. beam_score the scoring kernel vs ``score_candidates_ref`` at the paper
              coder's (B*S, D) = (720, 1024) and (720, 1000): the error
              relative to sum_d |(a x + b) x| + |c| within (D + 1) 2^-24,
              the worst case of a reordered float32 sum; the same bits on a
              second launch; at least one CTA per SM.  Kernel, plain
              version, the cuBLAS yardstick (x*x) @ a + x @ b + c
              (``library_ms``) and a one-element ``zero_()`` (``floor_ms``,
              the least any launch takes) are timed on the device: the sum
              of their device events in torch.profiler over 100 calls, the
              L2 flushed by a 64 MB write before each and the flush's
              events left out (no kernel event fails the phase).
              ``call_ms`` is the kernel's host rate, CUDA events around
              200 back-to-back Python calls.  Then its path: the public
              entry ``rec_tpu_torch.ops.score_candidates`` at (20, 36, 1024),
              with the launch count read around it, held against
              ``score_candidates_ref`` on the same inputs within the same
              relative limit (the kernels line reports this error).
5. coder      BeamSearchCoder on a (16, 16, 32) latent: GPU encode's sample
              == GPU decode bitwise == CPU decode bitwise.
6. flagship   RVAE-24 (160/32 filters) with data-dependent init on 2
              numpy-seeded 32x32 images: compress -> .rec with residual ->
              read -> decompress -> exact pixels; 24 kernel launches per
              image; throughput, bits/dim, file bytes, GPU-vs-CPU forward.
7. serve      the port's serving CLI in-process at its defaults (16
              synthetic cifar10 images, batch 8, RVAE-24 at full width,
              fresh weights, verify and true_lossless): 16 files written and
              verified with exact pixels, and 48 beam-search launches = 24
              res blocks x 2 batches.  Then the beam-search kernel at the
              serving shape N = 72 blocks against its plain version (one
              call each; agreement and objective gap as in phase 3), timed.
8. profile    one image's ``compress`` and one batch-8 ``compress_batch``
              under torch.profiler: device busy time, kernel count, the
              beam-search kernel's device ms and share, the heaviest device
              operators.  The idle share is an estimate from
              two readings: the profiled run's device busy time against the
              wall time of an unprofiled call just before it (the profiled
              wall time mostly measures the profiler).
9. scan_dispatch  which encode path the card takes (``SCAN_CASES``) on a
              (16, 16, 32) latent: S = 221 (Omega = 4.5, past the kernel's
              128-wide tile) warns, encodes on the scan path and launches
              no kernel; the paper config launches the kernel.  Each has
              the CPU's counts, an encode sample bitwise equal to the GPU
              decode and a GPU decode bitwise equal to the CPU decode.
10. initialize the compress CLI's ``mode=initialize`` in-process at its
              defaults on one synthetic cifar10 test image (RVAE-24 at full
              width, fresh weights from seed 42): the ratio table (192
              entries, finite, in (0, 1]), its fitted entries, and the
              fit's descent steps, host syncs and seconds.  Then the fit's
              CUDA-graph descent against its eager one on one block set
              (``check_ratio_fit``): the same ratios bitwise, both timed.
11. compress  ``mode=compress`` at its defaults on 4 images with that
              table: 4 rows with ``roundtrip_ok``, no crash, the reference's
              18 CSV columns in order, 24 kernel launches per image; the
              probed need and the budget per image, saturated blocks,
              encode and decode images/s, bits/dim and the phase means of
              ``phase_times.json``.  If no image grew the budget past 24,
              one more image is compressed from ``max_partitions=8``, so a
              grown budget runs through the kernel.
11a. importance_coder  ``GaussianCoder`` at its defaults (Omega 3, 12
              bits, block 1000, budget 24, chunk 1024, fmix) on the
              flagship's (16, 16, 32) latent (9 blocks) and a threefry
              case: encode sample == GPU decode == CPU decode bitwise; the
              GPU's indices, counts and sample equal to the CPU encode's
              on all 9 blocks, for both streams; an
              ``encode_batch`` of 8 (72 blocks) timed with its peak
              memory; one encode's device kernels under torch.profiler.
11b. importance_compress  ``sampler=importance`` through the compress
              CLI on 1 cifar10 image (RVAE-24, the ratio table of
              initialize) and 1 Kodak image (``model=large_resnet_vae``),
              and through ``compress_with_lossy_model`` on 1 Kodak image
              (Large2LevelVAE 196/128): exact images (the lossy decode
              within the CLI's rtol 1e-4 / atol 1e-5), need, budget,
              comp_time and decomp_time.
11c. importance_serve, shared_pool_serve  ``cli.serve`` at its defaults
              (16 images, batch 8, verify on) with ``sampler=importance``
              and with ``shared_pool=true``: 16 files verified; images/s
              beside the per-beam serve rate of phase 7.
11d. rejection_coder  ``RejectionCoder`` at the reference defaults
              (Omega 3, buffers of 10,000, 100 x 100 mass samples) on the
              fresh RVAE-24's median-KL res block latent (16x16x32, 9
              blocks of 1000 dims at their own ceil(KL / 3) partitions):
              decode == encode sample and GPU decode == CPU decode bitwise
              on every block, and the block of fewest partitions encoded on
              the CPU with the GPU's indices and sample; per block the
              partitions, encode and decode ms and spillover rounds; device
              kernels per partition step, peak allocated bytes.
11e. update_sampler  ``compression_performance mode=update_sampler`` at
              its defaults (RVAE-24, fresh weights) on 2 images: seconds
              and partition updates per image, the spillover probability,
              and a probability vector in ``rejection_acceptance.npy``.
11f. mnist_train  ``train_generative_model model=vae`` at its defaults
              (batch 8, adam 3e-4, lamb 0) for 200 steps, resumed to 210:
              steps/s, the device busy share of 10 steps, the restore.
11g. mnist_emp_bayes  ``cli.mnist_emp_bayes`` at the example's defaults
              for 100 steps of each prior: steps/s and a finite loss.
              The 11a-g paths have no TPU-kernel counterpart: their
              launches of both kernels are read on their own lines and
              must be 0; they are not in the kernels line.
11h. pixel_cnn  ``PixelCNN`` at its defaults (60 filters, 5 blocks) on 8
              synthetic 32x32x3 images: data-dependent init, the GPU
              forward against the CPU forward on the same weights (max abs
              diff of loc and log_scale), a finite log likelihood, the AR
              property (a moved input changes no output of a step
              generated before it: on the card within AR_LEAK_TOL, on the
              CPU exactly), one 32x32x3 sample (3,072 steps) from one key
              on the card, timed, against the CPU's draw at every step
              given the GPU's earlier pixels (``replay_values``), and an
              8x8x3 sample against the free-running CPU sample; a pixel
              may differ only where the drawn value lies within EDGE_TOL
              bins of a bin edge.  Device kernels per step and the idle
              share from the 8x8x3 sample under torch.profiler.  Launches
              neither kernel.
11i. demos    the example entry points: ``cli.discrete_rec_demo`` on the
              card against the CPU (importance index and sample bitwise;
              per KL the counts, code bits, indices and sample equal),
              4 beam-search launches per
              run, and the kernel at its shape (N=1, D=16, B=8, S=36,
              P=32) against its plain version, timed beside its bound;
              ``cli.snis_mog`` at its defaults (2,000 steps, batch 128):
              steps/s, the final nll, an exact decode;
              ``cli.astar_sampling_demo`` at 200 samples: seconds and the
              moment check; ``examples/lossless/data_aggregation.py``
              (numpy only, shared with rec_tpu) over the compress phase's
              CSV and an empty cell, against the CSV's means.
11j. sharded_codec  ``parallel.sharded_encode_blocks`` on one 72-block
              latent (B = 20, S = 36, budget 24, fmix) over every visible
              card, ``[cuda:0] * 2`` and ``[cuda:0] * 5`` (padded to 75
              blocks): indices, counts and sample bitwise the one-card
              encode's, one beam-search launch per mesh entry on its card,
              the sharded decode bitwise; wall ms per encode.  Each phase
              of 11j-l prints its mesh and whether an entry repeats.
11k. multi_card_serve  at two or more cards, ``cli.serve`` (16 images)
              and ``cli.lossy_serve`` (16 images) at their defaults over
              every card: every file verified and byte-identical to the
              one-card run's at the per-card batch, launches on every
              card, images/s beside the one-card rates; at one card, the
              same through ``make_batch_compress`` and
              ``make_batch_rec_forward`` over ``[cuda:0] * 2``, bitwise the
              one-device outputs at batch 4.
11l. dp_train  ``train_generative_model`` at its defaults (batch 8) for 10
              steps over every card (at one card: ``[cuda:0] * 2``) against
              the one-card run: losses within DP_TRAIN_RTOL, two runs
              bitwise equal in losses and checkpoint bytes, steps/s of
              both.
12. train     the training CLI in-process at its defaults (RVAE-24 at full
              width, batch 8, adamax lr 1e-3, lamb 0.1, EMA 0.999, the
              synthetic cifar10 train split) for 60 steps with log_freq=30
              into rec_tpu_torch/build/train/: every loss and elbo_bpd
              finite (kept on the device, read once at the end), the mean
              elbo_bpd of the last 10 steps below that of the first 10,
              logged steps 0 and 30, checkpoints ckpt_1, ckpt_31, ckpt_60
              and model_config.json; then iters=70 resumes from step 60
              for 10 steps (ckpt_60, ckpt_61, ckpt_70 kept).  Steps/s and
              images/s without the first step and the log steps' work, peak
              allocated memory, the device busy share of 10 profiled steps
              of a fresh run (its unprofiled 10 steps are the steps/s of
              cuDNN's deterministic algorithms), then steps/s with free and
              autotuned ones (TF32 off).
13. train_compress  ``mode=initialize`` then ``mode=compress`` on 1 image
              with the trained directory as ``model_save_dir``: the
              weights restored (their EMA shadows), exact pixels, 24
              beam-search launches; ideal ELBO bits/dim, bits/dim and
              budget, which say nothing of a trained model (70 steps on
              synthetic data).

14. lossy_kernel  the beam-search kernel vs its plain version (the checks
              of phase 3) at the lossy coder's B = 10, S = 20 on the
              full-width Large2LevelVAE's (196/128 filters, fresh weights
              from seed 42) level-1 posterior and prior, split with the
              level's coding seed: one 512x768 image (N = 302, D = 1000,
              P = 24), the same blocks with every target three prior
              scales away (every block runs the whole budget), and a
              serving batch of eight 256x256 images (N = 408, P = 32);
              each timed, beside the bound.
15. lossy_compress  ``rec_tpu_torch.cli.compress_with_lossy_model``
              in-process at its defaults (that model, 4 synthetic Kodak
              512x768 images, B = 10, S = 20, budget 24): every file decodes
              within the CLI's own tolerance, the reference's CSV columns,
              2 beam-search launches per image (13 and 302 blocks);
              per-image bpp, PSNR, MS-SSIM, comp_time, saturated blocks,
              mean counts, the ideal pass's required partitions, and the
              full-width forward of one image on the card against the CPU.
16. lossy_serve   ``rec_tpu_torch.cli.lossy_serve`` in-process at its
              defaults (16 synthetic CLIC 256x256 images in batches of 8,
              budget 32, verify on): 16 files verified, 4 beam-search
              launches (24 and 408 blocks per launch); images/s, bpp, mean
              counts, then one batch of 8 under torch.profiler
              (``device_profile``).  The lossy phases' weights are fresh,
              so bpp, PSNR and the partition counts say nothing of a
              trained model; the counts stand beside every rate.

17. lossy_train  ``rec_tpu_torch.cli.train_lossy_model`` in-process at its
              defaults (the 2-level VAE at 196/128, batch 8, 256-crops of
              the synthetic CLIC train split, adam 1e-4, mse, beta 0.01, EMA
              0.999) for 120 steps with log_freq=60 into
              rec_tpu_torch/build/lossy_train/: every loss finite (read
              once at the end), the mean of the last 10 below the first
              10, logged steps 0 and 60, checkpoints 1, 61 and 120 and
              model_config.json with the reference's keys; iters=130
              resumes from 120; two fresh 5-step runs from one seed give
              the same losses and checkpoint bytes.  Steps/s and images/s
              without the first step and the log steps' work, peak
              allocated memory, the device busy share and heaviest
              operators of 10 profiled steps (``device_profile``) and one
              step's device time by kind (``device_ms_by_kind``).
18. lossy_train_compress  the compress CLI at its defaults (4 Kodak-size
              images) restoring that checkpoint's EMA weights, then on 2
              images with its trained weights (``use_ema=false``): every
              file decoded within the CLI's tolerance, 2 launches per
              image; bpp, PSNR, MS-SSIM, counts, which say nothing of a
              trained model (130 steps on synthetic data).
19. lossy4_train  the trainer at ``model=large_level_4_vae`` (196/128/128/128)
              for 20 steps: every loss finite, the checkpoint restored by a
              second call; steps/s.
20. lossy4_compress  the compress CLI at ``model=large_level_4_vae`` and its
              defaults (196/128/128/128, 4 Kodak-size images, fresh
              weights): every file decoded, 4 launches per image with 13,
              13, 197 and 302 blocks (levels 4, 3, 2, 1, as
              ``latent_shapes`` gives them), peak allocated memory, the
              full-width forward on the card against the CPU.
21. lossy4_serve  the serving CLI at ``model=large_level_4_vae`` and its
              defaults (the model's 192/192/128/128, 16 images in batches
              of 8, verify on): 16 files verified, 4 launches per batch
              with the blocks ``latent_shapes`` gives; images/s.

22. large_kernel  the beam-search kernel vs its plain version (the checks
              of phase 3) at the large lossless model's shapes, from the
              compress CLI's default model (``LargeResNetVAE``,
              160/160/128/32, fresh weights from seed 42): one Kodak
              image's block-1 group (N = 197, D = 1000) and a 256x256
              tile's block-2 group (one block of D = 512), each at the
              budget its probed need grows to; timed, beside the bound.
23. large_initialize, large_compress  ``cli.compression_performance
              model=large_resnet_vae`` at its defaults on the Kodak
              stand-in (discretized_logistic, B = 20, S = 36, budget 24
              auto-grown, capped at LARGE_MAX_BUDGET): ``mode=initialize``
              on 1 image, then ``mode=compress`` on 2: exact pixels, the
              launches each unit's groups and budget give
              (``mega_beam_launches``), the probed need, budget, saturated
              blocks, encode and decode s per image, and one image's
              full-width forward on the card against the CPU.
24. large_tile  the same CLI with ``tile=256`` on 1 image: 6 exact tiles
              and the ``_total`` row.
25. large_train  ``cli.train_generative_model model=large_resnet_vae`` at
              its defaults (adam, lamb 0.01, laplace, batch 8, EMA 0.999,
              256-crops of the synthetic CLIC train split) for 50 steps,
              resumed to 60: steps/s and images/s, the device busy share
              of 10 steps, one step's device ms by kind, peak memory, the
              loss at the start and the end.
26. large_train_compress  the large compress CLI on one Kodak image with
              those EMA weights: the checkpoint's laplace likelihood is
              picked up, exact pixels.
27. iaf_train_compress  the lossless trainer at its defaults with
              ``model_cfg.use_iaf=true`` for 20 steps (steps/s beside
              train's), then the compress CLI on one cifar10 image with its
              weights: exact, 24 launches.

Then each phase's seconds, the kernels line, the card line (nvidia-smi
name and power limit) and the final ``{"ok": true, "device": ...}``
line.  Exits non-zero without
printing a result when no CUDA device is present.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W).  The 67
# TFLOP/s float32 rate counts an FMA as two operations; the kernels' bounds
# count lane instructions against the issue rate below instead.
H100_F32_OPS = 67e12
H100_BYTES_PER_S = 3.35e12
# Lane instructions per clock per SM: 128 (4 schedulers x 32 lanes), and 64
# on the INT32 pipe that runs integer logic, shifts and adds (integer
# multiplies issue to the FMA pipe).
LANES_PER_SM = 128
INT_LANES_PER_SM = 64
# The operations one candidate element needs, in lane instructions, counted
# off csrc/mega_beam.cu with Hopper's fused forms (a 3-input LOP3/IADD3, a
# rotate as one funnel shift, the mantissa as one LEA.HI):
#   bits      fmix: counter IMAD 1, two fmix32 rounds 2 x (3 shifts,
#             3 xors, 2 IMADs) with the key xor fused, mantissa 1 = 18, of
#             which 13 on the INT32 pipe; threefry2x32: counter add 1,
#             20 rounds x (add, rotate, xor) = 60, key injections 4, output
#             3, mantissa 1 = 69, all on the INT32 pipe;
#   normal    u (2), 1 - u^2 (1), lg2 (1), the central polynomial (9), p u
#             (1), the tail test (1, INT32 pipe) = 15;
#   score     3 FMAs per scored element; a regenerated (carried) one needs
#             2 (its scale and the beam's value).
BITS_OPS = {"fmix": 18, "threefry": 69}
BITS_INT_OPS = {"fmix": 13, "threefry": 69}
NORMAL_OPS, NORMAL_INT_OPS = 15, 1
SCORE_OPS, CARRY_OPS = 3, 2
# The earlier cost model of bench.py:59-62 (53 / 153 lane instructions per
# element, the bits counted generously); reported for comparison, not the
# bound.
COST_MODEL_OPS = {"fmix": 53.0, "threefry": 153.0}

MAIN = dict(N=9, D=1000, B=20, S=36, P=24)
# Largest allowed gap, in nats, between the search objectives of the
# kernel's and the plain version's samples for one block: one partition's
# KL budget.  A flip between near-tied candidates changes the path after it
# but not its quality by more than that; a wrong score, stream or selection
# picks unrelated candidates and misses by tens of nats.
OBJECTIVE_TOL = 3.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build():
    from rec_tpu_torch.ops import _build, beam_score, mega_beam

    t0 = time.perf_counter()
    libs = _build.build_all(["mega_beam", "beam_score"])
    mega_beam._load_kernel()
    beam_score._load_kernel()
    nvcc_s = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_report(name) for name in libs}
    for name, kernels in ptxas.items():
        if not kernels:
            raise AssertionError(f"{name}: no ptxas report")
        for k in kernels:
            if k["spill_stores"] or k["spill_loads"]:
                raise AssertionError(f"{name}: {k['function']} spills "
                                     f"({k['spill_stores']} bytes stored)")
    emit({"phase": "build", "ok": True, "nvcc_s": nvcc_s,
          "libraries": [os.path.relpath(p) for p in libs.values()],
          "ptxas": ptxas})
    return ptxas


def phase_normal_map(dev):
    """The bits -> normal map on all 2^23 inputs it reads: GPU == CPU, and
    the streams' table (``rng.normal_table``) == the map on the GPU."""
    from rec_tpu_torch.coding import rng
    from rec_tpu_torch.ops.threefry_normal import bits_to_normal

    bits = torch.arange(2 ** 23, dtype=torch.int64) << 9
    cpu = bits_to_normal(bits).view(torch.int32)
    gpu = bits_to_normal(bits.to(dev)).view(torch.int32).cpu()
    diff = int((cpu != gpu).sum())
    table = rng._bits_to_normal_f32(bits.to(dev)).view(torch.int32).cpu()
    table_diff = int((table != gpu).sum())
    if diff or table_diff:
        raise AssertionError(f"normal map: {diff} GPU/CPU mismatches, "
                             f"{table_diff} table/map mismatches")
    emit({"phase": "normal_map", "ok": True, "inputs": 2 ** 23,
          "mismatches": 0, "table_mismatches": 0})


def _objective(t, c, z):
    """Search objective of a block's sample: sum_d log q(z) - log p(z)."""
    return torch.sum(t.log_prob(z) - c.log_prob(z), dim=-1)


def _blocks(dev, n_copies=1, seed=5):
    """Latent blocks at the main-path shape: 9 blocks of D=1000 whose
    target widths spread the KL so some counts stay under the 24-partition
    budget and some saturate it, repeated ``n_copies`` times with fresh
    draws and keys (72 blocks = a serving batch of 8 images)."""
    from rec_tpu_torch.coding import rng
    from rec_tpu_torch.coding.gauss import GaussianParams

    D = MAIN["D"]
    rs = np.random.RandomState(0)
    spread = np.tile([0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.8, 1.2, 2.0],
                     n_copies)
    N = spread.size
    loc = (rs.randn(N, D) * spread[:, None]).astype(np.float32)
    scale = np.exp(rs.randn(N, D) * 0.2).astype(np.float32)
    t = GaussianParams(torch.tensor(loc, device=dev),
                       torch.tensor(scale, device=dev))
    c = GaussianParams(torch.zeros(N, D, device=dev),
                       torch.ones(N, D, device=dev))
    bkeys = rng.block_key(rng.root_key(seed, dev),
                          torch.arange(N, device=dev))
    return t, c, bkeys


def card_rates() -> dict:
    """The card's SM count and top SM clock, and the lane-instruction rates
    they give: all lanes, and the INT32 pipe."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(sms=sms, clock_max_sm_mhz=mhz,
                lane_ops_per_s=sms * LANES_PER_SM * mhz * 1e6,
                int_ops_per_s=sms * INT_LANES_PER_SM * mhz * 1e6)


def mega_beam_bound(counts, N, D, B, S, P, stream, rates) -> dict:
    """The least time for one call on these inputs: data-dependent work (at
    t = 0 one beam scores S rows, at every later live step B beams do; each
    live step regenerates B winning rows) in lane instructions over all
    lanes, its integer part over the INT32 pipe, and the bytes; the
    largest of the three.  ``cost_model_ms`` is the earlier cost model's
    time for comparison."""
    counts = np.asarray(counts, np.int64)
    live = counts > 0
    scored = int(np.sum(live * S * D + np.maximum(counts - 1, 0) * B * S * D))
    carried = int(np.sum(counts * B * D))
    elements = scored + carried
    ops = (elements * (BITS_OPS[stream] + NORMAL_OPS)
           + scored * SCORE_OPS + carried * CARRY_OPS)
    int_ops = elements * (BITS_INT_OPS[stream] + NORMAL_INT_OPS)
    nbytes = 3 * N * P * D * 4 + N * 4 + N * 8 + N * P * 4
    parts = dict(bound_ops_ms=1e3 * ops / rates["lane_ops_per_s"],
                 bound_int_ms=1e3 * int_ops / rates["int_ops_per_s"],
                 bound_bytes_ms=1e3 * nbytes / H100_BYTES_PER_S)
    return dict(parts, bound_ms=max(parts.values()),
                bound_by="operations" if max(parts.values())
                > parts["bound_bytes_ms"] else "bytes",
                elements=elements, ops=ops, int_ops=int_ops, bytes=nbytes,
                cost_model_ms=1e3 * elements * COST_MODEL_OPS[stream]
                / rates["lane_ops_per_s"])


def _check_mega_beam(dev, t, c, bkeys, stream, B, S, P, extra_samples):
    """The kernel against its plain version on one block set: equal counts,
    indices in [0, S), >= 95% agreement on live indices, the objective gap
    of the replayed samples within OBJECTIVE_TOL, and the same indices on a
    second run.  Returns (agreement, gap, counts)."""
    from rec_tpu_torch.coding import beam_search
    from rec_tpu_torch.ops import mega_beam

    tag = f"{stream} N={t.loc.shape[0]} D={t.loc.shape[1]} B={B} S={S} P={P}"
    kw = dict(kl_per_partition=3.0, n_beams=B, n_samples=S,
              max_partitions=P, stream=stream)
    ind, cnt = mega_beam.mega_encode_blocks(t, c, bkeys, **kw)
    again, _ = mega_beam.mega_encode_blocks(t, c, bkeys, **kw)
    rind, rcnt = mega_beam.mega_encode_blocks_ref(t, c, bkeys, **kw)
    torch.cuda.synchronize()
    if not torch.equal(ind, again):
        raise AssertionError(f"{tag}: two runs gave different indices")
    if not torch.equal(cnt, rcnt):
        raise AssertionError(f"{tag}: counts {cnt} vs plain {rcnt}")
    if not bool(((ind >= 0) & (ind < S)).all()):
        raise AssertionError(f"{tag}: index out of [0, {S})")
    live = torch.arange(P, device=dev)[None, :] < cnt[:, None]
    agree = float((ind == rind)[live].float().mean())
    if agree < 0.95:
        raise AssertionError(f"{tag}: agreement {agree} < 0.95")
    cfg = beam_search.BeamSearchConfig(
        kl_per_partition=3.0, n_beams=B, extra_samples=extra_samples,
        max_partitions=P, stream=stream)
    assert cfg.n_samples == S
    z = beam_search.decode_blocks(cfg, c, ind, cnt, bkeys)
    z_ref = beam_search.decode_blocks(cfg, c, rind, rcnt, bkeys)
    err = float(torch.max(torch.abs(_objective(t, c, z)
                                    - _objective(t, c, z_ref))))
    if not err <= OBJECTIVE_TOL:
        raise AssertionError(f"{tag}: objective gap {err} nats > "
                             f"{OBJECTIVE_TOL}")
    return agree, err, cnt.cpu().numpy().astype(np.int64)


def _mega_beam_case(dev, t, c, bkeys, stream, plain_reps, rates,
                    B=MAIN["B"], S=MAIN["S"], P=MAIN["P"],
                    extra_samples=1.2):
    """The beam-search kernel against its plain version on one block set
    (by default at the main-path settings): checks, times and the bound."""
    from rec_tpu_torch.coding import beam_search
    from rec_tpu_torch.ops import mega_beam

    N, D = t.loc.shape
    kw = dict(kl_per_partition=3.0, n_beams=B, n_samples=S,
              max_partitions=P, stream=stream)
    agree, err, counts = _check_mega_beam(dev, t, c, bkeys, stream, B, S, P,
                                          extra_samples)
    cfg = beam_search.BeamSearchConfig(
        kl_per_partition=3.0, n_beams=B, extra_samples=extra_samples,
        max_partitions=P, stream=stream)
    enc = beam_search.encode_blocks(cfg, t, c, bkeys)
    dec = beam_search.decode_blocks(cfg, c, enc.indices, enc.count, bkeys)
    if not torch.equal(enc.sample.view(torch.int32), dec.view(torch.int32)):
        raise AssertionError(f"{stream}: replay is not bitwise")
    n, qa, qb, ascale = mega_beam.precompute(t, c, 3.0, P)
    ms = cuda_time(lambda: mega_beam.launch_kernel(
        n, bkeys, qa, qb, ascale, n_beams=B, n_samples=S, stream=stream), 10)
    wrapper_ms = cuda_time(
        lambda: mega_beam.mega_encode_blocks(t, c, bkeys, **kw), 10)
    plain_ms = cuda_time(
        lambda: mega_beam.mega_encode_blocks_ref(t, c, bkeys, **kw),
        plain_reps)
    bound = mega_beam_bound(counts, N, D, B, S, P, stream, rates)
    ctas, threads = mega_beam.grid(torch.cuda.current_device(), stream)
    return dict(blocks=N, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                agreement=agree, max_abs_err=err, counts=counts.tolist(),
                share_of_bound=bound["bound_ms"] / ms,
                grid={"ctas": ctas, "threads": threads}, **bound)


# Edge shapes of the kernel, each held against the plain version on both
# streams at a small D: (name, N, D, B, S, P, loc sd, log scale mean).
# N=1 is one block on the full grid, N=133 more blocks than SMs, B=S=128
# the whole selection tile, and P=160 a budget past 128 (wide, narrow
# targets so every block runs the whole budget).
EDGES = (("n1", 1, 1000, 20, 36, 24, 0.5, 0.0),
         ("n133", 133, 64, 20, 36, 24, None, 0.0),
         ("b128_s128", 4, 64, 128, 128, 12, 0.6, 0.0),
         ("p160", 2, 96, 3, 20, 160, 2.5, math.log(0.05)))


def _edge_blocks(dev, N, D, loc_sd, log_scale, seed):
    from rec_tpu_torch.coding import rng
    from rec_tpu_torch.coding.gauss import GaussianParams

    rs = np.random.RandomState(seed)
    if loc_sd is None:   # _blocks' spread of KLs, cycled over the blocks
        spread = np.resize([0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.8, 1.2, 2.0],
                           N)
    else:
        spread = np.full(N, loc_sd)
    loc = (rs.randn(N, D) * spread[:, None]).astype(np.float32)
    scale = np.exp(rs.randn(N, D) * 0.2 + log_scale).astype(np.float32)
    t = GaussianParams(torch.tensor(loc, device=dev),
                       torch.tensor(scale, device=dev))
    c = GaussianParams(torch.zeros(N, D, device=dev),
                       torch.ones(N, D, device=dev))
    bkeys = rng.block_key(rng.root_key(seed, dev), torch.arange(N, device=dev))
    return t, c, bkeys


def check_edge(dev, i, stream) -> dict:
    """Edge shape ``EDGES[i]`` against the plain version on one stream (the
    checks of ``_check_mega_beam``); also run by the card's pytest module
    tests/test_torch_mega_beam_card.py."""
    name, N, D, B, S, P, loc_sd, log_scale = EDGES[i]
    t, c, bkeys = _edge_blocks(dev, N, D, loc_sd, log_scale, 40 + i)
    extra = math.log(S + 0.5) / 3.0   # BeamSearchConfig's S at Omega=3
    agree, err, counts = _check_mega_beam(dev, t, c, bkeys, stream, B, S, P,
                                          extra)
    if P > 128 and counts.max() <= 128:
        raise AssertionError(f"{name}: no block ran past 128 steps")
    return {"case": name, "stream": stream,
            "shape": dict(N=N, D=D, B=B, S=S, P=P), "agreement": agree,
            "max_abs_err": err, "max_count": int(counts.max()),
            "min_count": int(counts.min())}


def phase_kernel(dev, rates):
    t, c, bkeys = _blocks(dev)
    results = {}
    for stream in ("fmix", "threefry"):
        results[stream] = _mega_beam_case(dev, t, c, bkeys, stream, 3, rates)
        emit({"phase": "kernel", "ok": True, "stream": stream,
              **results[stream]})
    for i in range(len(EDGES)):
        for stream in ("fmix", "threefry"):
            emit({"phase": "kernel_edge", "ok": True,
                  **check_edge(dev, i, stream)})
    return results


def l2_flush(dev):
    """A callable that writes a 64 MB buffer, more than the H100's 50 MB L2,
    so that the next kernel finds its inputs in HBM, as a caller whose inputs
    other kernels wrote would."""
    buf = torch.empty(16 << 20, dtype=torch.int32, device=dev)
    return lambda: buf.fill_(1)


def _device_events(fn, reps, flush=None):
    """(name, device us) of each device event of ``reps`` calls of ``fn``
    under torch.profiler, each call after ``flush`` if one is given."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(label, fn, flush, reps=100, attempts=3):
    """Device milliseconds per call of ``fn`` (the sum of the device events
    it launches, read from torch.profiler over ``reps`` calls with ``flush``
    before each, the flush's own events left out), its device events per
    call, their names and the attempts it took.  The flush's event names
    and ``fn``'s events per call come from two short sessions of their own.
    Now and then a session shows no device event at all (seen on an H100
    with torch 2.11), so a measurement whose counts do not add up is taken
    again, up to ``attempts`` times.  Fails when they never add up, or when
    ``fn`` shares an event name with the flush."""
    fn()
    flush()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        flush_names = {n for n, _ in _device_events(flush, 3)}
        alone = _device_events(fn, 3)
        names = {n for n, _ in alone}
        if names & flush_names:
            raise AssertionError(f"{label}: shares a device event name with "
                                 f"the L2 flush: "
                                 f"{sorted(names & flush_names)}")
        events = [(n, us) for n, us in _device_events(fn, reps, flush)
                  if n not in flush_names]
        if flush_names and names and len(events) * 3 == len(alone) * reps:
            return (sum(us for _, us in events) / reps / 1e3,
                    len(events) / reps, sorted(names), attempt)
    raise AssertionError(f"{label}: device events did not add up in "
                         f"{attempts} attempts (last: {len(flush_names)} "
                         f"flush names, {len(alone)} events in 3 calls, "
                         f"{len(events)} in {reps})")


def _gauss_pair(rs, D, dev):
    """A target and a coder Gaussian of width D from a numpy RandomState."""
    from rec_tpu_torch.coding.gauss import GaussianParams

    def g(loc, ls):
        return GaussianParams(
            torch.tensor(rs.randn(D) * loc, dtype=torch.float32, device=dev),
            torch.tensor(np.exp(rs.randn(D) * ls), dtype=torch.float32,
                         device=dev))
    return g(0.5, 0.3), g(0.0, 0.1)


def score_inputs(dev, N, D):
    """Candidate rows x (N, D) and the quadratic coefficients (a, b, c_sum)
    of two diagonal Gaussians, from a numpy seed."""
    from rec_tpu_torch.coding.gauss import quadratic_coeffs

    rs = np.random.RandomState(2)
    x = torch.tensor(rs.randn(N, D), dtype=torch.float32, device=dev)
    return (x, *quadratic_coeffs(*_gauss_pair(rs, D, dev)))


def time_beam_score(dev, x, a, b, c) -> dict:
    """Device ms per call, with the L2 flushed before each, of the scoring
    kernel (``ms``), its plain version, the cuBLAS yardstick
    (x*x) @ a + x @ b + c (``library_ms``) and a one-element
    ``zero_()`` (``floor_ms``: no launch takes less); and the kernel's host
    rate, CUDA events around 200 back-to-back Python calls (``call_ms``).
    Fails unless the profiler shows the kernel itself."""
    from rec_tpu_torch.ops import beam_score

    flush = l2_flush(dev)
    kern = lambda: beam_score.launch_kernel(x, a, b, c)  # noqa: E731
    z = torch.zeros(1, device=dev)
    ms, per_call, names, tries = device_ms("beam_score", kern, flush)
    if not any("beam_score" in n for n in names):
        raise AssertionError(f"beam_score: no device event of the kernel "
                             f"among {names}")
    plain_ms, plain_k, _, plain_tries = device_ms(
        "plain", lambda: beam_score.score_candidates_ref(x, a, b, c), flush)
    library_ms, library_k, _, library_tries = device_ms(
        "library", lambda: (x * x) @ a + x @ b + c, flush)
    floor_ms, _, _, floor_tries = device_ms("floor", z.zero_, flush)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                floor_ms=floor_ms, call_ms=cuda_time(kern, 200),
                device_events_per_call={"kernel": per_call, "plain": plain_k,
                                        "library": library_k},
                profiler_attempts=[tries, plain_tries, library_tries,
                                   floor_tries])


def phase_beam_score(dev):
    from rec_tpu_torch.ops import beam_score, score_candidates

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {}
    for N, D in ((720, 1024), (720, 1000)):
        x, a, b, c = score_inputs(dev, N, D)
        got = beam_score.launch_kernel(x, a, b, c)
        again = beam_score.launch_kernel(x, a, b, c)
        ref = beam_score.score_candidates_ref(x, a, b, c)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"beam_score ({N}, {D}): two launches gave "
                                 f"different bits")
        mag = torch.sum(torch.abs((a * x + b) * x), dim=-1) + torch.abs(c)
        abs_err = float(torch.max(torch.abs(got - ref)))
        rel_err = float(torch.max(torch.abs(got - ref) / mag))
        tol = (D + 1) * 2.0 ** -24
        if not rel_err <= tol:
            raise AssertionError(f"beam_score ({N}, {D}): relative error "
                                 f"{rel_err} > {tol}")
        rows, ctas = beam_score.grid(N, dev)
        if ctas < sms:
            raise AssertionError(f"beam_score ({N}, {D}): {ctas} CTAs for "
                                 f"{sms} SMs")
        times = time_beam_score(dev, x, a, b, c)
        nbytes = N * D * 4 + 2 * D * 4 + 4 + N * 4
        ops = 4 * N * D
        bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS)
        shapes[(N, D)] = dict(times, bound_ms=bound_ms,
                              share_of_bound=bound_ms / times["ms"],
                              grid={"rows_per_cta": rows, "ctas": ctas,
                                    "sms": sms},
                              max_abs_err=abs_err, max_rel_err=rel_err)
        emit({"phase": "beam_score", "ok": True, "shape": [N, D],
              "rel_tol": tol, "bound_by": "bytes", "bytes": nbytes,
              "timing": "device ms per call from torch.profiler, L2 flushed "
                        "before each; call_ms is the host rate",
              "library": "(x*x) @ a + x @ b + c, cuBLAS", **shapes[(N, D)]})
    # Its path: the public entry point at the paper coder's shape, held
    # against the plain version on the same inputs.
    B, S, D = 20, 36, 1024
    rs = np.random.RandomState(3)
    comb = torch.tensor(rs.randn(B, S, D), dtype=torch.float32, device=dev)
    num, den = _gauss_pair(rs, D, dev)
    beam_score.score_rows.launches = 0
    scores = score_candidates(comb, num, den)
    torch.cuda.synchronize()
    launches = beam_score.score_rows.launches
    if launches < 1 or scores.shape != (B, S):
        raise AssertionError(f"score_candidates: {launches} launches, "
                             f"shape {tuple(scores.shape)}")
    x = comb.reshape(B * S, D)
    a, b, c = beam_score.quadratic_coeffs(num, den)
    ref = beam_score.score_candidates_ref(x, a, b, c).reshape(B, S)
    mag = (torch.sum(torch.abs((a * x + b) * x), dim=-1)
           + torch.abs(c)).reshape(B, S)
    abs_err = float(torch.max(torch.abs(scores - ref)))
    rel_err = float(torch.max(torch.abs(scores - ref) / mag))
    tol = (D + 1) * 2.0 ** -24
    if not rel_err <= tol:
        raise AssertionError(f"score_candidates: relative error {rel_err} "
                             f"> {tol}")
    emit({"phase": "beam_score_path", "ok": True, "launches": launches,
          "shape": [B, S, D], "rel_tol": tol, "max_abs_err": abs_err,
          "max_rel_err": rel_err})
    return dict(shapes[(720, 1024)], launches=launches,
                path_max_abs_err=abs_err, path_max_rel_err=rel_err)


def phase_coder(dev):
    from rec_tpu_torch.coding import BeamSearchCoder
    from rec_tpu_torch.coding.gauss import GaussianParams

    rs = np.random.RandomState(1)
    shape = (16, 16, 32)
    loc = (rs.randn(*shape) * 0.6).astype(np.float32)
    scale = np.exp(rs.randn(*shape) * 0.2).astype(np.float32)
    coder = BeamSearchCoder(kl_per_partition=3.0, n_beams=20,
                            extra_samples=1.2, block_size=1000,
                            max_partitions=24)
    t = GaussianParams(torch.tensor(loc, device=dev),
                       torch.tensor(scale, device=dev))
    c = GaussianParams(torch.zeros(shape, device=dev),
                       torch.ones(shape, device=dev))
    enc = coder.encode(t, c, 321)
    dec = coder.decode(c, enc.indices, enc.counts, 321)
    cc = GaussianParams(torch.zeros(shape), torch.ones(shape))
    dec_cpu = coder.decode(cc, enc.indices.cpu(), enc.counts.cpu(), 321)
    as_int = lambda x: x.view(torch.int32).cpu()  # noqa: E731
    if not torch.equal(as_int(enc.sample), as_int(dec)):
        raise AssertionError("coder: GPU encode sample != GPU decode")
    if not torch.equal(as_int(dec), as_int(dec_cpu)):
        raise AssertionError("coder: GPU decode != CPU decode")
    emit({"phase": "coder", "ok": True, "blocks": int(enc.counts.numel()),
          "counts": enc.counts.tolist()})


def phase_flagship(dev, num_res_blocks=24, filters=(160, 32), n_img=2):
    from rec_tpu_torch import io as rio
    from rec_tpu_torch.coding import BeamSearchCoder
    from rec_tpu_torch.io import residual
    from rec_tpu_torch.models.resnet_vae import (BidirectionalResNetVAE,
                                                 ResNetVAEConfig,
                                                 latents_for_rec)
    from rec_tpu_torch.ops import mega_beam

    cfg = ResNetVAEConfig(num_res_blocks=num_res_blocks,
                          deterministic_filters=filters[0],
                          stochastic_filters=filters[1])
    coder = BeamSearchCoder(kl_per_partition=3.0, n_beams=20,
                            extra_samples=1.2, block_size=1000,
                            max_partitions=24)
    rs = np.random.RandomState(0)
    H, W = 32, 32
    levels = rs.randint(0, 256, size=(n_img, H, W, 3))
    img01 = ((levels + 0.5) / 256.0).astype(np.float32)
    images = torch.tensor(img01 - 0.5, device=dev)
    noise = rs.randn(cfg.num_res_blocks, n_img, H // 2, W // 2,
                     cfg.stochastic_filters).astype(np.float32)

    model = BidirectionalResNetVAE(cfg, coder, seed=0, device=dev)
    model.data_dependent_init(images, noise)
    with torch.no_grad():
        gpu_fwd = model(images, noise)
    cpu_model = BidirectionalResNetVAE(cfg, coder, seed=0, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    cpu_model.initialized = True
    with torch.no_grad():
        cpu_fwd = cpu_model(images.cpu(), noise)
    fwd_diff = max(
        float(torch.max(torch.abs(gpu_fwd[k].cpu() - cpu_fwd[k])))
        for k in ("reconstruction", "log_likelihood"))
    fwd_diff_post = float(torch.max(torch.abs(
        gpu_fwd["posterior"].loc.cpu() - cpu_fwd["posterior"].loc)))

    # The main path, driven as a user would: compress -> .rec -> decompress.
    seeds = [1234 + 101 * i for i in range(n_img)]
    # .rec files go to the checkout's gitignored build directory.
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "rec_tpu_torch", "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    comps, file_bytes, latent_bits = [], [], []
    enc_s = resid_s = dec_s = 0.0
    log2_s = math.log2(coder.n_samples)
    mega_beam.mega_encode_blocks.launches = 0
    for i in range(n_img):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = model.compress(images[i:i + 1], seeds[i])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # The residual is scored against the decoder's reconstruction.
        recon = model.decompress((H, W), comp["indices"], comp["counts"],
                                 seeds[i])
        torch.cuda.synchronize()
        enc_s += t1 - t0
        resid_s += time.perf_counter() - t1
        payload, _ = residual.encode_residual(img01[i], recon[0].cpu().numpy())
        path = os.path.join(out_dir, f"img_{i}.rec")
        file_bytes.append(rio.write_rec(
            path, seed=seeds[i], image_shape=(H, W, 3), block_size=1000,
            max_index=coder.n_samples, latents=latents_for_rec(comp),
            residual=payload))
        latent_bits.append(float(comp["counts"].sum()) * log2_s)
        comps.append(comp)
    launches = mega_beam.mega_encode_blocks.launches
    for i in range(n_img):
        path = os.path.join(out_dir, f"img_{i}.rec")
        seed, shape, _, latents, section = rio.read_rec(
            path, max_partitions=coder.max_partitions, with_residual=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ind = torch.stack([torch.from_numpy(a) for a, _ in latents]).to(dev)
        cnt = torch.stack([torch.from_numpy(b) for _, b in latents]).to(dev)
        recon = model.decompress(shape[:2], ind, cnt, seed)
        torch.cuda.synchronize()
        dec_s += time.perf_counter() - t0
        out01 = residual.decode_residual(section, recon[0].cpu().numpy())
        if not np.array_equal(residual.quantize(out01),
                              residual.quantize(img01[i])):
            raise AssertionError(f"flagship: image {i} not recovered")
        if not np.array_equal(ind.cpu().numpy(),
                              comps[i]["indices"].cpu().numpy()):
            raise AssertionError(f"flagship: image {i} index round trip")
        os.remove(path)
    if launches != cfg.num_res_blocks * n_img:
        raise AssertionError(f"flagship: {launches} kernel launches for "
                             f"{n_img} images, expected "
                             f"{cfg.num_res_blocks * n_img}")
    dims = H * W * 3
    emit({"phase": "flagship", "ok": True, "images": n_img,
          "lossless": True, "kernel_launches": launches,
          "launches_per_image": launches / n_img,
          "encode_images_per_s": n_img / enc_s,
          "encode_with_residual_decode_images_per_s":
              n_img / (enc_s + resid_s),
          "decode_images_per_s": n_img / dec_s,
          "latent_bits_per_dim": float(np.mean(latent_bits)) / dims,
          "file_bytes": file_bytes,
          "total_bits_per_dim": float(np.mean(file_bytes)) * 8 / dims,
          "forward_gpu_vs_cpu_max_abs": fwd_diff,
          "posterior_loc_gpu_vs_cpu_max_abs": fwd_diff_post})


def phase_serve(dev, rates):
    """The serving CLI in-process at its defaults, then the kernel at the
    serving shape."""
    import glob
    import shutil

    from rec_tpu_torch.cli import serve
    from rec_tpu_torch.ops import mega_beam

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "rec_tpu_torch", "build", "serve")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = serve.Config()
    mega_beam.mega_encode_blocks.launches = 0
    t0 = time.perf_counter()
    stats = serve.main(["n_devices=1", f"output_dir={out_dir}",
                        f"model_save_dir={os.path.join(out_dir, 'ckpt')}"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = mega_beam.mega_encode_blocks.launches
    files = sorted(glob.glob(os.path.join(out_dir, "img_*.rec")))
    n_batches = -(-cfg.num_images // cfg.batch_size)
    want = cfg.model_cfg.num_res_blocks * n_batches
    if stats["images"] != cfg.num_images or len(files) != cfg.num_images:
        raise AssertionError(f"serve: {stats['images']} images, "
                             f"{len(files)} files")
    if launches != want:
        raise AssertionError(f"serve: {launches} beam-search launches, "
                             f"expected {want}")
    shutil.rmtree(out_dir)
    emit({"phase": "serve", "ok": True, "images": stats["images"],
          "files_verified": len(files), "lossless": True,
          "batch": cfg.batch_size, "kernel_launches": launches,
          "encode_images_per_s": stats["images_per_s"],
          "steady_images": stats["steady_images"],
          "encode_s": stats["encode_s"], "bits_per_dim": stats["bits_per_dim"],
          "file_bytes_total": stats["bytes"], "synthetic_data":
              stats["synthetic"], "weights_restored": stats["restored"],
          "wall_s": wall_s})
    t, c, bkeys = _blocks(dev, n_copies=cfg.batch_size, seed=6)
    n72 = _mega_beam_case(dev, t, c, bkeys, "fmix", 1, rates)
    emit({"phase": "kernel_serving_shape", "ok": True, "stream": "fmix",
          **n72})
    return launches, n72, stats["images_per_s"]


def device_profile(fn, attempts=3) -> dict:
    """Device time by operator of one call of ``fn`` under torch.profiler,
    against the wall time of an unprofiled call just before it: busy ms,
    device kernels, the beam-search kernel's part, the heaviest operators
    and the idle share estimate (1 - busy / unprofiled wall).  A session
    that shows no device event (see ``device_ms``) is taken again, up to
    ``attempts`` times.  Only device activity is recorded, and the
    profiler's raw events are read: building its Python event tree costs
    seconds per ten thousand kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [(e.name(), e.duration_ns() / 1e6)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda]
        if kernels:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no device event in "
                             f"{attempts} sessions")
    busy_ms = sum(ms for _, ms in kernels)
    by_name = {}
    for name, ms in kernels:
        by_name[name] = by_name.get(name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    beam = [ms for name, ms in kernels if "mega_beam" in name]
    return {"profiled_wall_ms": wall_ms, "unprofiled_wall_ms": unprofiled_ms,
            "device_busy_ms": busy_ms, "device_kernels": len(kernels),
            "mega_beam_ms": sum(beam), "mega_beam_launches": len(beam),
            "mega_beam_share_of_busy": sum(beam) / busy_ms,
            "device_idle_share_estimate": 1.0 - busy_ms / unprofiled_ms,
            "top_device_ms": [[name[:60], ms] for name, ms in top]}


def _profile(label, fn, **extra):
    emit({"phase": "profile", "ok": True, "path": label, **extra,
          **device_profile(fn)})


def phase_profile(dev, batch=8):
    """Where the time goes: one image's ``compress`` and one serving batch's
    ``compress_batch`` (RVAE-24, fresh weights, warmed up first)."""
    from rec_tpu_torch.coding import BeamSearchCoder
    from rec_tpu_torch.models.resnet_vae import (BidirectionalResNetVAE,
                                                 ResNetVAEConfig)

    cfg = ResNetVAEConfig()
    coder = BeamSearchCoder(kl_per_partition=3.0, n_beams=20,
                            extra_samples=1.2, block_size=1000,
                            max_partitions=24)
    rs = np.random.RandomState(3)
    levels = rs.randint(0, 256, size=(batch, 32, 32, 3))
    images = torch.tensor(((levels + 0.5) / 256.0 - 0.5).astype(np.float32),
                          device=dev)
    noise = rs.randn(cfg.num_res_blocks, 1, 16, 16,
                     cfg.stochastic_filters).astype(np.float32)
    model = BidirectionalResNetVAE(cfg, coder, seed=0, device=dev)
    model.data_dependent_init(images[:1], noise)
    seeds = [77 + 101 * i for i in range(batch)]
    model.compress_batch(images, seeds)   # warm-up
    _profile("compress", lambda: model.compress(images[:1], seeds[0]),
             images=1)
    _profile("compress_batch", lambda: model.compress_batch(images, seeds),
             images=batch)


# The encode paths on the card: (name, coder settings, whether it warns,
# whether it launches the beam-search kernel).
SCAN_CASES = (("s221", dict(kl_per_partition=4.5, extra_samples=1.2),
               True, False),
              ("paper", {}, False, True))


def check_scan_dispatch(dev, i) -> dict:
    """Encode path ``SCAN_CASES[i]`` on a (16, 16, 32) latent on the card:
    the warning, the kernel launches, the counts against the CPU's, the
    encode sample against the GPU decode and the GPU decode against the CPU
    decode, bitwise.  Also run by tests/test_torch_scan_card.py."""
    from rec_tpu_torch.coding import BeamSearchCoder, beam_search
    from rec_tpu_torch.coding.gauss import GaussianParams
    from rec_tpu_torch.coding.partition import split_coders
    from rec_tpu_torch.ops import mega_beam

    name, kw, warns, kernel = SCAN_CASES[i]
    rs = np.random.RandomState(1)
    shape = (16, 16, 32)
    loc = (rs.randn(*shape) * 0.6).astype(np.float32)
    scale = np.exp(rs.randn(*shape) * 0.2).astype(np.float32)
    coder = BeamSearchCoder(block_size=1000, max_partitions=24, **kw)
    cpu = (GaussianParams(torch.tensor(loc), torch.tensor(scale)),
           GaussianParams(torch.zeros(shape), torch.ones(shape)))
    t, c = (GaussianParams(p.loc.to(dev), p.scale.to(dev)) for p in cpu)
    before = mega_beam.mega_encode_blocks.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        enc = coder.encode(t, c, 321)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    launches = mega_beam.mega_encode_blocks.launches - before
    warned = any("scan path" in str(w.message) for w in caught)
    plan, perms, _ = coder._setup(shape, [321], "cpu")
    want_counts = beam_search._counts(
        coder._cfg(), *(split_coders(GaussianParams(p.loc[None],
                                                    p.scale[None]),
                                     plan, perms) for p in cpu))
    dec = coder.decode(c, enc.indices, enc.counts, 321)
    dec_cpu = coder.decode(cpu[1], enc.indices.cpu(), enc.counts.cpu(), 321)
    as_int = lambda x: x.view(torch.int32).cpu()  # noqa: E731
    tag = f"scan_dispatch {name} (B={coder.n_beams}, S={coder.n_samples})"
    if warned != warns:
        raise AssertionError(f"{tag}: warned={warned}, expected {warns}")
    if (launches > 0) != kernel:
        raise AssertionError(f"{tag}: {launches} kernel launches")
    if not torch.equal(enc.counts.cpu(), want_counts):
        raise AssertionError(f"{tag}: counts differ from the CPU's")
    if not torch.equal(as_int(enc.sample), as_int(dec)):
        raise AssertionError(f"{tag}: GPU encode sample != GPU decode")
    if not torch.equal(as_int(dec), as_int(dec_cpu)):
        raise AssertionError(f"{tag}: GPU decode != CPU decode")
    return {"case": name, "n_beams": coder.n_beams,
            "n_samples": coder.n_samples, "warned": warned,
            "kernel_launches": launches, "encode_s": encode_s,
            "blocks": int(enc.counts.numel()),
            "counts": enc.counts.tolist()}


def phase_scan_dispatch(dev):
    for i in range(len(SCAN_CASES)):
        emit({"phase": "scan_dispatch", "ok": True,
              **check_scan_dispatch(dev, i)})


# The CSV columns of examples/lossless/compression_performance.py:379-384.
REFERENCE_FIELDS = ["index", "width", "height", "seed", "total_kl",
                    "ideal_elbo_bpd", "ideal_psnr", "ideal_ms_ssim",
                    "latent_code_bits", "file_bits", "total_bits_per_dim",
                    "residual_bits", "psnr", "ms_ssim", "comp_time",
                    "decomp_time", "roundtrip_ok", "saturated_blocks"]


def _lossless_dirs():
    """The compress CLI's checkpoint and output directories, under the
    checkout's gitignored build directory, emptied."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rec_tpu_torch", "build", "lossless")
    shutil.rmtree(root, ignore_errors=True)
    return os.path.join(root, "ckpt"), os.path.join(root, "out")


def check_ratio_fit(dev) -> dict:
    """The ratio fit's descent replayed as a CUDA graph against the same
    steps launched eagerly: three fits in a row (the deepest ratio index,
    half of it, 2) on 9 blocks of D = 1000 (~40 nats each), all through one
    captured graph, each giving the eager ratio, steps and conditioned
    blocks bit for bit; both paths timed, the capture included."""
    from rec_tpu_torch.coding.gauss import GaussianParams, kl_divergence
    from rec_tpu_torch.coding.ratio_fit import RatioFitConfig, _fit_one_ratio

    rs = np.random.RandomState(4)
    start = (GaussianParams(
        torch.tensor(rs.randn(9, 1000) * 0.25, dtype=torch.float32,
                     device=dev),
        torch.tensor(np.exp(rs.randn(9, 1000) * 0.1), dtype=torch.float32,
                     device=dev)),
        GaussianParams(torch.zeros(9, 1000, device=dev),
                       torch.ones(9, 1000, device=dev)))
    n_aux = 1 + torch.floor(torch.sum(kl_divergence(*start), dim=-1) / 3.0)
    top = int(n_aux.max())
    state = {True: start, False: start}
    secs = {True: 0.0, False: 0.0}
    graphs, steps = {}, []
    for r in (top, top // 2, 2):
        fits = {}
        for graph in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[graph] = _fit_one_ratio(
                RatioFitConfig(), *state[graph], n_aux >= r, r, 1.0 / r,
                torch.Generator().manual_seed(r), graphs if graph else None)
            torch.cuda.synchronize()
            secs[graph] += time.perf_counter() - t0
            state[graph] = (fits[graph].target, fits[graph].coder)
        g, e = fits[True], fits[False]
        same = all(torch.equal(a, b) for a, b in
                   zip((*g.target, *g.coder), (*e.target, *e.coder)))
        if (g.ratio, g.steps, g.steps_run) != (e.ratio, e.steps,
                                                e.steps_run) or not same:
            raise AssertionError(f"ratio fit r={r}: the CUDA graph and the "
                                 f"eager descent differ ({g.ratio}, "
                                 f"{g.steps} steps vs {e.ratio}, {e.steps})")
        steps.append(g.steps)
    return {"ratio_indices": [top, top // 2, 2], "steps": steps,
            "graphs_captured": len(graphs), "graph_s": secs[True],
            "eager_s": secs[False]}


def phase_initialize(save_dir, out_dir):
    from rec_tpu_torch.cli import compression_performance as cp

    t0 = time.perf_counter()
    stats = cp.main(["mode=initialize", "num_images=1",
                     f"model_save_dir={save_dir}", f"output_dir={out_dir}"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    table = stats["table"]
    if len(table) != 192 or not np.all(np.isfinite(table)):
        raise AssertionError(f"initialize: table of {len(table)} entries, "
                             f"finite: {np.all(np.isfinite(table))}")
    if not (table.min() > 0 and table.max() <= 1):
        raise AssertionError(f"initialize: ratios in [{table.min()}, "
                             f"{table.max()}], not in (0, 1]")
    if stats["restored"] or stats["fits"] < 1:
        raise AssertionError(f"initialize: restored={stats['restored']}, "
                             f"{stats['fits']} fits")
    emit({"phase": "initialize", "ok": True, "images": 1,
          "graph_vs_eager": check_ratio_fit(torch.device("cuda")),
          "table_len": len(table), "table_min": float(table.min()),
          "table_max": float(table.max()), "fitted": stats["fitted"],
          "fits": stats["fits"], "steps": stats["steps"],
          "steps_run": stats["steps_run"], "host_syncs": stats["syncs"],
          "fit_s": stats["fit_s"], "wall_s": wall_s})


def _compress_cli(save_dir, out_dir, *args):
    """``mode=compress`` in-process; returns (stats, launches, CSV
    header)."""
    from rec_tpu_torch.cli import compression_performance as cp
    from rec_tpu_torch.ops import mega_beam

    mega_beam.mega_encode_blocks.launches = 0
    stats = cp.main([*args, f"model_save_dir={save_dir}",
                     f"output_dir={out_dir}"])
    torch.cuda.synchronize()
    launches = mega_beam.mega_encode_blocks.launches
    with open(stats["csv"]) as f:
        header = next(csv.reader(f))
    rows = stats["rows"]
    if stats["crashes"] or not all(r["roundtrip_ok"] for r in rows):
        raise AssertionError(f"compress {args}: {stats['crashes']} crashes, "
                             f"roundtrip {[r['roundtrip_ok'] for r in rows]}")
    if header != REFERENCE_FIELDS:
        raise AssertionError(f"compress: CSV columns {header}")
    if launches != 24 * len(rows):
        raise AssertionError(f"compress {args}: {launches} kernel launches "
                             f"for {len(rows)} images")
    return stats, launches


def phase_compress(save_dir, out_dir, n_img=4):
    if not os.path.exists(os.path.join(save_dir, "coder_ratios_3.0.npy")):
        raise AssertionError("compress: no ratio table from initialize")
    stats, launches = _compress_cli(save_dir, out_dir, f"num_images={n_img}")
    rows = stats["rows"]
    if len(rows) != n_img:
        raise AssertionError(f"compress: {len(rows)} rows")
    launches_by_run = {"compress": launches}
    grown = {"from": 24, "budgets": stats["budgets"]}
    if max(stats["budgets"]) <= 24:
        # Start one image from a small budget so a grown one runs through
        # the kernel.
        more, n = _compress_cli(save_dir, out_dir + "_grown", "num_images=1",
                                "max_partitions=8")
        if more["budgets"][0] <= 8:
            raise AssertionError(f"compress: budget did not grow from 8 "
                                 f"(need {more['needs']})")
        launches_by_run["compress_grown"] = n
        grown = {"from": 8, "needs": more["needs"],
                 "budgets": more["budgets"],
                 "comp_time": more["rows"][0]["comp_time"]}
    emit({"phase": "compress", "ok": True, "images": len(rows),
          "roundtrip_ok": sum(bool(r["roundtrip_ok"]) for r in rows),
          "crashes": stats["crashes"], "kernel_launches": launches,
          "launches_per_image": launches / len(rows),
          "probed_need": stats["needs"], "budget": stats["budgets"],
          "saturated_blocks": [r["saturated_blocks"] for r in rows],
          "encode_images_per_s": len(rows) / sum(r["comp_time"]
                                                 for r in rows),
          "decode_images_per_s": len(rows) / sum(r["decomp_time"]
                                                 for r in rows),
          "encode_images_per_s_after_first": (len(rows) - 1) / sum(
              r["comp_time"] for r in rows[1:]),
          "comp_time": [r["comp_time"] for r in rows],
          "decomp_time": [r["decomp_time"] for r in rows],
          "mean_bits_per_dim": stats["mean_bpd"],
          "ideal_elbo_bpd": [r["ideal_elbo_bpd"] for r in rows],
          "phase_mean_ms": {k: v["mean_ms"]
                            for k, v in stats["phase_times"].items()},
          "grown_budget": grown, "synthetic_data": stats["synthetic"],
          "weights_restored": stats["restored"]})
    return launches_by_run


TRAIN_ITERS, TRAIN_RESUME_ITERS, TRAIN_LOG_FREQ = 60, 70, 30


def _train_dirs():
    """The trainer's checkpoint and log directories, under the checkout's
    gitignored build directory, emptied."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rec_tpu_torch", "build", "train")
    shutil.rmtree(root, ignore_errors=True)
    return os.path.join(root, "ckpt"), os.path.join(root, "logs")


def _train_cli(save_dir, log_dir, iters):
    from rec_tpu_torch.cli import train_generative_model as tgm

    return tgm.main([f"iters={iters}", f"log_freq={TRAIN_LOG_FREQ}",
                     f"model_save_dir={save_dir}", f"log_dir={log_dir}"])


def _checkpoints(save_dir):
    return sorted(int(n[5:-8]) for n in os.listdir(save_dir)
                  if n.startswith("ckpt_") and n.endswith(".msgpack"))


def _steps_per_s(run, n):
    """Steps per second of ``n`` steps of a ``Trainer`` (device fenced)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run.state, _ = run.step_fn(run.state, run.batch(), run.noise())
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def free_cudnn_steps_per_s(run, n=10) -> dict:
    """Steps/s with cuDNN free to pick non-deterministic algorithms
    (``deterministic=False``, as PyTorch defaults) and with its autotuner
    on (``benchmark=True``), each after a few steps of warm-up; TF32 stays
    off.  The model's own switch is held off meanwhile and set again
    after."""
    from unittest import mock

    from rec_tpu_torch.device import set_deterministic
    from rec_tpu_torch.models import resnet_vae

    out = {}
    with mock.patch.object(resnet_vae, "set_deterministic", lambda: None):
        torch.backends.cudnn.deterministic = False
        _steps_per_s(run, 2)
        out["nondeterministic"] = _steps_per_s(run, n)
        torch.backends.cudnn.benchmark = True
        _steps_per_s(run, 3)
        out["benchmark"] = _steps_per_s(run, n)
    set_deterministic()
    return out


def phase_train():
    """The training CLI in-process at its defaults (RVAE-24 at full width,
    batch 8, adamax lr 1e-3, lamb 0.1, EMA 0.999, synthetic cifar10 train
    split) for 60 steps, logging and saving every 30, then resumed to
    70; then 10 profiled steps and the numerics' cost.  Returns the
    checkpoint directory."""
    from rec_tpu_torch.cli import train_generative_model as tgm
    from rec_tpu_torch.utils.logging import setup_logger

    phase_t0 = time.perf_counter()
    save_dir, log_dir = _train_dirs()
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = _train_cli(save_dir, log_dir, TRAIN_ITERS)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    loss, elbo = np.asarray(stats["loss"]), np.asarray(stats["elbo_bpd"])
    if stats["steps"] != TRAIN_ITERS or stats["restored"]:
        raise AssertionError(f"train: {stats['steps']} steps, restored="
                             f"{stats['restored']}")
    if not (np.all(np.isfinite(loss)) and np.all(np.isfinite(elbo))):
        raise AssertionError("train: a loss or elbo_bpd is not finite")
    first10, last10 = float(elbo[:10].mean()), float(elbo[-10:].mean())
    if not last10 < first10:
        raise AssertionError(f"train: elbo_bpd did not fall (first 10 "
                             f"{first10}, last 10 {last10})")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if [r["step"] for r in logged] != [0, TRAIN_LOG_FREQ] or not all(
            math.isfinite(r["loss"]) for r in logged):
        raise AssertionError(f"train: logged steps "
                             f"{[r['step'] for r in logged]}")
    if _checkpoints(save_dir) != [1, TRAIN_LOG_FREQ + 1,
                                  TRAIN_ITERS] or not os.path.exists(
            os.path.join(save_dir, "model_config.json")):
        raise AssertionError(f"train: checkpoints {os.listdir(save_dir)}")
    step_s = stats["seconds"] - stats["first_step_s"] - stats["log_s"]
    steps_per_s = (stats["steps"] - 1) / step_s

    more = _train_cli(save_dir, log_dir, TRAIN_RESUME_ITERS)
    if not (more["restored"] and more["start_step"] == TRAIN_ITERS
            and more["steps"] == TRAIN_RESUME_ITERS - TRAIN_ITERS
            and more["final_step"] == TRAIN_RESUME_ITERS):
        raise AssertionError(f"train: resume {more['start_step']} -> "
                             f"{more['final_step']}, restored="
                             f"{more['restored']}")
    if _checkpoints(save_dir) != [TRAIN_ITERS, TRAIN_ITERS + 1,
                                  TRAIN_RESUME_ITERS]:
        raise AssertionError(f"train: checkpoints after resume "
                             f"{os.listdir(save_dir)}")
    if not np.all(np.isfinite(more["loss"])):
        raise AssertionError("train: a resumed loss is not finite")

    # Where the time goes: 10 steps of a fresh run (its own directory),
    # whose unprofiled 10 steps also give the deterministic algorithms'
    # steps/s beside the free and autotuned ones.
    run = tgm.build(tgm.Config(
        model_save_dir=os.path.join(os.path.dirname(save_dir), "profile"),
        log_dir=log_dir), setup_logger("train_profile"))

    def ten_steps():
        for _ in range(10):
            run.state, _ = run.step_fn(run.state, run.batch(), run.noise())

    prof = device_profile(ten_steps)
    numerics = {"deterministic": 10 / (prof["unprofiled_wall_ms"] / 1e3),
                **free_cudnn_steps_per_s(run)}
    emit({"phase": "train", "ok": True, "model": "resnet_vae",
          "params": sum(p.numel() for p in run.model.parameters()),
          "batch": stats["batch_size"], "steps": stats["steps"],
          "synthetic_data": stats["synthetic"],
          "steps_per_s": steps_per_s, "images_per_s":
              steps_per_s * stats["batch_size"],
          "first_step_s": stats["first_step_s"],
          "log_and_checkpoint_s": stats["log_s"], "loop_s": stats["seconds"],
          "wall_s": wall_s, "loss_first": float(loss[0]),
          "loss_last": float(loss[-1]), "elbo_bpd_first": float(elbo[0]),
          "elbo_bpd_last": float(elbo[-1]),
          "elbo_bpd_mean_first10": first10, "elbo_bpd_mean_last10": last10,
          "checkpoint_bytes": os.path.getsize(stats["checkpoint"]),
          "resumed_from": more["start_step"], "resumed_steps": more["steps"],
          "resumed_elbo_bpd_last": more["elbo_bpd"][-1],
          "peak_allocated_bytes": peak,
          "allocated_before_bytes": allocated_before,
          "profile_10_steps": {k: prof[k] for k in (
              "unprofiled_wall_ms", "device_busy_ms", "device_kernels",
              "device_idle_share_estimate", "top_device_ms")},
          "device_busy_share": prof["device_busy_ms"]
          / prof["unprofiled_wall_ms"],
          "steps_per_s_by_cudnn_algorithms": numerics,
          "phase_s": time.perf_counter() - phase_t0})
    return save_dir, steps_per_s


def phase_train_compress(save_dir):
    """The compress CLI on the weights the trainer just wrote (its EMA
    shadows, the CLI's default): ``mode=initialize`` on 1 image, then
    ``mode=compress`` on 1 image with that ratio table, restored from the
    training directory.  Returns its beam-search launches."""
    from rec_tpu_torch.cli import compression_performance as cp

    t0 = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(save_dir), "compress")
    init = cp.main(["mode=initialize", "num_images=1",
                    f"model_save_dir={save_dir}", f"output_dir={out_dir}"])
    if not init["restored"]:
        raise AssertionError("train_compress: initialize did not restore "
                             "the trained weights")
    stats, launches = _compress_cli(save_dir, out_dir, "num_images=1")
    row = stats["rows"][0]
    if not stats["restored"] or launches != 24:
        raise AssertionError(f"train_compress: restored={stats['restored']}"
                             f", {launches} beam-search launches")
    emit({"phase": "train_compress", "ok": True,
          "weights": f"EMA of {TRAIN_RESUME_ITERS} training steps on "
                     f"synthetic data (not a trained model's bits/dim)",
          "weights_restored": stats["restored"], "images": 1,
          "roundtrip_ok": bool(row["roundtrip_ok"]),
          "kernel_launches": launches, "probed_need": stats["needs"],
          "budget": stats["budgets"], "fits": init["fits"],
          "fit_s": init["fit_s"], "ideal_elbo_bpd": row["ideal_elbo_bpd"],
          "bits_per_dim": row["total_bits_per_dim"],
          "comp_time": row["comp_time"], "decomp_time": row["decomp_time"],
          "synthetic_data": stats["synthetic"],
          "phase_s": time.perf_counter() - t0})
    return launches


# The lossy CSV columns of examples/lossy/compress_with_lossy_model.py:159-169.
LOSSY_FIELDS = ["index", "seed", "ideal_bpp", "actual_bpp", "ideal_psnr",
                "psnr", "ideal_ms_ssim", "ms_ssim", "ms_ssim_db",
                "comp_time"]
# The lossy CLIs' coder: B = 10 beams, S = floor(e^(3 * 1.0)) = 20.
LOSSY = dict(B=10, S=20, extra_samples=1.0)
FRESH = ("fresh weights from seed 42: bpp, PSNR and the counts say "
         "nothing of a trained model")


def _lossy_dir(name):
    """A directory under the checkout's gitignored build directory,
    emptied."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "rec_tpu_torch", "build", name)
    shutil.rmtree(d, ignore_errors=True)
    return d


def _kodak_image(seed=7):
    """One numpy-seeded 512x768 image in [0, 1], smooth as the datasets'
    synthetic fallback."""
    from scipy.ndimage import uniform_filter

    img = np.random.RandomState(seed).rand(1, 512, 768, 3)
    img = uniform_filter(img, size=(1, 5, 5, 1), mode="wrap")
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def _lossy_model(dev, max_partitions=24):
    """The lossy CLIs' default model (Large2LevelVAE, 196/128 filters) with
    fresh weights from seed 42, and its coder."""
    from rec_tpu_torch.cli import compress_with_lossy_model as clm
    from rec_tpu_torch.coding import BeamSearchCoder

    coder = BeamSearchCoder(kl_per_partition=3.0, n_beams=LOSSY["B"],
                            extra_samples=LOSSY["extra_samples"],
                            block_size=1000, max_partitions=max_partitions)
    return clm.make_model("large_level_2_vae", coder, 42, dev, 196, 128), \
        coder


def _level1_blocks(model, coder, images, seeds, dev):
    """The level-1 latent blocks of ``images`` (B, H, W, 3) as the lossy
    path codes them: the full-width posterior and prior (the prior from a
    posterior sample of z2), split with each image's coding seed + 1."""
    from rec_tpu_torch.coding.partition import split_coders

    B, H, W, _ = images.shape
    rs = np.random.RandomState(8)
    noise = [rs.randn(B, *s).astype(np.float32)
             for s in model.latent_shapes(H, W)]
    with torch.no_grad():
        out = model(torch.tensor(images, device=dev), noise)
    post, prior = out["posteriors"][1], out["priors"][1]
    plan, perms, bkeys = coder._setup(post.loc.shape[1:],
                                      [s + 1 for s in seeds], dev)
    return (split_coders(post, plan, perms),
            split_coders(prior, plan, perms), bkeys)


def phase_lossy_kernel(dev, rates):
    """The beam-search kernel against its plain version (the checks of
    phase 3) at the lossy coder's B = 10, S = 20 on the full-width
    2-level VAE's level-1 blocks: one 512x768 image (N = 302, P = 24, the
    compress CLI's shape), the same blocks with every target moved three
    prior scales away so that every block runs the whole budget (the
    worst-case load at that shape), and a serving batch of eight 256x256
    images (N = 408, P = 32).  Returns the compress-shape case."""
    from rec_tpu_torch.coding.gauss import GaussianParams

    model, coder = _lossy_model(dev)
    t, c, bkeys = _level1_blocks(model, coder, _kodak_image(), [42], dev)
    far = GaussianParams(t.loc + 3.0 * c.scale, t.scale)
    serve_imgs = np.concatenate([_kodak_image(20 + i)[:, :256, :256]
                                 for i in range(8)])
    ts, cs, ks = _level1_blocks(model, coder, serve_imgs,
                                [42 + 101 * i for i in range(8)], dev)
    cases = {}
    for name, blocks, P in (("compress_n302", (t, c, bkeys), 24),
                            ("saturated_n302", (far, c, bkeys), 24),
                            ("serve_n408", (ts, cs, ks), 32)):
        case = _mega_beam_case(dev, *blocks, "fmix", 1, rates,
                               B=LOSSY["B"], S=LOSSY["S"], P=P,
                               extra_samples=LOSSY["extra_samples"])
        counts = np.asarray(case.pop("counts"))
        if name == "saturated_n302" and counts.min() < P:
            raise AssertionError(f"lossy_kernel {name}: counts "
                                 f"{counts.min()}..{counts.max()}")
        emit({"phase": "lossy_kernel", "ok": True, "case": name,
              "stream": "fmix",
              "shape": dict(N=int(blocks[0].loc.shape[0]), D=1000,
                            B=LOSSY["B"], S=LOSSY["S"], P=P),
              "weights": FRESH, "saturated_blocks": int(np.sum(counts == P)),
              "mean_count": float(counts.mean()), **case})
        cases[name] = case
    if cases["compress_n302"]["blocks"] != 302 or \
            cases["serve_n408"]["blocks"] != 408:
        raise AssertionError("lossy_kernel: block counts")
    return cases


def _lossy_gpu_vs_cpu(model, dev) -> dict:
    """The full-width forward of one 512x768 image on the card against the
    same weights on the CPU, same noise: largest absolute differences."""
    from rec_tpu_torch.cli import compress_with_lossy_model as clm

    cpu = clm.make_model("large_level_2_vae", None, 0, "cpu", 196, 128)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = _kodak_image(9)
    noise = [np.random.RandomState(10).randn(1, *s).astype(np.float32)
             for s in model.latent_shapes(512, 768)]
    with torch.no_grad():
        g = model(torch.tensor(x, device=dev), noise)
        c = cpu(torch.tensor(x), noise)

    def diff(a, b):
        return float(torch.max(torch.abs(a.cpu() - b)))

    return {"reconstruction": diff(g["reconstruction"], c["reconstruction"]),
            "level1_posterior_loc": diff(g["posteriors"][1].loc,
                                         c["posteriors"][1].loc),
            "level1_prior_scale": diff(g["priors"][1].scale,
                                       c["priors"][1].scale)}


def _lossy_cli_launches(main, args):
    """Run a lossy CLI in-process with the beam-search launch count set to
    0 just before it; returns (its stats, the launches, wall s)."""
    from rec_tpu_torch.ops import mega_beam

    mega_beam.mega_encode_blocks.launches = 0
    t0 = time.perf_counter()
    stats = main(args)
    torch.cuda.synchronize()
    return (stats, mega_beam.mega_encode_blocks.launches,
            time.perf_counter() - t0)


def phase_lossy_compress(dev):
    """``cli.compress_with_lossy_model`` in-process at its defaults (the
    2-level model at 196/128, 4 Kodak-size images, B = 10, S = 20, budget
    24): every image decoded from its file within the CLI's tolerance, the
    reference's CSV columns, 2 beam-search launches per image.  Returns the
    launches."""
    from rec_tpu_torch.cli import compress_with_lossy_model as clm

    root = _lossy_dir("lossy_compress")
    stats, launches, wall_s = _lossy_cli_launches(clm.main, [
        f"output_dir={os.path.join(root, 'out')}",
        f"model_save_dir={os.path.join(root, 'ckpt')}"])
    rows = stats["rows"]
    with open(stats["csv"]) as f:
        header = next(csv.reader(f))
    if header != LOSSY_FIELDS or len(rows) != 4:
        raise AssertionError(f"lossy_compress: {len(rows)} rows, CSV "
                             f"columns {header}")
    if launches != 2 * len(rows):
        raise AssertionError(f"lossy_compress: {launches} beam-search "
                             f"launches for {len(rows)} images")
    blocks = [[len(c) for c in cs] for cs in stats["counts"]]
    if any(b != [13, 302] for b in blocks):
        raise AssertionError(f"lossy_compress: blocks per level {blocks}")
    if not all(math.isfinite(r[k]) for r in rows for k in LOSSY_FIELDS):
        raise AssertionError("lossy_compress: a CSV value is not finite")
    model, _ = _lossy_model(dev)
    emit({"phase": "lossy_compress", "ok": True, "model": "large_level_2_vae",
          "images": len(rows), "image_shape": [512, 768, 3],
          "weights": FRESH, "synthetic_data": stats["synthetic"],
          "weights_restored": stats["restored"], "kernel_launches": launches,
          "blocks_per_level": blocks[0],
          "saturated_blocks": [int(sum(np.sum(c == 24) for c in cs))
                               for cs in stats["counts"]],
          "total_blocks": sum(blocks[0]),
          "mean_count": [float(np.mean(np.concatenate(cs)))
                         for cs in stats["counts"]],
          "required_partitions": stats["required_partitions"],
          "actual_bpp": [r["actual_bpp"] for r in rows],
          "ideal_bpp": [r["ideal_bpp"] for r in rows],
          "psnr": [r["psnr"] for r in rows],
          "ms_ssim": [r["ms_ssim"] for r in rows],
          "comp_time": [r["comp_time"] for r in rows],
          "encode_images_per_s_after_first": (len(rows) - 1) / sum(
              r["comp_time"] for r in rows[1:]),
          "forward_gpu_vs_cpu_max_abs": _lossy_gpu_vs_cpu(model, dev),
          "wall_s": wall_s})
    shutil.rmtree(root)
    return launches


def phase_lossy_serve(dev):
    """``cli.lossy_serve`` in-process at its defaults (16 CLIC-size 256x256
    images in batches of 8, the 2-level model at 196/128, budget 32, verify
    on): 16 files verified, one beam-search launch per level per batch;
    then one batch of 8 under torch.profiler.  Returns the launches."""
    import glob

    from rec_tpu_torch.cli import lossy_serve
    from rec_tpu_torch.data.datasets import (DatasetConfig, load_images,
                                             normalize)
    from rec_tpu_torch.parallel import make_batch_rec_forward

    root = _lossy_dir("lossy_serve")
    cfg = lossy_serve.Config()
    stats, launches, wall_s = _lossy_cli_launches(lossy_serve.main, [
        "n_devices=1", f"output_dir={root}",
        f"model_save_dir={os.path.join(root, 'ckpt')}"])
    files = sorted(glob.glob(os.path.join(root, "img_*.rec")))
    n_batches = -(-cfg.num_images // cfg.batch_size)
    if stats["images"] != cfg.num_images or len(files) != cfg.num_images:
        raise AssertionError(f"lossy_serve: {stats['images']} images, "
                             f"{len(files)} files")
    if launches != 2 * n_batches:
        raise AssertionError(f"lossy_serve: {launches} beam-search "
                             f"launches, expected {2 * n_batches}")
    counts = [np.concatenate([c[lvl] for c in stats["counts"]])
              for lvl in range(2)]
    model, _ = _lossy_model(dev, cfg.max_partitions)
    images = normalize(load_images(DatasetConfig(
        dataset="clic2019", split="test", normalize="unit"))[0][:8],
        "unit").astype(np.float32)
    rec_forward = make_batch_rec_forward(model)
    seeds = [42 + 101 * i for i in range(8)]
    rec_forward(images, seeds)   # warm-up
    prof = device_profile(lambda: rec_forward(images, seeds))
    shutil.rmtree(root)
    emit({"phase": "lossy_serve", "ok": True, "model": "large_level_2_vae",
          "images": stats["images"], "files_verified": len(files),
          "batch": cfg.batch_size, "image_shape": [256, 256, 3],
          "weights": FRESH, "synthetic_data": stats["synthetic"],
          "kernel_launches": launches,
          "blocks_per_launch": [int(c.size) // n_batches for c in counts],
          "encode_images_per_s": stats["images_per_s"],
          "steady_images": stats["steady_images"],
          "encode_s": stats["encode_s"], "bpp": stats["bpp"],
          "file_bytes_total": stats["bytes"],
          "mean_count": [float(c.mean()) for c in counts],
          "saturated_blocks": [int(np.sum(c == cfg.max_partitions))
                               for c in counts],
          "mean_psnr": float(np.mean(stats["psnr"])), "wall_s": wall_s,
          "device_profile_batch8": prof})
    return launches


# The lossy trainer's run (its reference's defaults otherwise).
LOSSY_TRAIN_ITERS, LOSSY_TRAIN_RESUME_ITERS, LOSSY_TRAIN_LOG_FREQ = 120, 130, 60
LOSSY4_TRAIN_ITERS = 20
# Device kernels by kind, for the trainer's time split: the first pattern a
# kernel's name holds decides.
KERNEL_KINDS = (("convolution", ("conv", "cudnn", "xmma", "fft", "gemm",
                                 "implicit", "sm90_", "cutlass", "winograd")),
                ("optimizer_and_ema", ("multi_tensor", "foreach")),
                ("reduction", ("reduce",)))


def _lossy_train_cli(root, iters, *args):
    from rec_tpu_torch.cli import train_lossy_model as tlm

    return tlm.main([f"iters={iters}",
                     f"model_save_dir={os.path.join(root, 'ckpt')}",
                     f"log_dir={os.path.join(root, 'logs')}", *args])


def device_ms_by_kind(fn) -> dict:
    """Device ms of one call of ``fn`` under torch.profiler, summed by
    ``KERNEL_KINDS`` (the rest is "elementwise_and_other")."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {kind: 0.0 for kind, _ in KERNEL_KINDS}
    out["elementwise_and_other"] = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = next((k for k, pats in KERNEL_KINDS
                     if any(p in name for p in pats)),
                    "elementwise_and_other")
        out[kind] += e.device_time_total / 1e3
    if not sum(out.values()):
        raise AssertionError("torch.profiler recorded no device event")
    return out


def phase_lossy_train():
    """``cli.train_lossy_model`` in-process at its defaults (the 2-level
    model at 196/128, batch 8, 256-crops of the synthetic CLIC train split,
    adam 1e-4, mse, beta 0.01, EMA 0.999) for 120 steps, logging and saving
    every 60, then resumed to 130; 10 profiled steps of a fresh run; two
    fresh 5-step runs from one seed, bitwise equal.  Returns the checkpoint
    directory."""
    from rec_tpu_torch.cli import train_lossy_model as tlm
    from rec_tpu_torch.utils.logging import setup_logger

    phase_t0 = time.perf_counter()
    root = _lossy_dir("lossy_train")
    save_dir = os.path.join(root, "ckpt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = _lossy_train_cli(root, LOSSY_TRAIN_ITERS,
                             f"log_freq={LOSSY_TRAIN_LOG_FREQ}")
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(stats["loss"])
    if stats["steps"] != LOSSY_TRAIN_ITERS or stats["restored"]:
        raise AssertionError(f"lossy_train: {stats['steps']} steps, "
                             f"restored={stats['restored']}")
    if not np.all(np.isfinite(loss)):
        raise AssertionError("lossy_train: a loss is not finite")
    first10, last10 = float(loss[:10].mean()), float(loss[-10:].mean())
    if not last10 < first10:
        raise AssertionError(f"lossy_train: the loss did not fall (first 10 "
                             f"{first10}, last 10 {last10})")
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if [r["step"] for r in logged] != [0, LOSSY_TRAIN_LOG_FREQ]:
        raise AssertionError(f"lossy_train: logged steps "
                             f"{[r['step'] for r in logged]}")
    with open(os.path.join(save_dir, "model_config.json")) as f:
        model_cfg = json.load(f)
    if model_cfg["kind"] != "large_level_2_vae" or sorted(
            model_cfg["cfg"]) != ["beta", "level_1_filters",
                                  "level_2_filters", "level_3_filters",
                                  "level_4_filters", "loss_fn"]:
        raise AssertionError(f"lossy_train: model_config {model_cfg}")
    if _checkpoints(save_dir) != [1, LOSSY_TRAIN_LOG_FREQ + 1,
                                  LOSSY_TRAIN_ITERS]:
        raise AssertionError(f"lossy_train: checkpoints "
                             f"{os.listdir(save_dir)}")
    step_s = stats["seconds"] - stats["first_step_s"] - stats["log_s"]
    steps_per_s = (stats["steps"] - 1) / step_s

    more = _lossy_train_cli(root, LOSSY_TRAIN_RESUME_ITERS,
                            f"log_freq={LOSSY_TRAIN_LOG_FREQ}")
    if not (more["restored"] and more["start_step"] == LOSSY_TRAIN_ITERS
            and more["final_step"] == LOSSY_TRAIN_RESUME_ITERS
            and np.all(np.isfinite(more["loss"]))):
        raise AssertionError(f"lossy_train: resume {more['start_step']} -> "
                             f"{more['final_step']}, restored="
                             f"{more['restored']}")
    if _checkpoints(save_dir) != [LOSSY_TRAIN_ITERS, LOSSY_TRAIN_ITERS + 1,
                                  LOSSY_TRAIN_RESUME_ITERS]:
        raise AssertionError(f"lossy_train: checkpoints after resume "
                             f"{os.listdir(save_dir)}")

    # Determinism: two fresh runs of 5 steps from one seed.
    runs = [_lossy_train_cli(os.path.join(root, f"det_{k}"), 5)
            for k in "ab"]
    ckpt_bytes = []
    for r in runs:
        with open(r["checkpoint"], "rb") as f:
            ckpt_bytes.append(f.read())
    deterministic = {k: runs[0][k] == runs[1][k]
                     for k in ("loss", "distortion", "bpp")}
    deterministic["checkpoint_bytes"] = ckpt_bytes[0] == ckpt_bytes[1]
    if not all(deterministic.values()):
        raise AssertionError(f"lossy_train: two runs from one seed differ: "
                             f"{deterministic}, losses {runs[0]['loss']} "
                             f"{runs[1]['loss']}")

    # Where the time goes: 10 steps of a fresh run, then one step by kind.
    run = tlm.build(tlm.Config(
        model_save_dir=os.path.join(root, "profile"),
        log_dir=os.path.join(root, "logs")), setup_logger("lossy_profile"))

    def steps(n):
        for _ in range(n):
            run.state, _ = run.step_fn(run.state, run.batch(), run.noise())

    steps(2)   # warm-up
    prof = device_profile(lambda: steps(10))
    by_kind = device_ms_by_kind(lambda: steps(1))
    emit({"phase": "lossy_train", "ok": True, "model": "large_level_2_vae",
          "filters": [196, 128], "crop": [256, 256],
          "params": sum(p.numel() for p in run.model.parameters()),
          "batch": stats["batch_size"], "steps": stats["steps"],
          "synthetic_data": stats["synthetic"],
          "steps_per_s": steps_per_s,
          "images_per_s": steps_per_s * stats["batch_size"],
          "first_step_s": stats["first_step_s"],
          "log_and_checkpoint_s": stats["log_s"], "loop_s": stats["seconds"],
          "wall_s": wall_s, "loss_first": float(loss[0]),
          "loss_last": float(loss[-1]), "loss_mean_first10": first10,
          "loss_mean_last10": last10,
          "distortion_first": stats["distortion"][0],
          "distortion_last": stats["distortion"][-1],
          "bpp_first": stats["bpp"][0], "bpp_last": stats["bpp"][-1],
          "checkpoint_bytes": os.path.getsize(stats["checkpoint"]),
          "resumed_from": more["start_step"], "resumed_steps": more["steps"],
          "resumed_loss_last": more["loss"][-1],
          "deterministic": deterministic,
          "determinism_losses": runs[0]["loss"],
          "peak_allocated_bytes": peak,
          "profile_10_steps": {k: prof[k] for k in (
              "unprofiled_wall_ms", "device_busy_ms", "device_kernels",
              "device_idle_share_estimate", "top_device_ms")},
          "device_busy_share": prof["device_busy_ms"]
          / prof["unprofiled_wall_ms"],
          "one_step_device_ms_by_kind": by_kind,
          "phase_s": time.perf_counter() - phase_t0})
    shutil.rmtree(os.path.join(root, "profile"), ignore_errors=True)
    return save_dir


def _lossy_rows(stats, budget) -> dict:
    rows, counts = stats["rows"], stats["counts"]
    return {"blocks_per_level": [len(c) for c in counts[0]],
            "saturated_blocks": [int(sum(np.sum(c == budget) for c in cs))
                                 for cs in counts],
            "mean_count": [[float(np.mean(c)) for c in cs] for cs in counts],
            "required_partitions": stats["required_partitions"],
            "actual_bpp": [r["actual_bpp"] for r in rows],
            "ideal_bpp": [r["ideal_bpp"] for r in rows],
            "psnr": [r["psnr"] for r in rows],
            "ms_ssim": [r["ms_ssim"] for r in rows],
            "comp_time": [r["comp_time"] for r in rows],
            "encode_images_per_s_after_first": (len(rows) - 1) / sum(
                r["comp_time"] for r in rows[1:])}


def phase_lossy_train_compress(save_dir):
    """``cli.compress_with_lossy_model`` at its defaults (4 Kodak-size
    images) restoring the trainer's checkpoint (its EMA weights): every
    file decoded within the CLI's tolerance, 2 launches per image.
    Returns the launches."""
    from rec_tpu_torch.cli import compress_with_lossy_model as clm

    out_dir = os.path.join(os.path.dirname(save_dir), "compress")
    stats, launches, wall_s = _lossy_cli_launches(clm.main, [
        f"output_dir={out_dir}", f"model_save_dir={save_dir}"])
    rows = stats["rows"]
    if not stats["restored"] or len(rows) != 4 or launches != 2 * len(rows):
        raise AssertionError(f"lossy_train_compress: restored="
                             f"{stats['restored']}, {len(rows)} rows, "
                             f"{launches} launches")
    if any([len(c) for c in cs] != [13, 302] for cs in stats["counts"]):
        raise AssertionError("lossy_train_compress: blocks per level")
    # The trained weights themselves (use_ema=false) on two images: the
    # EMA at decay 0.999 still holds 0.999^130 = 88% of the fresh weights.
    raw, raw_launches, _ = _lossy_cli_launches(clm.main, [
        f"output_dir={out_dir}_raw", f"model_save_dir={save_dir}",
        "use_ema=false", "num_images=2"])
    if not raw["restored"] or raw_launches != 4:
        raise AssertionError(f"lossy_train_compress: use_ema=false restored="
                             f"{raw['restored']}, {raw_launches} launches")
    emit({"phase": "lossy_train_compress", "ok": True,
          "model": "large_level_2_vae",
          "weights": f"EMA of {LOSSY_TRAIN_RESUME_ITERS} training steps on "
                     f"synthetic data (says nothing of a trained model)",
          "weights_restored": stats["restored"], "images": len(rows),
          "files_decoded": len(rows), "kernel_launches": launches,
          "synthetic_data": stats["synthetic"],
          **_lossy_rows(stats, 24), "wall_s": wall_s,
          "raw_weights": {"images": len(raw["rows"]),
                          "kernel_launches": raw_launches,
                          **_lossy_rows(raw, 24)}})
    return launches + raw_launches


def phase_lossy4_train():
    """``cli.train_lossy_model model=large_level_4_vae`` at 196/128/128/128
    (the CLI's widths) for 20 steps, then the checkpoint restored by a
    second call at the same ``iters`` (no step left to run)."""
    root = _lossy_dir("lossy4_train")
    args = ["model=large_level_4_vae", "log_freq=10"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = _lossy_train_cli(root, LOSSY4_TRAIN_ITERS, *args)
    peak = torch.cuda.max_memory_allocated()
    if stats["steps"] != LOSSY4_TRAIN_ITERS or not np.all(
            np.isfinite(stats["loss"])):
        raise AssertionError(f"lossy4_train: {stats['steps']} steps, "
                             f"losses {stats['loss']}")
    again = _lossy_train_cli(root, LOSSY4_TRAIN_ITERS, *args)
    if not (again["restored"] and again["start_step"] == LOSSY4_TRAIN_ITERS
            and again["steps"] == 0):
        raise AssertionError("lossy4_train: the checkpoint did not restore")
    step_s = stats["seconds"] - stats["first_step_s"] - stats["log_s"]
    steps_per_s = (stats["steps"] - 1) / step_s
    emit({"phase": "lossy4_train", "ok": True, "model": "large_level_4_vae",
          "filters": [196, 128, 128, 128], "batch": stats["batch_size"],
          "crop": [256, 256], "steps": stats["steps"],
          "steps_per_s": steps_per_s,
          "images_per_s": steps_per_s * stats["batch_size"],
          "first_step_s": stats["first_step_s"],
          "loss_first": stats["loss"][0], "loss_last": stats["loss"][-1],
          "restored_step": again["start_step"],
          "checkpoint_bytes": os.path.getsize(stats["checkpoint"]),
          "peak_allocated_bytes": peak})
    shutil.rmtree(root)


def _lossy4_gpu_vs_cpu(dev) -> dict:
    """The full-width 4-level forward (196/128/128/128, fresh weights from
    seed 42) of one 512x768 image on the card against the same weights on
    the CPU, same noise: largest absolute differences."""
    from rec_tpu_torch.cli import compress_with_lossy_model as clm

    widths = (196, 128, 128, 128)
    gpu = clm.make_model("large_level_4_vae", None, 42, dev, *widths)
    cpu = clm.make_model("large_level_4_vae", None, 42, "cpu", *widths)
    x = _kodak_image(9)
    noise = [np.random.RandomState(10).randn(1, *s).astype(np.float32)
             for s in gpu.latent_shapes(512, 768)]
    with torch.no_grad():
        g = gpu(torch.tensor(x, device=dev), noise)
        c = cpu(torch.tensor(x), noise)

    def diff(a, b):
        return float(torch.max(torch.abs(a.cpu() - b)))

    return {"reconstruction": diff(g["reconstruction"], c["reconstruction"]),
            "level1_posterior_loc": diff(g["posteriors"][3].loc,
                                         c["posteriors"][3].loc),
            "level4_prior_scale": diff(g["priors"][0].scale,
                                       c["priors"][0].scale)}


def phase_lossy4_compress(dev):
    """``cli.compress_with_lossy_model model=large_level_4_vae`` at its
    defaults (196/128/128/128, 4 Kodak-size images, fresh weights): every
    file decoded within the CLI's tolerance, 4 launches per image (levels
    4, 3, 2, 1: 13, 13, 197 and 302 blocks, as ``latent_shapes`` gives
    them).  Returns the launches."""
    from rec_tpu_torch.cli import compress_with_lossy_model as clm

    root = _lossy_dir("lossy4_compress")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats, launches, wall_s = _lossy_cli_launches(clm.main, [
        "model=large_level_4_vae", f"output_dir={os.path.join(root, 'out')}",
        f"model_save_dir={os.path.join(root, 'ckpt')}"])
    peak = torch.cuda.max_memory_allocated()
    rows = stats["rows"]
    want = [math.ceil(math.prod(s) / 1000) for s in clm.make_model(
        "large_level_4_vae", None, 0, "cpu", 196, 128, 128, 128
    ).latent_shapes(512, 768)]
    blocks = [[len(c) for c in cs] for cs in stats["counts"]]
    if len(rows) != 4 or launches != 4 * len(rows):
        raise AssertionError(f"lossy4_compress: {len(rows)} rows, "
                             f"{launches} launches")
    if want != [13, 13, 197, 302] or any(b != want for b in blocks):
        raise AssertionError(f"lossy4_compress: blocks {blocks}, "
                             f"latent_shapes gives {want}")
    if not all(math.isfinite(r[k]) for r in rows for k in LOSSY_FIELDS):
        raise AssertionError("lossy4_compress: a CSV value is not finite")
    emit({"phase": "lossy4_compress", "ok": True,
          "model": "large_level_4_vae", "filters": [196, 128, 128, 128],
          "images": len(rows), "image_shape": [512, 768, 3],
          "weights": FRESH, "synthetic_data": stats["synthetic"],
          "files_decoded": len(rows), "kernel_launches": launches,
          **_lossy_rows(stats, 24), "peak_allocated_bytes": peak,
          "forward_gpu_vs_cpu_max_abs": _lossy4_gpu_vs_cpu(dev),
          "wall_s": wall_s})
    shutil.rmtree(root)
    return launches


def phase_lossy4_serve(dev):
    """``cli.lossy_serve model=large_level_4_vae`` at its defaults (the
    model's 192/192/128/128, 16 synthetic CLIC 256x256 images in batches of
    8, budget 32, verify on): 16 files verified, 4 launches per batch.
    Returns the launches."""
    import glob

    from rec_tpu_torch.cli import compress_with_lossy_model as clm
    from rec_tpu_torch.cli import lossy_serve

    root = _lossy_dir("lossy4_serve")
    cfg = lossy_serve.Config()
    stats, launches, wall_s = _lossy_cli_launches(lossy_serve.main, [
        "model=large_level_4_vae", "n_devices=1", f"output_dir={root}",
        f"model_save_dir={os.path.join(root, 'ckpt')}"])
    files = sorted(glob.glob(os.path.join(root, "img_*.rec")))
    n_batches = -(-cfg.num_images // cfg.batch_size)
    if stats["images"] != cfg.num_images or len(files) != cfg.num_images \
            or len(stats["psnr"]) != cfg.num_images:
        raise AssertionError(f"lossy4_serve: {stats['images']} images, "
                             f"{len(files)} files")
    if launches != 4 * n_batches:
        raise AssertionError(f"lossy4_serve: {launches} launches, expected "
                             f"{4 * n_batches}")
    counts = [np.concatenate([c[lvl] for c in stats["counts"]])
              for lvl in range(4)]
    blocks = [int(c.size) // n_batches for c in counts]
    want = [cfg.batch_size * math.ceil(math.prod(s) / 1000)
            for s in clm.make_model("large_level_4_vae", None, 0, "cpu"
                                    ).latent_shapes(256, 256)]
    if blocks != want:
        raise AssertionError(f"lossy4_serve: blocks per launch {blocks}, "
                             f"latent_shapes gives {want}")
    shutil.rmtree(root)
    emit({"phase": "lossy4_serve", "ok": True, "model": "large_level_4_vae",
          "filters": [192, 192, 128, 128], "images": stats["images"],
          "files_verified": len(stats["psnr"]), "batch": cfg.batch_size,
          "image_shape": [256, 256, 3], "weights": FRESH,
          "synthetic_data": stats["synthetic"], "kernel_launches": launches,
          "blocks_per_launch": blocks,
          "encode_images_per_s": stats["images_per_s"],
          "steady_images": stats["steady_images"],
          "encode_s": stats["encode_s"], "bpp": stats["bpp"],
          "mean_count": [float(c.mean()) for c in counts],
          "saturated_blocks": [int(np.sum(c == cfg.max_partitions))
                               for c in counts],
          "mean_psnr": float(np.mean(stats["psnr"])), "wall_s": wall_s})
    return launches

# The large lossless model's phases: the compress CLI's defaults
# (160/160/128/32, discretized_logistic, B = 20, S = 36, Omega = 3, block
# 1000, budget 24 auto-grown) on the synthetic Kodak stand-in (512x768).
# Fresh weights can probe a large need; the auto-grown budget is capped at
# LARGE_MAX_BUDGET (the CLI's max_budget), and the phases print whether
# the cap bound.
LARGE_MAX_BUDGET = 512
LARGE_TRAIN_ITERS, LARGE_TRAIN_RESUME_ITERS, LARGE_TRAIN_LOG_FREQ = 50, 60, 25
IAF_TRAIN_ITERS, IAF_TRAIN_LOG_FREQ = 20, 10


def mega_beam_launches(N, D, P) -> int:
    """The launches of one ``mega_encode_blocks`` call on N blocks of D
    dims at budget P: the wrapper splits the block axis into equal chunks
    when the score coefficients pass ``_SCHED_LIMIT_BYTES``."""
    from rec_tpu_torch.ops import mega_beam

    per_block = 3 * P * (-(-D // 128) * 128) * 4
    chunk = max(1, min(N, mega_beam._SCHED_LIMIT_BYTES // per_block))
    return -(-N // chunk)


def _large_groups(H, W, widths=(160, 160, 128, 32), block=1000):
    """(blocks, block dims) of the large model's two groups, top-down, for
    an H x W unit."""
    from rec_tpu_torch.coding.partition import plan_split

    out = []
    for dims in (H // 64 * (W // 64) * widths[3],
                 H // 16 * (W // 16) * widths[2]):
        plan = plan_split(dims, block)
        out.append((plan.num_blocks, plan.block_size))
    return out


def _large_cli(save_dir, out_dir, *args):
    """``cli.compression_performance model=large_resnet_vae`` in-process on
    the Kodak stand-in with the beam-search launch count set to 0 just
    before it; checks every row exact and the CSV's columns, and that the
    launches are what each unit's groups and budget give.  Returns (stats,
    launches, wall s)."""
    from rec_tpu_torch.cli import compression_performance as cp
    from rec_tpu_torch.ops import mega_beam

    mega_beam.mega_encode_blocks.launches = 0
    t0 = time.perf_counter()
    stats = cp.main(["model=large_resnet_vae", "dataset.dataset=kodak",
                     f"max_budget={LARGE_MAX_BUDGET}", *args,
                     f"model_save_dir={save_dir}", f"output_dir={out_dir}"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = mega_beam.mega_encode_blocks.launches
    rows = [r for r in stats["rows"] if not str(r["index"]).endswith(
        "_total")]
    with open(stats["csv"]) as f:
        header = next(csv.reader(f))
    if header != REFERENCE_FIELDS:
        raise AssertionError(f"large {args}: CSV columns {header}")
    if stats["crashes"] or not all(r["roundtrip_ok"] for r in stats["rows"]):
        raise AssertionError(f"large {args}: {stats['crashes']} crashes, "
                             f"roundtrip "
                             f"{[r['roundtrip_ok'] for r in stats['rows']]}")
    want = sum(mega_beam_launches(n, d, p) for r, p in
               zip(rows, stats["budgets"])
               for n, d in _large_groups(r["height"], r["width"]))
    if launches != want:
        raise AssertionError(f"large {args}: {launches} beam-search "
                             f"launches, the budgets give {want}")
    return stats, launches, wall_s


def _large_rows(stats) -> dict:
    rows = [r for r in stats["rows"] if not str(r["index"]).endswith(
        "_total")]
    return {"probed_need": stats["needs"], "budget": stats["budgets"],
            "max_budget_bound": max(stats["needs"]) > LARGE_MAX_BUDGET,
            "saturated_blocks": [r["saturated_blocks"] for r in rows],
            "total_kl": [r["total_kl"] for r in rows],
            "ideal_elbo_bpd": [r["ideal_elbo_bpd"] for r in rows],
            "bits_per_dim": [r["total_bits_per_dim"] for r in rows],
            "encode_s": [r["comp_time"] for r in rows],
            "decode_s": [r["decomp_time"] for r in rows],
            "phase_mean_ms": {k: v["mean_ms"]
                              for k, v in stats["phase_times"].items()}}


def _large_model(dev, save_dir, image):
    """The compress CLI's large model with fresh weights from seed 42
    (data-dependent init on ``image``, as the CLI does) and its coder."""
    from rec_tpu_torch.cli import compression_performance as cp

    cfg = cp.Config(model="large_resnet_vae", model_save_dir=save_dir)
    coder = cp.build_coder(cfg)
    model, restored = cp.load_model(cfg, coder, image, dev)
    if restored:
        raise AssertionError("large: fresh weights expected")
    return cfg, coder, model


def _kodak_test_image(index=0):
    """Image ``index`` of the compress CLI's Kodak stand-in, centred, as
    (1, 512, 768, 3) float32."""
    from rec_tpu_torch.data.datasets import (DatasetConfig, load_images,
                                             normalize)

    images, _ = load_images(DatasetConfig(dataset="kodak", split="test"))
    return normalize(images, "centered")[index:index + 1].astype(np.float32)


def _probed_blocks(cfg, coder, model, x, seed, group, dev):
    """One unit's group ``group`` (0 = block 2, 1 = block 1) split into
    latent blocks with that group's coding seed, and the budget the CLI
    grows to for the unit's probed need (capped at LARGE_MAX_BUDGET)."""
    from rec_tpu_torch.cli import compression_performance as cp
    from rec_tpu_torch.coding.partition import split_coders

    xt = torch.tensor(x, device=dev)
    with torch.no_grad():
        out = model(xt, cp.forward_noise(cfg, x.shape, seed))
    pairs = cp.pairs(out)
    need = max(coder.required_partitions(p, c, seed) for p, c in pairs)
    budget = coder.max_partitions
    if need > budget:
        budget = cp.grow_budget(
            dataclasses.replace(cfg, max_budget=LARGE_MAX_BUDGET),
            logging.getLogger("large_kernel"), coder, need).max_partitions
    post, prior = pairs[group]
    group_seed = seed + 7919 if group == 0 else seed
    plan, perms, bkeys = coder._setup(post.loc.shape[1:], [group_seed], dev)
    return (split_coders(post, plan, perms),
            split_coders(prior, plan, perms), bkeys), need, budget


def phase_large_kernel(dev, rates):
    """The beam-search kernel against its plain version (the checks of
    phase 3) at the large model's shapes, from a fresh full-width model
    (160/160/128/32, seed 42): one Kodak image's block-1 group (N = 197,
    D = 1000) at the budget its probed need grows to, and a 256x256 tile's
    block-2 group, one block of D = 512 (``tile=256``'s lone block).
    Returns the two cases."""
    x = _kodak_test_image()
    root = _lossy_dir("large_kernel")
    cfg, coder, model = _large_model(dev, root, x)
    cases = {}
    for name, unit, group, want in (
            ("kodak_n197", x, 1, (197, 1000)),
            ("tile_d512", np.ascontiguousarray(x[:, :256, :256]), 0,
             (1, 512))):
        blocks, need, P = _probed_blocks(cfg, coder, model, unit, 42, group,
                                         dev)
        shape = tuple(blocks[0].loc.shape)
        if shape != want:
            raise AssertionError(f"large_kernel {name}: blocks {shape}")
        case = _mega_beam_case(dev, *blocks, "fmix", 1, rates, P=P)
        counts = np.asarray(case.pop("counts"))
        emit({"phase": "large_kernel", "ok": True, "case": name,
              "stream": "fmix",
              "shape": dict(N=shape[0], D=shape[1], B=MAIN["B"],
                            S=MAIN["S"], P=P),
              "probed_need": need, "weights": FRESH,
              "saturated_blocks": int(np.sum(counts == P)),
              "mean_count": float(counts.mean()), **case})
        cases[name] = dict(case, P=P)
    shutil.rmtree(root, ignore_errors=True)
    return cases


def _large_gpu_vs_cpu(dev, save_dir, x) -> dict:
    """The full-width large model's forward of one Kodak image on the card
    against the same weights on the CPU, same noise: largest absolute
    differences."""
    from rec_tpu_torch.cli import compression_performance as cp
    from rec_tpu_torch.models.large_resnet_vae import LargeResNetVAE

    cfg, _, gpu = _large_model(dev, save_dir, x)
    cpu = LargeResNetVAE(cfg.large_cfg, None, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    cpu.initialized = True
    noise = cp.forward_noise(cfg, x.shape, 9)
    with torch.no_grad():
        g = gpu(torch.tensor(x, device=dev), noise)
        c = cpu(torch.tensor(x), noise)

    def diff(a, b):
        return float(torch.max(torch.abs(a.cpu() - b)))

    (g2, _), (g1, _) = g["posterior_prior_pairs"]
    (c2, _), (c1, _) = c["posterior_prior_pairs"]
    return {"reconstruction": diff(g["reconstruction"], c["reconstruction"]),
            "block1_posterior_loc": diff(g1.loc, c1.loc),
            "block2_posterior_loc": diff(g2.loc, c2.loc),
            "log_likelihood_rel": diff(g["log_likelihood"],
                                       c["log_likelihood"])
            / float(torch.max(torch.abs(c["log_likelihood"])))}


def phase_large_compress(dev):
    """``cli.compression_performance model=large_resnet_vae`` at its
    defaults on the Kodak stand-in: ``mode=initialize`` on 1 image, then
    ``mode=compress`` on 2 with that ratio table (large_initialize,
    large_compress); then ``tile=256`` on 1 image, 6 tiles and the total
    row (large_tile).  Returns the launches of the compress and tile
    runs."""
    from rec_tpu_torch.cli import compression_performance as cp

    t0 = time.perf_counter()
    root = _lossy_dir("large")
    save_dir = os.path.join(root, "ckpt")
    init = cp.main(["model=large_resnet_vae", "dataset.dataset=kodak",
                    "mode=initialize", "num_images=1",
                    f"model_save_dir={save_dir}",
                    f"output_dir={os.path.join(root, 'init')}"])
    table = init["table"]
    if init["restored"] or init["fits"] < 1 or not (
            np.all(np.isfinite(table)) and table.min() > 0
            and table.max() <= 1):
        raise AssertionError(f"large_initialize: restored="
                             f"{init['restored']}, {init['fits']} fits, "
                             f"ratios in [{table.min()}, {table.max()}]")
    emit({"phase": "large_initialize", "ok": True, "images": 1,
          "image_shape": [512, 768, 3], "weights": FRESH,
          "table_len": len(table), "fitted": init["fitted"],
          "fits": init["fits"], "steps": init["steps"],
          "host_syncs": init["syncs"], "fit_s": init["fit_s"],
          "phase_s": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    stats, launches, wall_s = _large_cli(
        save_dir, os.path.join(root, "out"), "num_images=2")
    peak = torch.cuda.max_memory_allocated()
    if len(stats["rows"]) != 2:
        raise AssertionError(f"large_compress: {len(stats['rows'])} rows")
    emit({"phase": "large_compress", "ok": True, "model": "large_resnet_vae",
          "filters": [160, 160, 128, 32], "images": 2,
          "image_shape": [512, 768, 3], "weights": FRESH,
          "synthetic_data": stats["synthetic"], "exact_pixels": 2,
          "groups_blocks_dims": _large_groups(512, 768),
          "kernel_launches": launches, "launches_per_image": launches / 2,
          **_large_rows(stats), "peak_allocated_bytes": peak,
          "forward_gpu_vs_cpu_max_abs": _large_gpu_vs_cpu(
              dev, os.path.join(root, "gpu_vs_cpu"), _kodak_test_image(1)),
          "wall_s": wall_s, "phase_s": time.perf_counter() - t0})

    t0 = time.perf_counter()
    tiles, tile_launches, tile_wall_s = _large_cli(
        save_dir, os.path.join(root, "tile"), "num_images=1", "tile=256")
    rows = tiles["rows"]
    labels = [f"0_t{r}_{c}" for r in range(2) for c in range(3)]
    if [r["index"] for r in rows] != labels + ["0_total"]:
        raise AssertionError(f"large_tile: rows {[r['index'] for r in rows]}")
    emit({"phase": "large_tile", "ok": True, "tile": 256, "images": 1,
          "tiles": 6, "exact_tiles": 6, "weights": FRESH,
          "groups_blocks_dims": _large_groups(256, 256),
          "kernel_launches": tile_launches, **_large_rows(tiles),
          "total_row": rows[-1], "wall_s": tile_wall_s,
          "phase_s": time.perf_counter() - t0})
    shutil.rmtree(root)
    return launches, tile_launches


def _large_train_cli(root, iters):
    from rec_tpu_torch.cli import train_generative_model as tgm

    return tgm.main(["model=large_resnet_vae", "dataset.dataset=clic2019",
                     f"iters={iters}", f"log_freq={LARGE_TRAIN_LOG_FREQ}",
                     f"model_save_dir={os.path.join(root, 'ckpt')}",
                     f"log_dir={os.path.join(root, 'logs')}"])


def phase_large_train():
    """``cli.train_generative_model model=large_resnet_vae`` at its
    defaults (adam 1e-3, lamb 0.01, laplace, batch 8, EMA 0.999, 256-crops
    of the synthetic CLIC train split) for 50 steps, logging and saving
    every 25, then resumed to 60; 10 profiled steps of a fresh run and one
    step's device time by kind.  Returns the checkpoint directory."""
    from rec_tpu_torch.cli import train_generative_model as tgm
    from rec_tpu_torch.utils.logging import setup_logger

    phase_t0 = time.perf_counter()
    root = _lossy_dir("large_train")
    save_dir = os.path.join(root, "ckpt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = _large_train_cli(root, LARGE_TRAIN_ITERS)
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(stats["loss"])
    if stats["steps"] != LARGE_TRAIN_ITERS or stats["restored"] or not \
            np.all(np.isfinite(loss)):
        raise AssertionError(f"large_train: {stats['steps']} steps, "
                             f"restored={stats['restored']}, losses {loss}")
    first10, last10 = float(loss[:10].mean()), float(loss[-10:].mean())
    if not last10 < first10:
        raise AssertionError(f"large_train: the loss did not fall (first "
                             f"10 {first10}, last 10 {last10})")
    with open(os.path.join(save_dir, "model_config.json")) as f:
        model_cfg = json.load(f)
    if model_cfg["kind"] != "large_resnet_vae" or \
            model_cfg["cfg"]["likelihood"] != "laplace":
        raise AssertionError(f"large_train: model_config {model_cfg}")
    if _checkpoints(save_dir) != [1, LARGE_TRAIN_LOG_FREQ + 1,
                                  LARGE_TRAIN_ITERS]:
        raise AssertionError(f"large_train: checkpoints "
                             f"{os.listdir(save_dir)}")
    step_s = stats["seconds"] - stats["first_step_s"] - stats["log_s"]
    steps_per_s = (stats["steps"] - 1) / step_s
    more = _large_train_cli(root, LARGE_TRAIN_RESUME_ITERS)
    if not (more["restored"] and more["start_step"] == LARGE_TRAIN_ITERS
            and more["final_step"] == LARGE_TRAIN_RESUME_ITERS
            and np.all(np.isfinite(more["loss"]))):
        raise AssertionError(f"large_train: resume {more['start_step']} -> "
                             f"{more['final_step']}")

    argv = ["model=large_resnet_vae", "dataset.dataset=clic2019",
            f"model_save_dir={os.path.join(root, 'profile')}",
            f"log_dir={os.path.join(root, 'logs')}"]
    cfg = tgm._model_defaults(tgm.apply_overrides(tgm.Config(), argv), argv)
    run = tgm.build(cfg, setup_logger("large_profile"))

    def steps(n):
        for _ in range(n):
            run.state, _ = run.step_fn(run.state, run.batch(), run.noise())

    steps(2)   # warm-up
    prof = device_profile(lambda: steps(10))
    by_kind = device_ms_by_kind(lambda: steps(1))
    emit({"phase": "large_train", "ok": True, "model": "large_resnet_vae",
          "filters": [160, 160, 128, 32], "likelihood": "laplace",
          "optimizer": cfg.optimizer, "lamb": cfg.lamb,
          "crop": [cfg.dataset.crop_size] * 2,
          "params": sum(p.numel() for p in run.model.parameters()),
          "batch": stats["batch_size"], "steps": stats["steps"],
          "synthetic_data": stats["synthetic"],
          "steps_per_s": steps_per_s,
          "images_per_s": steps_per_s * stats["batch_size"],
          "first_step_s": stats["first_step_s"],
          "log_and_checkpoint_s": stats["log_s"], "loop_s": stats["seconds"],
          "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
          "loss_mean_first10": first10, "loss_mean_last10": last10,
          "elbo_bpd_first": stats["elbo_bpd"][0],
          "elbo_bpd_last": stats["elbo_bpd"][-1],
          "checkpoint_bytes": os.path.getsize(stats["checkpoint"]),
          "resumed_from": more["start_step"], "resumed_steps": more["steps"],
          "peak_allocated_bytes": peak,
          "profile_10_steps": {k: prof[k] for k in (
              "unprofiled_wall_ms", "device_busy_ms", "device_kernels",
              "device_idle_share_estimate", "top_device_ms")},
          "device_busy_share": prof["device_busy_ms"]
          / prof["unprofiled_wall_ms"],
          "one_step_device_ms_by_kind": by_kind,
          "phase_s": time.perf_counter() - phase_t0})
    shutil.rmtree(os.path.join(root, "profile"), ignore_errors=True)
    return save_dir


def phase_large_train_compress(save_dir):
    """The large compress CLI on one Kodak-size image restoring the
    trainer's checkpoint (its EMA weights): the checkpoint's laplace
    likelihood is picked up, exact pixels.  Returns the launches."""
    from rec_tpu_torch.cli import compression_performance as cp

    t0 = time.perf_counter()
    cfg = cp.reconcile_model_config(save_dir, "large_resnet_vae",
                                    cp.Config().large_cfg)
    if cfg.likelihood != "laplace":
        raise AssertionError(f"large_train_compress: likelihood "
                             f"{cfg.likelihood}")
    stats, launches, wall_s = _large_cli(
        save_dir, os.path.join(os.path.dirname(save_dir), "compress"),
        "num_images=1")
    if not stats["restored"] or launches <= 0:
        raise AssertionError(f"large_train_compress: restored="
                             f"{stats['restored']}, {launches} launches")
    emit({"phase": "large_train_compress", "ok": True,
          "weights": f"EMA of {LARGE_TRAIN_RESUME_ITERS} training steps on "
                     f"synthetic CLIC crops (says nothing of a trained "
                     f"model)", "likelihood": cfg.likelihood,
          "weights_restored": stats["restored"], "images": 1,
          "exact_pixels": 1, "kernel_launches": launches,
          **_large_rows(stats), "wall_s": wall_s,
          "phase_s": time.perf_counter() - t0})
    shutil.rmtree(os.path.dirname(save_dir))
    return launches


def phase_iaf_train_compress(train_steps_per_s):
    """The lossless trainer at its defaults (RVAE-24, 160/32) with
    ``model_cfg.use_iaf=true`` for 20 steps, its steps/s beside the
    plain model's (``train``); then the compress CLI on one cifar10 image
    with its weights (the IAF weights restored, unused by encode): exact,
    24 launches.  Returns the launches."""
    from rec_tpu_torch.cli import train_generative_model as tgm

    t0 = time.perf_counter()
    root = _lossy_dir("iaf_train")
    save_dir = os.path.join(root, "ckpt")
    stats = tgm.main(["model_cfg.use_iaf=true", f"iters={IAF_TRAIN_ITERS}",
                      f"log_freq={IAF_TRAIN_LOG_FREQ}",
                      f"model_save_dir={save_dir}",
                      f"log_dir={os.path.join(root, 'logs')}"])
    loss = np.asarray(stats["loss"])
    if stats["steps"] != IAF_TRAIN_ITERS or not np.all(np.isfinite(loss)):
        raise AssertionError(f"iaf_train: {stats['steps']} steps, losses "
                             f"{loss}")
    step_s = stats["seconds"] - stats["first_step_s"] - stats["log_s"]
    steps_per_s = (stats["steps"] - 1) / step_s
    comp, launches = _compress_cli(save_dir, os.path.join(root, "out"),
                                   "num_images=1")
    row = comp["rows"][0]
    if not comp["restored"] or launches != 24:
        raise AssertionError(f"iaf_train_compress: restored="
                             f"{comp['restored']}, {launches} launches")
    emit({"phase": "iaf_train_compress", "ok": True,
          "model": "resnet_vae use_iaf", "filters": [160, 32],
          "steps": stats["steps"], "steps_per_s": steps_per_s,
          "images_per_s": steps_per_s * stats["batch_size"],
          "train_steps_per_s_without_iaf": train_steps_per_s,
          "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
          "weights_restored": comp["restored"], "exact_pixels": 1,
          "kernel_launches": launches, "probed_need": comp["needs"],
          "budget": comp["budgets"],
          "bits_per_dim": row["total_bits_per_dim"],
          "comp_time": row["comp_time"], "decomp_time": row["decomp_time"],
          "phase_s": time.perf_counter() - t0})
    shutil.rmtree(root)
    return launches


# ---------------------------------------------------------------------------
# The importance coder and shared-pool beam search (no TPU-kernel
# counterpart: their encodes are eager PyTorch, so their launches of both
# kernels must stay 0, and they are reported on their own lines).
# ---------------------------------------------------------------------------

IMPORTANCE_LATENT = (16, 16, 32)   # the flagship's per-res-block latent


def _reset_kernel_counts():
    """Both kernels' launch counts, set to 0 (read back by
    ``_no_kernel_launches``)."""
    from rec_tpu_torch.ops import beam_score, mega_beam

    mega_beam.mega_encode_blocks.launches = 0
    beam_score.score_rows.launches = 0


def _no_kernel_launches(label) -> dict:
    from rec_tpu_torch.ops import beam_score, mega_beam

    counts = {"mega_beam_launches": mega_beam.mega_encode_blocks.launches,
              "beam_score_launches": beam_score.score_rows.launches}
    if any(counts.values()):
        raise AssertionError(f"{label}: launched a TPU-kernel port {counts}")
    return counts


def _importance_latent(dev, seed, batch=None):
    """A target around a standard-normal coder with ~0.04 nats per dim
    (~14 partitions per 1000-dim block, near the fresh RVAE's need)."""
    from rec_tpu_torch.coding.gauss import GaussianParams

    rs = np.random.RandomState(seed)
    shape = ((batch,) if batch else ()) + IMPORTANCE_LATENT
    loc = (rs.randn(*shape) * 0.25).astype(np.float32)
    scale = np.exp(rs.randn(*shape) * 0.1).astype(np.float32)
    return (GaussianParams(torch.tensor(loc, device=dev),
                           torch.tensor(scale, device=dev)),
            GaussianParams(torch.zeros(shape, device=dev),
                           torch.ones(shape, device=dev)))


def _cuda_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_importance_coder(dev):
    """GaussianCoder at its defaults (Omega 3, 12 bits, block 1000, budget
    24, chunk 1024) on the flagship latent (9 blocks), for the fmix and the
    threefry stream, and as an encode_batch of 8 (72 blocks): encode sample
    == GPU decode == CPU decode bitwise; the GPU's indices, counts and
    sample equal to the CPU encode's on all 9 blocks (the replay alone
    cannot see a wrong pick); ms per encode and decode, device kernels of
    one encode, peak allocated bytes."""
    from rec_tpu_torch.coding import GaussianCoder, importance
    from rec_tpu_torch.coding.gauss import GaussianParams

    as_int = lambda x: x.view(torch.int32).cpu()  # noqa: E731
    _reset_kernel_counts()
    out = {}
    for stream in ("fmix", "threefry"):
        coder = GaussianCoder(stream=stream)
        t, c = _importance_latent(dev, 11)
        enc, enc_s = _cuda_s(lambda: coder.encode(t, c, 321))
        dec, dec_s = _cuda_s(
            lambda: coder.decode(c, enc.indices, enc.counts, 321))
        tc, cc = (GaussianParams(x.loc.cpu(), x.scale.cpu()) for x in (t, c))
        dec_cpu = coder.decode(cc, enc.indices.cpu(), enc.counts.cpu(), 321)
        if not torch.equal(as_int(enc.sample), as_int(dec)):
            raise AssertionError(f"importance {stream}: encode sample != "
                                 f"GPU decode")
        if not torch.equal(as_int(dec), as_int(dec_cpu)):
            raise AssertionError(f"importance {stream}: GPU decode != CPU "
                                 f"decode")
        t0 = time.perf_counter()
        cpu = coder.encode(tc, cc, 321)
        cpu_s = time.perf_counter() - t0
        for what in ("indices", "counts", "sample"):
            if not torch.equal(as_int(getattr(enc, what)),
                               as_int(getattr(cpu, what))):
                raise AssertionError(f"importance {stream}: GPU and CPU "
                                     f"encodes differ in {what}")
        out[stream] = {"counts": enc.counts.tolist(),
                       "gpu_equals_cpu_encode_blocks":
                           int(enc.counts.numel()),
                       "encode_ms_n9": enc_s * 1e3,
                       "decode_ms_n9": dec_s * 1e3,
                       "cpu_encode_s_n9": cpu_s}
    coder = GaussianCoder()
    t, c = _importance_latent(dev, 11)
    # A serving batch: 8 latents, 72 blocks in one block-codec call.
    t8, c8 = _importance_latent(dev, 12, batch=8)
    seeds = [500 + 101 * i for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    enc8, enc8_s = _cuda_s(lambda: coder.encode_batch(t8, c8, seeds))
    peak = torch.cuda.max_memory_allocated()
    dec8, dec8_s = _cuda_s(
        lambda: coder.decode_batch(c8, enc8.indices, enc8.counts, seeds))
    if not torch.equal(as_int(enc8.sample), as_int(dec8)):
        raise AssertionError("importance: batch encode sample != decode")
    prof = device_profile(lambda: coder.encode(t, c, 321))
    emit({"phase": "importance_coder", "ok": True, "coder": "GaussianCoder",
          "coding_bits": coder.coding_bits,
          "candidate_chunk": coder.candidate_chunk,
          "block": coder.block_size, "budget": coder.max_partitions,
          "fmix": out["fmix"], "threefry": out["threefry"],
          "encode_ms_n72": enc8_s * 1e3, "decode_ms_n72": dec8_s * 1e3,
          "counts_n72_mean": float(enc8.counts.float().mean()),
          "peak_allocated_bytes_n72": peak,
          "group_elements": importance.GROUP_ELEMENTS["cuda"],
          "device_kernels_per_encode_n9": prof["device_kernels"],
          "device_busy_ms_n9": prof["device_busy_ms"],
          "device_idle_share_estimate_n9":
              prof["device_idle_share_estimate"],
          "top_device_ms_n9": prof["top_device_ms"][:4],
          **_no_kernel_launches("importance_coder")})


def phase_importance_compress(dev, save_dir, out_dir):
    """``sampler=importance`` through the compress CLIs on one image each:
    RVAE-24 (160/32) on a cifar10 image with the ratio table initialize
    fitted, ``model=large_resnet_vae`` on a synthetic Kodak image (fresh
    weights), and ``compress_with_lossy_model`` (Large2LevelVAE, 196/128)
    on one Kodak image: exact images, the lossy decode within the CLI's own
    tolerance; need, budget, comp_time and decomp_time."""
    from rec_tpu_torch.cli import compress_with_lossy_model as clm
    from rec_tpu_torch.cli import compression_performance as cp
    from rec_tpu_torch.coding import GaussianCoder
    from rec_tpu_torch.models.lossy import decompress_from_file

    rows = {}
    large = _lossy_dir("imp_large")
    for name, args in (
            ("rvae24", [f"model_save_dir={save_dir}",
                        f"output_dir={out_dir}_importance"]),
            ("large", ["model=large_resnet_vae", "dataset.dataset=kodak",
                       f"max_budget={LARGE_MAX_BUDGET}",
                       f"model_save_dir={large}/ckpt",
                       f"output_dir={large}/out"])):
        _reset_kernel_counts()
        stats, wall_s = _cuda_s(lambda: cp.main(
            ["sampler=importance", "num_images=1", *args]))
        r = stats["rows"]
        if stats["crashes"] or len(r) != 1 or not r[0]["roundtrip_ok"]:
            raise AssertionError(f"importance_compress {name}: "
                                 f"{stats['crashes']} crashes, rows {r}")
        rows[name] = {"exact_pixels": 1, "probed_need": stats["needs"],
                      "budget": stats["budgets"],
                      "saturated_blocks": r[0]["saturated_blocks"],
                      "comp_time": r[0]["comp_time"],
                      "decomp_time": r[0]["decomp_time"],
                      "latent_code_bits": r[0]["latent_code_bits"],
                      "total_bits_per_dim": r[0]["total_bits_per_dim"],
                      "wall_s": wall_s,
                      **_no_kernel_launches(f"importance_compress {name}")}
    root = _lossy_dir("imp_lossy")
    _reset_kernel_counts()
    stats, wall_s = _cuda_s(lambda: clm.main([
        "sampler=importance", "num_images=1",
        f"output_dir={root}/out", f"model_save_dir={root}/ckpt"]))
    counts = stats["counts"][0]
    # The CLI's model (fresh weights from seed 42) decodes the file again,
    # timed; the CLI itself held that decode to rtol 1e-4 / atol 1e-5.
    coder = GaussianCoder()
    model = clm.make_model("large_level_2_vae", coder, 42, dev, 196, 128)
    recon, dec_s = _cuda_s(lambda: decompress_from_file(
        model, f"{root}/out/img_0.rec", max_partitions=coder.max_partitions))
    if not bool(torch.isfinite(recon).all()):
        raise AssertionError("importance_compress lossy: decode not finite")
    rows["lossy_level2"] = {
        "decoded_within_cli_tolerance": 1,
        "blocks_per_level": [len(c) for c in counts],
        "probed_need": stats["required_partitions"],
        "budget": [coder.max_partitions],
        "saturated_blocks": int(sum(np.sum(c == coder.max_partitions)
                                    for c in counts)),
        "mean_count": float(np.mean(np.concatenate(counts))),
        "comp_time": stats["rows"][0]["comp_time"], "decomp_time": dec_s,
        "actual_bpp": stats["rows"][0]["actual_bpp"], "wall_s": wall_s,
        **_no_kernel_launches("importance_compress lossy")}
    for d in (f"{out_dir}_importance", large, root):
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "importance_compress", "ok": True, "weights": FRESH,
          **rows})


SERVE_VARIANTS = (("importance_serve", "sampler=importance"),
                  ("shared_pool_serve", "shared_pool=true"))


def phase_serve_variant(name, option, beam_images_per_s):
    """``cli.serve`` at its defaults (RVAE-24, 16 images in batches of 8,
    fresh weights, verify and true_lossless on) with ``option``: every file
    verified with exact pixels, neither kernel launched; images/s beside
    the per-beam serve rate of this run (no gain is claimed)."""
    import glob

    from rec_tpu_torch.cli import serve

    out_dir = _lossy_dir(name)
    _reset_kernel_counts()
    stats, wall_s = _cuda_s(lambda: serve.main(
        [option, "n_devices=1", f"output_dir={out_dir}",
         f"model_save_dir={os.path.join(out_dir, 'ckpt')}"]))
    files = glob.glob(os.path.join(out_dir, "img_*.rec"))
    cfg = serve.Config()
    if stats["images"] != cfg.num_images or len(files) != cfg.num_images:
        raise AssertionError(f"{name}: {stats['images']} images, "
                             f"{len(files)} files")
    shutil.rmtree(out_dir)
    emit({"phase": name, "ok": True, "option": option,
          "images": stats["images"], "files_verified": len(files),
          "lossless": True, "batch": cfg.batch_size,
          "encode_images_per_s": stats["images_per_s"],
          "beam_search_serve_images_per_s": beam_images_per_s,
          "steady_images": stats["steady_images"],
          "encode_s": stats["encode_s"],
          "bits_per_dim": stats["bits_per_dim"], "wall_s": wall_s,
          **_no_kernel_launches(name)})


def _rvae_latent_blocks(dev, seed=42):
    """The flagship RVAE-24's (posterior, prior) blocks of one res block's
    16x16x32 latent on a synthetic cifar10 test image, from fresh weights
    (seed 42, data-dependent init) through the compress CLI's loaders:
    split into 9 blocks of 1000 dims as the coder splits it.  The res
    block is the one of median KL of the 24 (the extremes are collapsed
    or heavy).  Returns (targets, coders, group, group KLs)."""
    from rec_tpu_torch.cli import compression_performance as cp
    from rec_tpu_torch.coding import rng
    from rec_tpu_torch.coding.gauss import GaussianParams, kl_divergence
    from rec_tpu_torch.coding.partition import (plan_split, split_coders,
                                                split_permutations)
    from rec_tpu_torch.utils.logging import setup_logger

    cfg = cp.Config(num_images=1, model_save_dir=_lossy_dir("rej_ckpt"))
    x = cp._padded(cfg, cp._images(cfg, setup_logger("rejection"))[0][0])
    model, _ = cp.load_model(cfg, None, x, dev)
    with torch.no_grad():
        out = model(torch.as_tensor(x, device=dev),
                    cp.forward_noise(cfg, x.shape, seed))
    groups = cp.pairs(out)
    kls = [float(torch.sum(kl_divergence(p, c))) for p, c in groups]
    g = int(np.argsort(kls)[len(kls) // 2])
    p, c = groups[g]
    plan = plan_split(int(p.loc.numel()), 1000)
    perms = split_permutations(rng.root_keys([seed], device=dev), plan)
    return (split_coders(p, plan, perms), split_coders(c, plan, perms), g,
            kls)


def phase_rejection_coder(dev):
    """``RejectionCoder`` at the reference defaults (Omega 3, buffers of
    10,000, 100 x 100 mass samples) on the flagship's latent (9 blocks of
    1000 dims, each at its own ceil(KL / 3) partitions): every block
    encoded on the GPU, decode == encode sample bitwise, GPU decode == CPU
    decode bitwise, the block of fewest partitions encoded on the CPU
    too with the GPU's indices and sample, and the first two steps of a
    full block (block 0) on both with equal indices and conditioned bits.  Per block: partitions, encode
    and decode ms, spillover rounds, and from a second encode under a
    device-only profiler the device kernels per partition step, busy ms
    and idle share; peak allocated bytes."""
    from rec_tpu_torch.coding import RejectionCoder
    from rec_tpu_torch.coding.gauss import GaussianParams

    as_int = lambda x: x.view(torch.int32).cpu()  # noqa: E731
    _reset_kernel_counts()
    tb, cb, group, kls = _rvae_latent_blocks(dev)
    rc = RejectionCoder()
    buf = rc.sampler.cfg.sample_buffer_size
    main_rounds = rc.sampler.cfg.r_buffer_size // buf
    blocks, encoded = [], []
    torch.cuda.reset_peak_memory_stats()
    for b in range(tb.loc.shape[0]):
        t = GaussianParams(tb.loc[b], tb.scale[b])
        c = GaussianParams(cb.loc[b], cb.scale[b])
        got = {}
        # An unprofiled encode (timed), then one whose device activity is
        # recorded: the same bits.
        prof = device_profile(lambda: got.update(
            enc=rc.encode_block(t, c, 321 + b)))
        ind, sample = got["enc"]
        dec, dec_s = _cuda_s(lambda: rc.decode_block(c, ind, 321 + b))
        cpu_c = GaussianParams(c.loc.cpu(), c.scale.cpu())
        dec_cpu = rc.decode_block(cpu_c, ind, 321 + b)
        if not torch.equal(as_int(sample), as_int(dec)):
            raise AssertionError(f"rejection block {b}: encode sample != "
                                 f"GPU decode")
        if not torch.equal(as_int(dec), as_int(dec_cpu)):
            raise AssertionError(f"rejection block {b}: GPU decode != CPU "
                                 f"decode")
        encoded.append((t, c, ind, sample))
        blocks.append({
            "partitions": len(ind), "encode_ms": prof["unprofiled_wall_ms"],
            "decode_ms": dec_s * 1e3,
            # Index i was drawn in round i // buffer.
            "spillover_rounds": sum(max(i // buf + 1 - main_rounds, 0)
                                    for i in ind),
            "max_index": max(ind),
            "device_kernels_per_partition_step":
                prof["device_kernels"] / len(ind),
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share_estimate":
                prof["device_idle_share_estimate"]})
    peak = torch.cuda.max_memory_allocated()
    # The block of fewest partitions, for time: the last block, which
    # holds the split's padding (dims where target == coder), when it
    # has the fewest.  Every partition draws 10^4 x 1000 normals twice.
    cpu_b = int(np.argmin([b["partitions"] for b in blocks]))
    t, c, ind, sample = encoded[cpu_b]
    t0 = time.perf_counter()
    cpu_ind, cpu_sample = RejectionCoder().encode_block(
        GaussianParams(t.loc.cpu(), t.scale.cpu()),
        GaussianParams(c.loc.cpu(), c.scale.cpu()), 321 + cpu_b)
    cpu_s = time.perf_counter() - t0
    if cpu_ind != ind or not torch.equal(as_int(cpu_sample), as_int(sample)):
        raise AssertionError(f"rejection block {cpu_b}: GPU and CPU encodes "
                             f"differ")
    # A full block too (block 0, no padding: every dim's ratio terms are
    # live), for its first 2 partition steps (a CPU step takes ~2 s): the
    # index and the conditioned target's and coder's bits after each.
    steps = 2
    t, c, ind, _ = encoded[0]
    t0 = time.perf_counter()
    gpu_steps = itertools.islice(rc.encode_steps(t, c, 321), steps)
    cpu_steps = itertools.islice(RejectionCoder().encode_steps(
        GaussianParams(t.loc.cpu(), t.scale.cpu()),
        GaussianParams(c.loc.cpu(), c.scale.cpu()), 321), steps)
    s = -1
    for s, ((gi, gt, gc), (ci, ct, cc)) in enumerate(zip(gpu_steps,
                                                         cpu_steps)):
        if not (gi == ci == ind[s] and all(
                torch.equal(as_int(g), as_int(h)) for g, h in zip(
                    (gt.loc, gt.scale, gc.loc, gc.scale),
                    (ct.loc, ct.scale, cc.loc, cc.scale)))):
            raise AssertionError(f"rejection block 0, step {s}: GPU and CPU "
                                 f"encodes differ")
    if s != steps - 1:
        raise AssertionError("rejection block 0: fewer steps than compared")
    full_s = time.perf_counter() - t0
    emit({"phase": "rejection_coder", "ok": True, "coder": "RejectionCoder",
          "weights": FRESH, "res_block": group,
          "res_block_kl": kls[group],
          "kl_per_partition": rc.kl_per_partition,
          "sample_buffer": rc.sampler.cfg.sample_buffer_size,
          "r_buffer": rc.sampler.cfg.r_buffer_size,
          "mass_samples": [rc.sampler.cfg.mass_samples,
                           rc.sampler.cfg.oversampling],
          "blocks": blocks,
          "partitions_total": sum(b["partitions"] for b in blocks),
          "encode_s_n9": sum(b["encode_ms"] for b in blocks) / 1e3,
          "decode_s_n9": sum(b["decode_ms"] for b in blocks) / 1e3,
          "gpu_decode_equals_cpu_blocks": len(blocks),
          "gpu_equals_cpu_encode_blocks": 1, "cpu_encode_block": cpu_b,
          "cpu_encode_s": cpu_s,
          "gpu_equals_cpu_full_block_steps": [0, steps],
          "full_block_steps_s": full_s,
          "top_device_ms_last_block": prof["top_device_ms"][:4],
          "peak_allocated_bytes": peak,
          **_no_kernel_launches("rejection_coder")})


def phase_update_sampler():
    """``compression_performance mode=update_sampler`` in-process at its
    defaults (RVAE-24 160/32, block 1000, Omega 3, fresh weights) on 2
    synthetic cifar10 images: seconds and partition updates per image, the
    spillover probability, and that the saved vector is a probability
    vector."""
    from rec_tpu_torch.cli import compression_performance as cp
    from rec_tpu_torch.coding import RejectionSamplerConfig

    root = _lossy_dir("update_sampler")
    _reset_kernel_counts()
    stats, wall_s = _cuda_s(lambda: cp.main([
        "mode=update_sampler", "num_images=2",
        f"model_save_dir={root}/ckpt", f"output_dir={root}/out"]))
    acc = np.load(stats["path"])
    if not (np.all(np.isfinite(acc)) and np.all((acc >= 0) & (acc <= 1))
            and acc.sum() <= 1.0 + 1e-9
            and acc.shape == (RejectionSamplerConfig().r_buffer_size,)):
        raise AssertionError("update_sampler: the saved vector is not a "
                             "probability vector")
    if len(stats["updates"]) != 2 or min(stats["updates"]) < 24:
        raise AssertionError(f"update_sampler: updates {stats['updates']}")
    shutil.rmtree(root)
    emit({"phase": "update_sampler", "ok": True, "weights": FRESH,
          "images": 2, "seconds_per_image": stats["seconds"],
          "partition_updates_per_image": stats["updates"],
          "spillover_probability": stats["spillover_probability"],
          "acceptance_sum": float(acc.sum()),
          "acceptance_max": float(acc.max()),
          "probability_vector": True, "wall_s": wall_s,
          **_no_kernel_launches("update_sampler")})


MNIST_ITERS, MNIST_RESUME_ITERS, MNIST_LOG_FREQ = 200, 210, 100


def phase_mnist_train():
    """``train_generative_model model=vae`` at its defaults (MNISTVAE
    784-300-300-50, batch 8, adam 3e-4, lamb 0, synthetic mnist) for 200
    steps, logging and saving every 100, resumed to 210; steps/s without
    the first step and the log steps, and the device busy share of 10
    profiled steps."""
    from rec_tpu_torch.cli import train_generative_model as tgm
    from rec_tpu_torch.utils.logging import setup_logger

    root = _lossy_dir("mnist_train")
    args = ["model=vae", f"log_freq={MNIST_LOG_FREQ}",
            f"model_save_dir={root}/ckpt", f"log_dir={root}/logs"]
    _reset_kernel_counts()
    stats = tgm.main(args + [f"iters={MNIST_ITERS}"])
    loss = np.asarray(stats["loss"])
    if stats["steps"] != MNIST_ITERS or not np.all(np.isfinite(loss)):
        raise AssertionError(f"mnist_train: {stats['steps']} steps, finite="
                             f"{np.all(np.isfinite(loss))}")
    more = tgm.main(args + [f"iters={MNIST_RESUME_ITERS}"])
    if not (more["restored"] and more["start_step"] == MNIST_ITERS
            and more["final_step"] == MNIST_RESUME_ITERS
            and np.all(np.isfinite(more["loss"]))):
        raise AssertionError(f"mnist_train: resume {more['start_step']} -> "
                             f"{more['final_step']}")
    step_s = stats["seconds"] - stats["first_step_s"] - stats["log_s"]
    cfg = tgm._model_defaults(tgm.Config(
        model="vae", model_save_dir=f"{root}/profile",
        log_dir=f"{root}/logs"), ["model=vae"])
    run = tgm.build(cfg, setup_logger("mnist_profile"))

    def ten_steps():
        for _ in range(10):
            run.state, _ = run.step_fn(run.state, run.batch(), run.noise())

    prof = device_profile(ten_steps)
    shutil.rmtree(root)
    emit({"phase": "mnist_train", "ok": True, "model": "vae",
          "params": sum(p.numel() for p in run.model.parameters()),
          "batch": stats["batch_size"], "steps": stats["steps"],
          "synthetic_data": stats["synthetic"],
          "steps_per_s": (stats["steps"] - 1) / step_s,
          "first_step_s": stats["first_step_s"],
          "log_and_checkpoint_s": stats["log_s"],
          "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
          "resumed_from": more["start_step"],
          "checkpoint_restored": True,
          "profile_10_steps": {k: prof[k] for k in (
              "unprofiled_wall_ms", "device_busy_ms", "device_kernels",
              "top_device_ms")},
          "device_busy_share": prof["device_busy_ms"]
          / prof["unprofiled_wall_ms"],
          **_no_kernel_launches("mnist_train")})


def phase_mnist_emp_bayes():
    """``cli.mnist_emp_bayes`` at the example's defaults (batch 128,
    latents 50, hidden 300, adam 1e-3, synthetic binarized mnist) for 100
    steps of each prior: steps/s without the first step, and a finite
    final loss."""
    from rec_tpu_torch.cli import mnist_emp_bayes as emp

    _reset_kernel_counts()
    runs = {}
    for prior in sorted(emp.PRIORS):
        out = emp.main(["--prior", prior, "--iters", "100",
                        "--log-every", "50"])
        if not (out["steps"] == 100 and out["nan_steps"] == 0
                and math.isfinite(out["final_loss"])):
            raise AssertionError(f"mnist_emp_bayes {prior}: {out}")
        runs[prior] = {k: out[k] for k in ("steps_per_s", "final_loss",
                                           "first_step_s", "seconds")}
    emit({"phase": "mnist_emp_bayes", "ok": True, "batch": 128,
          "steps": 100, **runs, **_no_kernel_launches("mnist_emp_bayes")})


# ---------------------------------------------------------------------------
# PixelCNN and the example entry points.
# ---------------------------------------------------------------------------

PIXEL_SHAPE = (32, 32, 3)
# A drawn value may quantise to another bin on the card than on the CPU
# only this close to a bin edge (in bins): the forwards differ by ~1e-6.
EDGE_TOL = 1e-4
# Largest change allowed where the AR masks forbid one: a cuDNN FFT or
# Winograd algorithm can leave ~1e-8 across exact-zero weights; a wrong
# mask moves outputs by ~1e-2.
AR_LEAK_TOL = 1e-6


def _ar_leak(model, x, r, c, k) -> dict:
    """Largest output change where the AR order forbids one when input
    (r, c, k) of image 0 moves: rows after r, row r right of c (both
    generated before the pixel), and the pixel's own channels <= k."""
    x2 = x.clone()
    x2[0, r, c, k] += 0.5
    with torch.no_grad():
        loc0, ls0 = model(x)
        loc1, ls1 = model(x2)
    leak = {}
    for name, a, b in (("loc", loc0, loc1), ("log_scale", ls0, ls1)):
        d = torch.abs(b - a)[0]
        leak[name] = {"later_rows": float(d[r + 1:].max()),
                      "row_right": float(d[r, c + 1:].max()),
                      "own_channels": float(d[r, c, :k + 1].max()),
                      "earlier_rows_changed": float(d[:r].max())}
    return leak


def _parted(a, b, values, other_values, first_only=False) -> dict:
    """The AR-order steps where two draws of one image part (only the first
    counts when the draws ran on freely after it), and the largest
    distance of either side's value there from a bin edge."""
    from rec_tpu_torch.models.pixel_cnn import edge_distance, parted_steps

    steps = parted_steps(a, b)
    checked = steps[:1] if first_only else steps
    dist = [max(edge_distance(values[i]), edge_distance(other_values[i]))
            for i in checked]
    return {"pixels": int(a.numel()), "differing": len(steps),
            "steps": steps[:8], "max_edge_distance": max(dist, default=0.0)}


def phase_pixel_cnn(dev):
    """``PixelCNN`` at its defaults (60 filters, 5 blocks) on 8 synthetic
    32x32x3 images: data-dependent init, the GPU forward against the CPU
    forward on the same weights, a finite log likelihood, the AR
    property on the card (and exactly on the CPU), and one 32x32x3 sample
    (3,072 steps) from one key, timed, held step by step against the
    CPU's draws given the same earlier pixels (``replay_values``: one CPU
    forward of the GPU's image gives every step's CPU value, bit for bit
    the CPU sampler's, because the masks hide later pixels exactly).  A
    free-running CPU sample, 15 ms a step on the card's host, is held
    against the GPU's at 8x8x3."""
    from rec_tpu_torch.coding import rng
    from rec_tpu_torch.models.pixel_cnn import PixelCNN

    rs = np.random.RandomState(11)
    levels = rs.randint(0, 256, size=(8,) + PIXEL_SHAPE)
    x_cpu = torch.tensor((levels / 256.0 - 0.5).astype(np.float32))
    x = x_cpu.to(dev)
    _reset_kernel_counts()
    model = PixelCNN(PIXEL_SHAPE[-1], device=dev)
    model.data_dependent_init(x)
    cpu = PixelCNN(PIXEL_SHAPE[-1], device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.initialized = True
    with torch.no_grad():
        loc, log_scale = model(x)
        cloc, cls = cpu(x_cpu)
        ll = model.log_likelihood(x).cpu()
    diff = {"loc": float(torch.max(torch.abs(loc.cpu() - cloc))),
            "log_scale": float(torch.max(torch.abs(log_scale.cpu() - cls)))}
    if not (bool(torch.isfinite(ll).all()) and ll.shape == (8,)
            and max(diff.values()) < 1e-4):
        raise AssertionError(f"pixel_cnn: ll {ll}, GPU-vs-CPU {diff}")
    at = (PIXEL_SHAPE[0] // 2, PIXEL_SHAPE[1] // 2, 1)
    leak = _ar_leak(model, x, *at)
    cpu_leak = _ar_leak(cpu, x_cpu, *at)

    def worst(d):
        return max(v for part in d.values() for k, v in part.items()
                   if k != "earlier_rows_changed")

    forward = device_profile(lambda: model(x[:1]))
    if (worst(leak) > AR_LEAK_TOL or worst(cpu_leak) != 0.0
            or leak["loc"]["earlier_rows_changed"] == 0.0):
        raise AssertionError(f"pixel_cnn: AR leak {leak}, CPU {cpu_leak}, "
                             f"kernels {forward['top_device_ms']}")

    steps = int(np.prod(PIXEL_SHAPE))
    (img, values), gpu_s = _cuda_s(lambda: model.sample_values(
        rng.root_key(0, dev), PIXEL_SHAPE))
    if not (img.shape == PIXEL_SHAPE and float(img.min()) >= -0.5
            and float(img.max()) <= 0.5):
        raise AssertionError("pixel_cnn: sample out of range")
    t0 = time.perf_counter()
    rimg, rvalues = cpu.replay_values(rng.root_key(0, "cpu"), img.cpu())
    replay_s = time.perf_counter() - t0
    replay = _parted(img, rimg, values, rvalues)
    if replay["max_edge_distance"] >= EDGE_TOL:
        raise AssertionError(f"pixel_cnn: the CPU's draws part from the "
                             f"GPU's sample away from a bin edge {replay}")

    small = (8, 8, 3)
    key = rng.root_key(1, dev)
    prof = device_profile(lambda: model.sample_values(key, small))
    simg, svalues = model.sample_values(key, small)
    t0 = time.perf_counter()
    cimg, cvalues = cpu.sample_values(rng.root_key(1, "cpu"), small)
    cpu_s = time.perf_counter() - t0
    free = _parted(simg, cimg, svalues, cvalues, first_only=True)
    if free["max_edge_distance"] >= EDGE_TOL:
        raise AssertionError(f"pixel_cnn: 8x8x3 samples part away from a "
                             f"bin edge {free}")
    emit({"phase": "pixel_cnn", "ok": True,
          "filters": model.first_conv.v.shape[0],
          "blocks": model.num_residual_blocks,
          "params": sum(p.numel() for p in model.parameters()),
          "images": 8, "log_likelihood_bpd": float(
              -ll.mean() / (np.prod(PIXEL_SHAPE) * math.log(2.0))),
          "gpu_vs_cpu_max_abs_diff": diff, "ar_leak": leak,
          "ar_leak_max": worst(leak), "ar_leak_max_cpu": worst(cpu_leak),
          "forward_device_kernels": forward["device_kernels"],
          "forward_top_device_ms": forward["top_device_ms"],
          "sample_shape": list(PIXEL_SHAPE), "sample_steps": steps,
          "sample_s": gpu_s, "steps_per_s": steps / gpu_s,
          "cpu_replay_s": replay_s,
          "pixels_equal_cpu_draws": replay["pixels"] - replay["differing"],
          "sample_vs_cpu_draws": replay,
          "sample_8x8x3_vs_cpu_sample": free,
          "cpu_sample_8x8x3_steps_per_s": int(np.prod(small)) / cpu_s,
          "profile_sample_8x8x3": {k: prof[k] for k in (
              "unprofiled_wall_ms", "device_busy_ms", "device_kernels",
              "device_idle_share_estimate")},
          "device_kernels_per_step_8x8x3": prof["device_kernels"]
          / int(np.prod(small)),
          **_no_kernel_launches("pixel_cnn")})


def _demo_dir(name):
    return _lossy_dir(os.path.join("demos", name))


def _demo_blocks(dev, shift):
    """The discrete demo's sweep target at ``shift`` as the coder hands it
    to the kernel: one block of D = 16 (every dim alike, so the split
    permutation moves nothing) under the seed's block key."""
    from rec_tpu_torch.cli import discrete_rec_demo as drd
    from rec_tpu_torch.coding import rng
    from rec_tpu_torch.coding.gauss import GaussianParams

    t = drd.sweep_target(shift, dev)
    t = GaussianParams(t.loc[None], t.scale[None])
    c = GaussianParams(torch.zeros_like(t.loc), torch.ones_like(t.loc))
    bkeys = rng.block_key(rng.root_key(drd.SWEEP_SEED, dev)[None],
                          torch.arange(1, device=dev))
    return t, c, bkeys


def _discrete_demo(dev, rates):
    """``cli.discrete_rec_demo`` on the card against the CPU, and the
    kernel at its shape against the plain version."""
    from rec_tpu_torch.cli import discrete_rec_demo as drd
    from rec_tpu_torch.ops import mega_beam

    _reset_kernel_counts()
    gpu, seconds = _cuda_s(lambda: drd.main([]))
    launches = mega_beam.mega_encode_blocks.launches
    cpu = drd.main(["--device", "cpu"])
    gi, ci = gpu["importance"], cpu["importance"]
    if not (gi["index"] == ci["index"]
            and torch.equal(gi["sample"], ci["sample"])):
        raise AssertionError(f"discrete demo: importance {gi} vs {ci}")
    if launches != len(drd.SHIFTS):
        raise AssertionError(f"discrete demo: {launches} kernel launches")
    rows = []
    for g, c in zip(gpu["sweep"], cpu["sweep"]):
        if not (g["count"] == c["count"] and g["code_bits"] == c["code_bits"]
                and torch.equal(g["indices"], c["indices"])
                and torch.equal(g["sample"], c["sample"])):
            raise AssertionError(f"discrete demo: shift {g['shift']}: GPU "
                                 f"{g} vs CPU {c}")
        rows.append({"kl": g["kl"], "count": g["count"],
                     "code_bits": g["code_bits"]})
    t, c, bkeys = _demo_blocks(dev, drd.SHIFTS[-1])
    case = _mega_beam_case(dev, t, c, bkeys, "fmix", 10, rates, B=8, S=36,
                           P=32, extra_samples=1.2)
    for shift in drd.SHIFTS[:-1]:
        _check_mega_beam(dev, *_demo_blocks(dev, shift), "fmix", 8, 36, 32,
                         1.2)
    return {"seconds": seconds, "launches": launches,
            "importance_index": gi["index"], "sweep": rows,
            "kernel_n1_d16": case}


def _aggregate(out_dir) -> dict:
    """``examples/lossless/data_aggregation.py`` (numpy only, shared with
    rec_tpu) in its own process over a grid of two cells: the compress
    phase's CSV as (Omega 3, B 20, extra 1.2) and an empty (5, 10, 1.2)
    cell, against the CSV's own means."""
    src = sorted(f for f in os.listdir(out_dir) if f.endswith(".csv"))
    if len(src) != 1:
        raise AssertionError(f"demos: compress CSVs {src} in {out_dir}")
    root = _demo_dir("grid")
    cell = os.path.join(root, "omega_3.0_beams_20_extra_1.2")
    os.makedirs(cell)
    os.makedirs(os.path.join(root, "omega_5.0_beams_10_extra_1.2"))
    shutil.copy(os.path.join(out_dir, src[0]), cell)
    with open(os.path.join(cell, src[0])) as f:
        rows = list(csv.DictReader(f))
    out = os.path.join(root, "aggregated")
    subprocess.run(
        [sys.executable, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "examples",
            "lossless", "data_aggregation.py"),
         "--root", root, "--expected-images", str(len(rows)), "--out", out],
        check=True, capture_output=True, text=True, timeout=120)
    grids = {m: np.load(os.path.join(out, f"{m}_extra_1.2.npy"))
             for m in ("overhead", "runtime", "crashes")}
    overhead = np.mean([float(r["total_bits_per_dim"])
                        - float(r["ideal_elbo_bpd"]) for r in rows])
    runtime = np.mean([float(r["comp_time"]) for r in rows])
    ok = (all(g.shape == (2, 2) for g in grids.values())
          and np.isclose(grids["overhead"][0, 1], overhead, rtol=1e-12)
          and np.isclose(grids["runtime"][0, 1], runtime, rtol=1e-12)
          and grids["crashes"][0, 1] == 0
          and grids["crashes"][1, 0] == len(rows)
          and np.isnan(grids["overhead"][1, 0])
          and np.isnan(grids["overhead"][0, 0]))
    shutil.rmtree(root)
    if not ok:
        raise AssertionError(f"demos: aggregated grids {grids}")
    return {"cells": 2, "images": len(rows),
            "overhead_bits_per_dim": float(grids["overhead"][0, 1]),
            "runtime_s": float(grids["runtime"][0, 1])}


def phase_demos(dev, rates, out_dir):
    """The four example entry points on the card: ``discrete_rec_demo``
    (GPU against CPU, the kernel at N=1, D=16 against its plain version),
    ``snis_mog`` at its defaults, ``astar_sampling_demo`` at 200 samples
    and ``examples/lossless/data_aggregation.py`` over the compress
    phase's CSV."""
    from rec_tpu_torch.cli import astar_sampling_demo as astar
    from rec_tpu_torch.cli import snis_mog

    demo = _discrete_demo(dev, rates)
    emit({"phase": "demos", "ok": True, "demo": "discrete_rec_demo",
          **demo})
    _reset_kernel_counts()
    snis_dir = _demo_dir("snis_mog")
    snis, snis_s = _cuda_s(lambda: snis_mog.main(["--out", snis_dir]))
    if not (snis["exact"] and np.all(np.isfinite(snis["losses"]))
            and os.path.exists(os.path.join(snis_dir, "density.npy"))):
        raise AssertionError(f"snis_mog: exact {snis['exact']}")
    shutil.rmtree(snis_dir)
    emit({"phase": "demos", "ok": True, "demo": "snis_mog",
          "steps": snis["steps"], "steps_per_s": snis["steps_per_s"],
          "train_s": snis["seconds"], "total_s": snis_s,
          "nll_first": float(snis["losses"][0]),
          "final_nll": snis["final_nll"], "index": snis["index"],
          "decode_exact": snis["exact"]})
    star = astar.main(["--samples", "200"])
    emit({"phase": "demos", "ok": True, "demo": "astar_sampling_demo",
          "samples": len(star["samples"]), "seconds": star["seconds"],
          "mean": star["mean"],
          "true_mean": star["true_mean"], "se": star["se"],
          "var": star["var"], "moment_check": star["ok"]})
    t0 = time.perf_counter()
    agg = _aggregate(out_dir)
    emit({"phase": "demos", "ok": True, "demo": "data_aggregation",
          "seconds": time.perf_counter() - t0, **agg,
          **_no_kernel_launches("snis_mog, astar, data_aggregation")})
    return demo["launches"], demo["kernel_n1_d16"]


# ---------------------------------------------------------------------------
# Several devices in one process (ROADMAP A3): the sharded block codec,
# both serving CLIs over a mesh and the data-parallel trainer.  Each runs
# over every visible card and, where one card is visible, over a mesh that
# lists cuda:0 more than once (its shards then take turns on that card).
# ---------------------------------------------------------------------------

def _mesh_info(mesh) -> dict:
    return {"mesh": [str(d) for d in mesh], "repeats": mesh.repeats}


def phase_sharded_codec(dev):
    """``parallel.sharded_encode_blocks`` on one 72-block latent (the
    flagship serving batch's block count at its ~14 partitions per block;
    B = 20, S = 36, budget 24, fmix) over every visible card,
    ``[cuda:0] * 2`` and ``[cuda:0] * 5`` (72 blocks pad to 75): indices,
    counts and sample bitwise the one-card ``coder.encode``'s, one
    beam-search launch per entry on its card, ``sharded_decode_blocks``
    bitwise the encode's sample; wall ms per encode (3 after a warm-up).
    Returns the launches of the timed encodes."""
    from rec_tpu_torch.coding import BeamSearchCoder
    from rec_tpu_torch.ops import mega_beam
    from rec_tpu_torch.parallel import (Mesh, make_mesh,
                                        sharded_decode_blocks,
                                        sharded_encode_blocks)

    from rec_tpu_torch.coding.gauss import GaussianParams

    card0 = torch.device("cuda", 0)
    coder = BeamSearchCoder(n_beams=MAIN["B"], extra_samples=1.2,
                            block_size=MAIN["D"], max_partitions=MAIN["P"])
    # ~0.04 nats per dim against the standard normal: ~14 partitions per
    # block, near the fresh RVAE-24's need (the split permutation mixes
    # every block's dims, so each block gets the latent's mean KL).
    rs = np.random.RandomState(5)
    shape = (72, MAIN["D"])
    t = GaussianParams(
        torch.tensor(rs.randn(*shape) * 0.25, dtype=torch.float32,
                     device=card0),
        torch.tensor(np.exp(rs.randn(*shape) * 0.1), dtype=torch.float32,
                     device=card0))
    c = GaussianParams(torch.zeros(shape, device=card0),
                       torch.ones(shape, device=card0))
    want = coder.encode(t, c, 42)
    one_ms = _cuda_s(lambda: coder.encode(t, c, 42))[1] * 1e3
    meshes = {"visible": make_mesh(), "repeat2": Mesh([card0] * 2),
              "repeat5": Mesh([card0] * 5)}
    rows, launches = {}, 0
    for name, mesh in meshes.items():
        sharded_encode_blocks(coder, t, c, 42, mesh)   # warm-up
        _reset_kernel_counts()
        mega_beam.mega_encode_blocks.launches_by_device.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            got = sharded_encode_blocks(coder, t, c, 42, mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        n = mega_beam.mega_encode_blocks.launches
        by_card = dict(mega_beam.mega_encode_blocks.launches_by_device)
        want_by_card = {str(d): 3 * sum(e == d for e in mesh)
                        for d in set(mesh)}
        if n != 3 * len(mesh) or by_card != want_by_card:
            raise AssertionError(f"sharded_codec {name}: launches {by_card}"
                                 f", expected {want_by_card}")
        launches += n
        if not (torch.equal(got.indices, want.indices)
                and torch.equal(got.counts, want.counts)
                and torch.equal(got.sample.view(torch.int32),
                                want.sample.view(torch.int32))):
            raise AssertionError(f"sharded_codec {name}: differs from the "
                                 f"one-card encode")
        dec = sharded_decode_blocks(coder, c, want.indices, want.counts, 42,
                                    mesh)
        if not torch.equal(dec.view(torch.int32),
                           want.sample.view(torch.int32)):
            raise AssertionError(f"sharded_codec {name}: decode differs")
        rows[name] = {**_mesh_info(mesh), "encode_ms": ms,
                      "launches_per_encode_by_card":
                          {k: v // 3 for k, v in by_card.items()},
                      "bitwise_equal": True}
    emit({"phase": "sharded_codec", "ok": True, "blocks": 72,
          "one_card_encode_ms": one_ms,
          "mean_count": float(want.counts.float().mean()), **rows})
    return launches


def _same_outputs(a, b) -> bool:
    """Bitwise equality of two output trees (dicts, lists, tuples of
    tensors), compared on the host."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu().view(torch.int32) if a.is_floating_point()
                           else a.cpu(),
                           b.cpu().view(torch.int32) if b.is_floating_point()
                           else b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_outputs(a[k], b[k])
                                            for k in a)
    return len(a) == len(b) and all(_same_outputs(x, y) for x, y in zip(a, b))


def _rec_bytes(out_dir) -> dict:
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir)) if f.endswith(".rec")}


def _serve_two_ways(main, name, n_cards, images, *args):
    """A serving CLI in-process over every visible card (``n_devices=0``,
    the default batch of 8 padded to a multiple of the cards), then on each
    card alone at the per-card batch: every file verified, and each file
    byte-identical to the one its card wrote alone.  Returns the mesh run's
    stats, the cuda:0 run's, the mesh run's launches by card, its wall s
    and how many of its files also equal the cuda:0 run's (rows of other
    cards: whether two cards compute the same bits)."""
    from rec_tpu_torch.ops import mega_beam

    root = _lossy_dir(name)
    common = [f"num_images={images}", *args,
              f"model_save_dir={os.path.join(root, 'ckpt')}"]
    _reset_kernel_counts()
    mega_beam.mega_encode_blocks.launches_by_device.clear()
    mesh_stats, wall_s = _cuda_s(lambda: main(
        common + ["n_devices=0", f"output_dir={root}/mesh"]))
    by_card = dict(mega_beam.mega_encode_blocks.launches_by_device)
    batch = -(-8 // n_cards) * n_cards
    per = batch // n_cards
    alone, stats = {}, {}
    for k in range(n_cards):
        stats[k] = main(common + [f"device=cuda:{k}", f"batch_size={per}",
                                  f"output_dir={root}/card{k}"])
        alone[k] = _rec_bytes(f"{root}/card{k}")
    mine = _rec_bytes(f"{root}/mesh")
    owner = {f: (int(f[4:-4]) % batch) // per for f in mine}
    differ = sorted(f for f in mine if mine[f] != alone[owner[f]].get(f))
    if len(mine) != images or differ:
        raise AssertionError(f"{name}: {len(mine)} files; differ from their "
                             f"card's own run: {differ}")
    same_as_card0 = sum(mine[f] == alone[0][f] for f in mine)
    shutil.rmtree(root)
    return mesh_stats, stats[0], by_card, wall_s, same_as_card0


def phase_multi_card_serve(dev, serve_rate):
    """Serving over several devices.  At two or more visible cards,
    ``cli.serve`` at its defaults (RVAE-24, 16 images, batch 8, verify on)
    with ``n_devices=0`` (every card), then ``cli.lossy_serve`` the same way
    (16 images, so that a batch after the first gives a rate): every file
    verified and byte-identical to the file its card writes serving alone
    at the per-card batch (``_serve_two_ways``), launches on every card,
    images/s beside the one-card rates.  At one visible card the same check
    through ``make_batch_compress`` and ``make_batch_rec_forward`` over
    ``[cuda:0] * 2`` (the serving CLIs take real cards only): the outputs
    bitwise those of one device at the per-entry batch of 4.  Returns the
    mega_beam launches of the mesh runs."""
    from rec_tpu_torch.cli import lossy_serve, serve
    from rec_tpu_torch.ops import mega_beam
    from rec_tpu_torch.parallel import (Mesh, make_batch_compress,
                                        make_batch_rec_forward, make_mesh)
    from rec_tpu_torch.parallel.batch import _join_rows

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        lossless = _serve_two_ways(serve.main, "multi_card_serve", n_cards,
                                   16)
        lossy = _serve_two_ways(lossy_serve.main, "multi_card_lossy_serve",
                                n_cards, 16)
        rows = {}
        for label, (mesh_stats, one_stats, by_card, wall_s, same0) in (
                ("serve", lossless), ("lossy_serve", lossy)):
            if set(by_card) != {str(d) for d in make_mesh()}:
                raise AssertionError(f"multi_card_serve {label}: launches "
                                     f"by card {by_card}")
            rows[label] = {
                "mesh": mesh_stats["mesh"], "images": mesh_stats["images"],
                "files_byte_identical_to_own_card_alone": True,
                "files_equal_to_cuda0_alone": same0,
                "images_per_s": mesh_stats["images_per_s"],
                "images_per_s_per_card":
                    mesh_stats["images_per_s_per_device"],
                "cuda0_per_card_batch_images_per_s":
                    one_stats["images_per_s"],
                "launches_by_card": by_card, "wall_s": wall_s}
        rows["serve"]["one_card_batch8_images_per_s"] = serve_rate
        emit({"phase": "multi_card_serve", "ok": True, "cards": n_cards,
              "route": "cli", **rows})
        return sum(sum(r["launches_by_card"].values()) for r in rows.values())
    # One card: the mesh lists it twice.
    from rec_tpu_torch.cli.compress_with_lossy_model import make_model
    from rec_tpu_torch.data.datasets import (DatasetConfig, load_images,
                                             normalize)

    card0 = torch.device("cuda", 0)
    mesh = Mesh([card0] * 2)
    cfg = dataclasses.replace(serve.Config(),
                              model_save_dir=_lossy_dir("multi_card_ckpt"))
    coder = serve.build_coder(cfg)
    images = normalize(load_images(cfg.dataset)[0], "centered")[:8].astype(
        np.float32)
    model, _ = serve.load_model(cfg, coder, images[:1], card0)
    lossy_cfg = lossy_serve.Config()
    lossy_model = make_model(lossy_cfg.model, serve.build_coder(lossy_cfg),
                             lossy_cfg.seed, card0, 0, 0).requires_grad_(False)
    lossy_images = normalize(load_images(DatasetConfig(
        dataset="clic2019", split="test", normalize="unit"))[0][:8],
        "unit").astype(np.float32)
    seeds = 42 + 101 * np.arange(8)
    rows, launches = {}, 0
    for label, make, m, x in (
            ("serve", make_batch_compress, model, images),
            ("lossy_serve", make_batch_rec_forward, lossy_model,
             lossy_images)):
        sharded, alone = make(m, mesh), make(m)
        sharded(x, seeds)   # warm-up: cuDNN's plans at batch 4
        alone(x, seeds)
        _reset_kernel_counts()
        out, wall_s = _cuda_s(lambda: sharded(x, seeds))
        n = mega_beam.mega_encode_blocks.launches
        per_entry = n // len(mesh)
        launches += n
        joined = _join_rows([alone(x[i:i + 4], seeds[i:i + 4])
                             for i in (0, 4)])
        if not _same_outputs(out, joined):
            raise AssertionError(f"multi_card_serve {label}: differs from "
                                 f"one device at batch 4")
        if n == 0 or n % len(mesh):
            raise AssertionError(f"multi_card_serve {label}: {n} launches")
        _, one_s = _cuda_s(lambda: alone(x, seeds))
        rows[label] = {**_mesh_info(mesh), "images": 8,
                       "outputs_bitwise_equal_to_batch4": True,
                       "launches_per_entry": per_entry,
                       "sharded_batch_s": wall_s, "one_device_batch8_s": one_s}
    emit({"phase": "multi_card_serve", "ok": True, "cards": n_cards,
          "route": "make_batch over a repeated card", **rows})
    return launches


DP_TRAIN_STEPS, DP_TRAIN_RTOL = 10, 1e-5


def phase_dp_train():
    """``train_generative_model`` at its defaults (RVAE-24, batch 8) for 10
    steps, data parallel over every visible card, or at one visible card
    over ``[cuda:0] * 2`` through ``build``'s mesh, against the one-card
    run on the same batches and noise: each step's loss within
    DP_TRAIN_RTOL (the largest relative gap is printed); two data-parallel
    runs from one seed bitwise equal in losses and checkpoint bytes;
    steps/s of both (the first step and the log steps left out)."""
    from rec_tpu_torch.cli import train_generative_model as tgm
    from rec_tpu_torch.parallel import Mesh, make_mesh
    from rec_tpu_torch.utils.logging import setup_logger

    card0 = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    mesh = make_mesh() if n_cards >= 2 else Mesh([card0] * 2)
    root = _lossy_dir("dp_train")
    log = setup_logger("dp_train")

    def run(name, device, use_mesh):
        argv = [f"iters={DP_TRAIN_STEPS}", f"log_freq={DP_TRAIN_STEPS}",
                f"model_save_dir={root}/{name}/ckpt",
                f"log_dir={root}/{name}/logs", f"device={device}"]
        cfg = tgm._model_defaults(tgm.apply_overrides(tgm.Config(), argv),
                                  argv)
        trainer = tgm.build(cfg, log, mesh=mesh if use_mesh else None)
        stats = tgm.train(cfg, trainer, log)
        stats["steps_per_s"] = (stats["steps"] - 1) / (
            stats["seconds"] - stats["first_step_s"] - stats["log_s"])
        with open(stats["checkpoint"], "rb") as f:
            stats["checkpoint_bytes"] = f.read()
        return stats

    _reset_kernel_counts()
    one = run("one", "cuda:0", False)
    a = run("dp_a", "cuda", True)
    b = run("dp_b", "cuda", True)
    shutil.rmtree(root)
    la, lo = np.asarray(a["loss"]), np.asarray(one["loss"])
    rel = float(np.max(np.abs(la - lo) / np.abs(lo)))
    if not (np.all(np.isfinite(la)) and rel <= DP_TRAIN_RTOL):
        raise AssertionError(f"dp_train: losses {la.tolist()} against one "
                             f"card's {lo.tolist()} (rel {rel})")
    if (a["loss"] != b["loss"]
            or a["checkpoint_bytes"] != b["checkpoint_bytes"]):
        raise AssertionError("dp_train: two runs from one seed differ")
    emit({"phase": "dp_train", "ok": True, **_mesh_info(mesh),
          "cards": n_cards, "batch": a["batch_size"],
          "steps": DP_TRAIN_STEPS, "loss_max_rel_gap_to_one_card": rel,
          "rtol": DP_TRAIN_RTOL, "bitwise_repeatable": True,
          "checkpoint_bytes": len(a["checkpoint_bytes"]),
          "steps_per_s": a["steps_per_s"],
          "one_card_steps_per_s": one["steps_per_s"],
          "loss_first": float(la[0]), "loss_last": float(la[-1]),
          **_no_kernel_launches("dp_train")})


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if argv:
        raise SystemExit("usage: python3 chip_smoke.py (no arguments)")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    ptxas = timed("build", phase_build)
    rates = card_rates()
    emit({"phase": "card", "ok": True, **rates})
    timed("normal_map", phase_normal_map, dev)
    kern = timed("kernel", phase_kernel, dev, rates)
    score = timed("beam_score", phase_beam_score, dev)
    timed("coder", phase_coder, dev)
    timed("flagship", phase_flagship, dev)
    serve_launches, n72, serve_rate = timed("serve", phase_serve, dev,
                                            rates)
    timed("profile", phase_profile, dev)
    timed("scan_dispatch", phase_scan_dispatch, dev)
    save_dir, out_dir = _lossless_dirs()
    timed("initialize", phase_initialize, save_dir, out_dir)
    launches = {"serve": serve_launches,
                **timed("compress", phase_compress, save_dir, out_dir)}
    timed("importance_coder", phase_importance_coder, dev)
    timed("importance_compress", phase_importance_compress, dev, save_dir,
          out_dir)
    for name, option in SERVE_VARIANTS:
        timed(name, phase_serve_variant, name, option, serve_rate)
    timed("rejection_coder", phase_rejection_coder, dev)
    timed("update_sampler", phase_update_sampler)
    timed("mnist_train", phase_mnist_train)
    timed("mnist_emp_bayes", phase_mnist_emp_bayes)
    timed("pixel_cnn", phase_pixel_cnn, dev)
    launches["discrete_rec_demo"], demo_case = timed(
        "demos", phase_demos, dev, rates, out_dir)
    launches["sharded_codec"] = timed("sharded_codec", phase_sharded_codec,
                                      dev)
    launches["multi_card_serve"] = timed(
        "multi_card_serve", phase_multi_card_serve, dev, serve_rate)
    timed("dp_train", phase_dp_train)
    train_dir, train_rate = timed("train", phase_train)
    launches["train_compress"] = timed("train_compress",
                                       phase_train_compress, train_dir)
    lossy_cases = timed("lossy_kernel", phase_lossy_kernel, dev, rates)
    lossy = lossy_cases["compress_n302"]
    launches["lossy_compress"] = timed("lossy_compress",
                                       phase_lossy_compress, dev)
    launches["lossy_serve"] = timed("lossy_serve", phase_lossy_serve, dev)
    lossy_train_dir = timed("lossy_train", phase_lossy_train)
    launches["lossy_train_compress"] = timed(
        "lossy_train_compress", phase_lossy_train_compress, lossy_train_dir)
    timed("lossy4_train", phase_lossy4_train)
    launches["lossy4_compress"] = timed("lossy4_compress",
                                        phase_lossy4_compress, dev)
    launches["lossy4_serve"] = timed("lossy4_serve", phase_lossy4_serve, dev)
    large_cases = timed("large_kernel", phase_large_kernel, dev, rates)
    launches["large_compress"], launches["large_tile"] = timed(
        "large_initialize_compress_tile", phase_large_compress, dev)
    large_train_dir = timed("large_train", phase_large_train)
    launches["large_train_compress"] = timed(
        "large_train_compress", phase_large_train_compress, large_train_dir)
    launches["iaf_train_compress"] = timed(
        "iaf_train_compress", phase_iaf_train_compress, train_rate)
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    if min(launches.values()) <= 0 or score["launches"] <= 0:
        raise AssertionError("a path launched no kernel")
    emit({"kernels": [{
        "name": "mega_beam",
        "route": "cuda",
        "source": "rec_tpu_torch/csrc/mega_beam.cu",
        "replaces": "rec_tpu/ops/mega_beam.py:73",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max([n72["max_abs_err"], demo_case["max_abs_err"]]
                           + [c["max_abs_err"] for c in (
                               *lossy_cases.values(),
                               *large_cases.values())]),
        "ms": n72["ms"],
        "plain_ms": n72["plain_ms"],
        "bound_ms": n72["bound_ms"],
        "bound_by": n72["bound_by"],
        "library_ms": None,
        "bound_ops_ms": n72["bound_ops_ms"],
        "bound_int_ms": n72["bound_int_ms"],
        "bound_bytes_ms": n72["bound_bytes_ms"],
        "agreement": n72["agreement"],
        "blocks": n72["blocks"],
        "ms_single_image_n9": kern["fmix"]["ms"],
        "bound_ms_single_image_n9": kern["fmix"]["bound_ms"],
        "ms_lossy_n302_b10_s20": lossy["ms"],
        "plain_ms_lossy_n302_b10_s20": lossy["plain_ms"],
        "bound_ms_lossy_n302_b10_s20": lossy["bound_ms"],
        "bound_by_lossy_n302_b10_s20": lossy["bound_by"],
        "agreement_lossy_n302_b10_s20": lossy["agreement"],
        "ms_lossy_saturated_n302": lossy_cases["saturated_n302"]["ms"],
        "bound_ms_lossy_saturated_n302":
            lossy_cases["saturated_n302"]["bound_ms"],
        **{f"{k}_demo_n1_d16_b8_p32": demo_case[k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "agreement",
                     "max_abs_err", "counts")},
        "ms_lossy_serve_n408_p32": lossy_cases["serve_n408"]["ms"],
        "bound_ms_lossy_serve_n408_p32":
            lossy_cases["serve_n408"]["bound_ms"],
        **{f"{k}_large_{name}": case[k]
           for name, case in large_cases.items()
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "agreement",
                     "blocks", "P")},
        "grid": n72["grid"],
        "ptxas": [{k: v for k, v in r.items() if k != "function"}
                  for r in ptxas["mega_beam"]],
    }, {
        "name": "beam_score",
        "route": "cuda",
        "source": "rec_tpu_torch/csrc/beam_score.cu",
        "replaces": "rec_tpu/ops/beam_score.py:53",
        "launches": score["launches"],
        "max_abs_err": max(score["max_abs_err"], score["path_max_abs_err"]),
        "ms": score["ms"],
        "plain_ms": score["plain_ms"],
        "bound_ms": score["bound_ms"],
        "bound_by": "bytes",
        "library_ms": score["library_ms"],
        "call_ms": score["call_ms"],
        "floor_ms": score["floor_ms"],
        "share_of_bound": score["share_of_bound"],
        "grid": score["grid"],
        "max_rel_err": max(score["max_rel_err"], score["path_max_rel_err"]),
        "path_max_rel_err": score["path_max_rel_err"],
        "ptxas": [{k: v for k, v in r.items() if k != "function"}
                  for r in ptxas["beam_score"]],
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
