"""The controls and the planted faults that ``correct`` has to catch, as
context managers for ``run.run_cell(..., around=...)``: each wraps the
program's set-up and window only, so the reference judges unchanged.

* ``tf32``: the program with TF32 on in cuDNN and cuBLAS, the step below
  the float32 the configurations state (the port pins TF32 off in
  ``device.set_deterministic``; this switches it back on under it).
* ``bf16``: the program's convolutions in bfloat16 (the CPU has no TF32;
  the tests' stand-in for the same fault).
* faults: ``beams1`` (the beam search keeps one beam, B = 1),
  ``prior`` (the encoder codes the prior in the posterior's place),
  ``index`` (a coded index altered where the batch encode produces
  it), ``residual`` (a residual byte altered where it is produced),
  ``half_batch`` (the batch encode runs on half the batch and repeats its
  outputs for the rest), ``shard`` (the join of a sharded batch keeps the
  first entry's outputs for every entry), and for training ``frozen`` (a
  step that returns its state unchanged) and ``half_loss`` (the loss taken
  over half the batch).

On the card, ``python3 benchmark/tests/planted.py --workload <cell>
--runs none=1,2,3 tf32=4,5,6 --seconds <s>`` prints each run's line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def tf32():
    import rec_tpu_torch.device as device_mod
    import rec_tpu_torch.models.lossy.base as lossy_base
    import rec_tpu_torch.models.resnet_vae as rvae

    pinned = device_mod.set_deterministic

    def loose():
        pinned()
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    with contextlib.ExitStack() as st:
        for mod in (device_mod, rvae, lossy_base):
            st.enter_context(_patched(mod, "set_deterministic", loose))
        loose()
        try:
            yield
        finally:
            pinned()


@contextlib.contextmanager
def bf16():
    conv = F.conv2d

    def low(x, w, *args, **kw):
        args = [a.bfloat16() if isinstance(a, torch.Tensor) else a
                for a in args]
        return conv(x.bfloat16(), w.bfloat16(), *args, **kw).float()

    with _patched(F, "conv2d", low):
        yield


def _encode_blocks(alter):
    """Patch the coder's block encode; ``alter(coder, targets, coders,
    bkeys, ratios, encode)`` returns its result."""
    from rec_tpu_torch.coding.coder import BeamSearchCoder

    encode = BeamSearchCoder._encode_blocks

    def patched(self, targets, coders, bkeys, ratios):
        return alter(self, targets, coders, bkeys, ratios, encode)

    return _patched(BeamSearchCoder, "_encode_blocks", patched)


@contextlib.contextmanager
def beams1():
    from rec_tpu_torch.coding import beam_search

    def alter(coder, targets, coders, bkeys, ratios, encode):
        cfg = dataclasses.replace(coder._cfg(), n_beams=1)
        return beam_search.encode_blocks(cfg, targets, coders, bkeys, ratios)

    with _encode_blocks(alter):
        yield


@contextlib.contextmanager
def prior():
    def alter(coder, targets, coders, bkeys, ratios, encode):
        return encode(coder, coders, coders, bkeys, ratios)

    with _encode_blocks(alter):
        yield


def _wrap_compress(alter):
    """Patch the serving driver's batch encode; ``alter(images, seeds,
    encode)`` returns the outputs."""
    from benchlib import lossless_serve

    setup = lossless_serve.Driver.setup

    def patched(self):
        setup(self)
        encode = self.compress
        self.compress = lambda images, seeds: alter(images, seeds, encode)

    return _patched(lossless_serve.Driver, "setup", patched)


@contextlib.contextmanager
def index():
    def alter(images, seeds, encode):
        out = encode(images, seeds)
        ind = out["indices"].clone()
        ind[0, 0, 0, 0] = 0 if ind[0, 0, 0, 0] else 1
        out["indices"] = ind
        return out

    with _wrap_compress(alter):
        yield


@contextlib.contextmanager
def half_batch():
    def alter(images, seeds, encode):
        half = len(seeds) // 2
        out = encode(images[:half], seeds[:half])
        return {k: torch.cat([v, v]) for k, v in out.items()}

    with _wrap_compress(alter):
        yield


@contextlib.contextmanager
def shard():
    import rec_tpu_torch.parallel.batch as batch

    join = batch._join_rows

    def first_only(parts):
        return join([parts[0]] * len(parts))

    with _patched(batch, "_join_rows", first_only):
        yield


@contextlib.contextmanager
def residual():
    from benchlib import lossless_serve

    setup = lossless_serve.Driver.setup

    def patched(self):
        setup(self)
        encode = self.encode_residual

        def altered(*args, **kw):
            payload, n = encode(*args, **kw)
            return payload[:-1] + bytes([payload[-1] ^ 0x5A]), n

        self.encode_residual = altered

    with _patched(lossless_serve.Driver, "setup", patched):
        yield


@contextlib.contextmanager
def frozen():
    import rec_tpu_torch.train.lossless as lossless

    def make(model, cfg, optimizer, num_pixels, mesh=None):
        def step_fn(state, images, noise):
            _, metrics = lossless.objective(model, cfg, state, images, noise,
                                            num_pixels)
            return state._replace(step=state.step + 1), metrics

        return step_fn

    with _patched(lossless, "make_train_step", make):
        yield


@contextlib.contextmanager
def half_loss():
    import rec_tpu_torch.train.lossless as lossless

    objective = lossless.objective

    def half(model, cfg, state, images, noise, num_pixels):
        b = images.shape[0] // 2
        return objective(model, cfg, state, images[:b], noise[:, :b],
                         num_pixels)

    with _patched(lossless, "objective", half):
        yield


CONTROLS = {"tf32": tf32, "bf16": bf16, "beams1": beams1, "prior": prior,
            "index": index,
            "half_batch": half_batch, "shard": shard, "residual": residual,
            "frozen": frozen, "half_loss": half_loss,
            "none": contextlib.nullcontext}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", nargs="+", required=True,
                    help="<control>=<seed>,<seed>,... per control")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.dirname(HERE), os.getcwd()]
    import run

    for group in args.runs:
        control, seeds = group.split("=")
        for seed in [int(s) for s in seeds.split(",")]:
            t0 = time.perf_counter()
            line = run.run_cell(os.getcwd(), args.workload, seed,
                                args.seconds, False,
                                around=CONTROLS[control])
            print(json.dumps({"control": control, "seed": seed,
                              "correct": line["correct"],
                              "checks": line["checks"],
                              "window_step": line.get("window_step"),
                              "units": line["units_in_window"],
                              "metrics": line["metrics"],
                              "run_s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
