"""The port's three example entry points (``rec_tpu_torch.cli.
{discrete_rec_demo,snis_mog,astar_sampling_demo}``) against the JAX
examples on JAX-CPU, in-process, at small sizes; and the shared
``examples/lossless/data_aggregation.py`` (numpy only) over the port's
compress CSVs.

Tolerances: the discrete demo's indices, counts, code bits and samples
are bitwise, and its printed lines equal; snis_mog's per-step losses rtol
1e-4 over 20 adam steps (float32 sums in another order, compounded by the
steps) and its density grid atol 1e-4 (sums of ~10 terms of up to ~2 in
magnitude), its coded index and sample bitwise; the A* log ratio atol
1e-5 on a 1,000-point grid over the search range (float32; the same
operations as XLA-CPU's, the logsumexp in another order), each A* sample
within 1e-5 (the same host draws; a bound that rounds differently only
reorders near-tied regions); the aggregated grid cells equal the CSV's
own means within rtol 1e-12 (float64 means of the same numbers).
"""

import csv
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JBeamSearchCoder
from rec_tpu.coding import GaussianParams as JGaussianParams
from rec_tpu.coding.importance import (
    encode_gaussian_importance_sample as j_encode_importance)
from rec_tpu.models import mnist_vae as jm
from rec_tpu_torch.cli import astar_sampling_demo as tastar
from rec_tpu_torch.cli import compression_performance as tcp
from rec_tpu_torch.cli import discrete_rec_demo as tdemo
from rec_tpu_torch.cli import snis_mog as tsnis
from rec_tpu_torch.models import mnist_convert
from rec_tpu_torch.models import mnist_vae as tm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNIS_RTOL = 1e-4       # per-step loss, 20 adam steps
GRID_ATOL = 1e-4       # unnormalised log density on the 100 x 100 grid
RATIO_ATOL = 1e-5      # A* log ratio
ASTAR_ATOL = 1e-5      # A* samples


def _example(relpath):
    path = os.path.join(REPO, "examples", relpath)
    name = "example_" + relpath.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# discrete_rec_demo
# ---------------------------------------------------------------------------

def test_discrete_demo_prints_the_examples_lines(capsys):
    ex = _example("discrete_rec_demo.py")
    ex.single_partition_demo()
    ex.kl_sweep()
    want = capsys.readouterr().out
    tdemo.main(["--device", "cpu"])
    assert capsys.readouterr().out == want


def test_discrete_demo_matches_jax():
    """The importance index and sample, and each sweep row's indices,
    counts and code bits, equal rec_tpu's on the example's inputs."""
    got = tdemo.main(["--device", "cpu"])
    target = JGaussianParams(jnp.asarray([1.2, -0.4], jnp.float32),
                             jnp.asarray([0.3, 0.5], jnp.float32))
    coder = JGaussianParams(jnp.zeros(2, jnp.float32),
                            jnp.ones(2, jnp.float32))
    imp = got["importance"]
    idx, sample = j_encode_importance(target, coder, jax.random.PRNGKey(0),
                                      imp["bits"])
    assert imp["index"] == int(idx)
    np.testing.assert_array_equal(imp["sample"].numpy(), np.asarray(sample))

    bsc = JBeamSearchCoder(kl_per_partition=3.0, n_beams=8,
                           extra_samples=1.2, block_size=None,
                           max_partitions=32)
    coder = JGaussianParams(jnp.zeros(16, jnp.float32),
                            jnp.ones(16, jnp.float32))
    assert [r["shift"] for r in got["sweep"]] == list(tdemo.SHIFTS)
    for row in got["sweep"]:
        target = JGaussianParams(jnp.full(16, row["shift"], jnp.float32),
                                 jnp.full(16, 0.7, jnp.float32))
        out = bsc.encode(target, coder, seed=1)
        assert row["count"] == int(out.counts[0])
        np.testing.assert_array_equal(row["indices"].numpy(),
                                      np.asarray(out.indices))
        np.testing.assert_array_equal(row["sample"].numpy(),
                                      np.asarray(out.sample))
        want_bits = float(bsc.codelength_nats(out)) / float(np.log(2.0))
        assert row["code_bits"] == want_bits
    assert [r["count"] for r in got["sweep"]] == [1, 2, 4, 7]


# ---------------------------------------------------------------------------
# snis_mog
# ---------------------------------------------------------------------------

SNIS_K, SNIS_H, SNIS_B, SNIS_ITERS, SNIS_LR = 9, 8, 16, 20, 3e-4


class _Recorder:
    """Wraps jax.random.normal and keeps the draws of one shape."""

    def __init__(self, shape):
        self.shape, self.draws = shape, []
        self.normal = jax.random.normal

    def __call__(self, key, shape=(), *args, **kw):
        out = self.normal(key, shape, *args, **kw)
        if tuple(shape) == self.shape:
            self.draws.append(np.array(out))
        return out


def _jax_snis_run(monkeypatch):
    """examples/snis_mog.py's training loop for SNIS_ITERS steps: its
    initial and final params, per-step losses, batches and the SNIS
    proposals each step drew inside flax's apply."""
    ex = _example("snis_mog.py")
    model = jm.SNISDistribution(dim=2, K=SNIS_K, hidden=SNIS_H)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "snis": jax.random.PRNGKey(1)},
                        jnp.zeros((1, 2)))
    init = jax.device_get(params)
    tx = optax.adam(SNIS_LR)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, batch, key):
        def loss_fn(p):
            return -jnp.mean(model.apply(p, batch, rngs={"snis": key}))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    batches, proposals, losses = [], [], []
    for _ in range(SNIS_ITERS):
        key, kd, ks = jax.random.split(key, 3)
        batch = ex.sample_mog(kd, SNIS_B)
        rec = _Recorder((SNIS_K - 1, 2))
        monkeypatch.setattr(jax.random, "normal", rec)
        model.apply(params, batch, rngs={"snis": ks})
        monkeypatch.undo()
        batches.append(np.asarray(batch))
        proposals.append(rec.draws[0])
        params, opt_state, loss = step(params, opt_state, batch, ks)
        losses.append(float(loss))
    return model, init, jax.device_get(params), batches, proposals, losses


def test_snis_mog_matches_jax(monkeypatch):
    jmodel, init, final, batches, proposals, losses = _jax_snis_run(
        monkeypatch)
    model = tm.SNISDistribution(2, SNIS_K, SNIS_H)
    mnist_convert.load_flax_params(model, init)
    steps = ((torch.tensor(b), torch.tensor(p))
             for b, p in zip(batches, proposals))
    got = tsnis.train(model, steps, SNIS_ITERS, SNIS_LR)
    np.testing.assert_allclose(got.numpy(), losses, rtol=SNIS_RTOL)

    # With rec_tpu's trained weights: the density grid and the coded
    # sample of the example.
    mnist_convert.load_flax_params(model, final)
    g = np.linspace(-2, 2, 100)
    xx, yy = np.meshgrid(g, g)
    points = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], -1), jnp.float32)
    prior_lp = jnp.sum(-0.5 * points ** 2 - 0.9189385, axis=1,
                       keepdims=True)
    want_grid = np.asarray(prior_lp + jmodel.apply(
        final, points, method=jmodel.energy)).reshape(100, 100)
    np.testing.assert_allclose(tsnis.density_grid(model), want_grid,
                               atol=GRID_ATOL)

    proposal = JGaussianParams(jnp.zeros(2), jnp.ones(2))
    idx, sample = j_encode_importance(
        proposal, proposal, jax.random.PRNGKey(7), coding_bits=10,
        log_weighting_fn=lambda eps: jmodel.apply(
            final, eps, method=jmodel.energy)[:, 0])
    coded = tsnis.code_sample(model)
    assert coded["exact"]
    assert coded["index"] == int(idx)
    np.testing.assert_array_equal(coded["sample"].numpy(),
                                  np.asarray(sample))


def test_snis_mog_cli(tmp_path):
    out = tsnis.main(["--iters", "20", "--batch", "16", "--K",
                      str(SNIS_K), "--hidden", str(SNIS_H), "--device",
                      "cpu", "--log-every", "10", "--out", str(tmp_path)])
    assert out["steps"] == 20 and np.all(np.isfinite(out["losses"]))
    assert out["exact"] and 0 <= out["index"] < 2 ** tsnis.CODING_BITS
    grid = np.load(tmp_path / "density.npy")
    assert grid.shape == (100, 100) and np.all(np.isfinite(grid))
    again = tsnis.main(["--iters", "20", "--batch", "16", "--K",
                        str(SNIS_K), "--hidden", str(SNIS_H), "--device",
                        "cpu", "--out", str(tmp_path)])
    np.testing.assert_array_equal(again["losses"], out["losses"])


# ---------------------------------------------------------------------------
# astar_sampling_demo
# ---------------------------------------------------------------------------

def test_astar_log_ratio_matches_jax():
    ex = _example("astar_sampling_demo.py")
    xs = np.linspace(-30.0, 30.0, 1000).astype(np.float32)
    want = np.asarray(ex.log_ratio(jnp.asarray(xs)))
    got = tastar.LogRatio("cpu")(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, atol=RATIO_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_astar_sample_matches_jax(seed):
    ex = _example("astar_sampling_demo.py")
    want = ex.astar_sample(np.random.RandomState(seed))
    got = tastar.astar_sample(np.random.RandomState(seed),
                              tastar.LogRatio("cpu"))
    assert abs(got - want) <= ASTAR_ATOL


def test_astar_cli_moment_check(capsys):
    out = tastar.main(["--samples", "60", "--seed", "1", "--device", "cpu"])
    assert out["ok"] and out["samples"].shape == (60,)
    assert "mean within 4 standard errors: True" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# data_aggregation: the example itself over the port's compress CSVs
# ---------------------------------------------------------------------------

COMPRESS_TINY = ["model_cfg.num_res_blocks=2",
                 "model_cfg.deterministic_filters=8",
                 "model_cfg.stochastic_filters=4", "block_size=64",
                 "max_partitions=4", "dataset.dataset=cifar10",
                 "dataset.synthetic_size=2", "device=cpu"]


def test_data_aggregation_reads_the_port_compress_csv(tmp_path):
    """examples/lossless/data_aggregation.py (numpy only, shared by both
    packages) over a grid whose cells hold the port's compress CSVs: a
    full cell of 2 images, a cell of 1 (1 crash) and an empty cell."""
    root = tmp_path / "grid"
    cells = {("3.0", "20"): 2, ("5.0", "10"): 1, ("5.0", "20"): 0}
    means = {}
    for (omega, beams), n in cells.items():
        out = root / f"omega_{omega}_beams_{beams}_extra_1.2"
        if not n:
            os.makedirs(out)
            continue
        stats = tcp.main(COMPRESS_TINY + [
            f"kl_per_partition={omega}", f"n_beams={beams}",
            f"num_images={n}",
            f"output_dir={out}", f"model_save_dir={tmp_path / 'ckpt'}"])
        assert stats["crashes"] == 0 and len(stats["rows"]) == n
        with open(stats["csv"]) as f:
            rows = list(csv.DictReader(f))
        means[(float(omega), int(beams))] = (
            np.mean([float(r["total_bits_per_dim"])
                     - float(r["ideal_elbo_bpd"]) for r in rows]),
            np.mean([float(r["comp_time"]) for r in rows]))
    agg = tmp_path / "aggregated"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "lossless",
                                      "data_aggregation.py"),
         "--root", str(root), "--expected-images", "2", "--out", str(agg)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "rows=omega [3.0, 5.0], cols=beams [10, 20]" in proc.stdout
    overhead = np.load(agg / "overhead_extra_1.2.npy")
    runtime = np.load(agg / "runtime_extra_1.2.npy")
    crashes = np.load(agg / "crashes_extra_1.2.npy")
    omegas, beams = [3.0, 5.0], [10, 20]
    for (o, b), (want_overhead, want_runtime) in means.items():
        i, j = omegas.index(o), beams.index(b)
        np.testing.assert_allclose(overhead[i, j], want_overhead,
                                   rtol=1e-12)
        np.testing.assert_allclose(runtime[i, j], want_runtime, rtol=1e-12)
    np.testing.assert_array_equal(crashes, [[np.nan, 0.0], [1.0, 2.0]])
    assert np.isnan(overhead[0, 0]) and np.isnan(overhead[1, 1])


@pytest.mark.parametrize("main,argv", [
    (tdemo.main, []), (tsnis.main, ["--iters", "1"]),
    (tastar.main, ["--samples", "1"])], ids=["discrete", "snis", "astar"])
def test_clis_run_on_the_card_unless_told(main, argv, tmp_path):
    """Without a card the device CLIs raise unless --device cpu is given:
    nothing carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if main is tsnis.main:
        argv = argv + ["--out", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
