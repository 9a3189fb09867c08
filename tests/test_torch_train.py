"""rec_tpu_torch's lossless trainer vs rec_tpu's on JAX-CPU, at a small
size (2 res blocks, 8/4 filters, 8x8x3 images, batch 2): the batch stream,
one train step's metrics and gradients, three optimizer steps (adam and
adamax, clipping off and on, the beta anneal and the target-bpp
controller), checkpoints written by either package and resumed by the
other, the msgpack encoder, the weight converter's way back, and the
training CLI against the reference CLI.

The port's posterior noise is JAX's draws, as rec_tpu makes them inside its
step: ``jax.random.normal`` of ``split(fold_in(key, i), num_res_blocks)``.
"""

import dataclasses
import importlib.util
import json
import os
import sys
import types

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.data.datasets import DatasetConfig as JDatasetConfig
from rec_tpu.data.datasets import iterate_batches as j_iterate_batches
from rec_tpu.models.resnet_vae import BidirectionalResNetVAE as JModel
from rec_tpu.models.resnet_vae import ResNetVAEConfig as JConfig
from rec_tpu.parallel import mesh as jmesh
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state as j_init_state
from rec_tpu.train import make_optimizer as j_make_optimizer
from rec_tpu.train import reconcile_model_config as j_reconcile
from rec_tpu.train import staircase_schedule as j_schedule
from rec_tpu.train.lossless import LosslessTrainConfig as JTrainConfig
from rec_tpu.train.lossless import make_train_step as j_make_train_step
from rec_tpu_torch.cli import compression_performance as tcp
from rec_tpu_torch.cli import train_generative_model as tcli
from rec_tpu_torch.data.datasets import DatasetConfig as TDatasetConfig
from rec_tpu_torch.data.datasets import iterate_batches as t_iterate_batches
from rec_tpu_torch.models.convert import (from_numpy_tree, load_flax_params,
                                          to_numpy_tree)
from rec_tpu_torch.models.resnet_vae import BidirectionalResNetVAE as TModel
from rec_tpu_torch.models.resnet_vae import ResNetVAEConfig as TConfig
from rec_tpu_torch.train import CheckpointManager as TCheckpointManager
from rec_tpu_torch.train import init_state as t_init_state
from rec_tpu_torch.train import make_optimizer as t_make_optimizer
from rec_tpu_torch.train import save_model_config as t_save_model_config
from rec_tpu_torch.train import staircase_schedule as t_schedule
from rec_tpu_torch.train.lossless import LosslessTrainConfig as TTrainConfig
from rec_tpu_torch.train.lossless import make_train_step as t_make_train_step
from rec_tpu_torch.train.lossless import objective
from rec_tpu_torch.train.msgpack import packb, unpackb
from rec_tpu_torch.utils import summary as tsummary

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_res_blocks=2, deterministic_filters=8, stochastic_filters=4)
B, HW = 2, 8
NUM_PIXELS = HW * HW
# A staircase drop at step 2: lr 1e-3 for counts 0 and 1, then 5e-4.
SCHEDULE = (1e-3, 2, 0.5)
KEY = jax.random.PRNGKey(7)
TINY = ["model_cfg.num_res_blocks=2", "model_cfg.deterministic_filters=8",
        "model_cfg.stochastic_filters=4", "batch_size=2"]

# Tolerances (float32, the same operations in another order):
METRIC_RTOL = 5e-5        # scalar metrics; measured <= 1.1e-5 by step 3
RECON_ATOL = 1e-5         # reconstruction in [0, 1]; measured <= 5e-6
GRAD_TOL = 3e-4           # max |error| / leaf L2 norm; measured 7.2e-5
MOMENT_TOL = 1e-3         # mu, nu after 3 steps, same measure; <= 1.3e-4
# Parameter and EMA changes after 3 steps, per leaf: L2 error over the
# change's L2 norm (measured <= 3.3e-3).  Adam normalises each element's
# step, so an element whose gradient is near 0 moves by an amount that
# float rounding decides; the per-leaf L2 measure is robust to that.
UPDATE_TOL = 1e-2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _flat(tree) -> dict:
    return dict(_leaves(tree))


def _noise(i: int) -> np.ndarray:
    """rec_tpu's posterior noise of step i."""
    keys = jax.random.split(jax.random.fold_in(KEY, i),
                            CFG["num_res_blocks"])
    return np.stack([np.asarray(jax.random.normal(k, (B, HW // 2, HW // 2,
                                                      CFG["stochastic_filters"])))
                     for k in keys])


@pytest.fixture(scope="module")
def ref():
    """A rec_tpu-initialised model's params and two 8x8 images."""
    rs = np.random.RandomState(0)
    x = ((rs.randint(0, 256, (B, HW, HW, 3)) + 0.5) / 256.0
         - 0.5).astype(np.float32)
    model = JModel(cfg=JConfig(**CFG), coder=None)
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x),
                                       jax.random.PRNGKey(1)))
    return model, params, x


def _jax_run(ref, name="adamax", clip=0.0, **train):
    model, params, _ = ref
    tx = j_make_optimizer(name, j_schedule(*SCHEDULE), clip_norm=clip)
    state = j_init_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                         beta=1.0)
    step = j_make_train_step(model, JTrainConfig(**train), tx,
                             num_pixels=NUM_PIXELS)
    return tx, state, step


def _port_run(ref, name="adamax", clip=0.0, model_cfg=None, **train):
    _, params, _ = ref
    model = TModel(model_cfg or TConfig(**CFG), None, device="cpu")
    load_flax_params(model, params)
    tx = t_make_optimizer(name, t_schedule(*SCHEDULE), clip_norm=clip)
    state = t_init_state(model, tx, beta=1.0)
    step = t_make_train_step(model, TTrainConfig(**train), tx,
                             num_pixels=NUM_PIXELS)
    return model, tx, state, step


def _port_step(step, state, x, i):
    return step(state, torch.from_numpy(x), torch.from_numpy(_noise(i)))


def _check_metrics(got, want, tag):
    for k in ("loss", "nll", "kl", "true_kl", "bpp", "beta", "elbo_bpd",
              "kl_per_block", "expected_max_kl"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=f"{tag}: {k}")
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               atol=RECON_ATOL, err_msg=f"{tag}: recon")


def _rel_to_norm(got: dict, want: dict, tol: float, tag: str) -> None:
    assert got.keys() == want.keys(), tag
    for k in want:
        err = np.max(np.abs(got[k] - want[k]), initial=0.0)
        assert err <= tol * np.linalg.norm(want[k]) + 1e-12, (tag, k, err)


def _changes_match(got: dict, want: dict, start: dict, tag: str) -> None:
    assert got.keys() == want.keys() == start.keys(), tag
    for k in want:
        d_want = want[k] - start[k]
        err = np.linalg.norm((got[k] - start[k]) - d_want)
        assert err <= UPDATE_TOL * np.linalg.norm(d_want) + 1e-9, (tag, k,
                                                                   err)


def _adam_layout(opt_state_tree: dict, clip: float) -> dict:
    return opt_state_tree["1"] if clip else opt_state_tree


def _check_states(tstate, jstate, start, clip, tag):
    """A port TrainState against a rec_tpu one (device_get)."""
    assert tstate.step == int(jstate.step), tag
    np.testing.assert_allclose(float(tstate.beta), float(jstate.beta),
                               rtol=1e-6, err_msg=tag)
    _changes_match(_flat(to_numpy_tree(tstate.params)),
                   _flat(jstate.params), start, f"{tag}: params")
    _changes_match(_flat(to_numpy_tree(tstate.ema_params)),
                   _flat(jstate.ema_params), start, f"{tag}: ema_params")
    got = _adam_layout(tstate.opt_state.layout(to_numpy_tree), clip)
    want = _adam_layout(flax.serialization.to_state_dict(jstate.opt_state),
                        clip)
    for moment in ("mu", "nu"):
        _rel_to_norm(_flat(got["0"][moment]), _flat(want["0"][moment]),
                     MOMENT_TOL, f"{tag}: {moment}")
    assert int(got["0"]["count"]) == int(want["0"]["count"]), tag
    assert int(got["1"]["count"]) == int(want["1"]["count"]), tag


class TestBatches:
    @pytest.mark.parametrize("crop,repeat", [(None, True), (4, True),
                                             (None, False)])
    def test_match_jax(self, tmp_path, crop, repeat):
        """The same seed gives rec_tpu's batches: 10 images in batches of
        3, past the end of the first epoch when repeating."""
        rs = np.random.RandomState(1)
        np.savez(tmp_path / "tiny8_train.npz",
                 images=rs.randint(0, 256, (10, HW, HW, 3)).astype(np.uint8))
        kw = dict(dataset="tiny8", data_dir=str(tmp_path), crop_size=crop)
        want = j_iterate_batches(JDatasetConfig(**kw), 3, seed=5,
                                 repeat=repeat)
        got = t_iterate_batches(TDatasetConfig(**kw), 3, seed=5,
                                repeat=repeat)
        def take(stream):
            return [next(stream) for _ in range(7)] if repeat else list(
                stream)

        got, want = take(got), take(want)
        assert len(got) == len(want) == (7 if repeat else 3)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (3, crop or HW, crop or HW, 3)
            np.testing.assert_array_equal(g, w)


class TestStep:
    def test_one_step_matches_jax(self, ref):
        """Metrics of one step, and the gradient of every leaf: rec_tpu's
        is its first-moment estimate after one step over (1 - b1)."""
        _, params, x = ref
        _, jstate, jstep = _jax_run(ref)
        jstate, jmetrics = jstep(jstate, jnp.asarray(x),
                                 jax.random.fold_in(KEY, 0))
        model, _, tstate, _ = _port_run(ref)
        loss, metrics = objective(model, TTrainConfig(), tstate,
                                  torch.from_numpy(x),
                                  torch.from_numpy(_noise(0)), NUM_PIXELS)
        _check_metrics(metrics, jmetrics, "one step")
        np.testing.assert_allclose(float(loss.detach()), float(jmetrics["loss"]),
                                   rtol=METRIC_RTOL)
        names = list(tstate.params)
        grads = torch.autograd.grad(loss, [tstate.params[k] for k in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        got = _flat(to_numpy_tree(dict(zip(names, grads))))
        want = {k: v / np.float32(0.1) for k, v in
                _flat(jax.device_get(jstate.opt_state[0].mu)).items()}
        _rel_to_norm(got, want, GRAD_TOL, "gradients")
        # The dead parameters (the last inference block's residual convs)
        # get no gradient in either package.
        dead = [k for k in want if "/infer_stack/infer_conv" in k]
        assert len(dead) == 6
        for k in dead:
            np.testing.assert_array_equal(got[k][-1], 0.0)
            np.testing.assert_array_equal(want[k][-1], 0.0)

    @pytest.mark.parametrize("name,clip,train", [
        ("adamax", 0.0, dict(anneal=True, annealing_end=2)),
        ("adamax", 1.0, dict(target_bpp=0.5)),
        ("adam", 0.0, dict(target_bpp=0.5)),
        ("adam", 1.0, dict(anneal=True, annealing_end=2))],
        ids=["adamax-anneal", "adamax-clip-target", "adam-target",
             "adam-clip-anneal"])
    def test_three_steps_match_jax(self, ref, name, clip, train):
        """Params, EMA, moments, counts, step and beta after 3 steps, each
        step's metrics on the way; the gradients' global norm is ~190, so
        clip_norm=1 clips every step, and target_bpp=0.5 lowers beta at
        steps 1 and 2 (bpp ~0.13)."""
        _, params, x = ref
        start = _flat(params)
        _, jstate, jstep = _jax_run(ref, name, clip, **train)
        _, _, tstate, tstep = _port_run(ref, name, clip, **train)
        for i in range(3):
            jstate, jm = jstep(jstate, jnp.asarray(x),
                               jax.random.fold_in(KEY, i))
            tstate, tm = _port_step(tstep, tstate, x, i)
            _check_metrics(tm, jm, f"step {i}")
        jstate = jax.device_get(jstate)
        _check_states(tstate, jstate, start, clip, name)
        if "target_bpp" in train:
            assert float(tstate.beta) == pytest.approx(1.0 / 1.001 ** 2,
                                                       rel=1e-6)

    def test_fixed_likelihood_scale_gets_no_gradient(self, ref):
        """learn_likelihood_scale=False: the gradient of
        likelihood_log_scale is exactly 0 in both packages."""
        model, params, x = ref
        jmodel = JModel(cfg=JConfig(**CFG, learn_likelihood_scale=False),
                        coder=None)

        def nll(p):
            out = jmodel.apply(p, jnp.asarray(x), jax.random.fold_in(KEY, 0))
            return -jnp.mean(out["log_likelihood"])

        want = jax.grad(nll)(params)["params"]["likelihood_log_scale"]
        assert float(want) == 0.0
        tm, _, tstate, _ = _port_run(
            ref, model_cfg=TConfig(**CFG, learn_likelihood_scale=False))
        loss, _ = objective(tm, TTrainConfig(), tstate, torch.from_numpy(x),
                            torch.from_numpy(_noise(0)), NUM_PIXELS)
        names = list(tstate.params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [tstate.params[k] for k in names], allow_unused=True,
            materialize_grads=True)))
        assert float(grads["likelihood_log_scale"]) == 0.0
        assert float(torch.abs(grads["generative_base"]).sum()) > 0.0


class TestCheckpoints:
    @pytest.mark.parametrize("clip", [0.0, 1.0])
    def test_port_checkpoint_restores_in_rec_tpu(self, ref, tmp_path, clip,
                                                 capsys):
        """The port saves after 2 steps; rec_tpu's CheckpointManager
        restores it onto its own template to the same arrays, and rec_tpu
        reads the port's model_config.json without overriding anything."""
        _, params, x = ref
        _, _, tstate, tstep = _port_run(ref, "adamax", clip)
        for i in range(2):
            tstate, _ = _port_step(tstep, tstate, x, i)
        TCheckpointManager(str(tmp_path)).save(tstate)
        t_save_model_config(str(tmp_path), "resnet_vae", TConfig(**CFG))
        assert sorted(os.listdir(tmp_path)) == ["ckpt_2.msgpack",
                                                "model_config.json"]
        tx = j_make_optimizer("adamax", j_schedule(*SCHEDULE),
                              clip_norm=clip)
        template = j_init_state(params, tx, beta=1.0)
        got = jax.device_get(JCheckpointManager(str(tmp_path))
                             .restore(template))
        assert int(got.step) == 2 and got.step.dtype == np.int32
        assert float(got.beta) == float(tstate.beta)
        for mine, theirs in ((tstate.params, got.params),
                             (tstate.ema_params, got.ema_params)):
            want = _flat(to_numpy_tree(mine))
            for k, v in _flat(theirs).items():
                np.testing.assert_array_equal(v, want[k], err_msg=k)
        layout = _flat(tstate.opt_state.layout(to_numpy_tree))
        restored = _flat(flax.serialization.to_state_dict(got.opt_state))
        assert layout.keys() == restored.keys()
        for k, v in restored.items():
            np.testing.assert_array_equal(v, layout[k], err_msg=k)
            assert v.dtype == layout[k].dtype
        capsys.readouterr()
        cfg = JConfig(**CFG)
        assert j_reconcile(str(tmp_path), "resnet_vae", cfg) == cfg
        assert capsys.readouterr().out == ""

    def test_rec_tpu_checkpoint_resumes_in_port(self, ref, tmp_path):
        """rec_tpu saves after 2 steps; the port restores the full state,
        and its third step equals rec_tpu's third step."""
        _, params, x = ref
        _, jstate, jstep = _jax_run(ref, "adam", 1.0)
        for i in range(2):
            jstate, _ = jstep(jstate, jnp.asarray(x),
                              jax.random.fold_in(KEY, i))
        JCheckpointManager(str(tmp_path)).save(jax.device_get(jstate))
        # A fresh port model with other weights, restored from the file.
        model = TModel(TConfig(**CFG), None, seed=3, device="cpu")
        model.initialized = True
        tx = t_make_optimizer("adam", t_schedule(*SCHEDULE), clip_norm=1.0)
        step = t_make_train_step(model, TTrainConfig(), tx,
                                 num_pixels=NUM_PIXELS)
        tstate = TCheckpointManager(str(tmp_path)).restore(
            t_init_state(model, tx, beta=1.0))
        assert tstate.step == 2
        assert tstate.opt_state.count == tstate.opt_state.schedule_count == 2
        saved = jax.device_get(jstate)
        for k, v in _flat(saved.params).items():
            np.testing.assert_array_equal(
                _flat(to_numpy_tree(tstate.params))[k], v, err_msg=k)
        jstate, jm = jstep(jstate, jnp.asarray(x), jax.random.fold_in(KEY, 2))
        tstate, tm = _port_step(step, tstate, x, 2)
        _check_metrics(tm, jm, "third step")
        _check_states(tstate, jax.device_get(jstate), _flat(params), 1.0,
                      "third step")

    def test_mismatched_optimizer_layout_raises(self, ref, tmp_path):
        _, _, tstate, tstep = _port_run(ref, "adamax", 0.0)
        TCheckpointManager(str(tmp_path)).save(tstate)
        _, _, clipped, _ = _port_run(ref, "adamax", 1.0)
        with pytest.raises(ValueError, match="clipping"):
            TCheckpointManager(str(tmp_path)).restore(clipped)

    def test_keeps_the_newest_three(self, ref, tmp_path):
        _, _, tstate, _ = _port_run(ref)
        mgr = TCheckpointManager(str(tmp_path / "ckpt"))
        assert mgr.restore(tstate) is None and mgr.latest_step is None
        for step in (1, 5, 9, 12):
            mgr.save(tstate._replace(step=step))
        assert sorted(os.listdir(mgr.directory)) == [
            "ckpt_12.msgpack", "ckpt_5.msgpack", "ckpt_9.msgpack"]
        assert mgr.restore_params()["step"] == 12


class TestMsgpack:
    def test_round_trip(self):
        obj = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                        -1, -32, -33, -128, -129, -32768, -32769, -2 ** 40],
               "float": 1.25, "none": None, "flags": [True, False],
               "bin": b"\x00\x01" * 200, "str": "x" * 40,
               "many": {str(i): i for i in range(20)},
               "array": np.arange(12, dtype=np.float32).reshape(3, 4),
               "empty": np.zeros((0, 2), np.int32), "nested": {},
               "scalar": np.float32(2.5), "count": np.int32(3)}
        got = unpackb(packb(obj))
        assert got.keys() == obj.keys()
        for k in ("ints", "float", "none", "flags", "bin", "str", "many",
                  "nested"):
            assert got[k] == obj[k], k
        for k in ("array", "empty"):
            assert isinstance(got[k], np.ndarray) and got[k].dtype == obj[k].dtype
            np.testing.assert_array_equal(got[k], obj[k])
        for k in ("scalar", "count"):
            assert isinstance(got[k], np.generic) and got[k] == obj[k]

    @pytest.mark.parametrize("clip", [0.0, 1.0])
    def test_flax_train_state_round_trips(self, ref, clip):
        """A flax-written TrainState unpacks and packs to the same bytes,
        which flax restores to the same arrays."""
        _, params, _ = ref
        tx = j_make_optimizer("adamax", j_schedule(*SCHEDULE),
                              clip_norm=clip)
        state = jax.device_get(j_init_state(params, tx, beta=1.0))
        data = flax.serialization.to_bytes(state)
        again = packb(unpackb(data))
        assert again == data
        want = _flat(flax.serialization.msgpack_restore(data))
        got = _flat(flax.serialization.msgpack_restore(again))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_zero_d_leaves_use_flax_ext_type(self, ref, tmp_path):
        """flax writes the 0-d step, counts and beta as ext 1 (ndarray), not
        ext 3 (numpy scalar); the port's checkpoints do the same, with the
        same dtypes."""
        _, params, _ = ref
        tx = j_make_optimizer("adamax", j_schedule(*SCHEDULE))
        flax_raw = unpackb(flax.serialization.to_bytes(
            jax.device_get(j_init_state(params, tx, beta=1.0))))
        _, _, tstate, _ = _port_run(ref)
        path = TCheckpointManager(str(tmp_path)).save(tstate)
        with open(path, "rb") as f:
            port_raw = unpackb(f.read())
        for raw in (flax_raw, port_raw):
            for leaf, dtype in ((raw["step"], np.int32),
                                (raw["beta"], np.float32),
                                (raw["opt_state"]["0"]["count"], np.int32),
                                (raw["opt_state"]["1"]["count"], np.int32)):
                assert isinstance(leaf, np.ndarray) and leaf.shape == ()
                assert leaf.dtype == dtype


class TestConvert:
    def test_round_trip_is_bitwise(self, ref):
        """to_numpy_tree(from_numpy_tree(t)) == t for the params tree and
        for a moments tree of random values."""
        _, params, _ = ref
        rs = np.random.RandomState(4)
        moments = jax.tree_util.tree_map(
            lambda a: np.asarray(rs.randn(*np.shape(a)), np.float32),
            params)
        for tree in (params, moments):
            want = _flat(tree)
            got = _flat(to_numpy_tree(from_numpy_tree(tree)))
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_model_to_tree_is_flax_layout(self, ref):
        _, params, _ = ref
        model = TModel(TConfig(**CFG), None, device="cpu")
        load_flax_params(model, params)
        got = _flat(to_numpy_tree(model))
        for k, v in _flat(params).items():
            assert got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_summary_writer_tensorboard_path(tmp_path, monkeypatch):
    """Scalars to metrics.jsonl always; scalars and NHWC images in [0, 1]
    to TensorBoard through torch.utils.tensorboard where it imports (here a
    stand-in module records the calls)."""
    calls = []

    class Recorder:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def add_scalar(self, tag, value, step):
            calls.append(("scalar", tag, value, step))

        def add_images(self, tag, arr, step, dataformats):
            calls.append(("images", tag, arr.min(), arr.max(), dataformats))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Recorder))
    w = tsummary.SummaryWriter(str(tmp_path))
    w.scalars(3, {"loss": np.float32(1.5)})
    w.images(3, "Original", np.linspace(-1, 2, 24).reshape(1, 2, 4, 3))
    w.close()
    assert calls == [("init", str(tmp_path)), ("scalar", "loss", 1.5, 3),
                     ("images", "Original", 0.0, 1.0, "NHWC"), ("close",)]
    rec = json.loads(open(tmp_path / "metrics.jsonl").read())
    assert rec["step"] == 3 and rec["loss"] == 1.5
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = tsummary.SummaryWriter(str(tmp_path / "plain"))
    w.images(0, "Original", np.zeros((1, 2, 2, 3)))
    w.close()


def _load_reference_cli(tmp_path_factory):
    """examples/lossless/train_generative_model.py as a module.  Importing
    it turns on JAX's persistent compilation cache; the cache directory it
    makes is a temporary one, and JAX's setting is put back afterwards."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    old = os.environ.get("REC_TPU_COMPILATION_CACHE")
    old_dir = jax.config.jax_compilation_cache_dir
    os.environ["REC_TPU_COMPILATION_CACHE"] = cache
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_train_generative_model",
            os.path.join(REPO, "examples", "lossless",
                         "train_generative_model.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        if old is None:
            os.environ.pop("REC_TPU_COMPILATION_CACHE")
        else:
            os.environ["REC_TPU_COMPILATION_CACHE"] = old
    return mod


class TestCli:
    @pytest.fixture
    def data(self, tmp_path, monkeypatch):
        """8x8 train and test images; TensorBoard left out of both CLIs
        (importing it pulls TensorFlow in where that is installed, tens of
        seconds; its path is tested above), so metrics.jsonl holds what
        both log."""
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        rs = np.random.RandomState(2)
        # 8x8 training images; a 16x16 test image, as the compress CLI's
        # MS-SSIM window needs (the model is convolutional).
        for split, n, side in (("train", 12, HW), ("test", 1, 16)):
            np.savez(tmp_path / f"tiny_{split}.npz",
                     images=rs.randint(0, 256, (n, side, side, 3)).astype(
                         np.uint8))
        return tmp_path

    def _args(self, root, which, iters):
        return TINY + ["dataset.dataset=tiny", f"dataset.data_dir={root}",
                       f"iters={iters}", "log_freq=2",
                       f"model_save_dir={root / ('ckpt_' + which)}",
                       f"log_dir={root / ('logs_' + which)}"]

    def test_train_resume_and_compress(self, data, tmp_path_factory,
                                       monkeypatch):
        """iters=4 log_freq=2: the scalars rec_tpu's CLI logs for the same
        config, checkpoints at steps 1, 3 and 4; iters=6 resumes from step
        4 and keeps the newest three; the compress CLI restores the
        trained weights."""
        ref_cli = _load_reference_cli(tmp_path_factory)
        monkeypatch.setattr(ref_cli, "make_mesh",
                            lambda: jmesh.make_mesh(1))
        ref_cli.main(self._args(data, "jax", 4))
        stats = tcli.main(self._args(data, "torch", 4) + ["device=cpu"])
        assert stats["start_step"] == 0 and stats["steps"] == 4
        assert not stats["restored"] and stats["final_step"] == 4
        assert all(np.isfinite(stats["loss"] + stats["elbo_bpd"]))
        logs = {}
        for which in ("jax", "torch"):
            with open(data / f"logs_{which}" / "metrics.jsonl") as f:
                logs[which] = [json.loads(line) for line in f]
        assert [r["step"] for r in logs["torch"]] == [0, 2]
        assert [set(r) for r in logs["torch"]] == [set(r)
                                                   for r in logs["jax"]]
        assert {"KL/dim_1", "KL/dim_2", "elbo_bpd"} <= set(logs["torch"][0])
        ckpt = data / "ckpt_torch"
        assert sorted(os.listdir(ckpt)) == sorted(os.listdir(
            data / "ckpt_jax")) == ["ckpt_1.msgpack", "ckpt_3.msgpack",
                                    "ckpt_4.msgpack", "model_config.json"]

        more = tcli.main(self._args(data, "torch", 6) + ["device=cpu"])
        assert more["restored"] and more["start_step"] == 4
        assert more["steps"] == 2 and more["final_step"] == 6
        assert sorted(os.listdir(ckpt)) == [
            "ckpt_4.msgpack", "ckpt_5.msgpack", "ckpt_6.msgpack",
            "model_config.json"]

        out = tcp.main(["model_cfg.num_res_blocks=2",
                        "model_cfg.deterministic_filters=8",
                        "model_cfg.stochastic_filters=4", "block_size=64",
                        "num_images=1", "dataset.dataset=tiny",
                        f"dataset.data_dir={data}",
                        f"model_save_dir={ckpt}",
                        f"output_dir={data / 'out'}", "device=cpu"])
        assert out["restored"] and out["crashes"] == 0
        assert out["rows"][0]["roundtrip_ok"]

    def test_runs_on_the_card_by_default(self, tmp_path):
        """No device= means CUDA; without a card that raises."""
        if torch.cuda.is_available():
            assert tcli.Config().device == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tcli.main(TINY + ["iters=1", f"log_dir={tmp_path}/logs",
                                  f"model_save_dir={tmp_path}/ckpt"])

    @pytest.mark.parametrize("model,item", [("vae", "A7")])
    def test_unported_models_raise(self, tmp_path, model, item):
        with pytest.raises(NotImplementedError, match=item):
            tcli.main(TINY + [f"model={model}", "device=cpu",
                              f"log_dir={tmp_path}/logs",
                              f"model_save_dir={tmp_path}/ckpt"])
        assert not os.path.exists(tmp_path / "ckpt")

    def test_config_keeps_the_reference_defaults(self, tmp_path_factory):
        ref_cli = _load_reference_cli(tmp_path_factory)
        want = {f.name: getattr(ref_cli.Config(), f.name)
                for f in dataclasses.fields(ref_cli.Config)}
        got = {f.name: getattr(tcli.Config(), f.name)
               for f in dataclasses.fields(tcli.Config)}
        assert set(want) - set(got) == set()
        assert set(got) - set(want) == {"device"}
        configs = {"dataset", "model_cfg", "large_cfg"}
        for k in set(want) & set(got) - configs:
            assert got[k] == want[k], k
        for k in configs:
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(
                want[k]), k
