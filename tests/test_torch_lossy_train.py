"""rec_tpu_torch's lossy trainer vs rec_tpu's on JAX-CPU at a small size
(8 filters per level, 64x64 crops, batch 2; 192x192 for the MS-SSIM
distortions, whose five scales need it): ``lower_bound``'s custom gradient
and GDN's parameter gradients, one train step's metrics and gradients for
the 1-, 2- and 4-level models and each distortion, three optimizer steps,
and the training CLI against examples/lossy/train_lossy_model.py
(checkpoints resumed across the packages both ways, the beta override, the
non-finite guard, the config).

The port's posterior noise is JAX's draws, as rec_tpu's models make them
inside their forward from the step's key.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.models import modules as jmod
from rec_tpu.models.lossy import Large1LevelVAE as J1
from rec_tpu.models.lossy import Large2LevelVAE as J2
from rec_tpu.models.lossy import Large4LevelVAE as J4
from rec_tpu.parallel import mesh as jmesh
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state as j_init_state
from rec_tpu.train import make_optimizer as j_make_optimizer
from rec_tpu.train import staircase_schedule as j_schedule
from rec_tpu.train.lossy import LossyTrainConfig as JTrainConfig
from rec_tpu.train.lossy import make_train_step as j_make_train_step
from rec_tpu_torch.cli import train_lossy_model as tcli
from rec_tpu_torch.models import signal as tsig
from rec_tpu_torch.models.lossy import Large1LevelVAE as T1
from rec_tpu_torch.models.lossy import Large2LevelVAE as T2
from rec_tpu_torch.models.lossy import Large4LevelVAE as T4
from rec_tpu_torch.models.lossy.convert import load_flax_params, to_numpy_tree
from rec_tpu_torch.train import CheckpointManager as TCheckpointManager
from rec_tpu_torch.train import init_state as t_init_state
from rec_tpu_torch.train import make_optimizer as t_make_optimizer
from rec_tpu_torch.train import staircase_schedule as t_schedule
from rec_tpu_torch.train import lossy as tlossy
from rec_tpu_torch.train.lossy import LossyTrainConfig as TTrainConfig
from rec_tpu_torch.train.lossy import get_distortion
from rec_tpu_torch.train.lossy import make_train_step as t_make_train_step
from rec_tpu_torch.train.msgpack import unpackb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
KEY = jax.random.PRNGKey(7)
# A staircase drop at step 2: lr 1e-3 for counts 0 and 1, then 5e-4 (a
# larger rate than the CLI's 1e-4, so that GDN's gamma leaves its bound).
SCHEDULE = (1e-3, 2, 0.5)
MODELS = {"level1": (J1, T1, (8,)), "level2": (J2, T2, (8, 8)),
          "level4": (J4, T4, (8, 8, 8, 8))}
TINY = ["level_1_filters=8", "level_2_filters=8", "level_3_filters=8",
        "level_4_filters=8", "batch_size=2", "dataset.crop_size=64"]

# Tolerances (float32, the same operations in another order), those of
# tests/test_torch_train.py:
METRIC_RTOL = 5e-5        # scalar metrics
GRAD_TOL = 3e-4           # max |error| / leaf L2 norm
MOMENT_TOL = 1e-3         # mu, nu after 3 steps, same measure
UPDATE_TOL = 1e-2         # params and EMA change after 3 steps, per leaf L2


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def jax_noise(which, key, shapes):
    """The standard normals rec_tpu's model ``which`` draws from ``key``,
    one per latent level in coding order."""
    if which == "level1":
        keys = [key]
    elif which == "level2":
        keys = list(jax.random.split(key))   # (k2, k1)
    else:
        k = jax.random.split(key, 4)         # level l samples with k[l - 1]
        keys = [k[3], k[2], k[1], k[0]]
    return [np.asarray(jax.random.normal(k, s)) for k, s in zip(keys, shapes)]


# ---------------------------------------------------------------------------
# lower_bound and GDN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bound", [tsig._GAMMA_BOUND, tsig._BETA_BOUND, 0.5])
def test_lower_bound_gradient_is_rec_tpus(bound):
    """Inputs below, at and above the bound, each with a negative, zero and
    positive cotangent: the values and the gradient equal jax.vjp of
    rec_tpu's lower_bound bitwise (the gradient passes where x >= bound or
    g < 0)."""
    b32 = float(np.float32(bound))
    xs = np.array([b32 - 1.0, np.nextafter(np.float32(b32), np.float32(-1)),
                   b32, np.nextafter(np.float32(b32), np.float32(2)),
                   b32 + 1.0], np.float32)
    x = np.repeat(xs, 3)
    g = np.tile(np.array([-0.75, 0.0, 0.75], np.float32), len(xs))
    want_y, vjp = jax.vjp(lambda v: jmod.lower_bound(v, bound),
                          jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tsig.lower_bound(tx, bound)
    (got_g,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    assert np.array_equal(y.detach().numpy().view(np.int32),
                          np.asarray(want_y).view(np.int32))
    assert np.array_equal(got_g.numpy().view(np.int32),
                          np.asarray(want_g).view(np.int32))
    below = x < np.float32(b32)
    assert np.all(got_g.numpy()[below & (g > 0)] == 0.0)
    assert np.all(got_g.numpy()[below & (g < 0)] == g[below & (g < 0)])


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_parameter_gradients(inverse):
    """GDN's beta and gamma gradients against JAX's, with reparameterised
    values above, at and below their bounds."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 5, 4, 6).astype(np.float32)
    r = rs.randn(2, 5, 4, 6).astype(np.float32)
    jm = jmod.GDN(inverse=inverse)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = params["params"]
    gamma = (0.3 * rs.randn(6, 6)).astype(np.float32)
    gamma[0, 1] = tsig._GAMMA_BOUND           # at the bound
    p["gamma_reparam"] = gamma                # many below it
    p["beta_reparam"] = np.abs(rs.randn(6)).astype(np.float32) + 0.5

    def loss(params):
        return jnp.sum(jm.apply(params, jnp.asarray(x)) * r)

    want = _flat(jax.grad(loss)(params))
    tm = tsig.GDN(6, inverse=inverse)
    load_flax_params(tm, params)
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    (torch.permute(out, (0, 2, 3, 1)) * torch.from_numpy(r)).sum().backward()
    got = _flat(to_numpy_tree({k: v.grad for k, v in tm.named_parameters()}))
    assert got.keys() == want.keys()
    for k in want:
        assert np.any(want[k] != 0.0), k
        err = np.max(np.abs(got[k] - want[k]))
        assert err <= GRAD_TOL * np.linalg.norm(want[k]), (k, err)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _init(which, hw):
    """rec_tpu's model, its params (init, then every leaf moved off its
    initial value) and a batch (shared by the tests of this worker)."""
    jcls, _, widths = MODELS[which]
    jmodel = jcls(*widths)
    x = np.random.RandomState(0).rand(B, hw, hw, 3).astype(np.float32)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jax.random.PRNGKey(1)))
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.02 * rs.randn(*a.shape), np.float32),
        params)
    return jmodel, params, x


def _setup(which, hw=64):
    """``_init``'s model, params and batch, and the port's model with those
    params."""
    _, tcls, widths = MODELS[which]
    jmodel, params, x = _init(which, hw)
    tmodel = tcls(*widths, device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel, x


def _noise(which, tmodel, x, i):
    shapes = [(B,) + s for s in tmodel.latent_shapes(*x.shape[1:3])]
    return [torch.from_numpy(n) for n in jax_noise(
        which, jax.random.fold_in(KEY, i), shapes)]


def _runs(which, distortion="mse", name="adam", hw=64):
    jmodel, params, tmodel, x = _setup(which, hw)
    num_pixels = hw * hw
    jtx = j_make_optimizer(name, j_schedule(*SCHEDULE))
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, params), jtx,
                          beta=0.01)
    jstep = j_make_train_step(jmodel, JTrainConfig(distortion=distortion),
                              jtx, num_pixels=num_pixels)
    ttx = t_make_optimizer(name, t_schedule(*SCHEDULE))
    tstate = t_init_state(tmodel, ttx, beta=0.01)
    tstep = t_make_train_step(tmodel, TTrainConfig(distortion=distortion),
                              ttx, num_pixels=num_pixels)
    return params, x, (jstate, jstep), (tmodel, tstate, tstep)


def _check_metrics(got, want, tag):
    for k in ("loss", "distortion", "bpp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=f"{tag}: {k}")


def _rel_to_norm(got: dict, want: dict, tol: float, tag: str) -> None:
    assert got.keys() == want.keys(), tag
    for k in want:
        err = np.max(np.abs(got[k] - want[k]), initial=0.0)
        assert err <= tol * np.linalg.norm(want[k]) + 1e-12, (tag, k, err)


STEP_CASES = [("level1", "mse", 64), ("level2", "mse", 64),
              ("level4", "mse", 64), ("level1", "mae", 64),
              ("level1", "discretized_logistic", 64),
              ("level1", "ms-ssim", 192), ("level1", "mae-ms-ssim", 192)]


@pytest.mark.parametrize("which,distortion,hw", STEP_CASES,
                         ids=[f"{w}-{d}" for w, d, _ in STEP_CASES])
def test_one_step_matches_jax(which, distortion, hw):
    """Metrics of one step, and the gradient of every leaf: rec_tpu's is
    its first-moment estimate after one adam step over (1 - b1)."""
    _, x, (jstate, jstep), (tmodel, tstate, _) = _runs(which, distortion,
                                                       hw=hw)
    jstate, jmetrics = jstep(jstate, jnp.asarray(x),
                             jax.random.fold_in(KEY, 0))
    loss, metrics = tlossy.objective(tmodel, get_distortion(distortion),
                                     tstate, torch.from_numpy(x),
                                     _noise(which, tmodel, x, 0), hw * hw)
    _check_metrics(metrics, jmetrics, "one step")
    names = list(tstate.params)
    grads = torch.autograd.grad(loss, [tstate.params[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    got = _flat(to_numpy_tree(dict(zip(names, grads))))
    want = {k: v / np.float32(0.1) for k, v in
            _flat(jax.device_get(jstate.opt_state[0].mu)).items()}
    _rel_to_norm(got, want, GRAD_TOL, "gradients")


@pytest.mark.parametrize("which,name", [("level2", "adam"),
                                        ("level1", "adamax")])
def test_three_steps_match_jax(which, name):
    """Params, EMA, moments and counts after 3 steps, each step's metrics
    on the way.  GDN's off-diagonal gamma starts at its bound, so the steps
    after the first run lower_bound's gradient below the bound."""
    params, x, (jstate, jstep), (tmodel, tstate, tstep) = _runs(
        which, name=name)
    start = _flat(params)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(x),
                           jax.random.fold_in(KEY, i))
        tstate, tm = tstep(tstate, torch.from_numpy(x),
                           _noise(which, tmodel, x, i))
        _check_metrics(tm, jm, f"step {i}")
    jstate = jax.device_get(jstate)
    assert tstate.step == int(jstate.step) == 3
    for mine, theirs in ((tstate.params, jstate.params),
                         (tstate.ema_params, jstate.ema_params)):
        got, want = _flat(to_numpy_tree(mine)), _flat(theirs)
        assert got.keys() == want.keys()
        for k in want:
            d_want = want[k] - start[k]
            err = np.linalg.norm((got[k] - start[k]) - d_want)
            assert err <= UPDATE_TOL * np.linalg.norm(d_want) + 1e-9, (k,
                                                                       err)
    got = tstate.opt_state.layout(to_numpy_tree)
    want = flax.serialization.to_state_dict(jstate.opt_state)
    for moment in ("mu", "nu"):
        _rel_to_norm(_flat(got["0"][moment]), _flat(want["0"][moment]),
                     MOMENT_TOL, moment)
    assert int(got["0"]["count"]) == int(want["0"]["count"]) == 3
    assert int(got["1"]["count"]) == int(want["1"]["count"]) == 3


@pytest.mark.parametrize("which", ["level2", "level4"])
def test_port_checkpoint_restores_in_rec_tpu(which, tmp_path):
    """The port saves a lossy state after one step; rec_tpu's
    CheckpointManager restores it onto its own template to the same
    arrays."""
    params, x, _, (tmodel, tstate, tstep) = _runs(which)
    tstate, _ = tstep(tstate, torch.from_numpy(x), _noise(which, tmodel, x,
                                                          0))
    from rec_tpu_torch.models.lossy import convert

    TCheckpointManager(str(tmp_path), convert=convert).save(tstate)
    template = j_init_state(params, j_make_optimizer(
        "adam", j_schedule(*SCHEDULE)), beta=1.0)
    got = jax.device_get(JCheckpointManager(str(tmp_path)).restore(template))
    assert int(got.step) == 1 and float(got.beta) == np.float32(0.01)
    for mine, theirs in ((tstate.params, got.params),
                         (tstate.ema_params, got.ema_params)):
        want = _flat(to_numpy_tree(mine))
        flat = _flat(theirs)
        assert flat.keys() == want.keys()
        for k, v in flat.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    layout = _flat(tstate.opt_state.layout(to_numpy_tree))
    restored = _flat(flax.serialization.to_state_dict(got.opt_state))
    assert layout.keys() == restored.keys()
    for k, v in restored.items():
        np.testing.assert_array_equal(v, layout[k], err_msg=k)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _load_reference_cli(tmp_path_factory):
    """examples/lossy/train_lossy_model.py as a module.  Importing it turns
    on JAX's persistent compilation cache; the cache directory it makes is
    a temporary one, and JAX's setting is put back afterwards."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    old = os.environ.get("REC_TPU_COMPILATION_CACHE")
    old_dir = jax.config.jax_compilation_cache_dir
    os.environ["REC_TPU_COMPILATION_CACHE"] = cache
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_train_lossy_model",
            os.path.join(REPO, "examples", "lossy", "train_lossy_model.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        if old is None:
            os.environ.pop("REC_TPU_COMPILATION_CACHE")
        else:
            os.environ["REC_TPU_COMPILATION_CACHE"] = old
    return mod


@pytest.fixture
def data(tmp_path, monkeypatch):
    """Six 80x80 training images (cropped to 64); TensorBoard left out of
    both CLIs (importing it pulls TensorFlow in where that is installed),
    so metrics.jsonl holds what both log."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rs = np.random.RandomState(2)
    np.savez(tmp_path / "tiny_train.npz",
             images=rs.randint(0, 256, (6, 80, 80, 3)).astype(np.uint8))
    return tmp_path


def _args(root, which, iters, *extra):
    return TINY + ["model=large_level_1_vae", "dataset.dataset=tiny",
                   f"dataset.data_dir={root}", f"iters={iters}",
                   "log_freq=2", f"model_save_dir={root / ('ckpt_' + which)}",
                   f"log_dir={root / ('logs_' + which)}", *extra]


def _logged(root, which):
    with open(root / f"logs_{which}" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _ckpts(path):
    return sorted(os.listdir(path))


def _jax_noise_in_port(monkeypatch):
    """The port CLI's noise replaced by rec_tpu's CLI draws: step i's key
    is fold_in(PRNGKey(seed), i)."""
    def noise(self):
        i = self.__dict__.setdefault("_step", self.state.step)
        self._step += 1
        draws = jax_noise("level1", jax.random.fold_in(
            jax.random.PRNGKey(42), i), self.noise_shape)
        return [torch.from_numpy(n) for n in draws]

    monkeypatch.setattr(tcli.Trainer, "noise", noise)


def test_cli_checkpoints_resume_across_packages(data, tmp_path_factory,
                                                monkeypatch):
    """The port trains 3 steps (log_freq=2: checkpoints 1 and 3); rec_tpu's
    CLI and the port each resume a copy to 5 steps and log the same
    metrics at step 4 (the port drawing JAX's noise); then rec_tpu trains 3
    steps of its own and the port resumes that to 5."""
    ref = _load_reference_cli(tmp_path_factory)
    monkeypatch.setattr(ref, "make_mesh", lambda: jmesh.make_mesh(1))
    first = tcli.main(_args(data, "torch", 3, "device=cpu"))
    assert first["steps"] == 3 and not first["restored"]
    assert all(np.isfinite(first["loss"] + first["distortion"]
                           + first["bpp"]))
    assert _ckpts(data / "ckpt_torch") == ["ckpt_1.msgpack", "ckpt_3.msgpack",
                                           "model_config.json"]
    shutil.copytree(data / "ckpt_torch", data / "ckpt_jax")
    ref.main(_args(data, "jax", 5))
    assert _ckpts(data / "ckpt_jax") == [
        "ckpt_1.msgpack", "ckpt_3.msgpack", "ckpt_5.msgpack",
        "model_config.json"]
    _jax_noise_in_port(monkeypatch)
    more = tcli.main(_args(data, "torch", 5, "device=cpu"))
    assert more["restored"] and more["start_step"] == 3
    assert more["steps"] == 2 and more["final_step"] == 5
    jl, tl = _logged(data, "jax"), _logged(data, "torch")
    assert [r["step"] for r in jl] == [4]
    assert [r["step"] for r in tl] == [0, 2, 4]
    assert set(jl[0]) == set(tl[-1])
    for k in ("loss", "distortion", "bpp"):
        np.testing.assert_allclose(tl[-1][k], jl[0][k], rtol=METRIC_RTOL,
                                   err_msg=k)
    with open(data / "ckpt_torch" / "model_config.json") as f:
        mine = json.load(f)
    with open(data / "ckpt_jax" / "model_config.json") as f:
        assert json.load(f) == mine
    assert mine["kind"] == "large_level_1_vae" and mine["cfg"]["beta"] == 0.01

    ref.main(_args(data, "jax2", 3))
    back = tcli.main(_args(data, "jax2", 5, "device=cpu"))
    assert back["restored"] and back["start_step"] == 3
    assert back["final_step"] == 5 and np.all(np.isfinite(back["loss"]))
    assert _ckpts(data / "ckpt_jax2") == [
        "ckpt_1.msgpack", "ckpt_3.msgpack", "ckpt_5.msgpack",
        "model_config.json"]


def test_cli_beta_overrides_the_restored_one(data):
    """A run resumed at another beta trains and saves with that beta, and
    records it in model_config.json."""
    tcli.main(_args(data, "torch", 2, "device=cpu"))
    more = tcli.main(_args(data, "torch", 3, "device=cpu", "beta=0.5",
                           "log_freq=1"))
    assert more["restored"] and more["start_step"] == 2
    (rec,) = [r for r in _logged(data, "torch") if r["step"] == 2]
    assert rec["loss"] == pytest.approx(0.5 * rec["distortion"] + rec["bpp"],
                                        rel=1e-6)
    with open(data / "ckpt_torch" / "ckpt_3.msgpack", "rb") as f:
        assert float(unpackb(f.read())["beta"]) == 0.5
    with open(data / "ckpt_torch" / "model_config.json") as f:
        assert json.load(f)["cfg"]["beta"] == 0.5


@pytest.mark.parametrize("log_freq,ckpts", [
    (1, ["model_config.json"]),
    (10, ["ckpt_1.msgpack", "model_config.json"])],
    ids=["at-a-log-step", "between-log-steps"])
def test_cli_stops_on_a_non_finite_loss(data, monkeypatch, log_freq, ckpts):
    """A non-finite loss raises and saves no checkpoint of the state that
    produced it: at a log step (here the first) or, between log steps, at
    the end of the run (the first step is finite there)."""
    real = tlossy.get_distortion
    calls = []

    def distortion(name):
        fn = real(name)

        def nan_after_first(x, y):
            calls.append(1)
            d = fn(x, y)
            return d if log_freq > 1 and len(calls) == 1 else d * np.nan

        return nan_after_first

    monkeypatch.setattr(tlossy, "get_distortion", distortion)
    with pytest.raises(FloatingPointError, match="step"):
        tcli.main(_args(data, "torch", 3, "device=cpu",
                        f"log_freq={log_freq}"))
    assert _ckpts(data / "ckpt_torch") == ckpts


@pytest.mark.parametrize("model", ["large_level_1_vae", "large_level_2_vae",
                                   "large_level_4_vae"])
def test_cli_trains_each_model(data, model):
    """Three steps of each model at 8 filters: finite losses, checkpoints
    at steps 1 and 3, the model kind recorded."""
    stats = tcli.main(_args(data, "torch", 3, "device=cpu", f"model={model}"))
    assert stats["steps"] == 3
    assert np.all(np.isfinite(stats["loss"]))
    assert _ckpts(data / "ckpt_torch") == ["ckpt_1.msgpack", "ckpt_3.msgpack",
                                           "model_config.json"]
    with open(data / "ckpt_torch" / "model_config.json") as f:
        assert json.load(f)["kind"] == model


def test_config_is_the_references_plus_device(tmp_path_factory):
    ref = _load_reference_cli(tmp_path_factory)
    want = {f.name: getattr(ref.Config(), f.name)
            for f in dataclasses.fields(ref.Config)}
    got = {f.name: getattr(tcli.Config(), f.name)
           for f in dataclasses.fields(tcli.Config)}
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    for k in set(want) - {"dataset"}:
        assert got[k] == want[k], k
    assert dataclasses.asdict(got["dataset"]) == dataclasses.asdict(
        want["dataset"])
    assert set(tcli.MODELS) == set(ref.MODELS)


def test_runs_on_the_card_by_default(tmp_path):
    """No device= means CUDA; without a card that raises."""
    assert tcli.Config().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(TINY + ["iters=1", f"log_dir={tmp_path}/logs",
                          f"model_save_dir={tmp_path}/ckpt"])
