"""The data-parallel train step: the port's ``make_train_step`` and
``make_vae_train_step`` over ``Mesh(["cpu"] * 2)`` against rec_tpu's jitted
step with the batch sharded over 2 of its virtual CPU devices and the
state replicated (examples/lossless/train_generative_model.py:173-180),
both on rec_tpu's posterior noise of the whole batch, for the RVAE, the
large model and the dense MNIST VAE: one step's metrics and gradients,
the free-bits floor on the whole batch, two runs bitwise equal and a
one-entry mesh as today's step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.models import mnist_vae as jm
from rec_tpu.models.large_resnet_vae import LargeResNetVAE as JLarge
from rec_tpu.models.large_resnet_vae import LargeResNetVAEConfig as JLargeCfg
from rec_tpu.models.resnet_vae import BidirectionalResNetVAE as JModel
from rec_tpu.models.resnet_vae import ResNetVAEConfig as JConfig
from rec_tpu.parallel import make_mesh as j_make_mesh
from rec_tpu.parallel.mesh import data_axis_sharding, replicated_sharding
from rec_tpu.train import init_state as j_init_state
from rec_tpu.train import make_optimizer as j_make_optimizer
from rec_tpu.train.lossless import LosslessTrainConfig as JTrainConfig
from rec_tpu.train.lossless import make_train_step as j_make_train_step
from rec_tpu.train.lossless import make_vae_train_step as j_make_vae_step
from rec_tpu_torch.models import large_convert, mnist_convert
from rec_tpu_torch.models import mnist_vae as tm
from rec_tpu_torch.models.convert import load_flax_params, to_numpy_tree
from rec_tpu_torch.models.large_resnet_vae import LargeResNetVAE as TLarge
from rec_tpu_torch.models.large_resnet_vae import \
    LargeResNetVAEConfig as TLargeCfg
from rec_tpu_torch.models.resnet_vae import BidirectionalResNetVAE as TModel
from rec_tpu_torch.models.resnet_vae import ResNetVAEConfig as TConfig
from rec_tpu_torch.parallel import Mesh
from rec_tpu_torch.train import init_state as t_init_state
from rec_tpu_torch.train import make_optimizer as t_make_optimizer
from rec_tpu_torch.train.lossless import LosslessTrainConfig as TTrainConfig
from rec_tpu_torch.train.lossless import make_train_step as t_make_train_step
from rec_tpu_torch.train.lossless import make_vae_train_step as t_make_vae

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(7)
STEP_RTOL = 5e-5        # a step's scalar metrics (test_torch_train.py's)
# Gradients, max |error| / leaf L2 norm.  Against rec_tpu: the one-device
# port is 1.4e-3 from rec_tpu's one-device step on the large model at these
# inputs and 1.1e-4 on the RVAE (measured), so the sharded step is held to
# that; against the port's one-device step: measured <= 8.5e-5.
GRAD_TOL = 2e-3
DP_GRAD_TOL = 3e-4
RVAE = dict(num_res_blocks=2, deterministic_filters=8, stochastic_filters=4)
LARGE = dict(first_deterministic_filters=12, second_deterministic_filters=12,
             first_stochastic_filters=8, second_stochastic_filters=4)


def _images(n, hw, seed):
    rs = np.random.RandomState(seed)
    x = ((rs.randint(0, 256, (n, *hw, 3)) + 0.5) / 256.0 - 0.5)
    # The second half is flat grey: its posteriors sit nearer the prior,
    # so a channel's KL differs between the two halves of the batch.
    x[n // 2:] = x[n // 2:].mean(axis=(1, 2, 3), keepdims=True) * 0.1
    return x.astype(np.float32)


def _rvae_noise(key, batch, hw):
    keys = jax.random.split(key, RVAE["num_res_blocks"])
    return np.stack([np.asarray(jax.random.normal(
        k, (batch, hw[0] // 2, hw[1] // 2, RVAE["stochastic_filters"])))
        for k in keys])


def _large_noise(key, batch, hw):
    H, W = hw
    k1, k2 = jax.random.split(key)
    return [np.asarray(jax.random.normal(
        k2, (batch, H // 64, W // 64, LARGE["second_stochastic_filters"]))),
        np.asarray(jax.random.normal(
            k1, (batch, H // 16, W // 16,
                 LARGE["first_stochastic_filters"])))]


def _setup_rvae(hw):
    jmodel = JModel(cfg=JConfig(**RVAE), coder=None)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(_images(4, hw, 0)),
        jax.random.PRNGKey(1)))

    def port():
        m = TModel(TConfig(**RVAE), None, device="cpu")
        load_flax_params(m, params)
        return m

    return jmodel, params, port, _rvae_noise, to_numpy_tree


def _setup_large(hw):
    jmodel = JLarge(cfg=JLargeCfg(**LARGE))
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(_images(2, hw, 0)),
        jax.random.PRNGKey(1)))

    def port():
        m = TLarge(TLargeCfg(**LARGE), None, device="cpu")
        large_convert.load_flax_params(m, params)
        return m

    return jmodel, params, port, _large_noise, large_convert.to_numpy_tree


def _setup_vae(hw):
    jmodel = jm.MNISTVAE(latents=6, hidden_size=16)
    x = (np.random.RandomState(0).rand(4, 28, 28, 1) > 0.5)
    params = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "snis": jax.random.PRNGKey(2)},
        jnp.asarray(x, jnp.float32), jax.random.PRNGKey(1)))

    def port():
        m = tm.MNISTVAE(6, 16, device="cpu")
        mnist_convert.load_flax_params(m, params)
        return m

    def noise(key, batch, hw):
        return np.asarray(jax.random.normal(key, (batch, 6)))

    return jmodel, params, port, noise, mnist_convert.to_numpy_tree


# model: (setup, image size, batch, optimizer, whether a free-bits floor
# applies, rec_tpu's step maker, the port's).
MODELS = {
    "rvae": (_setup_rvae, (8, 8), 4, "adamax", True, j_make_train_step,
             t_make_train_step),
    "large": (_setup_large, (64, 64), 2, "adam", True, j_make_train_step,
              t_make_train_step),
    "vae": (_setup_vae, (28, 28), 4, "adam", False, j_make_vae_step,
            t_make_vae),
}


def _batch(name, n, hw):
    if name == "vae":
        return (np.random.RandomState(3).rand(n, 28, 28, 1)
                > 0.5).astype(np.float32)
    return _images(n, hw, 3)


def _lamb(port_model, x, noise, n_shards):
    """A free-bits floor between two shards' KL of the channel where they
    differ most, three quarters of the way up: the batch's mean there lies
    below it (the floor holds) but one shard's lies above, so flooring each
    shard's mean gives another loss.  The mean stays clear of the kink,
    where the two packages' rounding could pick different sides."""
    with torch.no_grad():
        per = [port_model(torch.from_numpy(xs), n)["kld_channelwise"]
               for xs, n in zip(np.split(x, n_shards),
                                _split_noise(noise, n_shards))]
    a, b = per[0].reshape(-1), per[1].reshape(-1)
    c = int(torch.argmax(torch.abs(a - b)))
    lo, hi = sorted((float(a[c]), float(b[c])))
    return lo + 0.75 * (hi - lo)


def _split_noise(noise, k):
    if isinstance(noise, list):
        return list(zip(*[np.split(n, k) for n in noise]))
    return [np.ascontiguousarray(n) for n in np.split(noise, k, axis=1)]


def _torch_noise(noise):
    if isinstance(noise, (list, tuple)):
        return [torch.from_numpy(np.array(n)) for n in noise]
    return torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module", params=sorted(MODELS))
def dp_case(request):
    name = request.param
    setup, hw, batch, opt, floored, j_step, t_step = MODELS[name]
    jmodel, params, port, noise_fn, tree = setup(hw)
    x = _batch(name, batch, hw)
    noise = [noise_fn(jax.random.fold_in(KEY, i), batch, hw)
             for i in range(3)]
    kw = dict(beta=0.7)
    kw["lamb"] = _lamb(port(), x, noise[0], 2) if floored else 0.0
    return dict(name=name, jmodel=jmodel, params=params, port=port, x=x,
                noise=noise, kw=kw, opt=opt, j_step=j_step, t_step=t_step,
                tree=tree, num_pixels=hw[0] * hw[1])


def _port_steps(case, mesh, steps=1):
    model = case["port"]()
    tx = t_make_optimizer(case["opt"], lambda s: 1e-3)
    state = t_init_state(model, tx, beta=case["kw"]["beta"])
    step = case["t_step"](model, TTrainConfig(**case["kw"]), tx,
                          case["num_pixels"], mesh=mesh)
    metrics = []
    for i in range(steps):
        state, m = step(state, torch.from_numpy(case["x"]),
                        _torch_noise(case["noise"][i]))
        metrics.append(m)
    return state, metrics


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


class TestDataParallelStep:
    def test_matches_jax_sharded_step(self, dp_case):
        """One step over Mesh([cpu] * 2): the metrics within STEP_RTOL and
        every leaf's gradient within GRAD_TOL of rec_tpu's step with the
        batch sharded over two devices, and within DP_GRAD_TOL of the
        port's one-device step."""
        case = dp_case
        jmesh = j_make_mesh(2)
        tx = j_make_optimizer(case["opt"], 1e-3)
        jstate = jax.device_put(
            j_init_state(jax.tree_util.tree_map(jnp.asarray,
                                                case["params"]), tx,
                         beta=case["kw"]["beta"]),
            replicated_sharding(jmesh))
        jstep = case["j_step"](case["jmodel"], JTrainConfig(**case["kw"]),
                               tx, case["num_pixels"])
        xs = jax.device_put(jnp.asarray(case["x"]),
                            data_axis_sharding(jmesh, 4))
        jstate, jm_ = jstep(jstate, xs, jax.random.fold_in(KEY, 0))
        state, (tm_,) = _port_steps(case, Mesh(["cpu"] * 2))
        for k in ("loss", "nll", "kl", "true_kl", "bpp", "elbo_bpd",
                  "expected_max_kl"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=STEP_RTOL, atol=1e-6,
                                       err_msg=f"{case['name']}: {k}")
        # The gradients: each package's first moment after one step
        # (1 - b1 = 0.1 times the gradient).
        want = _flat(jax.device_get(jstate.opt_state[0].mu))
        got = _flat(case["tree"](state.opt_state.mu))
        one, _ = _port_steps(case, None)
        alone = _flat(case["tree"](one.opt_state.mu))
        assert got.keys() == want.keys() == alone.keys()
        for k in want:
            err = np.max(np.abs(got[k] - want[k]), initial=0.0)
            assert err <= GRAD_TOL * np.linalg.norm(want[k]) + 1e-12, (k,
                                                                      err)
            err = np.max(np.abs(got[k] - alone[k]), initial=0.0)
            assert err <= DP_GRAD_TOL * np.linalg.norm(alone[k]) + 1e-12, (
                k, err)

    @pytest.mark.parametrize("dp_case", ["rvae", "large"], indirect=True)
    def test_floor_is_taken_on_the_whole_batch(self, dp_case):
        """The batch's halves straddle ``lamb`` in one channel, so flooring
        each shard's KL mean would give a loss far from the global floor's;
        the sharded step's loss is the global one's.  (The dense VAE's loss
        has no floor.)"""
        case = dp_case
        model = case["port"]()
        lamb = case["kw"]["lamb"]
        with torch.no_grad():
            whole = model(torch.from_numpy(case["x"]),
                          _torch_noise(case["noise"][0]))
            halves = [model(torch.from_numpy(xs), _torch_noise(n))
                      for xs, n in zip(np.split(case["x"], 2),
                                       _split_noise(case["noise"][0], 2))]
        global_kl = float(torch.sum(torch.clamp_min(
            whole["kld_channelwise"], lamb)))
        per_shard = float(sum(torch.sum(torch.clamp_min(
            h["kld_channelwise"], lamb)) for h in halves) / 2)
        assert abs(per_shard - global_kl) > 100 * STEP_RTOL * global_kl
        _, (m,) = _port_steps(case, Mesh(["cpu"] * 2))
        np.testing.assert_allclose(float(m["kl"]), global_kl,
                                   rtol=STEP_RTOL)

    def test_two_runs_are_bitwise_equal(self, dp_case):
        """Three sharded steps twice from one seed: every loss and every
        parameter bitwise equal."""
        a, ma = _port_steps(dp_case, Mesh(["cpu"] * 2), steps=3)
        b, mb = _port_steps(dp_case, Mesh(["cpu"] * 2), steps=3)
        for x, y in zip(ma, mb):
            assert float(x["loss"]) == float(y["loss"])
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k
            assert torch.equal(a.ema_params[k], b.ema_params[k]), k

    def test_one_entry_mesh_is_todays_step(self, dp_case):
        a, ma = _port_steps(dp_case, None)
        b, mb = _port_steps(dp_case, Mesh(["cpu"]))
        assert float(ma[0]["loss"]) == float(mb[0]["loss"])
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k
