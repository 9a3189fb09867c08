"""rec_tpu_torch's IAF and cauchy posteriors of the RVAE vs rec_tpu's on
JAX-CPU, at a small size (2 res blocks, 8/4 filters, 8x8 images, batch 2):
the autoregressive masks, ``AutoRegressiveMultiConv2D`` (its output, its
data-dependent init and its autoregressive order), the forward pass and
one train step (metrics and every gradient) with ``use_iaf`` and with
``distribution="cauchy"``, JAX's normals and uniforms fed in, the weight
converter, and a ``use_iaf`` checkpoint restored and compressed exactly by
the compress CLI (whose encode applies no IAF)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.models import modules as jmod
from rec_tpu.models.resnet_vae import BidirectionalResNetVAE as JModel
from rec_tpu.models.resnet_vae import ResNetVAEConfig as JConfig
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state as j_init_state
from rec_tpu.train import make_optimizer as j_make_optimizer
from rec_tpu.train import staircase_schedule as j_schedule
from rec_tpu.train.lossless import LosslessTrainConfig as JTrainConfig
from rec_tpu.train.lossless import make_train_step as j_make_train_step
from rec_tpu_torch.cli import compression_performance as tcp
from rec_tpu_torch.cli import train_generative_model as tcli
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.models import modules as tmod
from rec_tpu_torch.models.convert import (from_numpy_tree, load_flax_params,
                                          to_numpy_tree)
from rec_tpu_torch.models.resnet_vae import BidirectionalResNetVAE as TModel
from rec_tpu_torch.models.resnet_vae import ResNetVAEConfig as TConfig
from rec_tpu_torch.models.resnet_vae import Uniforms
from rec_tpu_torch.train import CheckpointManager as TCheckpointManager
from rec_tpu_torch.train import init_state as t_init_state
from rec_tpu_torch.train import make_optimizer as t_make_optimizer
from rec_tpu_torch.train.lossless import LosslessTrainConfig as TTrainConfig
from rec_tpu_torch.train.lossless import objective

torch.set_num_threads(2)

BASE = dict(num_res_blocks=2, deterministic_filters=8, stochastic_filters=4)
VARIANTS = {"iaf": dict(use_iaf=True), "cauchy": dict(distribution="cauchy"),
            "cauchy_iaf": dict(distribution="cauchy", use_iaf=True)}
B, HW = 2, 8
NUM_PIXELS = HW * HW
KEY = jax.random.PRNGKey(7)
# Tolerances (float32, the same operations in another order), those of
# tests/test_torch_models.py and tests/test_torch_train.py:
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)   # forward outputs
METRIC_RTOL = 5e-5                       # a step's scalar metrics
GRAD_TOL = 3e-4                          # max |error| / leaf L2 norm


def _LR(step):
    return 1e-3


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _cfg(name):
    return dict(BASE, **VARIANTS[name])


def jax_noise(cfg, key):
    """The posterior noise rec_tpu draws inside its forward: per res block
    ``split(key, num_res_blocks)``, normals (``Uniforms`` for cauchy)."""
    keys = jax.random.split(key, cfg["num_res_blocks"])
    shape = (B, HW // 2, HW // 2, cfg["stochastic_filters"])
    if cfg.get("distribution") == "cauchy":
        return Uniforms(np.stack([np.asarray(jax.random.uniform(
            k, shape, minval=1e-6, maxval=1.0 - 1e-6)) for k in keys]))
    return np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys])


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """rec_tpu's model of one variant, its params (initialised on two 8x8
    images) and the images."""
    cfg = _cfg(request.param)
    rs = np.random.RandomState(0)
    x = ((rs.randint(0, 256, (B, HW, HW, 3)) + 0.5) / 256.0
         - 0.5).astype(np.float32)
    model = JModel(cfg=JConfig(**cfg), coder=None)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                       jax.random.PRNGKey(1)))
    return request.param, cfg, model, params, x


class TestMasks:
    @pytest.mark.parametrize("n_in,n_out", [(4, 4), (4, 8), (8, 4), (1, 3),
                                            (6, 2), (4, 160), (160, 32)])
    @pytest.mark.parametrize("zerodiagonal", [False, True])
    def test_match_rec_tpu(self, n_in, n_out, zerodiagonal):
        np.testing.assert_array_equal(
            tmod.linear_ar_mask(n_in, n_out, zerodiagonal),
            jmod.linear_ar_mask(n_in, n_out, zerodiagonal))
        for h, w in ((3, 3), (5, 5), (1, 1), (3, 5)):
            got = tmod.conv_ar_mask(h, w, n_in, n_out, zerodiagonal)
            assert got.dtype == np.float32 and got.shape == (h, w, n_in,
                                                              n_out)
            np.testing.assert_array_equal(
                got, jmod.conv_ar_mask(h, w, n_in, n_out, zerodiagonal))

    def test_widths_must_divide(self):
        with pytest.raises(ValueError, match="divide"):
            tmod.linear_ar_mask(4, 6)

    def test_masked_conv_keeps_the_mask_out_of_the_state(self):
        conv = tmod.ReparameterizedConv2D(4, 8, mask="a")
        assert sorted(conv.state_dict()) == ["bias", "log_scale", "v"]
        np.testing.assert_array_equal(
            conv.mask.numpy(),
            jmod.conv_ar_mask(3, 3, 4, 8, True).transpose(3, 2, 0, 1))
        with pytest.raises(ValueError, match="mask"):
            tmod.ReparameterizedConv2D(4, 8, mask="c")


def _multiconv():
    """rec_tpu's AutoRegressiveMultiConv2D (4 -> [8, 8] -> heads [4, 4]),
    its params initialised on an input and a context, and the port's with
    rec_tpu's v, the rest set by the port's data-dependent init."""
    rs = np.random.RandomState(3)
    z = rs.randn(2, 6, 6, 4).astype(np.float32)
    ctx = rs.randn(2, 6, 6, 8).astype(np.float32)
    jm = jmod.AutoRegressiveMultiConv2D(convolution_features=[8, 8],
                                        head_features=[4, 4])
    params = jax.device_get(jm.init(jax.random.PRNGKey(4), jnp.asarray(z),
                                    jnp.asarray(ctx)))
    tm = tmod.AutoRegressiveMultiConv2D(4, [8, 8], [4, 4])
    sd = {f"{name}.v": torch.tensor(np.asarray(leaf["v"]).transpose(
        3, 2, 0, 1)) for name, leaf in params["params"].items()}
    with torch.no_grad():
        for k, v in tm.state_dict().items():
            if k in sd:
                v.copy_(sd[k])
    return jm, params, tm, z, ctx


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


class TestMultiConv:
    def test_ddi_and_output_match_flax(self):
        """The data-dependent init sees the masked output: the port's
        log_scale and bias from rec_tpu's v equal rec_tpu's init, and both
        heads' outputs match."""
        jm, params, tm, z, ctx = _multiconv()
        convs = [m for m in tm.modules() if hasattr(m, "ddi")]
        assert len(convs) == 4
        for m in convs:
            m.ddi = True
        with torch.no_grad():
            tm(_nchw(z), _nchw(ctx))
        for m in convs:
            m.ddi = False
        for name, leaf in params["params"].items():
            mod = getattr(tm, name)
            for k in ("log_scale", "bias"):
                np.testing.assert_allclose(
                    getattr(mod, k).detach().numpy(), leaf[k],
                    rtol=1e-5, atol=1e-5, err_msg=f"{name}.{k}")
        want = jm.apply(params, jnp.asarray(z), jnp.asarray(ctx))
        with torch.no_grad():
            tm.load_state_dict(from_numpy_tree_flat(params), strict=True)
            got = tm(_nchw(z), _nchw(ctx))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w), **MODEL_TOL)

    @pytest.mark.parametrize("j", [0, 1, 2, 3])
    def test_autoregressive_order(self, j):
        """Perturbing input channel j at one pixel never changes a head's
        output channels <= j at that pixel, nor any output at a pixel after
        it in the masks' order (a later row, or the same row further
        right); it does change a later channel there."""
        _, params, tm, z, ctx = _multiconv()
        tm.load_state_dict(from_numpy_tree_flat(params), strict=True)
        y, x = 2, 3
        z2 = z.copy()
        z2[:, y, x, j] += 3.0
        with torch.no_grad():
            a = [h.permute(0, 2, 3, 1).numpy()
                 for h in tm(_nchw(z), _nchw(ctx))]
            b = [h.permute(0, 2, 3, 1).numpy()
                 for h in tm(_nchw(z2), _nchw(ctx))]
        later = np.zeros(z.shape[1:3], bool)
        later[y + 1:] = True
        later[y, x + 1:] = True
        changed = False
        for ha, hb in zip(a, b):
            np.testing.assert_array_equal(ha[:, y, x, :j + 1],
                                          hb[:, y, x, :j + 1])
            np.testing.assert_array_equal(ha[:, later], hb[:, later])
            changed |= bool(np.any(ha[:, y, x, j + 1:]
                                   != hb[:, y, x, j + 1:]))
        assert changed == (j < 3)


def from_numpy_tree_flat(params):
    """A flax tree of weight-norm convs (no scan stacks) -> state dict."""
    sd = {}
    for name, leaf in params["params"].items():
        sd[f"{name}.v"] = torch.tensor(np.asarray(leaf["v"]).transpose(
            3, 2, 0, 1))
        sd[f"{name}.log_scale"] = torch.tensor(np.asarray(leaf["log_scale"]))
        sd[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"]))
    return sd


class TestModel:
    def test_converter_round_trip(self, variant):
        """rec_tpu's tree -> port -> tree is bitwise, the IAF leaves nested
        under the scanned stacks included; the port model loads it
        strictly and a fresh port model gives flax's tree structure."""
        name, cfg, _, params, _ = variant
        want = _flat(params)
        got = _flat(to_numpy_tree(from_numpy_tree(params)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if cfg.get("use_iaf"):
            assert "/params/infer_stack/infer_iaf_context/v" in want
        if name == "iaf":
            assert ("/params/gen_stack/iaf_posterior_multiconv/head_1/v"
                    in want)
        model = TModel(TConfig(**cfg), None, seed=3, device="cpu")
        load_flax_params(model, params)
        fresh = _flat(to_numpy_tree(TModel(TConfig(**cfg), None, seed=3,
                                           device="cpu")))
        assert fresh.keys() == want.keys()
        for k in want:
            assert fresh[k].shape == want[k].shape, k

    def test_forward_matches_jax(self, variant):
        name, cfg, jmodel, params, x = variant
        key = jax.random.PRNGKey(5)
        want = jmodel.apply(params, jnp.asarray(x), key)
        model = TModel(TConfig(**cfg), None, device="cpu")
        load_flax_params(model, params)
        with torch.no_grad():
            got = model(torch.from_numpy(x), jax_noise(cfg, key))
        for k in ("reconstruction", "log_likelihood", "kld_channelwise",
                  "empirical_kld", "analytic_kl"):
            assert got[k].shape == np.shape(want[k]), k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **MODEL_TOL, err_msg=k)
        # IAF or cauchy: the KLs are the empirical ones.
        np.testing.assert_array_equal(got["analytic_kl"].numpy(),
                                      got["empirical_kld"].numpy())

    def test_noise_form_must_match_the_distribution(self, variant):
        name, cfg, _, params, x = variant
        model = TModel(TConfig(**cfg), None, device="cpu")
        load_flax_params(model, params)
        noise = jax_noise(cfg, KEY)
        wrong = noise.values if isinstance(noise, Uniforms) else Uniforms(
            noise)
        with pytest.raises(ValueError, match="noise"):
            model(torch.from_numpy(x), wrong)

    def test_one_step_matches_jax(self, variant):
        """One train step's metrics, and every leaf's gradient: rec_tpu's
        is its first-moment estimate after one step over (1 - b1)."""
        name, cfg, jmodel, params, x = variant
        tx = j_make_optimizer("adamax", 1e-3)
        jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, params),
                              tx, beta=1.0)
        jstep = j_make_train_step(jmodel, JTrainConfig(), tx,
                                  num_pixels=NUM_PIXELS)
        key = jax.random.fold_in(KEY, 0)
        jstate, jm = jstep(jstate, jnp.asarray(x), key)
        model = TModel(TConfig(**cfg), None, device="cpu")
        load_flax_params(model, params)
        tstate = t_init_state(model, t_make_optimizer("adamax", _LR),
                              beta=1.0)
        loss, tm = objective(model, TTrainConfig(), tstate,
                             torch.from_numpy(x), jax_noise(cfg, key),
                             NUM_PIXELS)
        for k in ("loss", "nll", "kl", "true_kl", "bpp", "elbo_bpd",
                  "kl_per_block", "expected_max_kl"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=k)
        names = list(tstate.params)
        grads = torch.autograd.grad(loss, [tstate.params[k] for k in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        got = _flat(to_numpy_tree(dict(zip(names, grads))))
        want = {k: v / np.float32(0.1) for k, v in
                _flat(jax.device_get(jstate.opt_state[0].mu)).items()}
        assert got.keys() == want.keys()
        for k in want:
            err = np.max(np.abs(got[k] - want[k]), initial=0.0)
            assert err <= GRAD_TOL * np.linalg.norm(want[k]) + 1e-12, (k,
                                                                      err)
        if name == "iaf":
            # Both contexts and the four masked convolutions, each with v,
            # log_scale and bias, all trained.
            iaf = [k for k in want if "iaf" in k]
            assert len(iaf) == 6 * 3
            for k in iaf:
                assert np.linalg.norm(got[k]) > 0, k


def test_trainer_draws_uniforms_for_cauchy(tmp_path, monkeypatch):
    """model_cfg.distribution=cauchy trains with Uniforms in [1e-6,
    1 - 1e-6]; use_iaf trains with normals."""
    monkeypatch.setitem(__import__("sys").modules,
                        "torch.utils.tensorboard", None)
    for name in ("cauchy", "iaf"):
        extra = [f"model_cfg.{k}={v}" for k, v in VARIANTS[name].items()]
        args = ["model_cfg.num_res_blocks=2",
                "model_cfg.deterministic_filters=8",
                "model_cfg.stochastic_filters=4", "batch_size=2",
                "dataset.synthetic_size=4", "iters=2", "log_freq=1",
                f"model_save_dir={tmp_path / name}",
                f"log_dir={tmp_path / name}_logs", "device=cpu"] + extra
        cfg = tcli.apply_overrides(tcli.Config(), args)
        run = tcli.build(cfg, tcli.setup_logger("test_iaf"))
        noise = run.noise()
        if name == "cauchy":
            assert isinstance(noise, Uniforms)
            u = noise.values
            assert u.shape == (2, 2, 16, 16, 4)
            assert float(u.min()) >= 1e-6 and float(u.max()) <= 1 - 1e-6
        else:
            assert isinstance(noise, torch.Tensor)
        stats = tcli.train(cfg, run, tcli.setup_logger("test_iaf"))
        assert stats["steps"] == 2 and np.all(np.isfinite(stats["loss"]))


def test_iaf_checkpoint_restores_and_compresses(tmp_path):
    """A rec_tpu use_iaf checkpoint: the compress CLI restores it strictly
    (the IAF weights exist, encode uses none), every image decodes
    exactly, and its first res block's code equals rec_tpu's compress of
    the same weights; the port's trainer checkpoint of a use_iaf model
    restores in rec_tpu."""
    cfg = _cfg("iaf")
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (2, 16, 16, 3)).astype(np.float32)
    os.makedirs(tmp_path / "data")
    np.savez(tmp_path / "data" / "tiny16_test.npz", images=images)
    coder = dict(n_beams=3, extra_samples=1.0, block_size=64,
                 max_partitions=6)
    jmodel = JModel(cfg=JConfig(**cfg), coder=JCoder(**coder))
    x = images / 255.0 - 0.5
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jax.random.PRNGKey(1)))
    state = j_init_state(params, j_make_optimizer("adamax", 1e-3), beta=1.0)
    JCheckpointManager(str(tmp_path / "ckpt")).save(jax.device_get(state))
    args = ["model_cfg.num_res_blocks=2", "model_cfg.deterministic_filters=8",
            "model_cfg.stochastic_filters=4", "model_cfg.use_iaf=true",
            "n_beams=3", "extra_samples=1.0", "block_size=64",
            "max_partitions=6", "auto_max_partitions=false",
            "num_images=2", "dataset.dataset=tiny16",
            f"dataset.data_dir={tmp_path / 'data'}",
            f"model_save_dir={tmp_path / 'ckpt'}",
            f"output_dir={tmp_path / 'out'}", "device=cpu"]
    stats = tcp.main(args)
    assert stats["restored"] and stats["crashes"] == 0
    assert [r["roundtrip_ok"] for r in stats["rows"]] == [True, True]

    model = TModel(TConfig(**cfg), TCoder(**coder), device="cpu")
    load_flax_params(model, params)
    want = jmodel.apply(params, jnp.asarray(x[:1]), 1234,
                        method=jmodel.compress)
    got = model.compress(torch.from_numpy(x[:1].astype(np.float32)), 1234)
    np.testing.assert_array_equal(got["counts"][0].numpy(),
                                  np.asarray(want["counts"][0]))
    np.testing.assert_array_equal(got["indices"][0].numpy(),
                                  np.asarray(want["indices"][0]))
    rec = model.decompress((16, 16), got["indices"], got["counts"], 1234)
    assert torch.equal(rec, got["reconstruction"])

    tstate = t_init_state(model, t_make_optimizer("adamax", _LR), beta=1.0)
    TCheckpointManager(str(tmp_path / "port")).save(tstate)
    template = j_init_state(params, j_make_optimizer(
        "adamax", j_schedule(1e-3, 10 ** 9, 1.0)), beta=1.0)
    restored = jax.device_get(JCheckpointManager(str(tmp_path / "port"))
                              .restore(template))
    for k, v in _flat(restored.params).items():
        np.testing.assert_array_equal(v, _flat(params)[k], err_msg=k)
