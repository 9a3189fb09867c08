"""rec_tpu_torch's LargeResNetVAE vs rec_tpu's on JAX-CPU at the widths of
tests/test_large_resnet_vae.py (12/12/8/4 filters) on 64x128 images
(192x192 for the MS-SSIM likelihoods): the converter, the forward pass of
all five likelihoods with JAX's params and draws, compress against
rec_tpu's scan path, the replay and ``.rec`` files in both directions, one
train step's metrics and gradients, checkpoints both ways, the trainer CLI
and ``compression_performance model=large_resnet_vae`` in both modes and
with ``tile`` against rec_tpu's CLI with JAX's draws swapped in."""

import csv
import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu import io as jio
from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.models.large_resnet_vae import LargeResNetVAE as JModel
from rec_tpu.models.large_resnet_vae import LargeResNetVAEConfig as JConfig
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state as j_init_state
from rec_tpu.train import make_optimizer as j_make_optimizer
from rec_tpu.train import reconcile_model_config as j_reconcile
from rec_tpu.train import staircase_schedule as j_schedule
from rec_tpu.train.lossless import LosslessTrainConfig as JTrainConfig
from rec_tpu.train.lossless import make_train_step as j_make_train_step
from rec_tpu_torch import io as tio
from rec_tpu_torch.cli import compression_performance as tcp
from rec_tpu_torch.cli import train_generative_model as tcli
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import gauss as tgauss
from rec_tpu_torch.models import large_convert
from rec_tpu_torch.models.large_resnet_vae import LargeResNetVAE as TModel
from rec_tpu_torch.models.large_resnet_vae import \
    LargeResNetVAEConfig as TConfig
from rec_tpu_torch.train import CheckpointManager as TCheckpointManager
from rec_tpu_torch.train import init_state as t_init_state
from rec_tpu_torch.train import make_optimizer as t_make_optimizer
from rec_tpu_torch.train import save_model_config as t_save_model_config
from rec_tpu_torch.train import staircase_schedule as t_schedule
from rec_tpu_torch.train.lossless import LosslessTrainConfig as TTrainConfig
from rec_tpu_torch.train.lossless import make_train_step as t_make_train_step
from rec_tpu_torch.train.lossless import objective
from rec_tpu_torch.utils.logging import gaussian_blur

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(first_deterministic_filters=12, second_deterministic_filters=12,
              first_stochastic_filters=8, second_stochastic_filters=4)
CODER = dict(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
             block_size=64, max_partitions=8)
HW = (64, 128)
SCHEDULE = (1e-3, 2, 0.5)
KEY = jax.random.PRNGKey(7)
# Tolerances (float32, the same operations in another order):
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)   # forward outputs, as the RVAE's
METRIC_RTOL = 5e-5                       # a step's metrics (test_torch_train)
GRAD_TOL = 3e-4                          # max |error| / leaf L2 norm
TINY = ["large_cfg.first_deterministic_filters=12",
        "large_cfg.second_deterministic_filters=12",
        "large_cfg.first_stochastic_filters=8",
        "large_cfg.second_stochastic_filters=4"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _images(n, hw, seed):
    rs = np.random.RandomState(seed)
    return ((rs.randint(0, 256, (n, *hw, 3)) + 0.5) / 256.0
            - 0.5).astype(np.float32)


def jax_noise(key, batch, hw, widths=WIDTHS):
    """rec_tpu's draws inside its forward: ``k1, k2 = split(key)``, block 1
    from k1, block 2 from k2; returned top-down (block 2's, block 1's)."""
    H, W = hw
    k1, k2 = jax.random.split(key)
    s2 = (batch, H // 64, W // 64, widths["second_stochastic_filters"])
    s1 = (batch, H // 16, W // 16, widths["first_stochastic_filters"])
    return [np.asarray(jax.random.normal(k2, s2)),
            np.asarray(jax.random.normal(k1, s1))]


def _init(cfg, hw=HW, perturb=True):
    """rec_tpu's params of ``cfg`` initialised on two images, each leaf
    moved off its initial value (zero biases and GDN's identity matrices
    would hide layout errors)."""
    jmodel = JModel(cfg=cfg, coder=JCoder(**CODER))
    x = _images(2, hw, 0)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jax.random.PRNGKey(1)))
    if perturb:
        rs = np.random.RandomState(5)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a + 0.05 * rs.randn(*np.shape(a)),
                                 np.float32), params)
    return jmodel, params


def _port(cfg_kw, params, coder=True):
    model = TModel(TConfig(**cfg_kw), TCoder(**CODER) if coder else None,
                   device="cpu")
    large_convert.load_flax_params(model, params)
    return model


@pytest.fixture(scope="module")
def large():
    jmodel, params = _init(JConfig(**WIDTHS))
    return jmodel, params, _port(WIDTHS, params).requires_grad_(False)


@pytest.fixture(scope="module")
def plain():
    """The model with use_sig_convs=False and use_gdn=False (weight-norm
    convolutions and elu throughout)."""
    kw = dict(WIDTHS, use_sig_convs=False, use_gdn=False)
    jmodel, params = _init(JConfig(**kw))
    return kw, jmodel, params


def test_gaussian_blur_matches_rec_tpu():
    from rec_tpu.utils.logging import gaussian_blur as j_blur

    x = np.random.RandomState(2).rand(2, 20, 24, 3).astype(np.float32)
    for k, sigma in ((11, 8.0), (5, 1.0), (4, 2.0)):
        want = np.asarray(j_blur(jnp.asarray(x), kernel_size=k, sigma=sigma))
        got = gaussian_blur(torch.from_numpy(x), kernel_size=k, sigma=sigma)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


class TestConverter:
    @pytest.mark.parametrize("which", ["signal", "plain"])
    def test_round_trip_is_bitwise(self, large, plain, which):
        """flax tree -> port -> tree gives the same bits and paths; a fresh
        port model's tree has flax's structure, shapes and dtypes."""
        if which == "signal":
            _, params, _ = large
            kw = WIDTHS
        else:
            kw, _, params = plain
        want = _flat(params)
        got = _flat(large_convert.to_numpy_tree(
            large_convert.from_numpy_tree(params)))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.float32
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        fresh = _flat(large_convert.to_numpy_tree(
            TModel(TConfig(**kw), None, seed=3, device="cpu")))
        assert fresh.keys() == want.keys()
        for k in want:
            assert fresh[k].shape == want[k].shape, k
        if which == "signal":
            assert "/params/first_gen_block/igdn_2/gamma_reparam" in want
            assert "/params/second_infer_block/conv_pre/kernel_rdft" in want
        else:
            assert "/params/second_gen_block/conv_tail/v" in want


@pytest.mark.parametrize("likelihood", ["discretized_logistic", "gaussian",
                                        "laplace", "ms-ssim",
                                        "ms-ssim-laplace"])
def test_forward_matches_jax(large, likelihood):
    """The five likelihoods (the MS-SSIM ones at 192x192, as their five
    scales need): reconstruction, log likelihood and the three KLs, each
    in rec_tpu's layout."""
    jmodel, params, _ = large
    kw = dict(WIDTHS, likelihood=likelihood)
    hw = (192, 192) if "ms-ssim" in likelihood else HW
    x = _images(2, hw, 3)
    key = jax.random.PRNGKey(9)
    want = JModel(cfg=JConfig(**kw)).apply(params, jnp.asarray(x), key)
    model = _port(kw, params, coder=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), jax_noise(key, 2, hw))
    assert got["kld_channelwise"].shape == (8 + 4,)
    assert got["analytic_kl"].shape == got["empirical_kld"].shape == (2, 2)
    for k in ("reconstruction", "log_likelihood", "kld_channelwise",
              "analytic_kl", "empirical_kld"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **MODEL_TOL, err_msg=k)
    for (gp, gq), (wp, wq) in zip(got["posterior_prior_pairs"],
                                  want["posterior_prior_pairs"]):
        for g, w in zip((*gp, *gq), (*wp, *wq)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def test_plain_convs_forward_matches_jax(plain):
    kw, jmodel, params = plain
    x = _images(2, HW, 4)
    key = jax.random.PRNGKey(10)
    want = jmodel.apply(params, jnp.asarray(x), key)
    with torch.no_grad():
        got = _port(kw, params, coder=False)(torch.from_numpy(x),
                                             jax_noise(key, 2, HW))
    for k in ("reconstruction", "log_likelihood", "kld_channelwise",
              "analytic_kl"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **MODEL_TOL, err_msg=k)


def test_data_dependent_init_matches(plain):
    """From rec_tpu's v, kernels and base, the port's data-dependent init
    on the same images and noise gives rec_tpu's log_scales and biases."""
    kw, jmodel, _ = plain
    x = _images(2, HW, 0)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.asarray(x),
                                        jax.random.PRNGKey(1)))
    model = TModel(TConfig(**kw), None, device="cpu")
    sd = large_convert.from_numpy_tree(params)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if not (k.endswith("log_scale") or k.endswith("bias")):
                v.copy_(sd[k])
    model.data_dependent_init(torch.from_numpy(x),
                              jax_noise(jax.random.PRNGKey(1), 2, HW))
    for k, v in model.state_dict().items():
        if k.endswith("log_scale") or k.endswith("bias"):
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


class _Recording:
    """rec_tpu's coder, recording each decode's prior and sample."""

    def __init__(self, coder):
        self.coder = coder
        self.calls = []

    def decode(self, prior, indices, counts, seed):
        z = self.coder.decode(prior, indices, counts, seed)
        self.calls.append((prior, z, int(seed)))
        return z


class TestCoding:
    def test_compress_matches_jax(self, large):
        """Block 2, coded first, equal in counts and indices; block 1's
        counts equal and >= 95% of its indices (its prior agrees to float
        tolerance); the KLs close; latents top-down."""
        jmodel, params, tmodel = large
        x = _images(1, HW, 6)
        want = jmodel.apply(params, jnp.asarray(x), 1234,
                            method=jmodel.compress)
        got = tmodel.compress(torch.from_numpy(x), 1234)
        (wi2, wc2), (wi1, wc1) = want["latents"]
        (gi2, gc2), (gi1, gc1) = got["latents"]
        assert gi2.shape == np.shape(wi2) == (1, CODER["max_partitions"])
        assert gi1.shape == np.shape(wi1) == (4, CODER["max_partitions"])
        np.testing.assert_array_equal(gc2.numpy(), np.asarray(wc2))
        np.testing.assert_array_equal(gi2.numpy(), np.asarray(wi2))
        np.testing.assert_array_equal(gc1.numpy(), np.asarray(wc1))
        assert np.mean(gi1.numpy() == np.asarray(wi1)) >= 0.95
        np.testing.assert_allclose(got["kl"].numpy(), np.asarray(want["kl"]),
                                   rtol=1e-4)

    def test_decompress_replays_the_encoder(self, large):
        _, _, tmodel = large
        x = _images(1, HW, 7)
        out = tmodel.compress(torch.from_numpy(x), 77)
        rec = tmodel.decompress(HW, out["latents"], 77)
        assert torch.equal(rec, out["reconstruction"])
        wrong = tmodel.decompress(HW, out["latents"], 78)
        assert not torch.allclose(wrong, rec, atol=1e-5)

    def test_rec_files_cross_packages(self, large, tmp_path):
        """A .rec file of each package decodes in the other, the
        reconstructions close; each group of either file replays in the
        port bitwise equal to rec_tpu's decode given the same prior and
        the group's seed (block 2: seed + 7919, block 1: seed); the two
        packages write the same bytes for the same latents."""
        jmodel, params, tmodel = large
        x = _images(1, HW, 8)
        seed = 31
        n_samples = tmodel.coder.n_samples
        jcomp = jmodel.apply(params, jnp.asarray(x), seed,
                             method=jmodel.compress)
        tcomp = tmodel.compress(torch.from_numpy(x), seed)
        files = {}
        for name, latents in (
                ("jax", [(np.asarray(i), np.asarray(c))
                         for i, c in jcomp["latents"]]),
                ("torch", [(i.numpy(), c.numpy())
                           for i, c in tcomp["latents"]])):
            kw = dict(seed=seed, image_shape=(*HW, 3), block_size=64,
                      max_index=n_samples, latents=latents)
            files[name] = str(tmp_path / f"{name}.rec")
            tio.write_rec(files[name], **kw)
            jio.write_rec(str(tmp_path / f"{name}_ref.rec"), **kw)
            with open(files[name], "rb") as a, \
                    open(str(tmp_path / f"{name}_ref.rec"), "rb") as b:
                assert a.read() == b.read()
        for name, path in files.items():
            rseed, shape, _, latents = tio.read_rec(
                path, max_partitions=CODER["max_partitions"])
            rec = _Recording(jmodel.coder)
            want = JModel(cfg=jmodel.cfg, coder=rec).apply(
                params, shape[:2], [tuple(map(jnp.asarray, lt))
                                    for lt in latents], rseed,
                method=JModel.decompress)
            got = tmodel.decompress(shape[:2], latents, rseed)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **MODEL_TOL)
            assert [s for _, _, s in rec.calls] == [rseed + 7919, rseed]
            for (ind, cnt), (prior, z, s) in zip(latents, rec.calls):
                mine = tmodel.coder.decode(
                    TG(torch.from_numpy(np.asarray(prior.loc)),
                       torch.from_numpy(np.asarray(prior.scale))),
                    ind, cnt, s)
                assert np.array_equal(mine.numpy().view(np.int32),
                                      np.asarray(z).view(np.int32)), name


def _jax_step(jmodel, params, name="adam", **train):
    tx = j_make_optimizer(name, j_schedule(*SCHEDULE))
    state = j_init_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                         beta=1.0)
    return state, j_make_train_step(jmodel, JTrainConfig(**train), tx,
                                    num_pixels=HW[0] * HW[1])


def _port_step(kw, params, name="adam", **train):
    model = _port(kw, params, coder=False)
    tx = t_make_optimizer(name, t_schedule(*SCHEDULE))
    state = t_init_state(model, tx, beta=1.0)
    return model, state, t_make_train_step(model, TTrainConfig(**train), tx,
                                           num_pixels=HW[0] * HW[1])


def _check_metrics(got, want, tag):
    for k in ("loss", "nll", "kl", "true_kl", "bpp", "beta", "elbo_bpd",
              "kl_per_block", "expected_max_kl"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=f"{tag}: {k}")


class TestTraining:
    @pytest.mark.parametrize("likelihood", ["laplace", "discretized_logistic"])
    def test_one_step_matches_jax(self, large, likelihood):
        """The lossless trainer's free bits over (2 groups) and every
        leaf's gradient (rec_tpu's: its first moment after one adam step
        over (1 - b1)), lower_bound's custom gradient included."""
        _, params, _ = large
        kw = dict(WIDTHS, likelihood=likelihood)
        jmodel = JModel(cfg=JConfig(**kw))
        x = _images(2, HW, 11)
        jstate, jstep = _jax_step(jmodel, params, lamb=0.01)
        key = jax.random.fold_in(KEY, 0)
        jstate, jm = jstep(jstate, jnp.asarray(x), key)
        model, tstate, _ = _port_step(kw, params, lamb=0.01)
        loss, tm = objective(model, TTrainConfig(lamb=0.01), tstate,
                             torch.from_numpy(x), jax_noise(key, 2, HW),
                             HW[0] * HW[1])
        _check_metrics(tm, jm, "one step")
        assert tm["kl_per_block"].shape == (2,)
        names = list(tstate.params)
        grads = torch.autograd.grad(loss, [tstate.params[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        got = _flat(large_convert.to_numpy_tree(dict(zip(names, grads))))
        want = {k: v / np.float32(0.1) for k, v in
                _flat(jax.device_get(jstate.opt_state[0].mu)).items()}
        assert got.keys() == want.keys()
        for k in want:
            err = np.max(np.abs(got[k] - want[k]), initial=0.0)
            assert err <= GRAD_TOL * np.linalg.norm(want[k]) + 1e-12, (k,
                                                                      err)

    def test_port_checkpoint_restores_in_rec_tpu(self, large, tmp_path,
                                                  capsys):
        """Two port steps saved; rec_tpu restores the same arrays onto its
        template, and reads the port's model_config.json as its own."""
        _, params, _ = large
        kw = dict(WIDTHS, likelihood="laplace")
        _, tstate, tstep = _port_step(kw, params)
        x = _images(2, HW, 12)
        for i in range(2):
            tstate, _ = tstep(tstate, torch.from_numpy(x), jax_noise(
                jax.random.fold_in(KEY, i), 2, HW))
        TCheckpointManager(str(tmp_path), convert=large_convert).save(tstate)
        t_save_model_config(str(tmp_path), "large_resnet_vae",
                            TConfig(**kw))
        template = j_init_state(params, j_make_optimizer(
            "adam", j_schedule(*SCHEDULE)), beta=1.0)
        got = jax.device_get(JCheckpointManager(str(tmp_path))
                             .restore(template))
        assert int(got.step) == 2
        for mine, theirs in ((tstate.params, got.params),
                             (tstate.ema_params, got.ema_params)):
            want = _flat(large_convert.to_numpy_tree(mine))
            for k, v in _flat(theirs).items():
                np.testing.assert_array_equal(v, want[k], err_msg=k)
        capsys.readouterr()
        cfg = JConfig(**kw)
        assert j_reconcile(str(tmp_path), "large_resnet_vae", cfg) == cfg

    def test_rec_tpu_checkpoint_resumes_in_port(self, large, tmp_path):
        """rec_tpu saves after 2 steps; the port restores the whole state
        and its third step's metrics equal rec_tpu's third step's."""
        _, params, _ = large
        kw = dict(WIDTHS, likelihood="laplace")
        jmodel = JModel(cfg=JConfig(**kw))
        jstate, jstep = _jax_step(jmodel, params)
        x = _images(2, HW, 13)
        for i in range(2):
            jstate, _ = jstep(jstate, jnp.asarray(x),
                              jax.random.fold_in(KEY, i))
        JCheckpointManager(str(tmp_path)).save(jax.device_get(jstate))
        model = TModel(TConfig(**kw), None, seed=3, device="cpu")
        model.initialized = True
        tx = t_make_optimizer("adam", t_schedule(*SCHEDULE))
        step = t_make_train_step(model, TTrainConfig(), tx,
                                 num_pixels=HW[0] * HW[1])
        tstate = TCheckpointManager(str(tmp_path), convert=large_convert
                                    ).restore(t_init_state(model, tx, 1.0))
        assert tstate.step == 2
        key = jax.random.fold_in(KEY, 2)
        jstate, jm = jstep(jstate, jnp.asarray(x), key)
        tstate, tm = step(tstate, torch.from_numpy(x),
                          jax_noise(key, 2, HW))
        _check_metrics(tm, jm, "third step")


def _load_reference(tmp_path_factory, name):
    """examples/lossless/<name>.py as a module; the JAX compilation cache
    it turns on is a temporary one, and JAX's setting is put back."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    old = os.environ.get("REC_TPU_COMPILATION_CACHE")
    old_dir = jax.config.jax_compilation_cache_dir
    os.environ["REC_TPU_COMPILATION_CACHE"] = cache
    try:
        spec = importlib.util.spec_from_file_location(
            f"reference_{name}",
            os.path.join(REPO, "examples", "lossless", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        if old is None:
            os.environ.pop("REC_TPU_COMPILATION_CACHE")
        else:
            os.environ["REC_TPU_COMPILATION_CACHE"] = old
    return mod


class _JaxKeys:
    def __init__(self, key):
        self.key = key


def _jax_normal(generator, shape, dtype, device):
    generator.key, sub = jax.random.split(generator.key)
    return torch.tensor(np.asarray(jax.random.normal(sub, tuple(shape),
                                                     jnp.float32)),
                        dtype=dtype, device=device)


def _jax_forward_noise(cfg, image_shape, seed, fold=None):
    key = jax.random.PRNGKey(seed)
    if fold is not None:
        key = jax.random.fold_in(key, fold)
    return jax_noise(key, 1, image_shape[1:3],
                     dataclasses.asdict(cfg.large_cfg))


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tgauss, "standard_normal", _jax_normal)
    monkeypatch.setattr(tcp, "forward_noise", _jax_forward_noise)
    monkeypatch.setattr(tcp, "fit_generator", lambda cfg, i, n: _JaxKeys(
        jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 1000 + i * 64 + n)))


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """Two 128x128 test images, a rec_tpu checkpoint of the model
    initialised on two images of that size, and the reference CLI."""
    root = tmp_path_factory.mktemp("large_cli")
    rs = np.random.RandomState(0)
    os.makedirs(root / "data")
    np.savez(root / "data" / "tiny128_test.npz",
             images=rs.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8))
    _, params = _init(JConfig(**WIDTHS), hw=(128, 128), perturb=False)
    state = j_init_state(params, j_make_optimizer("adam", 1e-3), beta=1.0)
    for d in ("ckpt_jax", "ckpt_torch", "ckpt_tile"):
        JCheckpointManager(str(root / d)).save(jax.device_get(state))
    return root, _load_reference(tmp_path_factory, "compression_performance")


def _cli_args(root, which, ckpt, *extra):
    return TINY + ["model=large_resnet_vae", "n_beams=4", "block_size=64",
                   "max_partitions=1", "num_images=2",
                   "dataset.dataset=tiny128",
                   f"dataset.data_dir={root / 'data'}",
                   f"model_save_dir={root / ckpt}",
                   f"output_dir={root / which}", *extra]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _check_rows(rows, want):
    assert [r["index"] for r in rows] == [r["index"] for r in want]
    for w, g in zip(want, rows):
        assert g["roundtrip_ok"] == w["roundtrip_ok"] == "True"
        for k in ("width", "height", "seed"):
            assert g[k] == w[k], k
        for k in ("total_kl", "ideal_elbo_bpd", "ideal_psnr",
                  "ideal_ms_ssim"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-4,
                                       err_msg=f"{g['index']}: {k}")


def _latents(root, which, labels, budgets):
    return [tio.read_rec(str(root / which / f"img_{label}.rec"),
                         max_partitions=b)[3]
            for label, b in zip(labels, budgets)]


class TestCli:
    def test_initialize_then_compress_match_jax(self, cli_setup, jax_draws):
        """Both modes of both CLIs on one rec_tpu checkpoint: the ratio
        table within 1e-3, then per image the ideal pass's numbers, the
        grown budget, counts equal and >= 95% of indices, two groups per
        .rec (block 2's 16 dims in 1 block, block 1's 512 in 8)."""
        root, jcp = cli_setup
        name = "coder_ratios_3.0.npy"
        jcp.main(_cli_args(root, "jax_init", "ckpt_jax", "mode=initialize"))
        got = tcp.main(_cli_args(root, "torch_init", "ckpt_torch",
                                 "mode=initialize", "device=cpu"))
        assert got["fits"] > 0
        np.testing.assert_allclose(got["table"],
                                   np.load(root / "ckpt_jax" / name),
                                   rtol=1e-3)
        # Both CLIs compress with the port's table.
        shutil.copy(root / "ckpt_torch" / name, root / "ckpt_jax" / name)

        jcp.main(_cli_args(root, "jax", "ckpt_jax"))
        stats = tcp.main(_cli_args(root, "torch", "ckpt_torch",
                                   "device=cpu"))
        assert stats["crashes"] == 0 and min(stats["budgets"]) > 1
        want_rows = _rows(root / "jax" / "tiny128.csv")
        _check_rows(_rows(root / "torch" / "tiny128.csv"), want_rows)
        lat = {w: _latents(root, w, [0, 1], stats["budgets"])
               for w in ("jax", "torch")}
        for a, b in zip(lat["jax"], lat["torch"]):
            assert [len(c) for _, c in b] == [1, 8]
            for (ia, ca), (ib, cb) in zip(a, b):
                np.testing.assert_array_equal(cb, ca)
            ind_a = np.concatenate([i.ravel() for i, _ in a])
            ind_b = np.concatenate([i.ravel() for i, _ in b])
            assert np.mean(ind_a == ind_b) >= 0.95
        for w, g in zip(want_rows, stats["rows"]):
            assert g["latent_code_bits"] == float(w["latent_code_bits"])

    def test_update_sampler_matches_jax(self, cli_setup, jax_draws):
        """``mode=update_sampler`` through both CLIs on one checkpoint:
        each image's two groups (block 2's 16 dims, block 1's first of 8
        blocks of 64) update the rejection coder; the averaged acceptance
        probabilities agree to atol 1e-6 (the forwards agree to float
        tolerance only, ROADMAP C4; the deviation is printed)."""
        root, jcp = cli_setup
        for w in ("jax", "torch"):
            shutil.copytree(root / "ckpt_tile", root / f"ckpt_rs_{w}")
        jcp.main(_cli_args(root, "jax_rs", "ckpt_rs_jax",
                           "mode=update_sampler"))
        got = tcp.main(_cli_args(root, "torch_rs", "ckpt_rs_torch",
                                 "mode=update_sampler", "device=cpu"))
        name = "rejection_acceptance.npy"
        want = np.load(root / "ckpt_rs_jax" / name)
        table = np.load(root / "ckpt_rs_torch" / name)
        assert got["restored"] and len(got["updates"]) == 2
        assert table.shape == want.shape == (10000,)
        assert np.all(table >= 0.0) and table.sum() <= 1.0 + 1e-9
        print("update_sampler max |port - rec_tpu|:",
              float(np.max(np.abs(table - want))))
        np.testing.assert_allclose(table, want, atol=1e-6)

    def test_tiles_match_jax(self, cli_setup, jax_draws):
        """tile=64 on 128x128 images: 4 tiles per image, each its own unit
        (seed, file, row) and exact, then one total row per image."""
        root, jcp = cli_setup
        jcp.main(_cli_args(root, "jax_tile", "ckpt_tile", "tile=64"))
        stats = tcp.main(_cli_args(root, "torch_tile", "ckpt_tile", "tile=64",
                                   "device=cpu"))
        rows = _rows(root / "torch_tile" / "tiny128.csv")
        want = _rows(root / "jax_tile" / "tiny128.csv")
        labels = [f"{i}_t{r}_{c}" for i in range(2) for r in range(2)
                  for c in range(2)]
        assert [r["index"] for r in rows] == labels + ["0_total", "1_total"]
        _check_rows(rows, want)
        assert stats["crashes"] == 0 and len(stats["budgets"]) == 8
        for a, b in zip(_latents(root, "jax_tile", labels, stats["budgets"]),
                        _latents(root, "torch_tile", labels,
                                 stats["budgets"])):
            for (ia, ca), (ib, cb) in zip(a, b):
                np.testing.assert_array_equal(cb, ca)
        for k in ("latent_code_bits", "residual_bits", "file_bits"):
            tiles = sum(float(r[k]) for r in rows[:4])
            assert float(rows[8][k]) == pytest.approx(tiles)
        assert rows[8]["width"] == "128" and rows[8]["roundtrip_ok"] == "True"

    def test_pad_multiple_is_64(self):
        cfg = tcp.Config(model="large_resnet_vae")
        assert tcp.pad_multiple_for(cfg) == 64
        assert tcp.pad_multiple_for(tcp.Config()) == 2
        assert tcp.Config().large_cfg.likelihood == "discretized_logistic"

    def test_trainer_then_compress_reads_laplace(self, tmp_path,
                                                 monkeypatch, capsys):
        """The trainer at model=large_resnet_vae writes checkpoints and
        model_config.json of kind large_resnet_vae with its laplace
        default; the compress CLI restores them, read as laplace, and
        compresses exactly."""
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        rs = np.random.RandomState(3)
        np.savez(tmp_path / "tiny128_train.npz",
                 images=rs.randint(0, 256, (4, 128, 128, 3)).astype(
                     np.uint8))
        np.savez(tmp_path / "tiny128_test.npz",
                 images=rs.randint(0, 256, (1, 128, 128, 3)).astype(
                     np.uint8))
        ckpt = tmp_path / "ckpt"
        stats = tcli.main(TINY + [
            "model=large_resnet_vae", "batch_size=2", "iters=3",
            "log_freq=2", "dataset.dataset=tiny128",
            f"dataset.data_dir={tmp_path}", f"model_save_dir={ckpt}",
            f"log_dir={tmp_path / 'logs'}", "device=cpu"])
        assert stats["steps"] == 3 and np.all(np.isfinite(stats["loss"]))
        with open(ckpt / "model_config.json") as f:
            saved = json.load(f)
        assert saved["kind"] == "large_resnet_vae"
        assert saved["cfg"]["likelihood"] == "laplace"
        with open(tmp_path / "logs" / "metrics.jsonl") as f:
            logged = [json.loads(line) for line in f]
        assert {"KL/dim_1", "KL/dim_2"} <= set(logged[0])
        capsys.readouterr()
        out = tcp.main(TINY + [
            "model=large_resnet_vae", "n_beams=4", "block_size=64",
            "num_images=1", "max_budget=64", "dataset.dataset=tiny128",
            f"dataset.data_dir={tmp_path}", f"model_save_dir={ckpt}",
            f"output_dir={tmp_path / 'out'}", "device=cpu"])
        assert out["restored"] and out["crashes"] == 0
        assert out["rows"][0]["roundtrip_ok"]
        assert "'likelihood': 'laplace'" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["model=large_resnet_vae"],
    ["model=large_resnet_vae", "dataset.dataset=kodak"],
    ["model=large_resnet_vae", "dataset.dataset=clic2019", "lamb=0.2",
     "optimizer=adamax"],
    ["model=large_resnet_vae", "dataset.dataset=hopper512",
     "dataset.crop_size=128"],
    ["model=resnet_vae", "dataset.dataset=kodak"]])
def test_trainer_defaults_match_reference(tmp_path_factory, argv):
    """The large model's per-model defaults (adam, lamb 0.01, 256-crops of
    the big-image datasets) as the reference CLI sets them, never over
    what the command line set."""
    ref = _load_reference(tmp_path_factory, "train_generative_model")
    want = ref._model_defaults(ref.apply_overrides(ref.Config(), argv), argv)
    got = tcli._model_defaults(tcli.apply_overrides(tcli.Config(), argv),
                               argv)
    for k in ("optimizer", "lamb", "learning_rate"):
        assert getattr(got, k) == getattr(want, k), k
    assert dataclasses.asdict(got.dataset) == dataclasses.asdict(want.dataset)
    assert dataclasses.asdict(got.large_cfg) == dataclasses.asdict(
        want.large_cfg)
