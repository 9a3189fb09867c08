"""rec_tpu_torch's compress-CLI slice vs rec_tpu on JAX-CPU: code lengths,
the Gaussian conditionals, the aux-variance-ratio fit fed JAX's normals,
PSNR / SSIM / MS-SSIM, the probed and grown partition budget, and
``mode=initialize`` then ``mode=compress`` of both CLIs on one checkpoint
with the same noise, at a tiny config (2 res blocks, 8/4 filters, block
64, two 16x16 images)."""

import csv
import dataclasses
import importlib.util
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.coding import CodedLatent as JCoded
from rec_tpu.coding import GaussianParams as JG
from rec_tpu.coding import gauss as jgauss
from rec_tpu.coding import ratio_fit as jfit
from rec_tpu.models import likelihoods as jlik
from rec_tpu.models.resnet_vae import BidirectionalResNetVAE as JModel
from rec_tpu.models.resnet_vae import ResNetVAEConfig as JConfig
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state, make_optimizer
from rec_tpu.utils import metrics as jmetrics
from rec_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from rec_tpu_torch.cli import compression_performance as tcp
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.coding import CodedLatent as TCoded
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import gauss as tgauss
from rec_tpu_torch.coding import ratio_fit as tfit
from rec_tpu_torch.data.datasets import write_png
from rec_tpu_torch.io import read_rec
from rec_tpu_torch.models import likelihoods as tlik
from rec_tpu_torch.utils import metrics as tmetrics
from rec_tpu_torch.utils.profiling import PhaseTimer as TPhaseTimer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_res_blocks=2, deterministic_filters=8, stochastic_filters=4)
TINY = ["model_cfg.num_res_blocks=2", "model_cfg.deterministic_filters=8",
        "model_cfg.stochastic_filters=4", "block_size=64",
        "max_partitions=1", "num_images=2", "dataset.dataset=tiny16"]


class _JaxKeys:
    """A JAX key standing in for a torch.Generator: each draw splits it,
    as rec_tpu's ratio fitter splits its key once per fitted ratio."""

    def __init__(self, key):
        self.key = key


def _jax_normal(generator, shape, dtype, device):
    generator.key, sub = jax.random.split(generator.key)
    return torch.tensor(np.asarray(jax.random.normal(sub, tuple(shape),
                                                     jnp.float32)),
                        dtype=dtype, device=device)


def _jax_forward_noise(cfg, image_shape, seed, fold=None):
    """rec_tpu's posterior noise: normals per res block from
    split(key, num_res_blocks), key = PRNGKey(seed) or folded."""
    key = jax.random.PRNGKey(seed)
    if fold is not None:
        key = jax.random.fold_in(key, fold)
    mc = cfg.model_cfg
    _, H, W, _ = image_shape
    shape = (1, H // 2, W // 2, mc.stochastic_filters)
    return np.stack([np.asarray(jax.random.normal(k, shape))
                     for k in jax.random.split(key, mc.num_res_blocks)])


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's randomness replaced by rec_tpu's draws."""
    monkeypatch.setattr(tgauss, "standard_normal", _jax_normal)
    monkeypatch.setattr(tcp, "forward_noise", _jax_forward_noise)
    monkeypatch.setattr(tcp, "fit_generator", lambda cfg, i, n: _JaxKeys(
        jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 1000 + i * 64 + n)))


def _blocks(seed=0, N=6, D=80):
    """Targets of increasing KL against a standard-normal coder."""
    rs = np.random.RandomState(seed)
    spread = np.linspace(0.25, 1.5, N)[:, None]
    loc = (rs.randn(N, D) * spread).astype(np.float32)
    scale = np.exp(0.1 * rs.randn(N, D)).astype(np.float32)
    zeros, ones = np.zeros((N, D), np.float32), np.ones((N, D), np.float32)
    return ((JG(jnp.asarray(loc), jnp.asarray(scale)),
             JG(jnp.asarray(zeros), jnp.asarray(ones))),
            (TG(torch.from_numpy(loc), torch.from_numpy(scale)),
             TG(torch.from_numpy(zeros), torch.from_numpy(ones))))


class TestCodelength:
    @pytest.mark.parametrize("omega,extra", [(3.0, 1.2), (4.5, 1.2),
                                             (3.0, 1.0), (2.0, 1.1)])
    @pytest.mark.parametrize("n", [1, 4, 9, 32, 33, 197, 302])
    def test_matches_jax_bitwise(self, omega, extra, n):
        """Per-block count * ln S and the latent's sum: rec_tpu's float32
        bits, past 32 blocks too (XLA-CPU's order, ``xla_sum_f32``)."""
        counts = np.random.RandomState(n).randint(1, 200, n).astype(np.int32)
        kw = dict(kl_per_partition=omega, extra_samples=extra)
        jc, tc = JCoder(**kw), TCoder(**kw)
        want = np.asarray(jc._cfg().codelength_nats(jnp.asarray(counts)))
        got = tc._cfg().codelength_nats(torch.from_numpy(counts)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        want_sum = np.asarray(jc.codelength_nats(
            JCoded(None, jnp.asarray(counts), None)))
        got_sum = tc.codelength_nats(TCoded(None, torch.from_numpy(counts),
                                            None)).numpy()
        assert got_sum == want_sum


class TestGauss:
    def test_conditionals_match_jax(self):
        (jt, jc), (tt, tc) = _blocks(1)
        rs = np.random.RandomState(2)
        aux_var = (rs.rand(6, 80) * 0.9).astype(np.float32)
        sample = rs.randn(6, 80).astype(np.float32)
        ja, ta = jnp.asarray(aux_var), torch.from_numpy(aux_var)
        js, ts = jnp.asarray(sample), torch.from_numpy(sample)
        pairs = [
            (jgauss.auxiliary_coder(jc, ja), tgauss.auxiliary_coder(tc, ta)),
            (jgauss.conditional_coder(jc, ja, js),
             tgauss.conditional_coder(tc, ta, ts)),
            (jgauss.conditional_target(jt, jc, ja, js),
             tgauss.conditional_target(tt, tc, ta, ts)),
            (jgauss.standard_normal_like(jt.loc),
             tgauss.standard_normal_like(tt.loc))]
        for want, got in pairs:
            for w, g in zip(want, got):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=0)

    def test_last_partition_stays_finite(self):
        """aux_var == p_var: the clamped variances are 0, not NaN."""
        (_, _), (tt, tc) = _blocks(3)
        z = torch.zeros(6, 80)
        assert torch.equal(tgauss.conditional_coder(tc, tc.var, z).scale, z)
        assert torch.equal(
            tgauss.conditional_target(tt, tc, tc.var, z).scale, z)

    def test_sample_matches_jax(self, monkeypatch):
        """loc + scale * eps, eps of shape + loc.shape from the draw
        function, which a test can point at JAX's normals."""
        (jt, _), (tt, _) = _blocks(4)
        want = jt.sample(jax.random.PRNGKey(5), (2,))
        monkeypatch.setattr(
            tgauss, "standard_normal", lambda key, shape, dtype, device:
            torch.tensor(np.asarray(jax.random.normal(key, tuple(shape)))))
        got = tt.sample(jax.random.PRNGKey(5), (2,))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    def test_sample_is_seeded(self):
        (_, _), (tt, _) = _blocks(4)
        a = tt.sample(torch.Generator().manual_seed(0), (3,))
        assert a.shape == (3, 6, 80)
        assert torch.equal(a, tt.sample(torch.Generator().manual_seed(0),
                                        (3,)))


class TestRatioFit:
    def test_fit_one_ratio_matches_jax(self, monkeypatch):
        """One ratio with rec_tpu's normals: the ratio at rtol 1e-3, the
        conditioned distributions close, unselected blocks untouched."""
        monkeypatch.setattr(tgauss, "standard_normal", _jax_normal)
        (jt, jc), (tt, tc) = _blocks(6)
        mask = np.array([False, True, True, False, True, True])
        cfg = jfit.RatioFitConfig(kl_per_partition=3.0)
        key = jax.random.PRNGKey(9)
        _, sub = jax.random.split(key)
        jr, jt2, jc2 = jfit._fit_one_ratio(
            cfg, jt, jc, jnp.asarray(mask), jnp.asarray(7.0),
            jnp.asarray(0.2, jnp.float32), sub)
        got = tfit._fit_one_ratio(tfit.RatioFitConfig(kl_per_partition=3.0),
                                  tt, tc, torch.from_numpy(mask), 7, 0.2,
                                  _JaxKeys(key))
        np.testing.assert_allclose(got.ratio, float(jr), rtol=1e-3)
        assert 1 <= got.steps <= got.steps_run and got.syncs >= 1
        for w, g in ((jt2, got.target), (jc2, got.coder)):
            for a, b in zip(w, g):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(got.target.loc[~mask].numpy(),
                                      tt.loc[~mask].numpy())

    def test_update_matches_jax(self, monkeypatch):
        """A whole update, twice (the running average): every fitted ratio
        at rtol 1e-3, the count table exactly, and fitted()'s power-law
        entries exactly."""
        monkeypatch.setattr(tgauss, "standard_normal", _jax_normal)
        (jt, jc), (tt, tc) = _blocks(7)
        cfg = dict(kl_per_partition=3.0)
        jf = jfit.RatioFitter(jfit.RatioFitConfig(**cfg), max_partitions=40)
        tf = tfit.RatioFitter(tfit.RatioFitConfig(**cfg), max_partitions=40)
        for k in (1, 2):
            jf.update(jt, jc, jax.random.PRNGKey(k))
            tf.update(tt, tc, _JaxKeys(jax.random.PRNGKey(k)))
        np.testing.assert_array_equal(tf.counts, jf.counts)
        fitted = jf.counts > 0
        assert fitted.sum() > 10
        np.testing.assert_allclose(tf.ratios[fitted], jf.ratios[fitted],
                                   rtol=1e-3)
        want, got = np.array(jf.fitted()), np.array(tf.fitted())
        np.testing.assert_array_equal(got[~fitted], want[~fitted])
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert tf.fits == 2 * (fitted.sum() - 1)
        assert tf.steps <= tf.steps_run and tf.syncs > tf.fits

    @pytest.mark.parametrize("losses,want", [
        ([1.0, 0.5, 0.49995], 3),      # |L1 - L2| < tol at i = 3
        ([np.inf], 1),                  # inf - inf is NaN: stops at once
        ([5.0, 4.0, 3.0, 2.0], None),   # still moving
        ([5.0, 4.0, 3.0, 2.0], 4)])     # max_iters = 4
    def test_stop_step_is_the_while_loops_exit(self, losses, want):
        max_iters = 4 if want == 4 else 100
        got = tfit._stop_step(np.asarray(losses, np.float32),
                              np.float32(1e-4), max_iters, 1)
        assert got == want


class TestMetrics:
    @pytest.mark.parametrize("size,scales", [(48, 2), (176, 5)])
    @pytest.mark.parametrize("name", ["psnr", "ssim", "ms_ssim"])
    def test_match_jax(self, name, size, scales):
        rs = np.random.RandomState(size)
        a = rs.rand(2, size, size, 3).astype(np.float32)
        b = np.clip(a + 0.1 * rs.randn(*a.shape), 0, 1).astype(np.float32)
        kw = {}
        if name == "ms_ssim":
            w = np.asarray(jmetrics._MSSSIM_WEIGHTS[:scales])
            kw = dict(weights=w / w.sum())
        want = getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b), **kw)
        got = getattr(tmetrics, name)(torch.from_numpy(a),
                                      torch.from_numpy(b), **kw)
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_odd_sizes_pad_at_the_edge(self):
        """_avg_pool2 repeats the last row and column (edge padding)."""
        x = torch.arange(15.0).reshape(1, 3, 5, 1)
        got = tmetrics._avg_pool2(x)[0, :, :, 0]
        want = np.asarray(jmetrics._avg_pool2(jnp.asarray(x.numpy())))
        np.testing.assert_allclose(got.numpy(), want[0, :, :, 0])
        assert got[1, 2].item() == 14.0

    def test_ms_ssim_likelihood(self):
        rs = np.random.RandomState(1)
        a = rs.rand(1, 176, 176, 3).astype(np.float32) - 0.5
        b = a + 0.05 * rs.randn(*a.shape).astype(np.float32)
        want = jlik.ms_ssim_pseudo(jnp.asarray(a), jnp.asarray(b), 2.0)
        got = tlik.get_likelihood("ms-ssim")(torch.from_numpy(a),
                                             torch.from_numpy(b), 2.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _load_reference_cli(tmp_path_factory):
    """examples/lossless/compression_performance.py as a module.  Importing
    it turns on JAX's persistent compilation cache; the cache directory it
    makes is a temporary one, and JAX's setting is put back afterwards, so
    later tests compile as they would without this module."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    old = os.environ.get("REC_TPU_COMPILATION_CACHE")
    old_dir = jax.config.jax_compilation_cache_dir
    os.environ["REC_TPU_COMPILATION_CACHE"] = cache
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_compression_performance",
            os.path.join(REPO, "examples", "lossless",
                         "compression_performance.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        if old is None:
            os.environ.pop("REC_TPU_COMPILATION_CACHE")
        else:
            os.environ["REC_TPU_COMPILATION_CACHE"] = old
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two 16x16 test images, a rec_tpu checkpoint of the tiny RVAE, and
    the reference CLI module."""
    root = tmp_path_factory.mktemp("compress")
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 16, 16, 3)).astype(np.float32)
    os.makedirs(root / "data")
    np.savez(root / "data" / "tiny16_test.npz", images=images)
    model = JModel(cfg=JConfig(**CFG), coder=JCoder())
    x = images / 255.0 - 0.5
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                                 jax.random.PRNGKey(1))
    # Sharper posteriors than the init's, so the probe has to grow the
    # budget past max_partitions=1.
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p - 1.5 if "log_scale_head" in str(path)
        and "bias" in str(path) else p, params)
    state = init_state(params, make_optimizer("adamax", 1e-3), beta=1.0)
    for d in ("ckpt_jax", "ckpt_torch"):
        JCheckpointManager(str(root / d)).save(jax.device_get(state))
    return root, _load_reference_cli(tmp_path_factory), params


def test_reference_import_keeps_jax_cache_setting(tmp_path_factory):
    before = jax.config.jax_compilation_cache_dir
    _load_reference_cli(tmp_path_factory)
    assert jax.config.jax_compilation_cache_dir == before


def _args(root, which, mode):
    return TINY + [f"mode={mode}", f"dataset.data_dir={root / 'data'}",
                   f"model_save_dir={root / ('ckpt_' + which)}",
                   f"output_dir={root / ('out_' + which)}"]


def _rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


class TestCli:
    def test_initialize_then_compress_match_jax(self, setup, jax_draws):
        root, jcp, _ = setup
        jcp.main(_args(root, "jax", "initialize"))
        got = tcp.main(_args(root, "torch", "initialize") + ["device=cpu"])
        name = "coder_ratios_3.0.npy"
        want_table = np.load(root / "ckpt_jax" / name)
        table = np.load(root / "ckpt_torch" / name)
        assert table.shape == want_table.shape == (192,)
        assert got["fits"] > 0 and got["steps"] > 0 and got["syncs"] > 0
        np.testing.assert_allclose(table, want_table, rtol=1e-3)
        # The ratio file loads in both packages: rec_tpu's CLI compresses
        # with the port's table, and the port compresses with it too.
        shutil.copy(root / "ckpt_torch" / name, root / "ckpt_jax" / name)

        jcp.main(_args(root, "jax", "compress"))
        stats = tcp.main(_args(root, "torch", "compress") + ["device=cpu"])
        assert stats["crashes"] == 0 and stats["budgets"][0] > 1
        fields, want = _rows(root / "out_jax" / "tiny16.csv")
        tfields, rows = _rows(root / "out_torch" / "tiny16.csv")
        assert tfields == fields == tcp.FIELDS
        assert len(rows) == len(want) == 2
        for w, g in zip(want, rows):
            assert g["roundtrip_ok"] == w["roundtrip_ok"] == "True"
            for k in ("total_kl", "ideal_elbo_bpd", "ideal_psnr",
                      "ideal_ms_ssim"):
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=1e-4, err_msg=k)
            for k in ("index", "width", "height", "seed"):
                assert g[k] == w[k]

        ind, cnt = {}, {}
        for which in ("jax", "torch"):
            lat = [read_rec(str(root / f"out_{which}" / f"img_{i}.rec"),
                            max_partitions=stats["budgets"][i])[3]
                   for i in range(2)]
            ind[which] = np.stack([[a for a, _ in li] for li in lat])
            cnt[which] = np.stack([[c for _, c in li] for li in lat])
        np.testing.assert_array_equal(cnt["torch"], cnt["jax"])
        np.testing.assert_array_equal(ind["torch"][:, 0], ind["jax"][:, 0])
        assert np.mean(ind["torch"] == ind["jax"]) >= 0.95
        # Equal counts give rec_tpu's code length bit for bit.
        for w, g in zip(want, rows):
            assert float(g["latent_code_bits"]) == float(w["latent_code_bits"])
        # The index arrays beside the files.
        with np.load(root / "out_torch" / "block_indices_0.npz") as f:
            np.testing.assert_array_equal(f["indices_1"], ind["torch"][0, 1])

    def test_importance_compress_matches_jax(self, setup, jax_draws):
        """``sampler=importance`` through both CLIs on one checkpoint:
        exact images, the files' counts and indices equal (max_index
        2^coding_bits in the container), and the CSV's latent code bits
        equal."""
        root, jcp, _ = setup
        extra = ["sampler=importance", "coding_bits=6"]
        args = {w: [a.replace(f"out_{w}", f"out_{w}_imp")
                    for a in _args(root, w, "compress")] + extra
                for w in ("jax", "torch")}
        jcp.main(args["jax"])
        stats = tcp.main(args["torch"] + ["device=cpu"])
        assert stats["crashes"] == 0
        _, want = _rows(root / "out_jax_imp" / "tiny16.csv")
        _, rows = _rows(root / "out_torch_imp" / "tiny16.csv")
        assert len(rows) == len(want) == 2
        for i, (w, g) in enumerate(zip(want, rows)):
            assert g["roundtrip_ok"] == w["roundtrip_ok"] == "True"
            files = [read_rec(str(root / f"out_{x}_imp" / f"img_{i}.rec"),
                              max_partitions=stats["budgets"][i])
                     for x in ("jax", "torch")]
            for (ja, jc), (ta, tc) in zip(files[0][3], files[1][3]):
                np.testing.assert_array_equal(tc, jc)
                np.testing.assert_array_equal(ta, ja)
            assert float(g["latent_code_bits"]) == float(w["latent_code_bits"])

    def test_required_budget_matches_jax(self, setup, monkeypatch):
        root, jcp, params = setup
        monkeypatch.setattr(tcp, "forward_noise", _jax_forward_noise)
        x = np.random.RandomState(3).rand(1, 16, 16, 3).astype(np.float32)
        jcfg = jcp.apply_overrides(jcp.Config(), TINY)
        jcoder = jcp.build_coder(jcfg)
        want = jcp.required_budget(jcfg, jcp.ModelAdapter(jcfg, jcoder),
                                   jcoder, params, jnp.asarray(x - 0.5), 7)
        tcfg = tcp.apply_overrides(tcp.Config(), TINY + ["device=cpu"])
        tcoder = tcp.build_coder(tcfg)
        model, restored = tcp.load_model(
            dataclasses.replace(tcfg, model_save_dir=str(root / "ckpt_jax")),
            tcoder, x - 0.5, "cpu")
        assert restored
        got = tcp.required_budget(tcfg, model, tcoder,
                                  torch.from_numpy(x - 0.5), 7)
        assert got == want > 1


class TestGrowBudget:
    @pytest.mark.parametrize("need,start", [(7, 6), (25, 24), (100, 24),
                                            (8000, 24), (9000, 24),
                                            (10 ** 6, 2000)])
    def test_headroom_and_cap_match_reference(self, setup, need, start):
        _, jcp, _ = setup
        log = logging.getLogger("test_grow_budget")
        jcfg, tcfg = jcp.Config(max_partitions=start), tcp.Config(
            max_partitions=start)
        want = jcp.grow_budget(jcfg, log, jcp.build_coder(jcfg), need)
        got = tcp.grow_budget(tcfg, log, tcp.build_coder(tcfg), need)
        assert got.max_partitions == want.max_partitions
        assert got.max_partitions >= min(need, tcfg.max_budget)

    def test_never_shrinks_a_budget_the_user_set(self, setup):
        """The reference caps an explicit max_partitions=10000 down to
        max_budget=8192 when a later image probes 12000; the port keeps
        10000."""
        _, jcp, _ = setup
        log = logging.getLogger("test_grow_budget")
        jcfg = jcp.Config(max_partitions=10000)
        tcfg = tcp.Config(max_partitions=10000)
        assert jcp.grow_budget(jcfg, log, jcp.build_coder(jcfg),
                               12000).max_partitions == 8192
        assert tcp.grow_budget(tcfg, log, tcp.build_coder(tcfg),
                               12000).max_partitions == 10000


class TestOptions:
    @pytest.mark.parametrize("option,item", [
        ("mode=update_sampler", "A4b")])
    def test_unported_options_raise(self, tmp_path, option, item):
        with pytest.raises(NotImplementedError, match=item):
            tcp.main(TINY + [option, f"output_dir={tmp_path}",
                             "device=cpu"])

    def test_runs_on_the_card_by_default(self, tmp_path):
        """No device= means CUDA; without a card that raises instead of
        running on the CPU."""
        if torch.cuda.is_available():
            assert tcp.process_device(tcp.Config().device, 0).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tcp.main(TINY + [f"output_dir={tmp_path}"])

    def test_matmul_precision_highest_is_accepted(self, tmp_path):
        stats = tcp.main(TINY + ["matmul_precision=highest", "num_images=1",
                                 "dataset.synthetic_size=1",
                                 "dataset.dataset=cifar10",
                                 f"output_dir={tmp_path}",
                                 f"model_save_dir={tmp_path}/ckpt",
                                 "device=cpu", "save_reconstructions=true"])
        assert stats["crashes"] == 0 and stats["synthetic"]
        assert os.path.exists(tmp_path / "recon_0.png")


def test_write_png_and_phase_dump_match_reference(tmp_path):
    from PIL import Image

    from rec_tpu.data.datasets import write_png as j_write_png

    img = np.random.RandomState(0).rand(5, 7, 3)
    write_png(str(tmp_path / "t.png"), img)
    j_write_png(str(tmp_path / "j.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    for timer, name in ((TPhaseTimer(), "t.json"), (JPhaseTimer(), "j.json")):
        with timer.phase("encode"):
            pass
        timer.dump(str(tmp_path / name))
    import json

    t, j = (json.load(open(tmp_path / n)) for n in ("t.json", "j.json"))
    assert t.keys() == j.keys() and t["encode"].keys() == j["encode"].keys()
