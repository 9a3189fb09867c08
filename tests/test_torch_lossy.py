"""rec_tpu_torch's lossy regime vs rec_tpu on JAX-CPU: the signal layers
(irdft basis, SignalConv2D at every geometry the models use, reflect
padding, GDN), the transforms and both models with weights carried over by
the converter and JAX's noise fed in, REC coding of both levels, .rec files
across the packages, the batched path, the converter round trip, the
saturation warning, the split permutation at a Kodak image's level-1 size
and both lossy CLIs at a tiny size on the CPU (the serving CLI also on two
mesh entries, against two processes and rec_tpu's ``n_devices=2``)."""

import csv
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.coding import GaussianParams as JG
from rec_tpu.coding import partition as jpart
from rec_tpu.coding import rng as jrng
from rec_tpu.io import write_rec as j_write_rec
from rec_tpu.models import modules as jmod
from rec_tpu.models.lossy import Large1LevelVAE as J1
from rec_tpu.models.lossy import Large2LevelVAE as J2
from rec_tpu.models.lossy import compress_to_file as j_compress_to_file
from rec_tpu.models.lossy import decompress_from_file as j_decompress
from rec_tpu.models.lossy import transforms as jtr
from rec_tpu_torch.cli import compress_with_lossy_model as tcli
from rec_tpu_torch.cli import lossy_serve as tserve
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import beam_search as tbs
from rec_tpu_torch.coding import partition as tpart
from rec_tpu_torch.coding import rng as trng
from rec_tpu_torch.io import read_rec, write_rec
from rec_tpu_torch.models import signal as tsig
from rec_tpu_torch.models.lossy import Large1LevelVAE as T1
from rec_tpu_torch.models.lossy import Large2LevelVAE as T2
from rec_tpu_torch.models.lossy import compress_to_file, decompress_from_file
from rec_tpu_torch.models.lossy.convert import (from_numpy_tree,
                                                load_flax_params,
                                                to_numpy_tree)
from rec_tpu_torch.parallel import (make_batch_rec_decode,
                                    make_batch_rec_forward)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODER = dict(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
             block_size=64, max_partitions=8)
MODULE_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
# The CSV columns of examples/lossy/compress_with_lossy_model.py:159-169.
REFERENCE_FIELDS = ["index", "seed", "ideal_bpp", "actual_bpp",
                    "ideal_psnr", "psnr", "ideal_ms_ssim", "ms_ssim",
                    "ms_ssim_db", "comp_time"]
# The CLIs' tiny settings: 8/8 filters, a small coder, 256x256 images (the
# smallest the reference's 5-scale MS-SSIM takes).
TINY = ["level_1_filters=8", "level_2_filters=8", "n_beams=3",
        "block_size=64", "max_partitions=6"]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _perturbed(params, seed):
    """A params tree with every leaf moved off its initial value (zero
    biases and identity GDN matrices would hide layout errors)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 * rs.randn(*a.shape), np.float32),
        jax.device_get(params))


# ---------------------------------------------------------------------------
# Signal layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3), (5, 5), (9, 9), (2, 2), (4, 3)])
def test_irdft_matrix(shape):
    np.testing.assert_allclose(tsig.irdft_matrix(shape),
                               jmod.irdft_matrix(shape), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("pad", [(1, 1), (0, 3), (4, 2), (7, 9)])
def test_reflect_pad_is_numpys(n, pad):
    """Pads of any size, a size-1 axis included, as jnp.pad reflects."""
    x = np.arange(2 * n * n, dtype=np.float32).reshape(1, n, n, 2)
    want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), pad, pad[::-1],
                                               (0, 0)), mode="reflect"))
    got = _nhwc(tsig.reflect_pad(_nchw(x), (pad, pad[::-1])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(8, 8), (1, 1), (2, 1)])
@pytest.mark.parametrize("dft", [True, False])
@pytest.mark.parametrize("kernel,down,up,corr", [
    (9, 4, 1, True), (5, 2, 1, True), (3, 1, 1, True),
    (5, 1, 2, False), (3, 1, 1, False), (9, 1, 4, False)])
def test_signal_conv(kernel, down, up, corr, dft, hw):
    """SignalConv2D at each geometry of the two models (down 9x9/s4, 5x5/s2,
    3x3/s1 correlations; up 5x5/s2, 3x3/s1, 9x9/s4 convolutions), with and
    without the RDFT parametrisation, on inputs down to 1x1 and 2x1."""
    rs = np.random.RandomState(kernel * 10 + up)
    x = rs.randn(2, *hw, 4).astype(np.float32)
    jm = jmod.SignalConv2D(features=5, kernel=(kernel, kernel), corr=corr,
                           strides_down=down, strides_up=up,
                           dft_parametrization=dft)
    params = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tsig.SignalConv2D(4, 5, (kernel, kernel), corr, down, up,
                           dft_parametrization=dft)
    load_flax_params(tm, params)
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **MODULE_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn(inverse):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 4, 6).astype(np.float32)
    jm = jmod.GDN(inverse=inverse)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # Positive reparameterisations well above the bounds, and a few below
    # them, so lower_bound clamps somewhere.
    p = params["params"]
    p["beta_reparam"] = np.abs(rs.randn(6)).astype(np.float32) + 0.5
    p["gamma_reparam"] = (0.3 * rs.randn(6, 6)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tsig.GDN(6, inverse=inverse)
    load_flax_params(tm, params)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), want, **MODULE_TOL)


# ---------------------------------------------------------------------------
# Transforms and models
# ---------------------------------------------------------------------------

def _images(n=1, hw=(64, 64), seed=0):
    return np.random.RandomState(seed).rand(n, *hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def level1():
    jmodel = J1(num_filters=16, coder=JCoder(**CODER))
    x = _images(2)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    jax.random.PRNGKey(1)), 5)
    tmodel = T1(16, TCoder(**CODER), device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel.requires_grad_(False), x


@pytest.fixture(scope="module")
def level2():
    jmodel = J2(level_1_filters=12, level_2_filters=8, coder=JCoder(**CODER))
    x = _images(2, seed=1)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    jax.random.PRNGKey(1)), 6)
    tmodel = T2(12, 8, TCoder(**CODER), device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel.requires_grad_(False), x


def _transform_cases(level1, level2):
    """(flax module, its params, the port's module, input, call args)."""
    _, p1, t1, x1 = level1
    _, p2, t2, x2 = level2
    p1, p2 = p1["params"], p2["params"]
    rs = np.random.RandomState(7)
    l1 = rs.randn(2, 4, 4, 12).astype(np.float32)
    z2 = rs.randn(2, 1, 1, 8).astype(np.float32)
    return {
        "analysis_l1": (jtr.AnalysisTransform(16, stages=((9, 4), (5, 2)),
                                              head_bias=False),
                        p1["analysis"], t1.analysis, x1),
        "synthesis_l1": (jtr.SynthesisTransform(16, stages=((5, 2),) * 2,
                                                final_kernel=9,
                                                final_stride=4),
                         p1["synthesis"], t1.synthesis,
                         rs.randn(2, 4, 4, 16).astype(np.float32)),
        "analysis_l2": (jtr.AnalysisTransform(12), p2["analysis"],
                        t2.analysis, x2),
        "synthesis_l2": (jtr.SynthesisTransform(12), p2["synthesis"],
                         t2.synthesis, l1),
        "hyper_analysis": (jtr.HyperAnalysisTransform(8),
                           p2["hyper_analysis"], t2.hyper_analysis, l1),
        "hyper_synthesis": (jtr.HyperSynthesisTransform(8, 12),
                            p2["hyper_synthesis"], t2.hyper_synthesis, z2),
    }


@pytest.mark.parametrize("name", ["analysis_l1", "synthesis_l1",
                                  "analysis_l2", "synthesis_l2",
                                  "hyper_analysis", "hyper_synthesis"])
def test_transform(level1, level2, name):
    jm, params, tm, x = _transform_cases(level1, level2)[name]
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(_nchw(x))
    if isinstance(got, torch.Tensor):   # a synthesis gives one tensor
        want, got = [want], [got]
    for w, g in zip(want, got):
        assert _nhwc(g).shape == np.shape(w)
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **MODEL_TOL)


@pytest.mark.parametrize("which", ["level1", "level2"])
def test_empirical_prior(level1, level2, which):
    """The constant prior at a 1x1 grid (reflect pads of 1 on size-1 axes)
    and at 3x2."""
    _, params, tmodel, _ = level1 if which == "level1" else level2
    name, nf = (("prior", 16) if which == "level1"
                else ("level_2_prior", 8))
    jm = jtr.EmpiricalPrior(nf)
    for h, w in ((1, 1), (3, 2)):
        want = jm.apply({"params": params["params"][name]}, 2, h, w)
        got = getattr(tmodel, name)(2, h, w)
        for a, b in zip(want, got):
            np.testing.assert_allclose(_nhwc(b), np.asarray(a), **MODEL_TOL)


def _jax_dists_l1(m, x):
    B, H, W, _ = x.shape
    post, prior = m._dists(x, B, H, W)
    return [post], [prior]


def _jax_dists_l2(m, x, key):
    B, H, W, _ = x.shape
    k2, _ = jax.random.split(key)
    l2_post, l1_loc, l1_ls = m._level2_posterior(x)
    z2 = l2_post.sample(k2)
    l1_post, l1_prior = m._level1_dists(z2, l1_loc, l1_ls)
    return [l2_post, l1_post], [m._level2_prior(B, H, W), l1_prior]


def _jax_noise(key, shapes, levels):
    """The standard normals rec_tpu's training forward draws, per level."""
    keys = [key] if levels == 1 else list(jax.random.split(key))
    return [np.asarray(jax.random.normal(k, s)) for k, s in zip(keys, shapes)]


@pytest.mark.parametrize("which", ["level1", "level2"])
def test_model_forward(level1, level2, which):
    """Posterior and prior parameters of every level, the latent samples,
    KLs and the reconstruction, with JAX's noise fed to the port."""
    jmodel, params, tmodel, x = level1 if which == "level1" else level2
    key = jax.random.PRNGKey(9)
    want = jmodel.apply(params, jnp.asarray(x), key)
    if which == "level1":
        posts, priors = jmodel.apply(params, jnp.asarray(x),
                                     method=_jax_dists_l1)
    else:
        posts, priors = jmodel.apply(params, jnp.asarray(x), key,
                                     method=_jax_dists_l2)
    noise = _jax_noise(key, [np.shape(z) for z in want["latents"]],
                       len(want["latents"]))
    got = tmodel(torch.from_numpy(x), noise)
    for a, b in zip(posts + priors, got["posteriors"] + got["priors"]):
        np.testing.assert_allclose(b.loc.numpy(), np.asarray(a.loc),
                                   **MODEL_TOL)
        np.testing.assert_allclose(b.scale.numpy(), np.asarray(a.scale),
                                   **MODEL_TOL)
    for a, b in zip(want["latents"], got["latents"]):
        assert b.shape == np.shape(a)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **MODEL_TOL)
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               **MODEL_TOL)
    np.testing.assert_allclose([float(k) for k in got["kls"]],
                               [float(k) for k in want["kls"]], rtol=1e-4)


@pytest.fixture(scope="module")
def coded(level1, level2):
    """rec_forward of one image, both packages, both models."""
    out = {}
    for name, (jmodel, params, tmodel, x) in (("level1", level1),
                                              ("level2", level2)):
        seed = 1234
        want = jmodel.apply(params, jnp.asarray(x[:1]), seed,
                            method=jmodel.rec_forward)
        got = tmodel.rec_forward(torch.from_numpy(x[:1]), seed)
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("which", ["level1", "level2"])
def test_rec_forward_matches_jax(coded, which):
    """The first-coded level's counts and indices equal, all counts equal,
    >= 95% of all indices equal, and the reconstructions close."""
    want, got = coded[which]
    wl, gl = want["latents"], got["latents"]
    assert len(wl) == len(gl) == (1 if which == "level1" else 2)
    np.testing.assert_array_equal(gl[0][1].numpy(), np.asarray(wl[0][1]))
    np.testing.assert_array_equal(gl[0][0].numpy(), np.asarray(wl[0][0]))
    wi = np.concatenate([np.asarray(i).ravel() for i, _ in wl])
    gi = np.concatenate([i.numpy().ravel() for i, _ in gl])
    wc = np.concatenate([np.asarray(c) for _, c in wl])
    gc = np.concatenate([c.numpy() for _, c in gl])
    np.testing.assert_array_equal(gc, wc)
    assert np.mean(wi == gi) >= 0.95
    np.testing.assert_allclose([float(k) for k in got["kls"]],
                               [float(k) for k in want["kls"]], rtol=1e-4)
    if np.array_equal(wi, gi):
        np.testing.assert_allclose(got["reconstruction"].numpy(),
                                   np.asarray(want["reconstruction"]),
                                   **MODEL_TOL)


def test_coded_latents_are_nhwc(level2):
    """Level by level, the port hands the coder (H, W, C) latents: the
    ideal pass's posterior of each level split with the coding seed gives
    JAX's per-block KLs, block for block."""
    jmodel, params, tmodel, x = level2
    key = jax.random.PRNGKey(9)
    posts, priors = jmodel.apply(params, jnp.asarray(x[:1]), key,
                                 method=_jax_dists_l2)
    want = jmodel.apply(params, jnp.asarray(x[:1]), key)
    noise = _jax_noise(key, [np.shape(z) for z in want["latents"]], 2)
    got = tmodel(torch.from_numpy(x[:1]), noise)
    for lvl, (q, p) in enumerate(zip(got["posteriors"], got["priors"])):
        assert q.loc.shape == np.shape(posts[lvl].loc)
        plan = jpart.plan_split(int(np.prod(q.loc.shape)), 64)
        perm = jpart.split_permutation(jrng.root_key(1234 + lvl), plan)
        jkl = jpart.block_kl(*jpart.split_pair(
            JG(posts[lvl].loc[0], posts[lvl].scale[0]),
            JG(priors[lvl].loc[0], priors[lvl].scale[0]), plan, perm))
        tplan = tpart.plan_split(plan.num_dims, 64)
        perms = tpart.split_permutations(
            trng.root_keys([1234 + lvl], device="cpu"), tplan)
        tkl = tpart.block_kl(tpart.split_coders(q, tplan, perms),
                             tpart.split_coders(p, tplan, perms))
        np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), rtol=1e-4)


def _replay_priors_jax(jmodel, params, hw, latents, seed):
    """The per-level coding priors and decoded samples of rec_tpu's decode
    (the level-1 prior from the decoded z2)."""
    H, W = hw
    coder = jmodel.coder

    def run(m):
        if isinstance(m, J1):
            p_loc, p_ls = m.prior(1, H // 16, W // 16)
            priors = [JG(p_loc[0], jtr.softplus_scale(p_ls)[0])]
            return priors, [coder.decode(priors[0], *latents[0], seed)]
        l2 = m._level2_prior(1, H, W)
        prior2 = JG(l2.loc[0], l2.scale[0])
        z2 = coder.decode(prior2, *latents[0], seed)
        p_loc, p_ls = m.hyper_synthesis(z2[None])
        prior1 = JG(p_loc[0], jtr.softplus_scale(p_ls)[0])
        return ([prior2, prior1],
                [z2, coder.decode(prior1, *latents[1], seed + 1)])

    return jmodel.apply(params, method=run)


@pytest.mark.parametrize("which", ["level1", "level2"])
def test_rec_files_cross_packages(level1, level2, tmp_path, which):
    """A .rec that rec_tpu's compress_to_file wrote decodes in the port,
    and one the port wrote decodes in rec_tpu: each latent level replayed
    bitwise equal to the other package's decode given the same prior, the
    reconstructions close, and the port's bytes those of rec_tpu's
    write_rec for the same indices."""
    jmodel, params, tmodel, x = level1 if which == "level1" else level2
    hw = x.shape[1:3]
    n_samples = TCoder(**CODER).n_samples
    for seed in (21, 22):
        j_path, t_path = str(tmp_path / "j.rec"), str(tmp_path / "t.rec")
        j_recon = j_compress_to_file(jmodel, params, j_path,
                                     jnp.asarray(x[0]), seed=seed,
                                     block_size=64, max_index=n_samples)
        t_recon = compress_to_file(tmodel, t_path, x[0], seed=seed,
                                   block_size=64, max_index=n_samples)
        np.testing.assert_allclose(
            decompress_from_file(tmodel, j_path, 8).numpy(),
            np.asarray(j_recon), **MODEL_TOL)
        np.testing.assert_allclose(
            np.asarray(j_decompress(jmodel, params, t_path, 8)),
            t_recon.numpy(), **MODEL_TOL)
        for path in (j_path, t_path):
            rseed, _, _, latents = read_rec(path, max_partitions=8)
            priors, samples = _replay_priors_jax(jmodel, params, hw,
                                                 latents, rseed)
            for lvl, ((ind, cnt), prior, z) in enumerate(
                    zip(latents, priors, samples)):
                got = tmodel.coder.decode(
                    TG(torch.from_numpy(np.asarray(prior.loc)),
                       torch.from_numpy(np.asarray(prior.scale))),
                    ind, cnt, rseed + lvl)
                assert np.array_equal(got.numpy().view(np.int32),
                                      np.asarray(z).view(np.int32))
            j_bytes = str(tmp_path / "jw.rec")
            j_write_rec(j_bytes, seed=rseed, image_shape=(*hw, 3),
                        block_size=64, max_index=n_samples, latents=latents)
            t_bytes = str(tmp_path / "tw.rec")
            write_rec(t_bytes, seed=rseed, image_shape=(*hw, 3),
                      block_size=64, max_index=n_samples, latents=latents)
            with open(j_bytes, "rb") as a, open(t_bytes, "rb") as b, \
                    open(path, "rb") as c:
                assert a.read() == b.read() == c.read()


# ---------------------------------------------------------------------------
# Batched path, converter, saturation, permutation
# ---------------------------------------------------------------------------

def test_batch_rec_forward_and_decode(level2, monkeypatch):
    """make_batch_rec_forward codes each level of the batch in one
    block-codec call; image i codes as rec_forward with seeds[i] (counts
    equal, indices >= 95%), its indices decode through the canonical
    rec_decode to the batched reconstruction, and make_batch_rec_decode
    reproduces all of them."""
    _, _, tmodel, _ = level2
    x = _images(3, seed=4)
    seeds = [50, 151, 252]
    calls = []
    real = tbs.encode_blocks
    monkeypatch.setattr(tbs, "encode_blocks", lambda *a, **k: (
        calls.append(tuple(a[1].loc.shape)) or real(*a, **k)))
    out = make_batch_rec_forward(tmodel)(x, np.asarray(seeds))
    assert calls == [(3, 8), (9, 64)]   # 1 + 3 blocks per image
    assert out["reconstruction"].shape == (3, 1, 64, 64, 3)
    for i, s in enumerate(seeds):
        one = tmodel.rec_forward(torch.from_numpy(x[i:i + 1]), s)
        for (bi, bc), (oi, oc) in zip(out["latents"], one["latents"]):
            np.testing.assert_array_equal(bc[i].numpy(), oc.numpy())
            assert np.mean(bi[i].numpy() == oi.numpy()) >= 0.95
        rec = tmodel.rec_decode((64, 64), [(a[i], c[i]) for a, c in
                                           out["latents"]], s)
        np.testing.assert_allclose(rec[0].numpy(),
                                   out["reconstruction"][i, 0].numpy(),
                                   atol=1e-4)
    dec = make_batch_rec_decode(tmodel, (64, 64))(out["latents"], seeds)
    np.testing.assert_allclose(dec.numpy(), out["reconstruction"].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("which", ["level1", "level2"])
def test_converter_round_trip(level1, level2, which):
    """flax tree -> port -> flax tree gives the same bits and structure; a
    fresh port model's tree runs in rec_tpu to the port's output."""
    jmodel, params, tmodel, x = level1 if which == "level1" else level2
    back = to_numpy_tree(from_numpy_tree(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    fresh = (T1(16, device="cpu", seed=3) if which == "level1"
             else T2(12, 8, device="cpu", seed=3)).requires_grad_(False)
    tree = to_numpy_tree(fresh)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(params))
    key = jax.random.PRNGKey(4)
    want = jmodel.apply(tree, jnp.asarray(x), key)
    noise = _jax_noise(key, [np.shape(z) for z in want["latents"]],
                       len(want["latents"]))
    got = fresh(torch.from_numpy(x), noise)
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               **MODEL_TOL)


def test_saturation_warning(level1, tmp_path):
    """compress_to_file warns when a block's count hits the budget."""
    _, _, tmodel, x = level1
    coder = tmodel.coder
    try:
        tmodel.coder = TCoder(**dict(CODER, max_partitions=1))
        with pytest.warns(UserWarning, match="max_partitions=1"):
            compress_to_file(tmodel, str(tmp_path / "s.rec"), x[0], seed=3,
                             block_size=64, max_index=coder.n_samples)
    finally:
        tmodel.coder = coder


@pytest.mark.parametrize("seed", [0, 1234])
def test_split_permutation_at_kodak_level1_size(seed):
    """A 512x768 image's level-1 latent (32 x 48 x 196 = 301,056 dims),
    where the 32-bit sort keys collide: the stable sorts agree with
    jax.random.permutation."""
    n = 32 * 48 * 196
    want = np.asarray(jax.random.permutation(
        jrng.split_key(jrng.root_key(seed)), n))
    got = tpart.split_permutations(trng.root_keys([seed], device="cpu"),
                                   tpart.plan_split(n, 1000))[0]
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def _compress_cli(tmp_path, *extra):
    return tcli.main(TINY + ["num_images=2", "dataset.dataset=clic2019",
                             "dataset.synthetic_size=2",
                             f"output_dir={tmp_path}/beta_0.01",
                             f"model_save_dir={tmp_path}/ckpt",
                             "device=cpu", *extra])


def test_compress_cli_csv_reads_in_rd_curves(tmp_path):
    """The compress CLI at a tiny size: 2 .rec files decoded within the
    CLI's tolerance, rec_tpu's CSV columns in order, and
    examples/lossy/rd_curves.py (numpy only) reads the CSV."""
    stats = _compress_cli(tmp_path)
    assert [r["index"] for r in stats["rows"]] == [0, 1]
    assert stats["synthetic"] and not stats["restored"]
    assert os.path.basename(stats["csv"]) == "large_level_2_vae_clic2019.csv"
    with open(stats["csv"]) as f:
        rows = list(csv.reader(f))
    assert rows[0] == REFERENCE_FIELDS and len(rows) == 3
    assert [len(c) for c in stats["counts"][0]] == [2, 32]
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "lossy",
                                      "rd_curves.py"),
         "--root", str(tmp_path), "--out", str(tmp_path / "rd")],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    curve = np.load(tmp_path / "rd" / "rd_curve.npy")
    assert curve.shape == (1, 3) and np.all(np.isfinite(curve))


def test_compress_cli_restores_a_rec_tpu_checkpoint(tmp_path):
    """A checkpoint rec_tpu's trainer would write for the 1-level model:
    its model_config.json overrides the model kind and width, and the port
    restores its EMA weights."""
    from rec_tpu.train import CheckpointManager as JCkpt
    from rec_tpu.train import (init_state, make_optimizer,
                               save_model_config, staircase_schedule)

    jmodel = J1(num_filters=8)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jax.random.PRNGKey(1))
    state = init_state(params, make_optimizer(
        "adam", staircase_schedule(1e-4, 10, 1.0)), beta=0.01)
    JCkpt(str(tmp_path / "ckpt")).save(state)
    save_model_config(str(tmp_path / "ckpt"), "large_level_1_vae",
                      {"level_1_filters": 8, "level_2_filters": 128})
    stats = _compress_cli(tmp_path, "level_1_filters=196")
    assert stats["restored"]
    assert os.path.basename(stats["csv"]) == "large_level_1_vae_clic2019.csv"


def test_lossy_serve_cli_verifies(tmp_path):
    stats = tserve.main(TINY + ["num_images=3", "batch_size=2",
                                "dataset.synthetic_size=3",
                                f"output_dir={tmp_path}",
                                f"model_save_dir={tmp_path}/ckpt",
                                "device=cpu"])
    recs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".rec"))
    assert recs == [f"img_{i}.rec" for i in range(3)]
    assert stats["images"] == 3 and stats["steady_images"] == 1
    assert len(stats["psnr"]) == 3
    for i in range(3):
        seed, shape, _, latents = read_rec(str(tmp_path / f"img_{i}.rec"))
        assert seed == 42 + 101 * i and shape == (256, 256, 3)
        assert [len(c) for _, c in latents] == [2, 32]


@pytest.fixture(scope="module")
def lossy_gloo(tmp_path_factory):
    """The lossy serving CLI as two processes over Gloo on the CPU, one
    device each, into ``<root>/two``: (root, the processes' outputs, the
    shared args)."""
    import socket

    root = tmp_path_factory.mktemp("lossy_gloo")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    args = TINY + ["num_images=3", "batch_size=2", "dataset.synthetic_size=3",
                   f"model_save_dir={root}/ckpt", "device=cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rec_tpu_torch.cli.lossy_serve", *args,
         f"output_dir={root}/two", f"coordinator=localhost:{port}",
         "num_processes=2", f"process_id={i}"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return root, outs, args


def _rec_bytes(out_dir) -> dict:
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir)) if f.endswith(".rec")}


def test_lossy_serve_two_processes_over_gloo(tmp_path, lossy_gloo):
    """Two processes share each global batch over Gloo: every file is
    written once and each process verifies its own; the files code as one
    process serving alone codes them (seeds and counts equal, indices
    >= 95%: batch-2 and batch-1 convolutions may round apart)."""
    root, outs, args = lossy_gloo
    # Batch 2 over 2 processes: one row each; the tail batch's row 1 is
    # padding.
    assert [int(out.split("served ")[1].split(" lossy")[0])
            for out in outs] == [2, 1]
    tserve.main(args + [f"output_dir={tmp_path}/one"])
    for i in range(3):
        two = read_rec(str(root / "two" / f"img_{i}.rec"))
        one = read_rec(str(tmp_path / "one" / f"img_{i}.rec"))
        assert two[0] == one[0] == 42 + 101 * i
        for (ai, ac), (bi, bc) in zip(two[3], one[3]):
            np.testing.assert_array_equal(ac, bc)
            assert np.mean(ai == bi) >= 0.95


def test_lossy_serve_two_devices_write_the_two_process_files(tmp_path,
                                                             lossy_gloo):
    """``device=cpu n_devices=2``: one process codes each batch's rows on
    two mesh entries at the two-process run's per-device batch, so every
    file is byte-identical to that run's."""
    root, _, args = lossy_gloo
    stats = tserve.main(args + [f"output_dir={tmp_path}", "n_devices=2"])
    assert stats["mesh"] == ["cpu", "cpu"] and stats["images"] == 3
    mine = _rec_bytes(tmp_path)
    assert sorted(mine) == [f"img_{i}.rec" for i in range(3)]
    assert mine == _rec_bytes(root / "two")


def test_lossy_serve_more_devices_than_visible_raise(tmp_path, monkeypatch):
    """One visible card (mocked): ``n_devices=2`` raises before any work,
    where rec_tpu's make_mesh would quietly take one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 visible"):
        tserve.main(TINY + ["n_devices=2", f"output_dir={tmp_path}",
                            "device=cuda"])


def _reference_module(tmp_path, name, path):
    """An examples/ CLI as a module, its JAX compilation cache a temporary
    one (JAX's setting put back)."""
    old = os.environ.get("REC_TPU_COMPILATION_CACHE")
    old_dir = jax.config.jax_compilation_cache_dir
    os.environ["REC_TPU_COMPILATION_CACHE"] = str(tmp_path / "jax_cache")
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, *path))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod    # its dataclasses look it up
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        if old is None:
            os.environ.pop("REC_TPU_COMPILATION_CACHE")
        else:
            os.environ["REC_TPU_COMPILATION_CACHE"] = old
    return mod


def test_lossy_serve_two_devices_match_jax(tmp_path):
    """``n_devices=2`` through both lossy serving CLIs on one rec_tpu
    checkpoint of the 2-level model (8/8 filters, 256x256 images, batch
    2): rec_tpu's program sharded over two CPU devices and the port's two
    mesh entries.  The bar of the batched coder against rec_tpu's (C4):
    each file's seed, the first coded level's counts and indices and every
    count equal, and >= 95% of all indices."""
    from rec_tpu.train import CheckpointManager as JCkpt
    from rec_tpu.train import (init_state, make_optimizer,
                               save_model_config, staircase_schedule)

    jmodel = J2(level_1_filters=8, level_2_filters=8)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jax.random.PRNGKey(1))
    state = init_state(params, make_optimizer(
        "adam", staircase_schedule(1e-4, 10, 1.0)), beta=0.01)
    JCkpt(str(tmp_path / "ckpt")).save(state)
    save_model_config(str(tmp_path / "ckpt"), "large_level_2_vae",
                      {"level_1_filters": 8, "level_2_filters": 8})
    jserve = _reference_module(tmp_path, "reference_lossy_serve",
                               ("examples", "lossy", "serve.py"))
    args = TINY + ["num_images=3", "batch_size=2", "dataset.synthetic_size=3",
                   f"model_save_dir={tmp_path}/ckpt", "n_devices=2"]
    jserve.main(args + [f"output_dir={tmp_path}/jax"])
    stats = tserve.main(args + [f"output_dir={tmp_path}/torch",
                                "device=cpu"])
    assert stats["restored"] and stats["images"] == 3
    same = total = 0
    for i in range(3):
        j = read_rec(str(tmp_path / "jax" / f"img_{i}.rec"))
        t = read_rec(str(tmp_path / "torch" / f"img_{i}.rec"))
        assert t[0] == j[0] == 42 + 101 * i and len(t[3]) == len(j[3]) == 2
        np.testing.assert_array_equal(t[3][0][0], j[3][0][0])
        for (ja, jc), (ta, tc) in zip(j[3], t[3]):
            np.testing.assert_array_equal(tc, jc)
            same += int(np.sum(ta == ja))
            total += ta.size
    assert same / total >= 0.95


def test_importance_compress_cli_matches_jax(tmp_path):
    """``sampler=importance`` through both lossy compress CLIs on one
    rec_tpu checkpoint of the 2-level model (8/8 filters, a 256x256
    image): both levels' counts and indices in the files equal, the index
    alphabet 2^coding_bits, and the port's decode within the CLI's own
    rtol 1e-4 / atol 1e-5."""
    from rec_tpu.train import CheckpointManager as JCkpt
    from rec_tpu.train import (init_state, make_optimizer,
                               save_model_config, staircase_schedule)

    jmodel = J2(level_1_filters=8, level_2_filters=8)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jax.random.PRNGKey(1))
    state = init_state(params, make_optimizer(
        "adam", staircase_schedule(1e-4, 10, 1.0)), beta=0.01)
    JCkpt(str(tmp_path / "ckpt")).save(state)
    save_model_config(str(tmp_path / "ckpt"), "large_level_2_vae",
                      {"level_1_filters": 8, "level_2_filters": 8})
    spec = importlib.util.spec_from_file_location(
        "reference_compress_with_lossy_model",
        os.path.join(REPO, "examples", "lossy",
                     "compress_with_lossy_model.py"))
    jcli = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = jcli    # its dataclasses look it up
    spec.loader.exec_module(jcli)
    args = TINY + ["sampler=importance", "coding_bits=6", "num_images=1",
                   "dataset.dataset=clic2019", "dataset.synthetic_size=1",
                   f"model_save_dir={tmp_path}/ckpt"]
    jcli.main(args + [f"output_dir={tmp_path}/jax"])
    stats = tcli.main(args + [f"output_dir={tmp_path}/torch", "device=cpu"])
    assert stats["restored"]
    j = read_rec(str(tmp_path / "jax" / "img_0.rec"), max_partitions=6)
    t = read_rec(str(tmp_path / "torch" / "img_0.rec"), max_partitions=6)
    assert t[0] == j[0] == 42 and len(t[3]) == len(j[3]) == 2
    for (ja, jc), (ta, tc) in zip(j[3], t[3]):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ta, ja)
    with open(tmp_path / "jax" / "img_0.rec", "rb") as a, \
            open(tmp_path / "torch" / "img_0.rec", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("cli", ["compress", "serve"])
def test_level4_model_through_the_clis(tmp_path, cli):
    """model=large_level_4_vae at 8 filters on 256x256 images: four latent
    levels per file (levels 4, 3 at 4x4, levels 2, 1 at 16x16), every file
    decoded by the CLI's own check.  The serving CLI takes widths for
    levels 1 and 2 only, so its levels 3 and 4 keep the model's 128."""
    args = TINY + ["model=large_level_4_vae", f"output_dir={tmp_path}/out",
                   f"model_save_dir={tmp_path}/ckpt", "device=cpu"]
    if cli == "compress":
        stats = tcli.main(args + ["level_3_filters=8", "level_4_filters=8",
                                  "num_images=2", "dataset.dataset=clic2019",
                                  "dataset.synthetic_size=2"])
        assert os.path.basename(stats["csv"]) == \
            "large_level_4_vae_clic2019.csv"
        assert [[len(c) for c in cs] for cs in stats["counts"]] == [
            [2, 2, 32, 32]] * 2
        assert len(stats["required_partitions"]) == 2
        return
    stats = tserve.main(args + ["num_images=3", "batch_size=2",
                                "dataset.synthetic_size=3"])
    assert stats["images"] == 3 and len(stats["psnr"]) == 3
    for i in range(3):
        seed, shape, _, latents = read_rec(
            str(tmp_path / "out" / f"img_{i}.rec"))
        assert seed == 42 + 101 * i and shape == (256, 256, 3)
        assert [len(c) for _, c in latents] == [32, 32, 32, 32]


@pytest.mark.parametrize("cli", ["compress", "serve"])
def test_clis_default_to_the_card(tmp_path, cli):
    """Both CLIs default to device=cuda and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = tcli if cli == "compress" else tserve
    assert mod.Config().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(TINY + [f"output_dir={tmp_path}",
                         f"model_save_dir={tmp_path}/ckpt"])
