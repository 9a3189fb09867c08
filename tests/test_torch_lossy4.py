"""rec_tpu_torch's Large4LevelVAE vs rec_tpu's on JAX-CPU at a small size
(8 filters per level, 64x128 images): the forward with JAX's noise fed in,
REC coding of the four levels (counts equal, indices >= 95%), each level's
replay bitwise equal to rec_tpu's decode, .rec files across the packages,
the batched path against single-image coding, the converter round trip and
the latent shapes at the CLIs' widths.  The lossy CLIs run the model at a
tiny size in tests/test_torch_lossy.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.coding import BeamSearchCoder as JCoder
from rec_tpu.coding import GaussianParams as JG
from rec_tpu.models.lossy import Large4LevelVAE as J4
from rec_tpu.models.lossy import compress_to_file as j_compress_to_file
from rec_tpu.models.lossy import decompress_from_file as j_decompress
from rec_tpu_torch.coding import BeamSearchCoder as TCoder
from rec_tpu_torch.coding import GaussianParams as TG
from rec_tpu_torch.coding import beam_search as tbs
from rec_tpu_torch.io import read_rec
from rec_tpu_torch.models.lossy import Large4LevelVAE as T4
from rec_tpu_torch.models.lossy import compress_to_file, decompress_from_file
from rec_tpu_torch.models.lossy.convert import (from_numpy_tree,
                                                load_flax_params,
                                                to_numpy_tree)
from rec_tpu_torch.parallel import (make_batch_rec_decode,
                                    make_batch_rec_forward)

torch.set_num_threads(2)

CODER = dict(kl_per_partition=3.0, n_beams=4, extra_samples=1.2,
             block_size=64, max_partitions=8)
# Float32 convolutions in another order (the tolerance of
# tests/test_torch_lossy.py).
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
WIDTHS = (8, 8, 8, 8)
HW = (64, 128)


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, *HW, 3).astype(np.float32)


@pytest.fixture(scope="module")
def level4():
    """rec_tpu's model with every leaf moved off its initial value (zero
    biases and identity GDN matrices would hide layout errors), and the
    port's with those weights."""
    jmodel = J4(*WIDTHS, coder=JCoder(**CODER))
    x = _images(2, 0)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jax.random.PRNGKey(1)))
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.05 * rs.randn(*a.shape), np.float32),
        params)
    tmodel = T4(*WIDTHS, coder=TCoder(**CODER), device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel.requires_grad_(False), x


def jax_noise(key, shapes):
    """The standard normals rec_tpu's 4-level forward draws, in coding order
    (levels 4, 3, 2, 1): level l samples with ``split(key, 4)[l - 1]``."""
    keys = jax.random.split(key, 4)
    return [np.asarray(jax.random.normal(keys[lvl - 1], s))
            for lvl, s in zip((4, 3, 2, 1), shapes)]


def _jax_dists(m, x, key):
    """rec_tpu's posteriors and priors per level in coding order."""
    B, H, W, _ = x.shape
    keys = jax.random.split(key, 4)
    posts, priors = [], []

    def sample_fn(level, post, prior):
        posts.append(post)
        priors.append(prior)
        return post.sample(keys[level - 1])

    m._ladder(B, H, W, m._inference_stats(x), sample_fn)
    return posts, priors


def test_forward(level4):
    """Every level's posterior and prior, the latent samples, KLs (coding
    order) and the reconstruction."""
    jmodel, params, tmodel, x = level4
    key = jax.random.PRNGKey(9)
    want = jmodel.apply(params, jnp.asarray(x), key)
    posts, priors = jmodel.apply(params, jnp.asarray(x), key,
                                 method=_jax_dists)
    shapes = [(2,) + s for s in tmodel.latent_shapes(*HW)]
    assert shapes == [tuple(p.loc.shape) for p in posts]
    got = tmodel(torch.from_numpy(x), jax_noise(key, shapes))
    assert len(got["posteriors"]) == len(got["priors"]) == 4
    for a, b in zip(posts + priors, got["posteriors"] + got["priors"]):
        np.testing.assert_allclose(b.loc.numpy(), np.asarray(a.loc),
                                   **MODEL_TOL)
        np.testing.assert_allclose(b.scale.numpy(), np.asarray(a.scale),
                                   **MODEL_TOL)
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               **MODEL_TOL)
    np.testing.assert_allclose([float(k) for k in got["kls"]],
                               [float(k) for k in want["kls"]], rtol=1e-4)


def test_rec_forward_matches_jax(level4):
    """Level 4 (coded first) equal in counts and indices; every level's
    counts equal, >= 95% of all indices equal, the KLs close."""
    jmodel, params, tmodel, x = level4
    seed = 1234
    want = jmodel.apply(params, jnp.asarray(x[:1]), seed,
                        method=jmodel.rec_forward)
    got = tmodel.rec_forward(torch.from_numpy(x[:1]), seed)
    wl, gl = want["latents"], got["latents"]
    assert len(wl) == len(gl) == 4
    np.testing.assert_array_equal(gl[0][1].numpy(), np.asarray(wl[0][1]))
    np.testing.assert_array_equal(gl[0][0].numpy(), np.asarray(wl[0][0]))
    for (wi, wc), (gi, gc) in zip(wl, gl):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        assert gi.shape == np.shape(wi)
    wi = np.concatenate([np.asarray(i).ravel() for i, _ in wl])
    gi = np.concatenate([i.numpy().ravel() for i, _ in gl])
    assert np.mean(wi == gi) >= 0.95
    np.testing.assert_allclose([float(k) for k in got["kls"]],
                               [float(k) for k in want["kls"]], rtol=1e-4)
    if np.array_equal(wi, gi):
        np.testing.assert_allclose(got["reconstruction"].numpy(),
                                   np.asarray(want["reconstruction"]),
                                   **MODEL_TOL)


def _replay_priors_jax(jmodel, params, hw, latents, seed):
    """rec_tpu's decode, level by level: each level's coding prior (from
    the latents decoded above it) and its decoded sample, coding order."""
    H, W = hw
    coder = jmodel.coder
    per_level = dict(zip((4, 3, 2, 1), latents))
    priors, samples = [], []

    def run(m):
        def sample_fn(level, post, prior):
            prior1 = JG(prior.loc[0], prior.scale[0])
            z = coder.decode(prior1, *per_level[level], seed + 4 - level)
            priors.append(prior1)
            samples.append(z)
            return z[None]

        m._ladder(1, H, W, None, sample_fn)

    jmodel.apply(params, method=run)
    return priors, samples


def test_rec_files_cross_packages(level4, tmp_path):
    """A .rec rec_tpu wrote decodes in the port and one the port wrote
    decodes in rec_tpu, the reconstructions close; each level of either
    file replays in the port bitwise equal to rec_tpu's decode given the
    same prior, with the level's seed."""
    jmodel, params, tmodel, x = level4
    n_samples = TCoder(**CODER).n_samples
    seed = 31
    j_path, t_path = str(tmp_path / "j.rec"), str(tmp_path / "t.rec")
    j_recon = j_compress_to_file(jmodel, params, j_path, jnp.asarray(x[0]),
                                 seed=seed, block_size=64,
                                 max_index=n_samples)
    t_recon = compress_to_file(tmodel, t_path, x[0], seed=seed,
                               block_size=64, max_index=n_samples)
    np.testing.assert_allclose(decompress_from_file(tmodel, j_path, 8).numpy(),
                               np.asarray(j_recon), **MODEL_TOL)
    np.testing.assert_allclose(
        np.asarray(j_decompress(jmodel, params, t_path, 8)),
        t_recon.numpy(), **MODEL_TOL)
    for path in (j_path, t_path):
        rseed, shape, _, latents = read_rec(path, max_partitions=8)
        assert rseed == seed and len(latents) == 4
        priors, samples = _replay_priors_jax(jmodel, params, shape[:2],
                                             latents, rseed)
        for lvl, ((ind, cnt), prior, z) in zip((4, 3, 2, 1), zip(
                latents, priors, samples)):
            got = tmodel.coder.decode(
                TG(torch.from_numpy(np.asarray(prior.loc)),
                   torch.from_numpy(np.asarray(prior.scale))),
                ind, cnt, rseed + 4 - lvl)
            assert np.array_equal(got.numpy().view(np.int32),
                                  np.asarray(z).view(np.int32)), (path, lvl)


def test_rec_decode_replays_the_encoder(level4):
    """The port's decode of its own indices gives the encoder's
    reconstruction bit for bit (the same single-image programs)."""
    _, _, tmodel, x = level4
    out = tmodel.rec_forward(torch.from_numpy(x[1:2]), 77)
    rec = tmodel.rec_decode(HW, out["latents"], 77)
    assert np.array_equal(rec.numpy().view(np.int32),
                          out["reconstruction"].numpy().view(np.int32))


def test_batch_rec_forward_and_decode(level4, monkeypatch):
    """One block-codec call per level for the whole batch, levels 4 to 1;
    image i codes as rec_forward with seeds[i] (counts equal, indices >=
    95%), decodes through the canonical rec_decode to the batched
    reconstruction, and make_batch_rec_decode reproduces the batch."""
    _, _, tmodel, _ = level4
    x = _images(3, 4)
    seeds = [50, 151, 252]
    calls = []
    real = tbs.encode_blocks
    monkeypatch.setattr(tbs, "encode_blocks", lambda *a, **k: (
        calls.append(tuple(a[1].loc.shape)) or real(*a, **k)))
    out = make_batch_rec_forward(tmodel)(x, np.asarray(seeds))
    # Per image: 1x2x8 = 16 dims (one block of 16) at levels 4 and 3,
    # 4x8x8 = 256 (4 blocks of 64) at levels 2 and 1.
    assert calls == [(3, 16), (3, 16), (12, 64), (12, 64)]
    assert out["reconstruction"].shape == (3, 1, *HW, 3)
    for i, s in enumerate(seeds):
        one = tmodel.rec_forward(torch.from_numpy(x[i:i + 1]), s)
        for (bi, bc), (oi, oc) in zip(out["latents"], one["latents"]):
            np.testing.assert_array_equal(bc[i].numpy(), oc.numpy())
            assert np.mean(bi[i].numpy() == oi.numpy()) >= 0.95
        rec = tmodel.rec_decode(HW, [(a[i], c[i]) for a, c in
                                     out["latents"]], s)
        np.testing.assert_allclose(rec[0].numpy(),
                                   out["reconstruction"][i, 0].numpy(),
                                   atol=1e-4)
    dec = make_batch_rec_decode(tmodel, HW)(out["latents"], seeds)
    np.testing.assert_allclose(dec.numpy(), out["reconstruction"].numpy(),
                               atol=1e-4)


def test_converter_round_trip(level4):
    """flax tree -> port -> flax tree gives the same bits and paths; a
    fresh port model's tree has flax's structure, shapes and dtypes, loads
    strictly, and runs in rec_tpu to the port's output."""
    jmodel, params, _, x = level4
    back = to_numpy_tree(from_numpy_tree(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    fresh = T4(*WIDTHS, device="cpu", seed=3).requires_grad_(False)
    tree = to_numpy_tree(fresh)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(params))
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0], flat_a):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype
    T4(*WIDTHS, device="cpu").load_state_dict(from_numpy_tree(tree),
                                              strict=True)
    key = jax.random.PRNGKey(4)
    want = jmodel.apply(tree, jnp.asarray(x), key)
    noise = jax_noise(key, [(2,) + s for s in fresh.latent_shapes(*HW)])
    got = fresh(torch.from_numpy(x), noise)
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               **MODEL_TOL)


@pytest.mark.parametrize("widths,hw,batch,blocks", [
    ((196, 128, 128, 128), (512, 768), 1, [13, 13, 197, 302]),
    ((196, 128, 128, 128), (256, 256), 8, [24, 24, 264, 408]),
    (None, (256, 256), 8, [24, 24, 400, 400])],
    ids=["compress-kodak", "serve-cli-widths", "serve-defaults"])
def test_latent_shapes_and_blocks(widths, hw, batch, blocks):
    """The latent shapes at levels 4, 3, 2, 1 and the blocks of 1000 dims
    per coding call: a Kodak image at the compress CLI's widths, and a
    serving batch of eight 256x256 images at those widths and at the
    model's defaults, 192/192/128/128 (what the serving CLI builds)."""
    model = T4(*(widths or ()), device="cpu")
    if widths is None:
        widths = (192, 192, 128, 128)
        assert model.filters == widths
    H, W = hw
    f1, f2, f3, f4 = widths
    assert model.latent_shapes(H, W) == [
        (H // 64, W // 64, f4), (H // 64, W // 64, f3),
        (H // 16, W // 16, f2), (H // 16, W // 16, f1)]
    got = [batch * math.ceil(math.prod(s) / 1000)
           for s in model.latent_shapes(H, W)]
    assert got == blocks
