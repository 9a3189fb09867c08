"""rec_tpu_torch's PixelCNN vs rec_tpu on JAX-CPU, with flax's weights
carried across by the converter, at small sizes (filters 8-18, 1-2 blocks,
5x5 to 8x8 images): the forward, the log likelihood, the data-dependent
init, both autoregressive properties, JAX's sampling draws
(``rng.uniform`` with ``maxval``, ``rng.split_chain``) and the samples
themselves.

Tolerances: loc and log_scale atol 1e-5 (float32 convolutions summed in
another order; measured ~1e-7); the log likelihood rtol 1e-5 (a sum over
the pixels); the init's log_scale and bias atol 1e-5.  The draws and the
converter are bitwise; the AR properties are exact zeros.  A sample equals
JAX's pixel for pixel, or parts from it only at a step whose drawn value
lies within 1e-4 of a bin edge (the forwards differ by ~1e-7, so only a
value that close to an edge can quantise to another bin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_tpu.models.pixel_cnn import PixelCNN as JPixelCNN
from rec_tpu_torch.coding import rng
from rec_tpu_torch.models import pixel_cnn_convert
from rec_tpu_torch.models.pixel_cnn import (U_MAX, U_MIN, PixelCNN,
                                            edge_distance, parted_steps)
from rec_tpu_torch.ops.threefry_normal import _log1p_f32, _log_f32

torch.set_num_threads(2)

ATOL = 1e-5            # per-pixel loc / log_scale, init log_scale / bias
LL_RTOL = 1e-5         # per-image log likelihood
EDGE_TOL = 1e-4        # bins: a sample may part from JAX's only this close

# (filters, blocks, batch shape NHWC)
CASES = [(18, 2, (2, 8, 8, 3)), (16, 1, (2, 6, 6, 1)),
         (12, 1, (1, 5, 5, 3)), (8, 1, (2, 6, 6, 1))]


def _images(shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) - 0.5).astype(
        np.float32)


def _pair(filters, blocks, x, key=0):
    """rec_tpu's model and params (flax init on ``x``) and the port's
    model with those params."""
    jmodel = JPixelCNN(filters=filters, num_residual_blocks=blocks)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(key),
                                        jnp.asarray(x)))
    model = PixelCNN(x.shape[-1], filters, blocks, device="cpu")
    pixel_cnn_convert.load_flax_params(model, params)
    return jmodel, params, model


@pytest.mark.parametrize("filters,blocks,shape", CASES)
def test_forward_matches_jax(filters, blocks, shape):
    x = _images(shape)
    jmodel, params, model = _pair(filters, blocks, x)
    want_loc, want_ls = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        loc, log_scale = model(torch.from_numpy(x))
    assert loc.shape == log_scale.shape == x.shape
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), atol=ATOL)
    np.testing.assert_allclose(log_scale.numpy(), np.asarray(want_ls),
                               atol=ATOL)


@pytest.mark.parametrize("filters,blocks,shape", CASES)
def test_log_likelihood_matches_jax(filters, blocks, shape):
    x = _images(shape)
    jmodel, params, model = _pair(filters, blocks, x)
    want = jmodel.apply(params, jnp.asarray(x),
                        method=jmodel.log_likelihood)
    with torch.no_grad():
        got = model.log_likelihood(torch.from_numpy(x))
    assert got.shape == (shape[0],) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LL_RTOL)


@pytest.mark.parametrize("filters,blocks,shape", CASES)
def test_data_dependent_init_matches_flax(filters, blocks, shape):
    """From flax's ``v``, the port's init pass on the same batch sets every
    log_scale and bias to flax's."""
    x = _images(shape, seed=3)
    _, params, model = _pair(filters, blocks, x)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith(".v"):
                p.zero_()
    model.initialized = False
    model.data_dependent_init(torch.from_numpy(x))
    got = pixel_cnn_convert.to_numpy_tree(model)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        if path[-1].key in ("log_scale", "bias"):
            np.testing.assert_allclose(leaf, want[path], atol=ATOL,
                                       err_msg=str(path))
            checked += 1
    assert checked == 2 * (3 + 3 * blocks)


def _zeros_model(filters, blocks, shape):
    model = PixelCNN(shape[-1], filters, blocks, device="cpu")
    model.data_dependent_init(torch.zeros(shape))
    return model


def _loc(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x))[0].numpy()


def test_autoregressive_property():
    """tests/test_pixel_cnn.py's property on the port: the output at a pixel
    does not depend on that pixel, nor on any later one in AR order."""
    x = np.zeros((1, 6, 6, 1), np.float32)
    model = _zeros_model(16, 1, x.shape)
    x2 = x.copy()
    x2[0, 3, 3, 0] = 1.0
    delta = np.abs(_loc(model, x2) - _loc(model, x))[0, :, :, 0]
    assert delta[3, 3] == 0.0
    assert delta[4:].max() == 0.0
    assert delta[3, 4:].max() == 0.0
    assert delta[:3].max() > 0.0     # earlier rows do see the pixel


def test_channel_autoregressive_property():
    """Channel k's output does not depend on the pixel's channels >= k."""
    x = np.zeros((1, 5, 5, 3), np.float32)
    model = _zeros_model(12, 1, x.shape)
    loc0 = _loc(model, x)
    x2 = x.copy()
    x2[0, 2, 2, 1] = 1.0
    delta = np.abs(_loc(model, x2) - loc0)[0, 2, 2]
    assert delta[0] == 0.0 and delta[1] == 0.0
    x3 = x.copy()
    x3[0, 2, 2, 0] = 1.0
    assert np.abs(_loc(model, x3) - loc0)[0, 2, 2, 0] == 0.0


@pytest.mark.parametrize("filters,shape,seed",
                         [(8, (6, 6, 1), 1), (8, (6, 6, 1), 4),
                          (12, (5, 5, 3), 1), (12, (5, 5, 3), 2)])
def test_sample_matches_jax(filters, shape, seed):
    x = np.zeros((1,) + shape, np.float32)
    jmodel, params, model = _pair(filters, 1, x)
    want = np.asarray(jmodel.apply(params, jax.random.PRNGKey(seed), shape,
                                   method=jmodel.sample))
    img, values = model.sample_values(rng.root_key(seed, "cpu"), shape)
    assert img.shape == shape
    assert float(img.min()) >= -0.5 and float(img.max()) <= 0.5
    parted = parted_steps(img, want)
    if parted:   # the first step the samples part at must be a near tie
        assert edge_distance(values[parted[0]]) < EDGE_TOL, parted
    assert np.array_equal(model.sample(rng.root_key(seed, "cpu"), shape),
                          img)
    # Every step of JAX's sample against the port's draw given JAX's
    # earlier pixels.
    rimg, rvalues = model.replay_values(rng.root_key(seed, "cpu"),
                                        torch.from_numpy(want.copy()))
    for i in parted_steps(rimg, want):
        assert edge_distance(rvalues[i]) < EDGE_TOL, i


@pytest.mark.parametrize("shape", [(6, 6, 1), (5, 5, 3)])
def test_replay_is_the_samplers_steps(shape):
    """One forward of a finished sample gives every step's value and pixel
    bit for bit (the masks hide later pixels exactly on the CPU); an image
    changed at one step replays the earlier steps unchanged."""
    model = PixelCNN(shape[-1], 12 if shape[-1] == 3 else 8, 1,
                     device="cpu")
    model.data_dependent_init(torch.from_numpy(_images((2,) + shape)))
    key = rng.root_key(9, "cpu")
    img, values = model.sample_values(key, shape)
    rimg, rvalues = model.replay_values(key, img)
    assert torch.equal(rimg, img)
    assert torch.equal(rvalues.view(torch.int32), values.view(torch.int32))
    moved = img.clone()
    moved[1, 2, 0] += 0.25
    step, = parted_steps(moved, img)
    _, mvalues = model.replay_values(key, moved)
    assert torch.equal(mvalues[:step + 1].view(torch.int32),
                       values[:step + 1].view(torch.int32))
    assert not torch.equal(mvalues[step + 1:], values[step + 1:])


def _jax_keys(n, seed=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, torch.tensor(np.asarray(jax.random.key_data(keys)),
                              dtype=torch.int64)


@pytest.mark.parametrize("minval,maxval", [(U_MIN, U_MAX), (-1.0, 1.0),
                                           (0.25, 3.0), (1e-3, 0.5)])
def test_uniform_maxval_is_jax_bitwise(minval, maxval):
    keys, kd = _jax_keys(4096)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (3,), minval=minval, maxval=maxval))(keys))
    got = rng.uniform(kd, 3, minval=minval, maxval=maxval).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny)])
def test_uniform_default_maxval_keeps_its_bits(minval):
    """The existing callers (the rejection coder's uniforms at minval 0,
    the Gumbel draws at float32's tiny) get the same bits as before the
    ``maxval`` argument: u + minval, floored at minval, == JAX's."""
    keys, kd = _jax_keys(4096, seed=5)
    got = rng.uniform(kd, 5, minval)
    bits = rng.stream_bits(kd, torch.arange(5), "threefry")
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    before = torch.clamp(u + minval, min=minval)
    assert torch.equal(got.view(torch.int32), before.view(torch.int32))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (5,), minval=minval))(keys))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_split_chain_is_jax_scan_chain():
    key, subs = jax.random.PRNGKey(1), []
    for _ in range(300):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(jax.random.key_data(sub)))
    got = rng.split_chain(rng.root_key(1, "cpu"), 300).numpy()
    np.testing.assert_array_equal(got, np.array(subs, np.int64))


def test_logistic_noise_is_xla_bitwise():
    """The sampler's log(u) - log1p(-u) with XLA-CPU's float32 log and
    log1p: rec_tpu's bits on 4096 of its uniforms."""
    keys, kd = _jax_keys(4096, seed=7)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), minval=U_MIN,
                                              maxval=U_MAX))(keys)
    want = np.asarray(jax.jit(lambda v: jnp.log(v) - jnp.log1p(-v))(u))
    tu = rng.uniform(kd, 1, U_MIN, U_MAX)[:, 0]
    got = (_log_f32(tu) - _log1p_f32(-tu)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_converter_round_trip_is_exact():
    x = _images((2, 8, 8, 3))
    _, params, model = _pair(18, 2, x)
    back = pixel_cnn_convert.to_numpy_tree(model)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


@pytest.mark.parametrize("filters,in_ch", [(16, 3), (10, 4)])
def test_filters_must_divide_channels(filters, in_ch):
    with pytest.raises(ValueError, match="divisible"):
        PixelCNN(in_ch, filters, 1, device="cpu")


def test_forward_needs_weights():
    model = PixelCNN(1, 8, 1, device="cpu")
    with pytest.raises(RuntimeError, match="data_dependent_init"):
        model(torch.zeros(1, 4, 4, 1))


def test_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PixelCNN(3)
