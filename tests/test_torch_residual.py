"""The port's residual coder counts where rec_tpu sorts and masks: its class
map (a histogram of the integer activity sums in place of np.quantile), its
joint class histograms and its histogram scale fits give rec_tpu's classes,
scales and payload bytes exactly."""

import numpy as np
import pytest

from rec_tpu.io import residual as jres
from rec_tpu_torch.io import residual as tres

SHAPES = [(1, 1, 3), (3, 5, 3), (32, 32, 3), (512, 768, 3)]
KINDS = ["random", "constant", "narrow"]


def _levels(shape, kind, seed=0):
    """8-bit reconstruction levels: uniform, one level, or +-3 levels."""
    rs = np.random.RandomState(seed)
    if kind == "random":
        return rs.randint(0, 256, shape).astype(np.int32)
    if kind == "constant":
        return np.full(shape, 77, np.int32)
    return (128 + rs.randint(-3, 4, shape)).astype(np.int32)


def _photo(seed=0, shape=(512, 768, 3)):
    """A stand-in photo and a reconstruction whose error varies by pixel,
    so the activity classes get different scales."""
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32)
    noise = rs.randn(*shape) * rs.rand(*shape[:2], 1) * 0.05
    recon = np.clip(x + noise, 0.0, 0.999).astype(np.float32)
    return x, recon


@pytest.mark.parametrize("n_classes", [1, 2, 3, 16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_class_map_equals_rec_tpu(shape, kind, n_classes):
    mu = _levels(shape, kind)
    want = jres._class_map(mu, n_classes)
    got = tres._class_map(mu, n_classes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_classes", [2, 3, 7, 16])
@pytest.mark.parametrize("n", [1, 2, 5, 11, 97, 3072, 100003])
def test_quantile_thresholds_equal_np_quantile(n, n_classes):
    # the thresholds themselves, float for float, over sums spread across
    # the whole range [0, 4590]
    s = np.random.RandomState(n).randint(0, tres._MAX_ACTIVITY + 1, n)
    got = tres._quantile_thresholds(
        np.bincount(s, minlength=tres._MAX_ACTIVITY + 1), n_classes)
    want = np.quantile(s / 9.0, np.arange(1, n_classes) / n_classes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_activity_sum_over_nine_is_rec_tpu_activity(shape, kind):
    mu = _levels(shape, kind, seed=1)
    s = tres._activity_sum(mu)
    assert s.min() >= 0 and s.max() <= tres._MAX_ACTIVITY
    np.testing.assert_array_equal(s / 9.0, jres._activity(mu))


def test_activity_sum_reaches_its_bound():
    mu = np.zeros((6, 6, 1), np.int32)
    mu[::2, ::2] = mu[1::2, 1::2] = 255
    assert tres._activity_sum(mu).max() == tres._MAX_ACTIVITY


@pytest.mark.parametrize("n_classes", [3, 16])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=str)
def test_class_histograms_equal_masks(shape, n_classes):
    x, recon = _photo(2, shape)
    xi, mu = tres.quantize(x), tres.quantize(recon)
    centred = (((xi - mu) % 256).reshape(-1) + 128) % 256 - 128
    cls = tres._class_map(mu, n_classes)
    hists = tres._class_histograms(centred, cls, n_classes)
    assert hists.shape == (n_classes, 256)
    for k in range(n_classes):
        np.testing.assert_array_equal(
            hists[k], np.bincount(centred[cls == k] + 128, minlength=256))


@pytest.mark.parametrize("residuals", [
    "laplace_0.5", "laplace_3", "laplace_40", "zeros", "one_value",
    "uniform"])
def test_fit_scale_on_histogram_equals_rec_tpu(residuals):
    rs = np.random.RandomState(3)
    kind, _, width = residuals.partition("_")
    if kind == "laplace":
        r = np.round(rs.laplace(0.0, float(width), 20000)).astype(np.int64)
        r = np.clip(r, -128, 127)
    elif kind == "zeros":
        r = np.zeros(500, np.int64)
    elif kind == "one_value":
        r = np.array([-128], np.int64)
    else:
        r = rs.randint(-128, 128, 5000)
    hist = np.bincount(r + 128, minlength=256)
    got = tres._fit_scale(hist)
    assert got == jres._fit_scale(r)
    assert isinstance(got, float)


@pytest.mark.parametrize("n_classes", [None, 3, 16])
def test_photo_payload_equals_rec_tpu_and_round_trips(n_classes):
    x, recon = _photo(4)
    payload, n = tres.encode_residual(x, recon, n_classes=n_classes)
    assert (payload, n) == jres.encode_residual(x, recon,
                                                n_classes=n_classes)
    out = tres.decode_residual(payload, recon)
    np.testing.assert_array_equal(tres.quantize(out), tres.quantize(x))


def test_empty_class_keeps_default_scale():
    # a constant reconstruction puts every subpixel in the top class, so
    # the classes below are empty and keep their 1/256 scale.
    x = np.random.RandomState(5).rand(16, 16, 3).astype(np.float32)
    recon = np.full_like(x, 0.5)
    payload, _ = tres.encode_residual(x, recon, n_classes=4)
    assert payload == jres.encode_residual(x, recon, n_classes=4)[0]
    scales = np.frombuffer(payload[2:18], "<f4")
    assert np.all(scales[:3] == np.float32(1.0 / 256.0))
    np.testing.assert_array_equal(
        tres.quantize(tres.decode_residual(payload, recon)), tres.quantize(x))
