"""Residual entropy coding: true lossless files.

The port's own copy of rec_tpu/io/residual.py; the .rec files it writes are
byte-identical to rec_tpu's.

The reference's "lossless" evaluation counts the image-residual bits
implicitly via the discretized-logistic likelihood and only stores latent
indices in the .rec file (SURVEY.md §0; ref compression_performance.py:339).
This module actually codes the residual so the file alone reproduces the
image bit-exactly:

  * the decoder's reconstruction mu (from the REC-decoded latents) defines
    p(x | mu) = DiscretizedLogistic(mu, s);
  * the residual symbol r = (x_int - mu_int) mod 256 is therefore
    ~ discretized logistic centred at 0;
  * residuals stream through the native arithmetic coder.

Adaptive scale field: one global scale
wastes ~2.4 bpd on a generalizing big-image model because the residual
field is heteroscedastic — flat regions reconstruct to within a level or
two while textured regions miss by tens.  Both sides hold the SAME decoded
reconstruction, so both can compute a per-pixel *activity* map (local
gradient energy of mu) and partition pixels into K classes by activity
quantiles with ZERO side information; the encoder then fits a per-class
discretized-logistic scale by MLE on that class's actual residuals and
transmits K float32 scales (~64 bytes) — the only side information.  Each
class codes as its own arithmetic stream (they parallelize across host
threads, like the container's per-latent streams).

Payload format (version 3, stored under the container's "S" tag):
    u8 version=3 | u8 K | f32 scales[K] | classed stream
The classed stream is ONE arithmetic-coded interval whose per-symbol
histogram is the symbol's class row (cpp rec_ac_encode_classes) — no
per-class stream terminations, no length table, and no EOF at all (the
decoder knows the pixel count and recomputes every symbol's class), so K
costs exactly 4K bytes of side information.  Version-2 payloads (an earlier
format: K separate streams with a length table) and version-1 payloads
(container tag "R": single global scale) still decode; v1 warns — those
files were written against an older (einsum) decode replay, so
exact losslessness is only guaranteed when the writer's replay matches
(detected, not silent).

CONTRACT: the reconstruction entering ``encode_residual`` and
``decode_residual`` must come from the SAME compiled program — the canonical
single-image ``model.decompress``.  Different program shapes (e.g. a vmapped
batch decode) produce ULP-level reconstruction differences, which flip
quantization bins at boundaries and corrupt the residual (and the class
map).  Batch-encode pipelines therefore run the canonical decode replay per
image for residual scoring even when the index search was batched.  All
class-map math below is host-side numpy on identical inputs —
deterministic by construction.  The class thresholds come from a histogram
of the integer activity sums, and equal rec_tpu's ``np.quantile`` of the
float activity by construction; one joint bincount gives every class's
residual histogram, which is all the scale fits read.
"""

from __future__ import annotations

import struct
import warnings
from typing import Tuple, Union

import numpy as np

from ..utils.profiling import span
from .arithmetic import ArithmeticCoder

ALPHABET = 257  # EOF=0 + 256 shifted residual symbols (v1/v2 streams)
RESIDUAL_VERSION = 3
DEFAULT_CLASSES = 16
_MIN_SCALE = 1e-5  # in [0,1) image units; ~0.0026 levels
_MAX_SCALE = 4.0


def quantize(image01: np.ndarray) -> np.ndarray:
    """[0,1) float image -> int levels 0..255 (binsize 1/256, matching the
    likelihood's floor discretization)."""
    return np.clip(np.floor(np.asarray(image01) * 256.0), 0, 255).astype(
        np.int32)


def residual_histogram(scale: float, total: int = 1 << 16) -> np.ndarray:
    """Counts over (EOF, r=-128..127 shifted to 1..256) from the logistic CDF
    at integer offsets; floor of 1 count keeps every symbol codable."""
    binsize = 1.0 / 256.0
    r = np.arange(-128, 128, dtype=np.float64)
    from scipy.special import expit as sigmoid  # overflow-stable

    lo = (r - 0.5) * binsize / scale
    hi = (r + 0.5) * binsize / scale
    p = sigmoid(hi) - sigmoid(lo)
    p /= p.sum()
    counts = np.maximum((p * total).astype(np.int64), 1)
    return np.concatenate([[1], counts])  # EOF prepended


_MAX_ACTIVITY = 4590  # 9 * (255 + 255): the largest 3x3 sum of |gh| + |gv|


def _activity_sum(mu_int: np.ndarray) -> np.ndarray:
    """Per-(pixel, channel) activity of the decoded reconstruction: local
    gradient energy, 3x3 box-summed, as the integer S in [0, 4590].
    Purely decoder-side information — high activity predicts large
    residuals (texture/edges reconstruct worse than flats), which is what
    makes quantile classes informative.  rec_tpu's float64 activity is
    exactly ``S / 9.0``: its sums are of small integers, so exact in
    float64, and the one rounding is the final division."""
    x = mu_int.astype(np.int32, copy=False)
    gh = np.abs(np.diff(x, axis=1, prepend=x[:, :1]))
    gv = np.abs(np.diff(x, axis=0, prepend=x[:1]))
    g = gh + gv
    # 3x3 box sum with edge replication (separable).
    p = np.pad(g, ((1, 1), (1, 1), (0, 0)), mode="edge")
    g = (p[:-2] + p[1:-1] + p[2:])
    return g[:, :-2] + g[:, 1:-1] + g[:, 2:]


def _quantile_thresholds(hist: np.ndarray, n_classes: int) -> np.ndarray:
    """``np.quantile(S / 9.0, k / K for k in 1..K-1)`` bit for bit, from
    the histogram of the integer sums S: numpy's default ('linear') method
    reads two order statistics at the virtual index q (n - 1) and
    interpolates them by its ``_lerp``; the cumulative counts give both
    order statistics without a sort."""
    n = int(hist.sum())
    qs = np.arange(1, n_classes) / n_classes
    virtual = (n - 1) * qs
    prev = np.floor(virtual)
    gamma = virtual - prev
    above = virtual >= n - 1
    prev = np.where(above, n - 1, prev).astype(np.intp)
    nxt = np.where(above, n - 1, prev + 1).astype(np.intp)
    # the j-th smallest S is the first value whose cumulative count
    # exceeds j.
    cum = np.cumsum(hist)
    a = np.searchsorted(cum, prev, side="right") / 9.0
    b = np.searchsorted(cum, nxt, side="right") / 9.0
    diff = b - a
    return np.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)


def _class_map(mu_int: np.ndarray, n_classes: int) -> np.ndarray:
    """Flat int class id per (pixel, channel) from activity quantiles.
    Identical on both sides: a deterministic function of mu alone, and
    equal to ``searchsorted(np.quantile(act, qs), act, side='right')``
    over the float activity ``act = S / 9.0``, through a table over the
    4591 possible sums."""
    sums = _activity_sum(mu_int).reshape(-1)
    if n_classes <= 1:
        return np.zeros(sums.shape, np.int64)
    hist = np.bincount(sums, minlength=_MAX_ACTIVITY + 1)
    thresholds = _quantile_thresholds(hist, n_classes)
    lut = np.searchsorted(thresholds, np.arange(_MAX_ACTIVITY + 1) / 9.0,
                          side="right")
    return lut[sums]


def _class_histograms(centred: np.ndarray, cls: np.ndarray,
                      n_classes: int) -> np.ndarray:
    """(K, 256) counts of each class's centred residuals (-128..127), row k
    equal to ``bincount(centred[cls == k] + 128)``, in one pass."""
    return np.bincount(cls * 256 + (centred + 128),
                       minlength=n_classes * 256).reshape(n_classes, 256)


def _fit_scale(hist: np.ndarray) -> float:
    """MLE discretized-logistic scale for one class's histogram of centred
    residual levels in [-128, 128) (256 counts), by golden-section search
    on the histogram NLL (each NLL evaluation is O(256) regardless of
    pixel count).  Returned as float32 so encoder and decoder build their
    histograms from the IDENTICAL transmitted value."""
    hist = np.asarray(hist, dtype=np.float64)
    binsize = 1.0 / 256.0
    r = np.arange(-128, 128, dtype=np.float64)

    from scipy.special import expit

    def nll(log_s):
        s = np.exp(log_s)
        p = expit((r + 0.5) * binsize / s) - expit((r - 0.5) * binsize / s)
        return -np.sum(hist * np.log(np.maximum(p, 1e-300)))

    lo, hi = np.log(_MIN_SCALE), np.log(_MAX_SCALE)
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = nll(c), nll(d)
    for _ in range(60):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = nll(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = nll(d)
    return float(np.float32(np.exp((a + b) / 2.0)))


def auto_classes(n_values: int) -> int:
    """Class count sized to the residual.  With the v3 classed stream a
    class costs only its 4-byte transmitted scale (the v2 multi-stream
    format cost ~10 bytes + a termination each — measured +0.38 bpd on
    hopper32 at a forced K=16), but a class still needs enough pixels for
    its MLE scale to be meaningful: one class per ~1024 values, capped."""
    return max(1, min(DEFAULT_CLASSES, n_values // 1024))


def encode_residual(image01: np.ndarray, recon01: np.ndarray,
                    scale: float = None, *,
                    n_classes: int = None) -> Tuple[bytes, int]:
    """Returns (self-describing payload, pixel count).

    ``scale`` (the model's global likelihood scale) is accepted for API
    compatibility but unused: per-class scales are fitted by MLE on the
    actual residuals and transmitted in the payload (K float32s).
    ``n_classes=None`` auto-sizes K to the image (``auto_classes``).  A
    span, ``io.residual``, with the count ``subpixels``."""
    with span("io.residual", subpixels=int(np.size(image01))):
        x = quantize(image01)
        mu = quantize(recon01)
        if n_classes is None:
            n_classes = auto_classes(x.size)
        r = ((x - mu) % 256).reshape(-1)               # 0..255
        centred = ((r + 128) % 256) - 128              # -128..127
        cls = _class_map(mu, n_classes)

        hists = _class_histograms(centred, cls, n_classes)
        scales = [_fit_scale(h) if h.any() else 1.0 / 256.0 for h in hists]
        # (K, 256)
        counts = np.stack([residual_histogram(s)[1:] for s in scales])
        symbols = (centred + 128).astype(np.int32)     # 0..255, no EOF shift
        stream, _ = ArithmeticCoder.encode_classes(counts, symbols, cls)

        payload = bytearray()
        payload += struct.pack("<BB", RESIDUAL_VERSION, n_classes)
        payload += struct.pack(f"<{n_classes}f", *scales)
        payload += stream
        return bytes(payload), int(x.size)


def decode_residual(payload: Union[bytes, "ResidualSection"],
                    recon01: np.ndarray, scale: float = None) -> np.ndarray:
    """Returns the exact original quantized image as [0,1) floats
    (level + 0.5)/256 — the canonical dequantization.  Accepts a raw v2
    payload, a (tag, data) ``ResidualSection`` from ``read_rec`` (tag "R"
    = legacy v1, needs ``scale``), or raw legacy bytes via tag "R"."""
    tag, data = ("S", payload)
    if hasattr(payload, "tag"):
        tag, data = payload.tag, payload.data
    mu = quantize(recon01)
    if tag == "R":
        return _decode_residual_v1(data, mu, scale)

    (version, n_classes) = struct.unpack_from("<BB", data, 0)
    assert version in (2, 3), f"unknown residual version {version}"
    off = 2
    scales = struct.unpack_from(f"<{n_classes}f", data, off)
    off += 4 * n_classes
    cls = _class_map(mu, n_classes)

    if version == 3:
        counts = np.stack([residual_histogram(float(s))[1:] for s in scales])
        stream = data[off:]
        symbols = ArithmeticCoder.decode_classes(counts, stream,
                                                 len(stream) * 8, cls)
        centred = symbols.astype(np.int64) - 128
    else:  # v2: one terminated stream per class + a length table
        lengths = struct.unpack_from(f"<{n_classes}I", data, off)
        off += 4 * n_classes
        centred = np.zeros(mu.size, np.int64)
        for k in range(n_classes):
            stream = data[off: off + lengths[k]]
            off += lengths[k]
            n_k = int(np.sum(cls == k))
            if lengths[k] == 0:
                continue
            ac = ArithmeticCoder(residual_histogram(float(scales[k])))
            msg = ac.decode(stream, len(stream) * 8, max_symbols=n_k + 2)
            symbols = msg[:-1]
            assert symbols.size == n_k, "residual stream length mismatch"
            centred[cls == k] = symbols - 1 - 128
    x = (mu.reshape(-1) + centred) % 256
    return ((x.reshape(mu.shape).astype(np.float32)) + 0.5) / 256.0


def _decode_residual_v1(data: bytes, mu: np.ndarray, scale: float
                        ) -> np.ndarray:
    """Legacy single-global-scale payload (container tag "R").

    Such files were written against an older einsum decode replay;
    the current pinned-scan replay is 1-ulp different at some shapes, so
    exact pixel recovery is likely but not guaranteed — surfaced here
    rather than silently reconstructing."""
    warnings.warn(
        "decoding a legacy (v1, tag 'R') residual section: written by an "
        "earlier replay version, exact losslessness is not guaranteed "
        "against the current decode replay", stacklevel=2)
    assert scale is not None, "legacy residual payload needs the model scale"
    ac = ArithmeticCoder(residual_histogram(scale))
    msg = ac.decode(data, len(data) * 8, max_symbols=mu.size + 2)
    symbols = msg[:-1]
    assert symbols.size == mu.size, "residual stream length mismatch"
    r = (symbols - 1 - 128) % 256
    x = (mu.reshape(-1) + r) % 256
    return ((x.reshape(mu.shape).astype(np.float32)) + 0.5) / 256.0
