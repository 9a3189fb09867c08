"""The ``.rec`` file read back in plain Python and numpy: the container's
header and its arithmetic-coded count and index streams, and the true-
lossless residual section.  It is written from the file format (the port's
``io/container.py``, ``io/residual.py`` and ``cpp/arithmetic.cc``) and
shares no code with the port: the arithmetic decoder is the 32-bit
precision interval coder in Python integers.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
from scipy.special import expit

PRECISION = 32
_WHOLE = 1 << PRECISION
_HALF = _WHOLE >> 1
_QUARTER = _WHOLE >> 2
_HEADER = "<IIIIIHHHH"


class FormatError(ValueError):
    """The bytes are not a file the reference can read."""


class _Bits:
    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)

    def get(self, i: int) -> int:
        if i >= self.nbits:
            return 0
        return (self.data[i >> 3] >> (7 - (i & 7))) & 1


def _cdf(counts) -> List[int]:
    out = [0]
    for c in counts:
        out.append(out[-1] + int(c))
    return out


class _Decoder:
    """The interval decoder's state over one bit stream."""

    def __init__(self, data: bytes):
        self.bits = _Bits(data)
        self.low, self.high, self.z, self.i = 0, _WHOLE, 0, 0
        for _ in range(PRECISION):
            self.z = (self.z << 1) | self.bits.get(self.i)
            self.i += 1

    def symbol(self, cdf: List[int]) -> int:
        R = cdf[-1]
        width = self.high - self.low
        zoff = self.z - self.low
        lo, hi = 0, len(cdf) - 2
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if (width * cdf[mid]) // R <= zoff:
                lo = mid
            else:
                hi = mid - 1
        j = lo
        high_ = self.low + (width * cdf[j + 1]) // R
        low_ = self.low + (width * cdf[j]) // R
        if not (low_ <= self.z < high_):
            raise FormatError("arithmetic stream is corrupt")
        self.low, self.high = low_, high_
        return j

    def renormalise(self) -> None:
        get = self.bits.get
        while True:
            if self.high < _HALF:
                self.low <<= 1
                self.high <<= 1
                self.z = (self.z << 1) | get(self.i)
            elif self.low > _HALF:
                self.low = (self.low - _HALF) << 1
                self.high = (self.high - _HALF) << 1
                self.z = ((self.z - _HALF) << 1) | get(self.i)
            else:
                break
            self.i += 1
        while self.low > _QUARTER and self.high < 3 * _QUARTER:
            self.low = (self.low - _QUARTER) << 1
            self.high = (self.high - _QUARTER) << 1
            self.z = ((self.z - _QUARTER) << 1) | get(self.i)
            self.i += 1


def decode_eof_stream(counts, data: bytes, limit: int = 1 << 22
                      ) -> np.ndarray:
    """Symbols up to the EOF symbol 0, the +1 shift undone."""
    cdf = _cdf(counts)
    dec = _Decoder(data)
    out = []
    while True:
        j = dec.symbol(cdf)
        if j == 0:
            return np.asarray(out, np.int64)
        out.append(j - 1)
        if len(out) > limit:
            raise FormatError("stream has no EOF")
        dec.renormalise()


def decode_class_stream(counts_2d, data: bytes, classes) -> np.ndarray:
    """One symbol per entry of ``classes``, each from its class's
    histogram (no EOF)."""
    cdfs = [_cdf(row) for row in counts_2d]
    dec = _Decoder(data)
    out = np.empty(len(classes), np.int64)
    for m, c in enumerate(classes.tolist()):
        out[m] = dec.symbol(cdfs[c])
        dec.renormalise()
    return out


class RecFile(NamedTuple):
    seed: int
    shape: Tuple[int, int, int]
    block_size: int
    max_index: int
    latents: list            # [(indices (blocks, P) int64, counts (blocks,))]
    residual: Optional[bytes]


def read_rec(data: bytes, max_partitions: int) -> RecFile:
    """Parse a default-histogram, arithmetic-coded ``.rec`` file."""
    off = struct.calcsize(_HEADER)
    if len(data) < off:
        raise FormatError("short header")
    (seed, block_size, max_index, h, w, c, custom_nav, index_flags,
     n_lat) = struct.unpack_from(_HEADER, data, 0)
    if custom_nav or index_flags:
        raise FormatError("custom histograms or rANS: not the served format")
    dyn = struct.unpack_from(f"<{4 * n_lat}I", data, off)
    off += 16 * n_lat
    num_blocks, nav_lens = dyn[:n_lat], dyn[n_lat:2 * n_lat]
    index_lens, nav_maxes = dyn[2 * n_lat:3 * n_lat], dyn[3 * n_lat:]
    nav_codes, index_codes = [], []
    for n in nav_lens:
        nav_codes.append(data[off:off + n])
        off += n
    for n in index_lens:
        index_codes.append(data[off:off + n])
        off += n
    residual = None
    if off < len(data):
        if data[off:off + 1] != b"S":
            raise FormatError("unknown trailing section")
        (rlen,) = struct.unpack_from("<I", data, off + 1)
        residual = data[off + 5: off + 5 + rlen]
    index_counts = np.ones(max_index + 1, np.int64)
    index_counts[1:] += 1000
    latents = []
    for li in range(n_lat):
        nav_counts = np.ones(nav_maxes[li] + 2, np.int64)
        nav_counts[1:] += 100
        counts = decode_eof_stream(nav_counts, nav_codes[li])
        flat = decode_eof_stream(index_counts, index_codes[li])
        if len(counts) != num_blocks[li] or counts.sum() != len(flat):
            raise FormatError("block or index count does not match")
        if np.any(counts > max_partitions):
            raise FormatError("a block has more partitions than the budget")
        indices = np.zeros((len(counts), max_partitions), np.int64)
        o = 0
        for b, n in enumerate(counts.tolist()):
            indices[b, :n] = flat[o:o + n]
            o += n
        latents.append((indices, counts))
    return RecFile(seed, (h, w, c), block_size, max_index, latents, residual)


# --- the true-lossless residual (format version 3) ---------------------------

def quantize(image01: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(np.asarray(image01) * 256.0), 0, 255).astype(
        np.int64)


def _histogram(scale: float, total: int = 1 << 16) -> np.ndarray:
    r = np.arange(-128, 128, dtype=np.float64)
    p = expit((r + 0.5) / 256.0 / scale) - expit((r - 0.5) / 256.0 / scale)
    p /= p.sum()
    return np.maximum((p * total).astype(np.int64), 1)


def _class_map(mu: np.ndarray, n_classes: int) -> np.ndarray:
    x = mu.astype(np.float64)
    g = (np.abs(np.diff(x, axis=1, prepend=x[:, :1]))
         + np.abs(np.diff(x, axis=0, prepend=x[:1])))
    p = np.pad(g, ((1, 1), (1, 1), (0, 0)), mode="edge")
    g = p[:-2] + p[1:-1] + p[2:]
    act = ((g[:, :-2] + g[:, 1:-1] + g[:, 2:]) / 9.0).reshape(-1)
    if n_classes <= 1:
        return np.zeros(act.shape, np.int64)
    thresholds = np.quantile(act, np.arange(1, n_classes) / n_classes)
    return np.searchsorted(thresholds, act, side="right")


def decode_residual(payload: bytes, recon01: np.ndarray) -> np.ndarray:
    """The image's 8-bit levels (H, W, C) from the residual and the
    decoder's reconstruction in [0, 1]."""
    if len(payload) < 2:
        raise FormatError("short residual")
    version, k = struct.unpack_from("<BB", payload, 0)
    if version != 3:
        raise FormatError(f"residual version {version}")
    scales = struct.unpack_from(f"<{k}f", payload, 2)
    mu = quantize(recon01)
    cls = _class_map(mu, k)
    counts = np.stack([_histogram(float(s)) for s in scales])
    sym = decode_class_stream(counts, payload[2 + 4 * k:], cls)
    x = (mu.reshape(-1) + sym - 128) % 256
    return x.reshape(mu.shape)
