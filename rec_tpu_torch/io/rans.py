"""rANS (range asymmetric numeral systems) entropy coder.

The port's own copy of rec_tpu/io/rans.py; the .rec files it writes are
byte-identical to rec_tpu's.

The reference declares ANS as a TODO and never ships it (ref
rec/io/entropy_coding.pyx:304-306); this module provides it.  The native implementation lives in cpp/arithmetic.cc
(``rec_rans_encode``/``rec_rans_decode``); this file holds its ctypes
bindings, with no pure-Python fallback.

Model interface matches the arithmetic coder: a count histogram defines the
symbol frequencies, EOF = symbol 0.  The histogram is deterministically
normalized to frequencies summing to ``1 << prob_bits`` (every present
symbol keeps freq >= 1) — the normalized table is part of the format, so
encoder and decoder only need to share the raw counts.

Wire format: 4-byte little-endian final state, then renormalization bytes in
decode order.  Encoding is LIFO (runs the message in reverse); decoding is a
tight divide-free loop — one multiply plus a binary search per symbol.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Optional

import numpy as np

from .arithmetic import _as_i32, _as_i64, _load_native


@lru_cache(maxsize=1)
def _load_rans() -> ctypes.CDLL:
    """Load librec_ac.so and register the rANS prototypes."""
    lib = _load_native()
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rec_rans_encode.restype = ctypes.c_int
    lib.rec_rans_encode.argtypes = [
        i64p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int64,
        u8p, ctypes.c_int64, i64p]
    lib.rec_rans_decode.restype = ctypes.c_int
    lib.rec_rans_decode.argtypes = [
        i64p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int64,
        i32p, ctypes.c_int64, i64p]
    lib.rec_rans_encode_many.restype = ctypes.c_int
    lib.rec_rans_encode_many.argtypes = [
        i64p, i64p, i32p, ctypes.c_int, i32p, i64p, ctypes.c_int,
        u8p, i64p, i64p, i32p]
    return lib


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

class RansCoder:
    """rANS coder over a count histogram; EOF = symbol 0.

    ``encode`` -> packed bytes; ``decode`` -> int32 message (including the
    trailing EOF symbol).  Byte-aligned by construction, so unlike
    ArithmeticCoder there is no separate bit length to carry.
    """

    def __init__(self, counts, prob_bits: int = 14):
        self.counts = _as_i64(counts)
        if np.any(self.counts < 0) or self.counts.sum() <= 0:
            raise ValueError("counts must be non-negative with positive total")
        if not 2 <= prob_bits <= 16:
            raise ValueError("prob_bits must be in [2, 16]")
        self.prob_bits = prob_bits
        self._lib = _load_rans()

    @staticmethod
    def encode_bound_bytes(msg_len: int) -> int:
        # 4 state bytes + worst case ~3 renorm bytes/symbol at prob_bits<=16.
        return 4 + 4 * max(int(msg_len), 1) + 16

    def encode(self, message) -> bytes:
        msg = _as_i32(message)
        lib = self._lib
        out = np.zeros(self.encode_bound_bytes(len(msg)), np.uint8)
        out_bytes = ctypes.c_int64(0)
        rc = lib.rec_rans_encode(
            self.counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self.counts), self.prob_bits,
            msg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(msg),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out),
            ctypes.byref(out_bytes))
        if rc != 0:
            raise ValueError(f"rANS encode failed (rc={rc})")
        return bytes(out[: int(out_bytes.value)])

    def decode(self, data: bytes,
               max_symbols: Optional[int] = None) -> np.ndarray:
        lib = self._lib
        cap = max_symbols if max_symbols is not None else max(
            8 * len(data) + 64, 1024)
        buf = np.frombuffer(data, np.uint8).copy()
        out = np.zeros(cap, np.int32)
        out_len = ctypes.c_int64(0)
        rc = lib.rec_rans_decode(
            self.counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self.counts), self.prob_bits,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            ctypes.byref(out_len))
        if rc == -5:
            raise ValueError("rANS decode output capacity exhausted")
        if rc != 0:
            raise ValueError(f"rANS decode failed (rc={rc})")
        return out[: int(out_len.value)].copy()

    @staticmethod
    def encode_many(counts_list, messages,
                    prob_bits: int = 14) -> List[bytes]:
        """Encode independent streams in parallel on host threads
        (cpp rec_rans_encode_many; per-latent streams are independent in the
        .rec format, ref rec/io/utils.py:66-68)."""
        lib = _load_rans()
        n = len(messages)
        if n == 0:
            return []
        counts_cat = np.concatenate([_as_i64(c) for c in counts_list])
        counts_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(c) for c in counts_list], out=counts_off[1:])
        n_symbols = np.asarray([len(c) for c in counts_list], np.int32)
        msgs_cat = np.concatenate([_as_i32(m) for m in messages])
        msg_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(m) for m in messages], out=msg_off[1:])
        bounds = [RansCoder.encode_bound_bytes(len(m)) for m in messages]
        out_off = np.zeros(n + 1, np.int64)
        np.cumsum(bounds, out=out_off[1:])
        out = np.zeros(int(out_off[-1]), np.uint8)
        out_bytes = np.zeros(n, np.int64)
        status = np.zeros(n, np.int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.rec_rans_encode_many(
            counts_cat.ctypes.data_as(i64p), counts_off.ctypes.data_as(i64p),
            n_symbols.ctypes.data_as(i32p), prob_bits,
            msgs_cat.ctypes.data_as(i32p), msg_off.ctypes.data_as(i64p),
            n, out.ctypes.data_as(u8p), out_off.ctypes.data_as(i64p),
            out_bytes.ctypes.data_as(i64p), status.ctypes.data_as(i32p))
        if rc != 0:
            raise ValueError(f"parallel rANS encode failed ({status})")
        return [bytes(out[int(out_off[s]): int(out_off[s]) + int(out_bytes[s])])
                for s in range(n)]
