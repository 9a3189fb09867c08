"""Python binding for the native C++ arithmetic coder (cpp/arithmetic.cc).

The port's own copy of rec_tpu/io/arithmetic.py (the port imports nothing of
rec_tpu); it builds the shared library into rec_tpu_torch/build/.

Loads (building on first use if needed) ``librec_ac.so`` via ctypes; there is
no pure-Python fallback, so a failed build or load raises.  The port's tests
hold its output byte for byte against rec_tpu's.

API mirrors the reference ArithmeticCoder (ref entropy_coding.pyx:19): a count
histogram defines the model; EOF is symbol 0; ``encode`` returns packed bits.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "build")


@lru_cache(maxsize=1)
def _load_native() -> ctypes.CDLL:
    """The shared C++ codec, built from cpp/arithmetic.cc into the port's
    own build directory (gitignored) at first use.  Raises if g++ fails."""
    so = os.path.abspath(os.path.join(_BUILD_DIR, "librec_ac.so"))
    src = os.path.abspath(os.path.join(_CPP_DIR, "arithmetic.cc"))
    if not os.path.exists(so) or os.path.getmtime(src) > os.path.getmtime(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             src, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{so}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rec_ac_encode.restype = ctypes.c_int
    lib.rec_ac_encode.argtypes = [i64p, ctypes.c_int, ctypes.c_int, i32p,
                                  ctypes.c_int64, u8p, ctypes.c_int64, i64p]
    lib.rec_ac_decode.restype = ctypes.c_int
    lib.rec_ac_decode.argtypes = [i64p, ctypes.c_int, ctypes.c_int, u8p,
                                  ctypes.c_int64, i32p, ctypes.c_int64, i64p]
    lib.rec_ac_encode_bound_bits.restype = ctypes.c_int64
    lib.rec_ac_encode_bound_bits.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.rec_ac_encode_many.restype = ctypes.c_int
    lib.rec_ac_encode_many.argtypes = [i64p, i64p, i32p, ctypes.c_int, i32p,
                                       i64p, ctypes.c_int, u8p, i64p, i64p,
                                       i32p]
    lib.rec_ac_encode_classes.restype = ctypes.c_int
    lib.rec_ac_encode_classes.argtypes = [
        i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p,
        ctypes.c_int64, u8p, ctypes.c_int64, i64p]
    lib.rec_ac_decode_classes.restype = ctypes.c_int
    lib.rec_ac_decode_classes.argtypes = [
        i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
        ctypes.c_int64, i32p, ctypes.c_int64, i32p]
    return lib


def _as_i64(counts) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(counts), dtype=np.int64)


def _as_i32(msg) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(msg), dtype=np.int32)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

class ArithmeticCoder:
    """Arithmetic coder over a count histogram; EOF = symbol 0.

    ``encode`` -> (packed bytes, bit length); ``decode`` -> int32 message
    (including the trailing EOF symbol).
    """

    def __init__(self, counts, precision: int = 32):
        self.counts = _as_i64(counts)
        if np.any(self.counts < 0) or self.counts.sum() <= 0:
            raise ValueError("counts must be non-negative with positive total")
        self.precision = precision
        self._lib = _load_native()

    def encode(self, message) -> Tuple[bytes, int]:
        msg = _as_i32(message)
        lib = self._lib
        bound_bits = lib.rec_ac_encode_bound_bits(len(msg), self.precision)
        out = np.zeros((int(bound_bits) + 7) // 8, np.uint8)
        out_bits = ctypes.c_int64(0)
        rc = lib.rec_ac_encode(
            self.counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self.counts), self.precision,
            msg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(msg),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out),
            ctypes.byref(out_bits))
        if rc != 0:
            raise ValueError(f"arithmetic encode failed (rc={rc})")
        nbits = int(out_bits.value)
        return bytes(out[: (nbits + 7) // 8]), nbits

    @staticmethod
    def encode_many(counts_list, messages, precision: int = 32):
        """Encode independent streams in parallel on host threads
        (cpp rec_ac_encode_many; the .rec format codes per-latent streams
        independently, ref rec/io/utils.py:66-68).  Returns a list of
        (bytes, nbits)."""
        lib = _load_native()
        n = len(messages)
        counts_cat = np.concatenate([_as_i64(c) for c in counts_list])
        counts_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(c) for c in counts_list], out=counts_off[1:])
        n_symbols = np.asarray([len(c) for c in counts_list], np.int32)
        msgs_cat = np.concatenate([_as_i32(m) for m in messages]) \
            if n else np.zeros(0, np.int32)
        msg_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(m) for m in messages], out=msg_off[1:])
        bounds = [(int(lib.rec_ac_encode_bound_bits(len(m), precision)) + 7)
                  // 8 for m in messages]
        out_off = np.zeros(n + 1, np.int64)
        np.cumsum(bounds, out=out_off[1:])
        out = np.zeros(int(out_off[-1]), np.uint8)
        out_bits = np.zeros(n, np.int64)
        status = np.zeros(n, np.int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.rec_ac_encode_many(
            counts_cat.ctypes.data_as(i64p), counts_off.ctypes.data_as(i64p),
            n_symbols.ctypes.data_as(i32p), precision,
            msgs_cat.ctypes.data_as(i32p), msg_off.ctypes.data_as(i64p),
            n, out.ctypes.data_as(u8p), out_off.ctypes.data_as(i64p),
            out_bits.ctypes.data_as(i64p), status.ctypes.data_as(i32p))
        if rc != 0:
            raise ValueError(f"parallel arithmetic encode failed ({status})")
        results = []
        for s in range(n):
            nbits = int(out_bits[s])
            start = int(out_off[s])
            results.append((bytes(out[start:start + (nbits + 7) // 8]),
                            nbits))
        return results

    # -- class-segmented coding (one stream, per-symbol histogram) --------

    @staticmethod
    def encode_classes(counts_2d, message, classes,
                       precision: int = 32) -> Tuple[bytes, int]:
        """Encode ``message[k]`` against histogram row ``classes[k]`` of
        ``counts_2d`` (K, V) in ONE arithmetic stream — no per-class
        termination, no EOF (the decoder knows the length and the classes;
        cpp rec_ac_encode_classes).  Returns (bytes, nbits)."""
        counts = np.ascontiguousarray(np.asarray(counts_2d), np.int64)
        msg, cls = _as_i32(message), _as_i32(classes)
        assert counts.ndim == 2 and len(msg) == len(cls)
        lib = _load_native()
        bound_bits = lib.rec_ac_encode_bound_bits(len(msg), precision)
        out = np.zeros((int(bound_bits) + 7) // 8, np.uint8)
        out_bits = ctypes.c_int64(0)
        rc = lib.rec_ac_encode_classes(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.shape[0], counts.shape[1], precision,
            msg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(msg),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out),
            ctypes.byref(out_bits))
        if rc != 0:
            raise ValueError(f"classed arithmetic encode failed (rc={rc})")
        nbits = int(out_bits.value)
        return bytes(out[: (nbits + 7) // 8]), nbits

    @staticmethod
    def decode_classes(counts_2d, data: bytes, nbits: int, classes,
                       precision: int = 32) -> np.ndarray:
        """Decode exactly ``len(classes)`` symbols, position k against
        histogram row ``classes[k]``."""
        counts = np.ascontiguousarray(np.asarray(counts_2d), np.int64)
        cls = _as_i32(classes)
        lib = _load_native()
        buf = np.frombuffer(data, np.uint8).copy()
        out = np.zeros(len(cls), np.int32)
        rc = lib.rec_ac_decode_classes(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.shape[0], counts.shape[1], precision,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nbits,
            cls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(cls),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise ValueError(f"classed arithmetic decode failed (rc={rc})")
        return out

    def decode(self, data: bytes, nbits: int,
               max_symbols: Optional[int] = None) -> np.ndarray:
        lib = self._lib
        cap = max_symbols if max_symbols is not None else max(4 * nbits + 64, 1024)
        buf = np.frombuffer(data, np.uint8).copy()
        out = np.zeros(cap, np.int32)
        out_len = ctypes.c_int64(0)
        rc = lib.rec_ac_decode(
            self.counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(self.counts), self.precision,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nbits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(f"arithmetic decode failed (rc={rc})")
        return out[: int(out_len.value)].copy()
