"""A msgpack decoder for the subset that flax's serialization writes.

``flax.serialization.to_bytes`` packs a state dict with msgpack: maps with
str keys, str, bin, ints, floats, nil/bools, arrays, and numpy arrays as ext
type 1 (type 3 for numpy scalars) whose payload is itself msgpack of
``(shape, dtype name, C-order bytes)``.  Arrays larger than 2^30 bytes,
which flax splits into chunks, are not supported.  The port reads
checkpoints without the msgpack package.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``."""
    obj, end = _decode(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return obj


def _ndarray(payload: bytes, scalar: bool):
    shape, dtype, raw = unpackb(payload)
    arr = np.frombuffer(bytes(raw), dtype=np.dtype(dtype))
    arr = arr.reshape(tuple(shape))
    return arr[()] if scalar else arr.copy()


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload, scalar=False)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload, scalar=True)
    raise ValueError(f"msgpack: unsupported ext type {code}")


def _decode(buf: memoryview, i: int) -> Tuple[Any, int]:
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[i:i + n], "utf-8"), i + n
    if b == 0xC0:
        return None, i
    if b == 0xC2:
        return False, i
    if b == 0xC3:
        return True, i
    if b in (0xC4, 0xC5, 0xC6):            # bin 8/16/32
        n, i = _length(buf, i, b - 0xC4)
        return bytes(buf[i:i + n]), i + n
    if b in (0xC7, 0xC8, 0xC9):            # ext 8/16/32
        n, i = _length(buf, i, b - 0xC7)
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1:i + 1 + n])), i + 1 + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, i)[0], i + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, i)[0], i + 8
    if 0xCC <= b <= 0xD3:                  # uint/int 8..64
        fmt = ">" + "BHIQbhiq"[b - 0xCC]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if 0xD4 <= b <= 0xD8:                  # fixext 1/2/4/8/16
        n = 1 << (b - 0xD4)
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1:i + 1 + n])), i + 1 + n
    if b in (0xD9, 0xDA, 0xDB):            # str 8/16/32
        n, i = _length(buf, i, b - 0xD9)
        return str(buf[i:i + n], "utf-8"), i + n
    if b in (0xDC, 0xDD):                  # array 16/32
        n, i = _length(buf, i, b - 0xDC + 1)
        return _array(buf, i, n)
    if b in (0xDE, 0xDF):                  # map 16/32
        n, i = _length(buf, i, b - 0xDE + 1)
        return _map(buf, i, n)
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _length(buf: memoryview, i: int, width: int) -> Tuple[int, int]:
    fmt = ">" + "BHI"[width]
    return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)


def _array(buf: memoryview, i: int, n: int):
    out = []
    for _ in range(n):
        v, i = _decode(buf, i)
        out.append(v)
    return out, i


def _map(buf: memoryview, i: int, n: int):
    out = {}
    for _ in range(n):
        k, i = _decode(buf, i)
        v, i = _decode(buf, i)
        out[k] = v
    return out, i
