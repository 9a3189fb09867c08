"""A msgpack encoder and decoder for the subset that flax's serialization
writes.

``flax.serialization.to_bytes`` packs a state dict with msgpack: maps with
str keys, str, bin, ints, floats, nil/bools, arrays, and numpy arrays as ext
type 1 (type 3 for numpy scalars) whose payload is itself msgpack of
``(shape, dtype name, C-order bytes)``.  Arrays larger than 2^30 bytes,
which flax splits into chunks, are not supported.  ``packb`` writes each
object in the form the msgpack package picks for it (the shortest header,
Python floats as float64), so a flax file unpacked and packed again gives
the same bytes.  The port reads and writes checkpoints without the msgpack
package.
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


def packb(obj: Any) -> bytes:
    """Encode ``obj``: dicts with str keys, lists and tuples, str, bytes,
    ints, floats, None, bools, numpy arrays (ext 1) and numpy scalars
    (ext 3)."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)


def _header(n: int, fix: Tuple[int, int], wide: Tuple[int, ...]) -> bytes:
    """The header of a length-``n`` object: ``fix`` = (first byte, largest
    n) of its fix form, or None; ``wide`` = the type bytes of its 8-, 16-
    and 32-bit length forms (None where the type has no such form)."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, fmt in zip(wide, ("B", "H", "I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v > 0:
        for code, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(">" + fmt, v)
    else:
        for code, fmt in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(">" + fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _ext_pack(code: int, arr: np.ndarray) -> list:
    """Ext ``code`` holding msgpack of (shape, dtype name, C-order
    bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes")
    payload = packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        head = bytes([0xD4 + n.bit_length() - 1])
    else:
        head = _header(n, None, (0xC7, 0xC8, 0xC9))
    return [head, struct.pack(">b", code), payload]


def _encode(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        out.extend(_ext_pack(_EXT_NDARRAY, obj))
    elif isinstance(obj, np.generic):
        out.extend(_ext_pack(_EXT_NPSCALAR, np.asarray(obj)))
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_header(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_header(len(raw), None, (0xC4, 0xC5, 0xC6)))
        out.append(raw)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), (0x80, 15), (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map key {k!r} is not a str")
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), (0x90, 15), (None, 0xDC, 0xDD)))
        for v in obj:
            _encode(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")
