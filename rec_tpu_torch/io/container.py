""".rec container format: index streams -> bytes on disk and back.

The port's own copy of rec_tpu/io/container.py; the .rec files it writes are
byte-identical to rec_tpu's.

Field-compatible with the reference container (ref rec/io/utils.py:7-215):
packed static header ``struct 'IIIIIHHHH'`` = (seed, block_size, max_index,
H, W, C, nav-counts-file flag, index-counts-file flag, num_latents), then
per-latent arrays (num_blocks, nav codelengths, index codelengths, nav maxes),
then arithmetic-coded streams of (a) partitions-per-block and (b) flattened
indices, each with a +1 symbol shift and EOF symbol 0.

Differences from the reference, by design:
  * streams are byte-packed end to end — no '1' guard bit / bigint string
    round trip (ref rec/io/utils.py:58-68); codes start on byte boundaries
    and decode stops at EOF, so trailing pad bits are harmless;
  * the index payload of our codec is a dense (num_blocks, max_partitions)
    int32 array + per-block counts (the vmap-friendly layout), converted to
    the ragged stream form here at the host boundary.

Default priors match the reference: uniform counts with a +1000 boost over
EOF for indices (ref utils.py:31-35) and +100 for partition counts.

Entropy-codec selection: ``codec="ac"`` (default, arithmetic coding) or
``codec="rans"`` (the rANS coder the reference leaves as a TODO, ref
entropy_coding.pyx:304-306).  The choice is recorded in bit 1 of the
custom-index-counts flag field, so default-codec files are byte-identical
to the pre-rANS format and old files read back unchanged.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .arithmetic import ArithmeticCoder
from .rans import RansCoder


class ResidualSection(NamedTuple):
    """Trailing residual section: ``tag`` identifies the payload format —
    "S" = self-describing v2 (adaptive per-class scales, current replay),
    "R" = legacy v1 (single global scale, older einsum replay; see
    rec_tpu/io/residual.py).  Pass the whole section to
    ``residual.decode_residual``."""

    tag: str
    data: bytes

_STATIC_HEADER = "<IIIIIHHHH"  # little-endian, no padding: a file format must pin byte order
STATIC_HEADER_SIZE = struct.calcsize(_STATIC_HEADER)  # 28 bytes

_CODEC_RANS_FLAG = 2  # bit 1 of the custom-index-counts header field


def default_index_counts(max_index: int) -> np.ndarray:
    counts = np.ones(max_index + 1, dtype=np.int64)
    counts[1:] += 1000
    return counts


def default_nav_counts(nav_max: int) -> np.ndarray:
    counts = np.ones(nav_max + 2, dtype=np.int64)
    counts[1:] += 100
    return counts


def _encode_stream(coder: ArithmeticCoder, symbols: np.ndarray) -> bytes:
    message = np.concatenate([np.asarray(symbols, np.int64) + 1, [0]])
    data, _ = coder.encode(message.astype(np.int32))
    return data


def _decode_stream(coder, data: bytes) -> np.ndarray:
    if isinstance(coder, RansCoder):
        message = coder.decode(data)
    else:
        message = coder.decode(data, len(data) * 8)
    return message[:-1] - 1  # strip EOF, undo +1 shift


def write_rec(file_path: str, *, seed: int, image_shape: Tuple[int, int, int],
              block_size: int, max_index: int,
              latents: Sequence[Tuple[np.ndarray, np.ndarray]],
              index_counts: Optional[np.ndarray] = None,
              nav_counts: Optional[Sequence[np.ndarray]] = None,
              residual: Optional[bytes] = None,
              codec: str = "ac") -> int:
    """Serialize per-latent coded indices to a .rec file.

    ``latents``: one (indices (num_blocks, max_partitions), counts
    (num_blocks,)) pair per stochastic layer, as produced by
    ``coder.encode``.  Returns total bytes written.
    """
    if len(image_shape) != 3:
        raise ValueError(f"image_shape must be rank 3, got {image_shape!r}")
    if codec not in ("ac", "rans"):
        raise ValueError(f"codec must be 'ac' or 'rans', got {codec!r}")
    num_latents = len(latents)

    nav_messages, index_messages, num_blocks, nav_maxes = [], [], [], []
    for indices, counts in latents:
        indices = np.asarray(indices)
        counts = np.asarray(counts)
        num_blocks.append(len(counts))
        nav_maxes.append(int(counts.max()) if len(counts) else 0)
        nav_messages.append(counts.astype(np.int64))
        index_messages.append(np.concatenate(
            [indices[b, : counts[b]] for b in range(len(counts))]
            or [np.zeros(0, np.int64)]).astype(np.int64))

    use_custom_index = index_counts is not None
    use_custom_nav = nav_counts is not None
    index_counts = (np.asarray(index_counts, np.int64) if use_custom_index
                    else default_index_counts(max_index))
    nav_counts_list = (list(nav_counts) if use_custom_nav
                       else [default_nav_counts(m) for m in nav_maxes])

    # All per-latent streams are independent -> one parallel native encode
    # (host threads, cpp rec_ac_encode_many; ref codes streams separately
    # too, rec/io/utils.py:66-68).
    def to_message(symbols):
        return np.concatenate([np.asarray(symbols, np.int64) + 1,
                               [0]]).astype(np.int32)

    all_counts = (list(nav_counts_list)
                  + [index_counts] * len(index_messages))
    all_messages = ([to_message(nav) for nav in nav_messages]
                    + [to_message(idx) for idx in index_messages])
    if codec == "rans":
        encoded = RansCoder.encode_many(all_counts, all_messages)
        nav_codes = encoded[: len(nav_messages)]
        index_codes = encoded[len(nav_messages):]
    else:
        encoded = ArithmeticCoder.encode_many(all_counts, all_messages)
        nav_codes = [data for data, _ in encoded[: len(nav_messages)]]
        index_codes = [data for data, _ in encoded[len(nav_messages):]]

    index_flags = int(use_custom_index) | (
        _CODEC_RANS_FLAG if codec == "rans" else 0)
    header = struct.pack(
        _STATIC_HEADER, seed, block_size, max_index,
        image_shape[0], image_shape[1], image_shape[2],
        int(use_custom_nav), index_flags, num_latents)
    dyn = struct.pack(
        f"<{num_latents}I{num_latents}I{num_latents}I{num_latents}I",
        *num_blocks,
        *[len(c) for c in nav_codes],
        *[len(c) for c in index_codes],
        *nav_maxes)

    with open(file_path, "wb") as f:
        f.write(header)
        f.write(dyn)
        for code in nav_codes:
            f.write(code)
        for code in index_codes:
            f.write(code)
        if residual is not None:
            # Optional trailing section (true-lossless residual stream,
            # rec_tpu/io/residual.py): tag byte + u32 length + bytes.
            # Readers of the base format simply never reach it.  "S" = the
            # v2 self-describing payload; legacy "R" files (v1 payload,
            # earlier replay version) are read but never written.
            f.write(b"S" + struct.pack("<I", len(residual)) + residual)
        return f.tell()


def read_rec(file_path: str, *,
             index_counts: Optional[np.ndarray] = None,
             nav_counts: Optional[Sequence[np.ndarray]] = None,
             max_partitions: Optional[int] = None,
             with_residual: bool = False):
    """Parse a .rec file -> (seed, image_shape, block_size, latents) where
    latents is a list of (indices (num_blocks, P) int32, counts (num_blocks,)
    int32) pairs, P = max_partitions (default: max observed count).  With
    ``with_residual=True`` a 5th element holds the trailing residual stream
    (bytes or None)."""
    with open(file_path, "rb") as f:
        (seed, block_size, max_index, h, w, c, use_custom_nav,
         index_flags, num_latents) = struct.unpack(
            _STATIC_HEADER, f.read(STATIC_HEADER_SIZE))
        use_custom_index = index_flags & 1
        codec = "rans" if index_flags & _CODEC_RANS_FLAG else "ac"
        dyn_fmt = f"<{num_latents}I{num_latents}I{num_latents}I{num_latents}I"
        dyn = struct.unpack(dyn_fmt, f.read(struct.calcsize(dyn_fmt)))
        num_blocks = dyn[:num_latents]
        nav_lens = dyn[num_latents: 2 * num_latents]
        index_lens = dyn[2 * num_latents: 3 * num_latents]
        nav_maxes = dyn[3 * num_latents:]

        nav_codes = [f.read(n) for n in nav_lens]
        index_codes = [f.read(n) for n in index_lens]
        residual = None
        tag = f.read(1)
        if tag in (b"R", b"S"):
            (rlen,) = struct.unpack("<I", f.read(4))
            residual = ResidualSection(tag.decode(), f.read(rlen))

    if use_custom_index and index_counts is None:
        raise ValueError("file uses custom index counts; pass index_counts")
    if use_custom_nav and nav_counts is None:
        raise ValueError("file uses custom nav counts; pass nav_counts")
    index_counts = (np.asarray(index_counts, np.int64)
                    if use_custom_index else default_index_counts(max_index))
    nav_counts_list = (list(nav_counts) if use_custom_nav
                       else [default_nav_counts(m) for m in nav_maxes])

    make_coder = RansCoder if codec == "rans" else ArithmeticCoder
    index_coder = make_coder(index_counts)
    latents: List[Tuple[np.ndarray, np.ndarray]] = []
    for li in range(num_latents):
        counts = _decode_stream(make_coder(nav_counts_list[li]),
                                nav_codes[li]).astype(np.int32)
        flat = _decode_stream(index_coder, index_codes[li]).astype(np.int32)
        assert len(counts) == num_blocks[li], "corrupt .rec: block count"
        P = max_partitions or (int(counts.max()) if len(counts) else 1)
        indices = np.zeros((len(counts), P), np.int32)
        off = 0
        for b, n in enumerate(counts):
            indices[b, :n] = flat[off: off + n]
            off += n
        assert off == len(flat), "corrupt .rec: index stream length"
        latents.append((indices, counts))

    if with_residual:
        return seed, (h, w, c), block_size, latents, residual
    return seed, (h, w, c), block_size, latents
