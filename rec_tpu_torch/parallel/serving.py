"""Which rows of a global batch each device serves (port of
rec_tpu/parallel/serving.py).

Every process loads the same images, so no data moves between processes.
The global mesh is every process's mesh in rank order, each ``n_devices``
entries long: the batch (padded to a multiple of the global mesh) splits
into contiguous equal shares in that order — the rows that JAX's 1-D data
sharding (``global_batch_array``) gives each device.  A process owns the
rows of its entries, one contiguous range.
"""

from __future__ import annotations


def local_rows(global_batch_len: int, rank: int, world: int,
               device: int = 0, n_devices: int = 1) -> range:
    """The global row indices that entry ``device`` of process ``rank``'s
    mesh owns, when each of ``world`` processes has ``n_devices`` entries
    (by default one device per process: the process's rows)."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of world {world}")
    if n_devices < 1 or not 0 <= device < n_devices:
        raise ValueError(f"device {device} of {n_devices}")
    entries = world * n_devices
    if global_batch_len % entries:
        raise ValueError(f"batch {global_batch_len} is not a multiple of "
                         f"the global mesh ({entries} entries)")
    share = global_batch_len // entries
    first = (rank * n_devices + device) * share
    return range(first, first + share)


def process_rows(global_batch_len: int, rank: int, world: int,
                 n_devices: int = 1) -> range:
    """The rows of all ``n_devices`` entries of process ``rank``."""
    first = local_rows(global_batch_len, rank, world, 0, n_devices)
    last = local_rows(global_batch_len, rank, world, n_devices - 1,
                      n_devices)
    return range(first.start, last.stop)
