"""Which rows of a global batch a process serves (port of
rec_tpu/parallel/serving.py).

Every process loads the same images, so no data moves between processes.
With one device per process the batch (padded to a multiple of the world
size) splits into contiguous equal shares in rank order — the rows that
JAX's 1-D data sharding gives each process's device.
"""

from __future__ import annotations


def local_rows(global_batch_len: int, rank: int, world: int) -> range:
    """The global row indices process ``rank`` of ``world`` owns."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of world {world}")
    if global_batch_len % world:
        raise ValueError(f"batch {global_batch_len} is not a multiple of "
                         f"the world size {world}")
    share = global_batch_len // world
    return range(rank * share, (rank + 1) * share)
