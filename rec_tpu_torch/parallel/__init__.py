"""Batched serving and process groups (port of rec_tpu/parallel).

Images are independent, so serving is data parallel: each process encodes
its own contiguous rows of every global batch, and within a process one
``compress_batch`` encodes all of them with one beam-search kernel launch
per res block (lossy models: per latent level).
"""

from .batch import (make_batch_compress, make_batch_decompress,
                    make_batch_rec_decode, make_batch_rec_forward)
from .mesh import init_distributed, rank, world_size
from .serving import local_rows

__all__ = ["make_batch_compress", "make_batch_decompress",
           "make_batch_rec_forward", "make_batch_rec_decode",
           "init_distributed", "rank", "world_size", "local_rows"]
