"""Data parallelism over devices and processes (port of rec_tpu/parallel).

Images and latent blocks are independent, so serving and coding shard with
no collectives: a ``Mesh`` lists the devices of one process (a device may
repeat), each process of a multi-process run owns contiguous rows of every
global batch, and within a device one ``compress_batch`` encodes all of its
rows with one beam-search kernel launch per res block (lossy models: per
latent level).  One latent's blocks shard over a mesh with
``sharded_encode_blocks``/``sharded_decode_blocks``.
"""

from .batch import (make_batch_compress, make_batch_decompress,
                    make_batch_rec_decode, make_batch_rec_forward,
                    shard_images)
from .codec import sharded_decode_blocks, sharded_encode_blocks
from .mesh import (Mesh, init_distributed, make_mesh, rank, replicate,
                   shard_rows, world_size)
from .serving import local_rows, process_rows

__all__ = ["Mesh", "make_mesh", "shard_rows", "replicate",
           "sharded_encode_blocks", "sharded_decode_blocks",
           "make_batch_compress", "make_batch_decompress",
           "make_batch_rec_forward", "make_batch_rec_decode",
           "shard_images", "init_distributed", "rank", "world_size",
           "local_rows", "process_rows"]
