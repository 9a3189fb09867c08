"""Bitstream IO: native arithmetic coding + .rec container (the port's
copy of rec_tpu/io)."""

from .arithmetic import ArithmeticCoder
from .container import (ResidualSection, default_index_counts,
                        default_nav_counts, read_rec, write_rec)
from .rans import RansCoder

__all__ = ["ArithmeticCoder", "RansCoder", "ResidualSection", "read_rec",
           "write_rec", "default_index_counts", "default_nav_counts"]
