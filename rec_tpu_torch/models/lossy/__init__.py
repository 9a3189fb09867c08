"""Lossy compression models (port of rec_tpu/models/lossy: the 1-, 2- and
4-level VAEs)."""

from .base import compress_to_file, decompress_from_file
from .level1 import Large1LevelVAE
from .level2 import Large2LevelVAE
from .level4 import Large4LevelVAE

__all__ = ["Large1LevelVAE", "Large2LevelVAE", "Large4LevelVAE",
           "compress_to_file", "decompress_from_file"]
