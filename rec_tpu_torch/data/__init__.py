"""Dataset loading (port of rec_tpu/data)."""

from .datasets import (DatasetConfig, iterate_batches, load_images,
                       normalize, pad_to_multiple)

__all__ = ["DatasetConfig", "iterate_batches", "load_images", "normalize",
           "pad_to_multiple"]
