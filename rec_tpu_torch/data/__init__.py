"""Dataset loading (port of rec_tpu/data)."""

from .datasets import DatasetConfig, load_images, normalize, pad_to_multiple

__all__ = ["DatasetConfig", "load_images", "normalize", "pad_to_multiple"]
