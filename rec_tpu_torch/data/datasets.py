"""Image datasets for serving, evaluation and training (port of
rec_tpu/data/datasets.py).

Loaders resolve in order, with no downloads:
  1. local arrays: ``<data_dir>/<name>_<split>.npz`` with an "images" entry,
     or a directory ``<data_dir>/<name>/<split>`` of .npy/.png files;
  2. a deterministic synthetic fallback (reported as such): smooth random
     fields from ``RandomState(crc32(name))``, bitwise equal to rec_tpu's.

Lossless models see images in [-0.5, 0.5] (``normalize(..., "centered")``).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

DATASET_SHAPES = {
    "mnist": (28, 28, 1),
    "binarized_mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "imagenet32": (32, 32, 3),
    "imagenet64": (64, 64, 3),
    "kodak": (512, 768, 3),
    "clic2019": (256, 256, 3),
    "hopper32": (32, 32, 3),
    "hopper256": (256, 256, 3),
    "hopper384": (384, 384, 3),
    "hopper512": (600, 512, 3),
    "photos384": (384, 384, 3),
}


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    dataset: str = "cifar10"
    data_dir: str = "data"
    split: str = "train"
    normalize: str = "centered"  # "centered" [-0.5,0.5] | "unit" [0,1]
    crop_size: Optional[int] = None
    synthetic_size: int = 256  # fallback dataset size


def _load_png_dir(path: str):
    files = sorted(glob.glob(os.path.join(path, "*.png"))
                   + glob.glob(os.path.join(path, "*.npy")))
    if not files:
        return None
    images = []
    for f in files:
        if f.endswith(".npy"):
            images.append(np.load(f))
        else:
            from PIL import Image

            images.append(np.asarray(Image.open(f).convert("RGB")))
    return np.stack(images) if len({i.shape for i in images}) == 1 else images


def load_images(cfg: DatasetConfig) -> Tuple[np.ndarray, bool]:
    """Returns (images in [0, 255] as float32, is_synthetic)."""
    npz = os.path.join(cfg.data_dir, f"{cfg.dataset}_{cfg.split}.npz")
    if os.path.exists(npz):
        with np.load(npz) as f:
            return f["images"].astype(np.float32), False
    png_dir = os.path.join(cfg.data_dir, cfg.dataset, cfg.split)
    if os.path.isdir(png_dir):
        imgs = _load_png_dir(png_dir)
        if imgs is not None:
            return np.asarray(imgs, np.float32), False
    if cfg.dataset not in DATASET_SHAPES:
        raise FileNotFoundError(
            f"dataset {cfg.dataset!r} has no local file {npz} and no "
            f"synthetic shape")
    from scipy.ndimage import uniform_filter

    rs = np.random.RandomState(zlib.crc32(cfg.dataset.encode()) % (2 ** 31))
    imgs = rs.rand(cfg.synthetic_size,
                   *DATASET_SHAPES[cfg.dataset]).astype(np.float32)
    imgs = uniform_filter(imgs, size=(1, 5, 5, 1), mode="wrap")
    if cfg.dataset == "binarized_mnist":
        imgs = (imgs > imgs.mean()).astype(np.float32) * 255.0
    else:
        imgs = 255.0 * (imgs - imgs.min()) / (imgs.max() - imgs.min())
    return imgs, True


def normalize(images: np.ndarray, mode: str) -> np.ndarray:
    x = images / 255.0
    return x - 0.5 if mode == "centered" else x


def iterate_batches(cfg: DatasetConfig, batch_size: int, seed: int = 0,
                    repeat: bool = True) -> Iterator[np.ndarray]:
    """Shuffled (``RandomState(seed)``), batched, optionally random-cropped
    stream of normalised numpy batches; rec_tpu's batches for the same
    seed.  A trainer copies each batch to its device."""
    images, _ = load_images(cfg)
    images = normalize(images, cfg.normalize)
    rs = np.random.RandomState(seed)
    n = len(images)
    while True:
        order = rs.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            batch = images[order[i:i + batch_size]]
            if cfg.crop_size:
                c = cfg.crop_size
                h0 = rs.randint(0, batch.shape[1] - c + 1)
                w0 = rs.randint(0, batch.shape[2] - c + 1)
                batch = batch[:, h0:h0 + c, w0:w0 + c]
            yield batch
        if not repeat:
            return


def pad_to_multiple(image: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Reflect-pad H, W (the last three axes are H, W, C) up to a
    multiple."""
    h, w = image.shape[-3], image.shape[-2]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph == 0 and pw == 0:
        return image
    pad = [(0, 0)] * (image.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
    return np.pad(image, pad, mode="reflect")


def write_png(path: str, image: np.ndarray) -> None:
    """Quantise a [0, 1] float image (H, W, C) to an 8-bit PNG."""
    from PIL import Image

    arr = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)
