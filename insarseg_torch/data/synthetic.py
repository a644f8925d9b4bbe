"""Synthetic data (own copy of ``insarseg/data/synthetic.py``, numpy and
PIL only): a miniature VOC tree on disk for the data path and the CLI, and
in-memory batches for smoke training. The same seed writes the same files
and draws the same arrays as the JAX package.

The real dataset (Arctic landfast-ice InSAR tiles) is not vendored; the
tree replicates its format: grayscale JPEG tiles and {0, 255} PNG masks in
the VOC layout.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def make_synthetic_voc(
    root: str,
    n_train: int = 8,
    n_val: int = 4,
    size: int = 64,
    seed: int = 0,
    noise: float = 0.25,
    contrast: float = 0.5,
    band_width: tuple = (0.03, 0.08),
) -> str:
    """Write a VOC2012-layout tree of ``size``^2 synthetic interferogram
    tiles under ``root`` (``tile_0000``... train, ``tile_v0000``... val)
    and return ``root``. Images are smooth random phase-like fields plus
    noise; masks are {0, 255} linear bands through a random in-frame point
    (every tile holds class 1), drawn brighter in the image.
    ``noise`` / ``contrast`` / ``band_width`` set the difficulty (keep
    noise below 0.8: the phase term is scaled by 0.8 - noise)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "JPEGImages")
    mask_dir = os.path.join(root, "SegmentationClass")
    split_dir = os.path.join(root, "ImageSets", "Segmentation")
    for d in (img_dir, mask_dir, split_dir):
        os.makedirs(d, exist_ok=True)

    def write_one(img_id: str):
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        a, b, c = rng.uniform(-3, 3, 3)
        phase = np.sin(2 * np.pi * (a * xx + b * yy + c)) * 0.5 + 0.5
        noise_f = rng.random((size, size), dtype=np.float32) * noise
        theta = rng.uniform(0, np.pi)
        x0, y0 = rng.uniform(0.25, 0.75, 2)
        w0 = rng.uniform(*band_width)
        band = np.abs(np.cos(theta) * (xx - x0)
                      + np.sin(theta) * (yy - y0)) < w0
        img_f = phase * (0.8 - noise) + noise_f
        img_f = np.where(band, 1.0 - (1.0 - contrast) * img_f, img_f)
        img = np.clip(img_f * 255, 0, 255).astype(np.uint8)
        mask = np.where(band, 255, 0).astype(np.uint8)
        Image.fromarray(img, "L").save(os.path.join(img_dir, f"{img_id}.jpg"))
        Image.fromarray(mask, "L").save(os.path.join(mask_dir,
                                                     f"{img_id}.png"))

    train_ids = [f"tile_{i:04d}" for i in range(n_train)]
    val_ids = [f"tile_v{i:04d}" for i in range(n_val)]
    for i in train_ids + val_ids:
        write_one(i)
    with open(os.path.join(split_dir, "train.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
    with open(os.path.join(split_dir, "val.txt"), "w") as f:
        f.write("\n".join(val_ids) + "\n")
    return root


def synthetic_batch(batch_size: int, size: int,
                    seed: int = 0) -> Dict[str, Any]:
    """{'image': (B, size, size, 1) f32 in [-1, 1], 'mask': (B, size, size)
    int32 in {0, 1}, 'n_valid': B}, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (batch_size, size, size, 1)).astype(np.float32)
    mask = (rng.random((batch_size, size, size)) > 0.8).astype(np.int32)
    return {"image": img, "mask": mask, "n_valid": batch_size}
