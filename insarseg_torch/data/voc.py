"""VOC-layout dataset reader and static-shape batch loader (counterpart of
``insarseg/data/voc.py``; numpy and PIL only, the arrays the JAX package's
reader gives, batch for batch).

- Layout: ``JPEGImages/{id}.jpg``, ``SegmentationClass/{id}.png``,
  ``ImageSets/Segmentation/{train,val}.txt``; a missing split file raises
  ``FileNotFoundError``.
- Images open grayscale ('L'), PIL-bilinear resized to (S, S), scaled to
  [0, 1] and normalized with the mean / std (0.5 / 0.5 -> [-1, 1]); with
  ``raw_u8`` they stay uint8 and the train step normalizes on the device.
- Masks open 'L', PIL-nearest resized. ``mask_contract='legacy'`` is the
  reference's ``ToTensor()`` then ``.long()``: only pixels of exactly 255
  become class 1; ``'index'`` reads raw class ids (``ignore_index`` stays
  usable).

Output is NHWC numpy: images (S, S, 1) float32 (or uint8), masks (S, S)
int32. :class:`BatchLoader` zero-pads the last partial batch to B with
``ignore_index`` masks and reports ``n_valid``; the padded zero images do
enter BatchNorm's batch statistics, as in the JAX package (the reference
trains on a smaller last batch; ``drop_last=True`` skips it instead). PIL
is imported where a file is decoded, so the module imports without it.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator, Optional, Tuple

import numpy as np


class VOCSegDataset:
    def __init__(
        self,
        voc_root: str,
        image_size: int,
        image_set: str = "train",
        mask_contract: str = "legacy",
        normalize_mean: float = 0.5,
        normalize_std: float = 0.5,
        ignore_index: int = 255,
        raw_u8: bool = False,
    ):
        if mask_contract not in ("legacy", "index"):
            raise ValueError(f"unknown mask_contract {mask_contract!r}; "
                             "expected 'legacy' or 'index'")
        self.voc_root = voc_root
        self.image_size = int(image_size)
        self.mask_contract = mask_contract
        self.mean = normalize_mean
        self.std = normalize_std
        self.ignore_index = ignore_index
        self.raw_u8 = raw_u8
        self.image_dir = os.path.join(voc_root, "JPEGImages")
        self.mask_dir = os.path.join(voc_root, "SegmentationClass")
        split = os.path.join(voc_root, "ImageSets", "Segmentation",
                             f"{image_set}.txt")
        if not os.path.exists(split):
            raise FileNotFoundError(f"ImageSets split file not found: {split}")
        with open(split) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def read_u8(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """The resized (S, S) uint8 image and mask bytes of sample
        ``idx``."""
        from PIL import Image

        img_id, s = self.ids[idx], self.image_size
        img = Image.open(os.path.join(self.image_dir, f"{img_id}.jpg"))
        img = img.convert("L").resize((s, s), Image.BILINEAR)
        mask = Image.open(os.path.join(self.mask_dir, f"{img_id}.png"))
        mask = mask.convert("L").resize((s, s), Image.NEAREST)
        return np.asarray(img, np.uint8), np.asarray(mask, np.uint8)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(image (S, S, 1) float32 normalized, or uint8 with ``raw_u8``;
        mask (S, S) int32)."""
        u8, m = self.read_u8(idx)
        if self.raw_u8:
            x = u8
        else:
            x = (np.asarray(u8, np.float32) / 255.0 - self.mean) / self.std
        if self.mask_contract == "legacy":
            m = (m == 255).astype(np.int32)
        else:
            m = m.astype(np.int32)
        return x[..., None], m


class BatchLoader:
    """Static-shape batches over an indexable dataset: dicts ``{"image":
    (B, S, S, 1), "mask": (B, S, S) int32, "n_valid": int}``. The last
    partial batch is zero-padded to B with ``ignore_index`` masks
    (``n_valid`` real samples, the weight of the reference's per-batch
    metric average) or dropped (``drop_last``). The shuffle order of an
    epoch is ``np.random.default_rng((seed, epoch))``'s; ``num_workers``
    threads decode a batch's samples."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        ignore_index: int = 255,
        drop_last: bool = False,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.ignore_index = ignore_index
        self.drop_last = drop_last
        self.num_workers = num_workers

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order of the next iteration; without it each
        iteration advances the epoch."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
            self._epoch += 1
        pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        if self.num_workers > 0:
            pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)
        try:
            for start in range(0, n, self.batch_size):
                idxs = order[start:start + self.batch_size]
                if len(idxs) < self.batch_size and self.drop_last:
                    break
                if pool is not None:
                    items = list(pool.map(self.dataset.__getitem__, idxs))
                else:
                    items = [self.dataset[i] for i in idxs]
                imgs = np.stack([it[0] for it in items])
                masks = np.stack([it[1] for it in items])
                n_valid = len(items)
                pad = self.batch_size - n_valid
                if pad:
                    imgs = np.concatenate(
                        [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
                    masks = np.concatenate(
                        [masks, np.full((pad,) + masks.shape[1:],
                                        self.ignore_index, masks.dtype)])
                yield {"image": imgs, "mask": masks, "n_valid": n_valid}
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
