"""Bilinear resize with the reference's semantics (counterpart of
``insarseg/ops/resize.py::resize_bilinear``): half-pixel centres
(``align_corners=False``), no antialias."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize an NCHW tensor to spatial ``size`` (under a spatial context,
    ``parallel/spatial.py``, along W alone: the slab keeps its rows)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if x.shape[-2] != size[0]:
        from insarseg_torch.parallel.spatial import current

        if current() is not None:
            raise NotImplementedError(
                "a resize along H reaches across the H slabs of a spatial "
                "mesh; insarseg_torch shards H for the U-Net families only "
                "(ROADMAP Queue 1 item 21b)")
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)
