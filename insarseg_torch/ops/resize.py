"""Bilinear resize with the reference's semantics (counterpart of
``insarseg/ops/resize.py::resize_bilinear``): half-pixel centres
(``align_corners=False``), no antialias."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize an NCHW tensor to spatial ``size``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)
