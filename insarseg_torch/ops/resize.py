"""Bilinear resize with the reference's semantics (counterpart of
``insarseg/ops/resize.py::resize_bilinear``): half-pixel centres
(``align_corners=False``), no antialias."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _source_rows(n_in: int, n_out: int, start: int, count: int,
                 device) -> Tuple[torch.Tensor, ...]:
    """Output rows ``start .. start + count`` of a bilinear resize of
    ``n_in`` rows to ``n_out``, by torch's rule (half-pixel centres, the
    source clamped at 0 and at the last row, in f32): each row's two
    source rows and their weights, made on ``device``."""
    dst = torch.arange(start, start + count, device=device,
                       dtype=torch.float32)
    src = ((dst + 0.5) * (n_in / n_out) - 0.5).clamp_min(0)
    i0 = src.floor().clamp_max(n_in - 1)
    l1 = (src - i0).clamp(0, 1)
    i0 = i0.long()
    i1 = i0 + (i0 < n_in - 1).long()
    return i0, i1, 1 - l1, l1


def _lerp_rows(x: torch.Tensor, i0, i1, l0, l1) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.index_select(2, i0).to(acc) * l0[:, None] \
        + x.index_select(2, i1).to(acc) * l1[:, None]
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    replicated: bool = False) -> torch.Tensor:
    """Resize an NCHW tensor to spatial ``size``.

    Under a spatial context (``parallel/spatial.py``) ``size`` is the
    output slab's own, the rows of a global output ``spatial`` times as
    high, and the caller says what ``x`` is (shapes alone cannot tell a
    6 x 6 bin map from a 6-row slab):

    - a slab (``replicated=False``) of a global input ``spatial`` times
      its height: each output row samples the global input rows by the
      unsharded resize's rule, the rows past the slab from a halo of the
      slabs around it (``spatial.halo``; the clamp at the image's edges
      reads the edge row itself); with H unchanged, a resize along W;
    - a whole map on every slab (``replicated=True``, the PSPNet's bins):
      the slab's rows of the global output, read from the map itself.
    """
    from insarseg_torch.parallel.spatial import current, halo

    comm = current()
    if comm is None or (not replicated and x.shape[-2] == size[0]):
        if tuple(x.shape[-2:]) == tuple(size):
            return x
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=False)
    h, h_out = x.shape[2], size[0]
    n_in = h if replicated else h * comm.size
    i0, i1, l0, l1 = _source_rows(n_in, h_out * comm.size,
                                  comm.index * h_out, h_out, x.device)
    if not replicated:
        # the rows this slab's outputs read, on the host's clock (no sync)
        c0, c1, _, _ = _source_rows(n_in, h_out * comm.size,
                                    comm.index * h_out, h_out, "cpu")
        top = comm.index * h
        k = max(top - int(c0[0]), int(c1[-1]) - (top + h - 1), 0)
        x = halo(x, k, comm)
        i0, i1 = i0 - (top - k), i1 - (top - k)
    y = _lerp_rows(x, i0, i1, l0, l1)
    if y.shape[3] == size[1]:
        return y
    return F.interpolate(y, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)
