"""Bilinear resize with the reference's semantics (counterpart of
``insarseg/ops/resize.py::resize_bilinear``): half-pixel centres
(``align_corners=False``), no antialias; and the JAX package's
nearest-neighbour resize (:func:`resize_nearest`).

Where a gradient is taken the bilinear resize's backward pass sums in a
fixed order, on every device: ``F.interpolate``'s CUDA backward and
``index_select``'s (the sharded rows' lerp) add into the input's gradient
with atomics, so two runs of one train step would differ in the last
bits. The forward runs as it is and the gradient is the transposed
interpolation, products with the resize's weight matrices in acc, rounded
once (:class:`_Interpolate`, :class:`_LerpRows`). Without a gradient
(eval, serving) the plain ops run."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _source_rows(n_in: int, n_out: int, start: int, count: int,
                 device, dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """Output rows ``start .. start + count`` of a bilinear resize of
    ``n_in`` rows to ``n_out``, by torch's rule (half-pixel centres, the
    source clamped at 0 and at the last row, in f32, or in ``dtype``):
    each row's two source rows and their weights, made on ``device``."""
    dst = torch.arange(start, start + count, device=device, dtype=dtype)
    src = ((dst + 0.5) * (n_in / n_out) - 0.5).clamp_min(0)
    i0 = src.floor().clamp_max(n_in - 1)
    l1 = (src - i0).clamp(0, 1)
    i0 = i0.long()
    i1 = i0 + (i0 < n_in - 1).long()
    return i0, i1, 1 - l1, l1


def _weights(i0, i1, l0, l1, n_in: int, dtype) -> torch.Tensor:
    """The (count, n_in) interpolation matrix of rows ``i0`` / ``i1``
    weighted ``l0`` / ``l1`` (two terms a row, one column where they
    meet), made on their device in ``dtype``; all zeros, and no
    ``one_hot``, where there is no input row (an empty slab) or no output
    row."""
    if not (n_in and i0.numel()):
        return torch.zeros(i0.shape[0], n_in, dtype=dtype, device=i0.device)
    return (F.one_hot(i0, n_in).to(dtype) * l0.to(dtype)[:, None]
            + F.one_hot(i1, n_in).to(dtype) * l1.to(dtype)[:, None])


def _like_input(dx: torch.Tensor, x_channels_last: bool) -> torch.Tensor:
    return dx.contiguous(memory_format=torch.channels_last) \
        if x_channels_last else dx


def _channels_last(x: torch.Tensor) -> bool:
    return not x.is_contiguous() and \
        x.is_contiguous(memory_format=torch.channels_last)


def _lerp(x: torch.Tensor, i0, i1, l0, l1) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.index_select(2, i0).to(acc) * l0[:, None] \
        + x.index_select(2, i1).to(acc) * l1[:, None]
    return y.to(x.dtype)


class _LerpRows(torch.autograd.Function):
    """:func:`_lerp` with the input's gradient ``A^T dy`` (A the rows'
    interpolation matrix) in acc."""

    @staticmethod
    def forward(ctx, x, i0, i1, l0, l1):
        ctx.save_for_backward(i0, i1, l0, l1)
        ctx.n, ctx.cl = x.shape[2], _channels_last(x)
        return _lerp(x, i0, i1, l0, l1)

    @staticmethod
    def backward(ctx, g):
        acc = torch.promote_types(g.dtype, torch.float32)
        a = _weights(*ctx.saved_tensors, ctx.n, acc)
        dx = torch.matmul(a.t(), g.to(acc)).to(g.dtype)
        return _like_input(dx, ctx.cl), None, None, None, None


def _grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def _lerp_rows(x: torch.Tensor, i0, i1, l0, l1) -> torch.Tensor:
    if _grad(x):
        return _LerpRows.apply(x, i0, i1, l0, l1)
    return _lerp(x, i0, i1, l0, l1)


def _axis_weights(n_in: int, n_out: int, device, dtype) -> torch.Tensor:
    """The (n_out, n_in) matrix of a bilinear resize of ``n_in`` rows (or
    columns) to ``n_out`` (``_source_rows``' rule in ``dtype``, as
    ``F.interpolate`` weighs an f64 input in f64)."""
    return _weights(*_source_rows(n_in, n_out, 0, n_out, device, dtype),
                    n_in, dtype)


class _Interpolate(torch.autograd.Function):
    """``F.interpolate(x, size, 'bilinear')`` (align_corners False, no
    antialias) with the input's gradient ``A_h^T g A_w`` in acc."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.shape, ctx.cl = x.shape[2:], _channels_last(x)
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False, antialias=False)

    @staticmethod
    def backward(ctx, g):
        (hi, wi), (ho, wo) = ctx.shape, g.shape[2:]
        acc = torch.promote_types(g.dtype, torch.float32)
        dx = g.to(acc)
        if ho != hi:
            dx = torch.matmul(_axis_weights(hi, ho, g.device, acc).t(), dx)
        if wo != wi:
            dx = torch.matmul(dx, _axis_weights(wi, wo, g.device, acc))
        return _like_input(dx.to(g.dtype), ctx.cl), None


def _interpolate(x: torch.Tensor, size) -> torch.Tensor:
    if _grad(x):
        return _Interpolate.apply(x, tuple(size))
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    replicated: bool = False) -> torch.Tensor:
    """Resize an NCHW tensor to spatial ``size``.

    Under a spatial context (``parallel/spatial.py``) ``size`` is the
    output slab's own: the rows of the global map of width ``size[1]``
    (``spatial.rows_at``), and the caller says what ``x`` is (shapes
    alone cannot tell a 6 x 6 bin map from a 6-row slab):

    - a slab (``replicated=False``) of its own map (``spatial.rows_of``):
      :func:`resize_rows`;
    - a whole map on every slab (``replicated=True``, the PSPNet's bins):
      the slab's rows of the global output, read from the map itself.
    """
    from insarseg_torch.parallel.spatial import current, rows_at, rows_of

    comm = current()
    if comm is None:
        if tuple(x.shape[-2:]) == tuple(size):
            return x
        return _interpolate(x, size)
    src = None if replicated else rows_of(x, comm)
    return resize_rows(x, src, rows_at(comm, size[1], size[0]), size[1],
                       comm)


def resize_rows(x: torch.Tensor, src, dst, width: int, comm) -> torch.Tensor:
    """The bilinear resize, in global coordinates, of slab ``x`` of the
    rows ``src`` (a ``spatial.Rows``; None: ``x`` is the whole map on
    every slab) to this slab's rows of ``dst``, ``width`` columns wide:
    each output row samples the global input rows by the unsharded
    resize's rule, the rows past the slab from a halo of the slabs around
    it (``spatial.halo``; the clamp at the image's edges reads the edge
    row itself). With the same rows, a resize along W alone."""
    from insarseg_torch.parallel.spatial import halo

    if src is not None and src == dst:
        y = x
    else:
        s = comm.index
        n_in = x.shape[2] if src is None else src.height
        a, b = dst.of(s)
        i0, i1, l0, l1 = _source_rows(n_in, dst.height, a, b - a, x.device)
        if src is not None:
            need = []
            for t in range(dst.size):
                # the rows slab t's outputs read, on the host's clock (no
                # sync)
                c, d = dst.of(t)
                if c == d:
                    need.append((0, 0))
                    continue
                c0, c1, _, _ = _source_rows(n_in, dst.height, c, d - c, "cpu")
                top, end = src.of(t)
                need.append((max(top - int(c0[0]), 0),
                             max(int(c1[-1]) - (end - 1), 0)))
            x = halo(x, need, comm, rows=src)
            first = src.of(s)[0] - need[s][0]
            i0, i1 = i0 - first, i1 - first
        y = _lerp_rows(x, i0, i1, l0, l1)
    if y.shape[3] == width:
        return y
    if not y.shape[2]:
        # no row to resize (interpolate takes none): none, still in the
        # graph
        return y[:, :, :, :1].expand(-1, -1, 0, width)
    return _interpolate(y, (y.shape[2], width))


def _nearest(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` resized to ``n`` along ``dim`` by ``jax.image.resize``'s
    nearest rule: output i takes input ``floor((i + 0.5) * m / n)``, in
    f32 in that order."""
    m = x.shape[dim]
    if m == n:
        return x
    src = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
           * m / n).floor().long()
    return x.index_select(dim, src)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC / HW) ``x`` to spatial
    ``size`` (counterpart of ``insarseg/ops/resize.py::resize_nearest``):
    the half-pixel-centre rule of ``jax.image.resize`` (PIL's NEAREST),
    any dtype (a mask's too). ``F.interpolate(mode='nearest')`` uses the
    floor rule and can pick another source pixel."""
    if not 2 <= x.dim() <= 4:
        raise ValueError(f"expected 2-4D input, got shape {tuple(x.shape)}")
    hd = 0 if x.dim() == 2 else x.dim() - 3
    return _nearest(_nearest(x, hd, size[0]), hd + 1, size[1])
