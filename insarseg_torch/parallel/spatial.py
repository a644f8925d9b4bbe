"""The ``spatial`` mesh axis: the image H axis sharded over S ranks, each
holding one slab of ``H / S`` rows (counterpart of the JAX package's
``spatial`` axis, ``insarseg/parallel/mesh.py:9-14``, where GSPMD inserts
the collectives that this module makes by hand).

The layers read the active context (:func:`current`, set by
:func:`active`); with none active every layer computes as it does on one
device. Under a context:

- a conv or pool with an H extent above 1 takes its H padding from
  :func:`halo` (``ops/layers.py::Conv2d``, ``max_pool_2d``): k rows from
  the slabs above and k from the slabs below (as many slabs as k rows
  reach), ``fill`` past the image's own edges (zeros for a conv, -inf for
  a max-pool); its backward sends each halo row's gradient back to the
  rank that holds the row, summed where several slabs read one row
  (GSPMD's collective-permute and its transpose);
- a mean over H and W sums over the group (:func:`spatial_sum`, whose
  backward is the same sum of the gradients: every slab's output depends
  on every slab's input), a max over H and W takes the group's max
  (:func:`spatial_max`, its gradient split over the positions equal to
  the max on every slab, as ``torch.amax`` and JAX's reduce-max split
  ties), and a map a pool made whole on every slab comes from
  :func:`spatial_gather`.

Such pooled maps are *replicated*: every slab of a data row holds the
same tensor, and each slab's part of the loss gives it a share of its
gradient; the shares meet where the map was made (the backward of
:func:`spatial_sum`, :func:`spatial_max` and :func:`spatial_gather` sums
them over the slabs), and a replicated parameter's shares in the
gradients' all-reduce over the ranks.

A context is a :class:`Comm` of one of two transports, behind one
interface (``exchange``, ``gather``, ``sum``, ``max``):

- :class:`GroupComm`, a spatial group of a ``torch.distributed`` process
  group (one process a rank, ``parallel/mesh.py::spatial_comm``) for the
  train and eval steps: an exchange or a gather is one all-reduce of a
  zeroed buffer with a slot a rank, which NCCL and gloo both run on CUDA
  tensors (gloo has no point-to-point ops for them, and on four H100s it
  cost the host less than ``batch_isend_irecv`` with the two neighbours:
  ``tools/spatial_ab.py``, PERF.md);
- :class:`ThreadComm`, one thread a slab in one process, for the forward
  over a spatial :class:`~insarseg_torch.parallel.mesh.Mesh`
  (``parallel/inference.py::make_predict_fn``): the threads of a data row
  meet at a barrier and copy each other's rows device to device.

The context is thread-local; the autograd functions keep the context of
their forward for their backward (which may run on autograd's device
thread), and a rematerialized block re-enters the context it was first
run under (``ops/blocks.py::DoubleConv``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

_LOCAL = threading.local()
# a slab's threads wait at most this long for each other: a thread that
# failed aborts the barrier at once, so this only ends a lost thread
THREAD_TIMEOUT = 600.0


class Comm:
    """The spatial group of one slab: ``size`` slabs, this one
    ``index`` (0 the top of the image)."""

    size: int
    index: int

    def exchange(self, up: torch.Tensor, down: torch.Tensor
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Send ``up`` to the slab above and ``down`` to the slab below
        (neither where the image ends); return what the slab above sent
        down and what the slab below sent up (``None`` at the image's
        edges). Every member calls it with tensors of one shape."""
        raise NotImplementedError

    def gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``t`` (one shape on all), top slab first, on
        this member's device."""
        raise NotImplementedError

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group: the same tensor on every member."""
        raise NotImplementedError

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s elementwise max over the group: the same tensor on every
        member."""
        raise NotImplementedError


def current() -> Optional[Comm]:
    """The active spatial context of this thread, or None."""
    return getattr(_LOCAL, "comm", None)


@contextlib.contextmanager
def active(comm: Optional[Comm]):
    """``comm`` as this thread's spatial context for the body of the
    ``with`` (``None``: none, every layer unsharded)."""
    prev = current()
    _LOCAL.comm = comm
    try:
        yield comm
    finally:
        _LOCAL.comm = prev


# ---------------------------------------------------------------------------
# the transports
# ---------------------------------------------------------------------------

class GroupComm(Comm):
    """Slab ``index`` of the ``size`` slabs of the process group
    ``group`` (its ranks top slab first)."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def exchange(self, up, down):
        # each rank's rows summed with zeros only: they arrive exact
        buf = up.new_zeros((self.size, 2) + tuple(up.shape))
        buf[self.index, 0], buf[self.index, 1] = up, down
        if buf.numel():
            dist.all_reduce(buf, group=self.group)
        s = self.index
        return (buf[s - 1, 1] if s > 0 else None,
                buf[s + 1, 0] if s + 1 < self.size else None)

    def gather(self, t):
        buf = t.new_zeros((self.size,) + tuple(t.shape))
        buf[self.index] = t
        if buf.numel():
            dist.all_reduce(buf, group=self.group)
        return list(buf.unbind(0))

    def sum(self, t):
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def max(self, t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t


class ThreadExchange:
    """What the ``size`` threads of one data row share: a barrier and one
    slot a thread."""

    def __init__(self, size: int):
        self.barrier = threading.Barrier(size, timeout=THREAD_TIMEOUT)
        self.slots: List = [None] * size


class ThreadComm(Comm):
    """Slab ``index`` of a :class:`ThreadExchange`, on ``device``. Each
    call posts this slab's tensors, waits for every slab's, reads its
    neighbours' (copied to ``device``), and waits again so that no slot
    is overwritten before it is read. Sums run over the slabs in order on
    every thread, so every slab gets the same bits."""

    def __init__(self, shared: ThreadExchange, index: int,
                 device: torch.device):
        self.shared, self.index, self.device = shared, index, device
        self.size = len(shared.slots)

    def _all(self, posted) -> list:
        slots = self.shared.slots
        slots[self.index] = posted
        self.shared.barrier.wait()
        got = list(slots)
        self.shared.barrier.wait()
        return got

    def exchange(self, up, down):
        got = self._all((up, down))
        s = self.index
        above = got[s - 1][1].to(self.device) if s > 0 else None
        below = got[s + 1][0].to(self.device) if s + 1 < self.size else None
        return above, below

    def gather(self, t):
        return [p.to(self.device) for p in self._all(t)]

    def sum(self, t):
        parts = self._all(t)
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = out + p.to(self.device)
        return out

    def max(self, t):
        parts = self._all(t)
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(self.device))
        return out


# ---------------------------------------------------------------------------
# the differentiable operations the layers call
# ---------------------------------------------------------------------------

def _like_format(x: torch.Tensor) -> torch.memory_format:
    """``x``'s memory format: channels-last where it is that and not also
    NCHW-contiguous, else contiguous."""
    if not x.is_contiguous() and \
            x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class _Halo(torch.autograd.Function):
    """The one-hop halo: ``k`` rows (at most the slab's height) from each
    neighbour."""

    @staticmethod
    def forward(ctx, x, k: int, comm: Comm, fill: float):
        ctx.k, ctx.comm = k, comm
        n, c, h, w = x.shape
        above, below = comm.exchange(x[:, :, :k], x[:, :, h - k:])
        out = torch.empty((n, c, h + 2 * k, w), dtype=x.dtype,
                          device=x.device, memory_format=_like_format(x))
        out[:, :, k:k + h] = x
        for rows, got in ((slice(0, k), above), (slice(k + h, None), below)):
            if got is None:
                out[:, :, rows] = fill
            else:
                out[:, :, rows] = got
        return out

    @staticmethod
    def backward(ctx, g):
        k, comm = ctx.k, ctx.comm
        h = g.shape[2] - 2 * k
        # the top halo's gradient belongs to the last rows of the slab
        # above, the bottom halo's to the first rows of the slab below
        from_above, from_below = comm.exchange(g[:, :, :k], g[:, :, k + h:])
        gx = g[:, :, k:k + h].clone(memory_format=_like_format(g))
        if from_above is not None:
            gx[:, :, :k] += from_above
        if from_below is not None:
            gx[:, :, h - k:] += from_below
        return gx, None, None, None


def halo(x: torch.Tensor, k: int, comm: Comm,
         fill: float = 0.0) -> torch.Tensor:
    """NCHW ``x`` (slab ``comm.index``) with ``k`` rows added above and
    below: the rows of the slabs around it, ``fill`` past the image's
    edges; ``x``'s memory format. Up to the slab's height the rows come
    from the two neighbours alone; a larger ``k`` reaches further, and
    the slab takes its rows from the whole H axis gathered
    (:func:`spatial_gather`), whose backward sums every slab's gradient
    of each row at its owner."""
    if k == 0:
        return x
    h = x.shape[2]
    if k <= h:
        return _Halo.apply(x, k, comm, fill)
    full = F.pad(spatial_gather(x, comm), (0, 0, k, k), value=fill)
    start = comm.index * h
    return full[:, :, start:start + h + 2 * k].contiguous(
        memory_format=_like_format(x))


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return torch.cat(comm.gather(x), dim=2)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        h = g.shape[2] // comm.size
        # every slab's share of each row's gradient, summed at its owner
        total = comm.sum(g.contiguous())
        return total[:, :, comm.index * h:(comm.index + 1) * h].clone(
            memory_format=_like_format(g)), None


def spatial_gather(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The whole H axis of NCHW slab ``x``: the slabs joined top to bottom,
    the same tensor on every slab (replicated); its backward sums the
    slabs' gradients and gives each slab its rows."""
    return _Gather.apply(x, comm)


class _Sum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, comm: Comm):
        ctx.comm = comm
        return comm.sum(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.sum(g.contiguous()), None


def spatial_sum(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``t`` summed over the slabs of ``comm``; its gradient is the slabs'
    sum of the gradients."""
    return _Sum.apply(t, comm)


class _Max(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, comm: Comm):
        m = comm.max(x.amax(dim=(2, 3), keepdim=True))
        ctx.comm = comm
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        x, m = ctx.saved_tensors
        # the replicated max's gradient is every slab's share; it goes to
        # the positions equal to the max on every slab, split by their
        # global count (torch.amax's and JAX's rule for ties)
        g = comm.sum(g.contiguous())
        hit = x == m
        count = comm.sum(hit.sum(dim=(2, 3), keepdim=True))
        return (g / count) * hit, None


def spatial_max(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The max over H and W of NCHW slab ``x`` and every other slab of
    ``comm``: (N, C, 1, 1) on every slab; a tie's gradient is split over
    every slab's positions equal to the max."""
    return _Max.apply(x, comm)
