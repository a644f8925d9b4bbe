"""The ``spatial`` mesh axis: the image H axis sharded over S ranks, each
holding one slab of ``H / S`` rows (counterpart of the JAX package's
``spatial`` axis, ``insarseg/parallel/mesh.py:9-14``, where GSPMD inserts
the collectives that this module makes by hand).

The layers read the active context (:func:`current`, set by
:func:`active`); with none active every layer computes as it does on one
device. Under a context:

- a conv with an H extent above 1 takes its H padding from :func:`halo`
  (``ops/layers.py::Conv2d``): k rows from the slab above and k from the
  slab below, zeros at the image's own edges, as the conv's zero padding;
  its backward sends each halo row's gradient back to the rank that holds
  the row (GSPMD's collective-permute and its transpose);
- a mean over H and W sums over the group (:func:`spatial_sum`, whose
  backward is the same sum of the gradients: every slab's output depends
  on every slab's input).

A context is a :class:`Comm` of one of two transports, behind one
interface (``exchange``, ``sum``):

- :class:`GroupComm`, a spatial group of a ``torch.distributed`` process
  group (one process a rank, ``parallel/mesh.py::spatial_comm``) for the
  train and eval steps: an exchange is one all-reduce of a zeroed buffer
  with a slot a rank, which NCCL and gloo both run on CUDA tensors (gloo
  has no point-to-point ops for them, and on four H100s it cost the host
  less than ``batch_isend_irecv`` with the two neighbours:
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

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group: the same tensor on every member."""
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

    def sum(self, t):
        t = t.clone()
        dist.all_reduce(t, group=self.group)
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

    def sum(self, t):
        parts = self._all(t)
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = out + p.to(self.device)
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

    @staticmethod
    def forward(ctx, x, k: int, comm: Comm):
        ctx.k, ctx.comm = k, comm
        n, c, h, w = x.shape
        above, below = comm.exchange(x[:, :, :k], x[:, :, h - k:])
        out = torch.empty((n, c, h + 2 * k, w), dtype=x.dtype,
                          device=x.device, memory_format=_like_format(x))
        out[:, :, k:k + h] = x
        for rows, got in ((slice(0, k), above), (slice(k + h, None), below)):
            if got is None:
                out[:, :, rows] = 0
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
        return gx, None, None


def halo(x: torch.Tensor, k: int, comm: Comm) -> torch.Tensor:
    """NCHW ``x`` (slab ``comm.index``) with ``k`` rows added above and
    below: the neighbouring slabs' edge rows, zeros at the image's edges;
    ``x``'s memory format."""
    if k == 0:
        return x
    if x.shape[2] < k:
        raise ValueError(f"a halo of {k} rows needs slabs of at least {k} "
                         f"rows; this one has {x.shape[2]}")
    return _Halo.apply(x, k, comm)


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
