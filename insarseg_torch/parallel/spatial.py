"""The ``spatial`` mesh axis: the image H axis sharded over S ranks
(counterpart of the JAX package's ``spatial`` axis,
``insarseg/parallel/mesh.py:9-14``, where GSPMD inserts the collectives
that this module makes by hand).

**Row ranges.** A map keeps its real rows alone, each slab a contiguous
range of them (:class:`Rows`): slab ``s`` holds global rows
``[bounds[s], bounds[s + 1])``. The image (level 0) is cut into equal
slabs (``parallel/mesh.py::slab_of``: S divides H). A window op of
stride ``st`` (a conv, a max-pool) gives output row ``j`` to the slab
that holds input row ``st j``, so its output's bounds are ``ceil(b /
st)``, clipped to its global height (a floor-mode pool of an odd map
drops its last row); the rows its windows read past a slab come from a
halo (:func:`halo`) that may differ above and below and may reach past
slabs of any height, empty ones too. So any H that S divides runs, with
no pad row anywhere: the BatchNorm sums and counts, the SE and CBAM
pools and the loss see the image's rows alone. A slab may hold no row
of a small map (U-Net at 80 rows over 8 slabs has 5 bottleneck rows);
it still takes part in every collective, in the same order as the other
slabs.

Every slab derives every map's bounds from the image's (H, S) and the
strides, with no collective: the context keeps the maps placed so far,
keyed by their width (:func:`rows_of`; a map's width is W at its level,
which every stride of the families divides along H and W alike). A map
no op has placed is a level-0 slab (``slab_of``'s equal split); the
steps forget the last image's maps where they cut the slab
(:meth:`Comm.new_image`).

The layers read the active context (:func:`current`, set by
:func:`active`); with none active every layer computes as it does on one
device. Under a context:

- a conv or pool with an H extent above 1 or a stride takes its H
  padding and the rows its windows read from :func:`halo`
  (``ops/layers.py::Conv2d``, ``max_pool_2d``), ``fill`` past the
  image's own edges (zeros for a conv, -inf for a max-pool); its
  backward sends each halo row's gradient back to the slab that holds
  the row, summed where several slabs read one row (GSPMD's
  collective-permute and its transpose);
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
interface (``gather``, ``sum``, ``max``):

- :class:`GroupComm`, a spatial group of a ``torch.distributed`` process
  group (one process a rank, ``parallel/mesh.py::spatial_comm``) for the
  train and eval steps: a gather is one all-reduce of a zeroed buffer
  with a slot a rank, each slot as high as the largest post, which NCCL
  and gloo both run on CUDA tensors (gloo has no point-to-point ops for
  them, and on four H100s it cost the host less than
  ``batch_isend_irecv`` with the two neighbours: ``tools/spatial_ab.py``,
  PERF.md);
- :class:`ThreadComm`, one thread a slab in one process, for the forward
  over a spatial :class:`~insarseg_torch.parallel.mesh.Mesh`
  (``parallel/inference.py::make_predict_fn``): the threads of a data row
  meet at a barrier and copy each other's rows device to device.

The context is thread-local; the autograd functions keep the context and
the rows of their forward for their backward (which may run on
autograd's device thread), and a rematerialized block re-enters the
context it was first run under (``ops/blocks.py::DoubleConv``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

_LOCAL = threading.local()
# a slab's threads wait at most this long for each other: a thread that
# failed aborts the barrier at once, so this only ends a lost thread
THREAD_TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class Rows:
    """A map's rows over the slabs: slab ``s`` holds global rows
    ``[bounds[s], bounds[s + 1])`` of ``bounds[-1]`` (any of them may be
    empty)."""

    bounds: Tuple[int, ...]

    @staticmethod
    def equal(height: int, size: int) -> "Rows":
        """``slab_of``'s split: ``size`` slabs of ``height / size`` rows."""
        q = height // size
        return Rows(tuple(s * q for s in range(size + 1)))

    @property
    def height(self) -> int:
        return self.bounds[-1]

    @property
    def size(self) -> int:
        return len(self.bounds) - 1

    def of(self, s: int) -> Tuple[int, int]:
        """Slab ``s``'s rows, ``(first, end)``."""
        return self.bounds[s], self.bounds[s + 1]

    def window(self, extent: int, stride: int, pad: int) -> "Rows":
        """The output of a floor-mode window of ``extent`` rows, ``stride``
        and padding ``pad`` on both sides: output row j to the slab holding
        input row ``stride j``."""
        out = (self.height + 2 * pad - extent) // stride + 1
        return Rows(tuple(min(-(-b // stride), out) for b in self.bounds))

    def scaled(self, f: int) -> "Rows":
        """Each row made ``f`` rows (a 2x2 / 2 transposed conv at 2, a
        depth-to-space by f)."""
        return Rows(tuple(f * b for b in self.bounds))

    def rounded(self, f: int) -> "Rows":
        """The bounds moved down to a multiple of ``f`` (``f`` divides the
        height): the re-slab before a space-to-depth by f."""
        return Rows(tuple(f * -(-b // f) for b in self.bounds))

    def divided(self, f: int) -> "Rows":
        """The rows of a space-to-depth by ``f`` of these (every bound a
        multiple of f)."""
        return Rows(tuple(b // f for b in self.bounds))


class Comm:
    """The spatial group of one slab: ``size`` slabs, this one
    ``index`` (0 the top of the image), and the maps placed on it
    (:func:`rows_of`)."""

    size: int
    index: int
    maps: Dict[int, Rows]

    def new_image(self) -> None:
        """Forget the maps of the last image (call it where the next image's
        slab is cut): its first map of a width not placed is a level-0
        slab."""
        self.maps = {}

    def gather(self, t: torch.Tensor,
               heights: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """Every member's NCHW ``t``, top slab first, on this member's
        device: member ``s`` posts ``heights[s]`` rows (default: this
        member's, on every member), the other dims as this one's."""
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


def rows_of(x: torch.Tensor, comm: Comm) -> Rows:
    """The rows of map ``x`` (a slab under ``comm``), by its width: the
    map an op placed there (:func:`place`), else a level-0 slab
    (``slab_of``'s split of ``size`` slabs of ``x``'s height)."""
    return rows_at(comm, x.shape[3], x.shape[2])


def rows_at(comm: Comm, width: int, height: int) -> Rows:
    """The rows of the map of ``width`` columns whose slab here holds
    ``height`` rows (a level-0 slab where no map of that width is
    placed)."""
    rows = comm.maps.get(width)
    if rows is None:
        return place(comm, width, Rows.equal(height * comm.size, comm.size))
    a, b = rows.of(comm.index)
    if b - a != height:
        raise ValueError(
            f"a map of width {width} whose slab {comm.index} holds {height} "
            f"rows, where the map of that width placed here holds {b - a}: "
            "a spatial mesh keys its maps by their width (a new image "
            "needs Comm.new_image)")
    return rows


def place(comm: Comm, width: int, rows: Rows) -> Rows:
    """Record ``rows`` as the map of ``width`` columns (an op's output);
    two maps of one width must agree."""
    known = comm.maps.setdefault(width, rows)
    if known != rows:
        raise ValueError(
            f"two maps of width {width} with other rows ({known.bounds} and "
            f"{rows.bounds}): a spatial mesh keys its maps by their width")
    return rows


# ---------------------------------------------------------------------------
# the transports
# ---------------------------------------------------------------------------

class GroupComm(Comm):
    """Slab ``index`` of the ``size`` slabs of the process group
    ``group`` (its ranks top slab first)."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self.maps = {}

    def gather(self, t, heights=None):
        # each rank's rows summed with zeros only: they arrive exact
        heights = heights or [t.shape[2]] * self.size
        n, c, _, w = t.shape
        buf = t.new_zeros((self.size, n, c, max(heights), w))
        buf[self.index, :, :, :t.shape[2]] = t
        if buf.numel():
            dist.all_reduce(buf, group=self.group)
        return [buf[s, :, :, :h] for s, h in enumerate(heights)]

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
    call posts this slab's tensors, waits for every slab's, reads the
    others' (copied to ``device``), and waits again so that no slot is
    overwritten before it is read. Sums run over the slabs in order on
    every thread, so every slab gets the same bits."""

    def __init__(self, shared: ThreadExchange, index: int,
                 device: torch.device):
        self.shared, self.index, self.device = shared, index, device
        self.size = len(shared.slots)
        self.maps = {}

    def _all(self, posted) -> list:
        slots = self.shared.slots
        slots[self.index] = posted
        self.shared.barrier.wait()
        got = list(slots)
        self.shared.barrier.wait()
        return got

    def gather(self, t, heights=None):
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


Need = Union[int, Sequence[Tuple[int, int]]]


@functools.lru_cache(maxsize=4096)
def _plan(rows: Rows, need: Tuple[Tuple[int, int], ...]) -> "_Plan":
    return _Plan(rows, need)


class _Plan:
    """Who sends which rows in a halo of ``need`` (each slab's (above,
    below) rows) over ``rows``: slab t's wanted global rows ``[lo[t],
    a[t])`` above and ``[b[t], hi[t])`` below (inside the image), and the
    first ``pre[t]`` and last ``suf[t]`` of its own rows that the slabs
    below and above read."""

    def __init__(self, rows: Rows, need: Sequence[Tuple[int, int]]):
        n, h = rows.size, rows.height
        self.a = [rows.bounds[t] for t in range(n)]
        self.b = [rows.bounds[t + 1] for t in range(n)]
        self.lo = [max(self.a[t] - need[t][0], 0) for t in range(n)]
        self.hi = [min(self.b[t] + need[t][1], h) for t in range(n)]
        self.pre = [min(max(max(self.hi[:t], default=0) - self.a[t], 0),
                        self.b[t] - self.a[t]) for t in range(n)]
        self.suf = [min(max(self.b[t] - min(self.lo[t + 1:], default=h), 0),
                        self.b[t] - self.a[t]) for t in range(n)]

    def idle(self) -> bool:
        """Whether no slab reads another's rows."""
        return not any(self.pre) and not any(self.suf)


def _pieces(parts, plan: _Plan, s: int, lo: int, hi: int, suffix: bool):
    """The global rows ``[lo, hi)`` out of the other slabs' posts
    (``parts``: each slab's first ``pre`` then last ``suf`` rows), top
    first: from the suffixes of the slabs above, or the prefixes of the
    slabs below."""
    out = []
    for t in (range(s) if suffix else range(s + 1, len(parts))):
        r0, r1 = max(lo, plan.a[t]), min(hi, plan.b[t])
        if r0 >= r1:
            continue
        base = plan.pre[t] - (plan.b[t] - plan.suf[t]) if suffix \
            else -plan.a[t]
        out.append(parts[t][:, :, base + r0:base + r1])
    return out


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, need, rows: Rows, comm: Comm, fill: float):
        s = comm.index
        plan = _plan(rows, need)
        ctx.plan, ctx.need, ctx.comm = plan, need, comm
        up, down = need[s]
        n, c, h, w = x.shape
        out = torch.empty((n, c, up + h + down, w), dtype=x.dtype,
                          device=x.device, memory_format=_like_format(x))
        out[:, :, :up], out[:, :, up + h:] = fill, fill
        out[:, :, up:up + h] = x
        if plan.idle():
            return out
        posted = torch.cat([x[:, :, :plan.pre[s]],
                            x[:, :, h - plan.suf[s]:]], dim=2)
        parts = comm.gather(posted, [p + q for p, q in zip(plan.pre,
                                                            plan.suf)])
        a, b = plan.a[s], plan.b[s]
        at = up - (a - plan.lo[s])
        for piece in _pieces(parts, plan, s, plan.lo[s], a, True):
            out[:, :, at:at + piece.shape[2]] = piece
            at += piece.shape[2]
        at = up + h
        for piece in _pieces(parts, plan, s, b, plan.hi[s], False):
            out[:, :, at:at + piece.shape[2]] = piece
            at += piece.shape[2]
        return out

    @staticmethod
    def backward(ctx, g):
        plan, comm, s = ctx.plan, ctx.comm, ctx.comm.index
        up = ctx.need[s][0]
        a, b = plan.a[s], plan.b[s]
        h = b - a
        gx = g[:, :, up:up + h].clone(memory_format=_like_format(g))
        if plan.idle():
            return gx, None, None, None, None
        # each slab's gradient of the rows it read above and below, summed
        # at the slab that holds them
        over = [(plan.a[t] - plan.lo[t], plan.hi[t] - plan.b[t])
                for t in range(comm.size)]
        top, bottom = over[s]
        posted = torch.cat([g[:, :, up - top:up],
                            g[:, :, up + h:up + h + bottom]], dim=2)
        parts = comm.gather(posted, [p + q for p, q in over])
        for t, part in enumerate(parts):
            if t == s:
                continue
            # t's post: the rows [lo, a) above it, then [b, hi) below it
            for r0, r1, at in ((plan.lo[t], plan.a[t], 0),
                               (plan.b[t], plan.hi[t], over[t][0])):
                lo, hi = max(r0, a), min(r1, b)
                if lo < hi:
                    gx[:, :, lo - a:hi - a] += \
                        part[:, :, at + lo - r0:at + hi - r0]
        return gx, None, None, None, None


def halo(x: torch.Tensor, k: Need, comm: Comm, fill: float = 0.0,
         rows: Optional[Rows] = None) -> torch.Tensor:
    """NCHW ``x`` (slab ``comm.index`` of ``rows``, default
    :func:`rows_of`) with rows added above and below: ``k`` rows on each
    side of every slab, or ``k[t]`` = (above, below) for slab t (every
    slab passes the same list). The rows come from the slabs around it,
    as many as they reach, empty ones passed over; ``fill`` past the
    image's edges; ``x``'s memory format. One gather of each slab's edge
    rows (none when no slab reads another's); its backward sums every
    slab's gradient of each row at the slab that holds it."""
    rows = rows_of(x, comm) if rows is None else rows
    need = ((k, k),) * comm.size if isinstance(k, int) else \
        tuple(tuple(p) for p in k)
    if not any(u or d for u, d in need):
        return x
    return _Halo.apply(x, need, rows, comm, fill)


@functools.lru_cache(maxsize=4096)
def _window_need(rows: Rows, out: Rows, extent: int, stride: int,
                 pad: int) -> Tuple[Tuple[Tuple[int, int], ...],
                                    Tuple[int, ...]]:
    """Each slab's (above, below) halo of a window op of ``extent`` rows,
    ``stride`` and padding ``pad`` from ``rows`` to ``out``
    (:meth:`Rows.window`), and the first row of the haloed slab that its
    windows read."""
    need, start = [], []
    for t in range(rows.size):
        (a, b), (j0, j1) = rows.of(t), out.of(t)
        if j0 == j1:
            need.append((0, 0))
            start.append(0)
            continue
        first = stride * j0 - pad
        last = stride * (j1 - 1) - pad + extent - 1
        up = max(a - first, 0)
        need.append((up, max(last - (b - 1), 0)))
        start.append(first - (a - up))
    return tuple(need), tuple(start)


def empty_out(op, x: torch.Tensor, extent: int, fill: float) -> torch.Tensor:
    """``op``'s output of no row, still joined to ``x`` and ``op``'s
    parameters in the graph (their gradients zeros): ``op`` of ``extent``
    ``fill`` rows, cut to none."""
    return op(F.pad(x[:, :, :0], (0, 0, 0, extent), value=fill))[:, :, :0]


def windowed(op, x: torch.Tensor, extent: int, stride: int, pad: int,
             comm: Comm, fill: float = 0.0) -> torch.Tensor:
    """A window op along H over slab ``x``: ``op(t)`` computes the
    unpadded op along H (stride ``stride``, the W padding its own) over
    ``t``; the window is ``extent`` rows with ``pad`` rows of padding on
    each side (``fill``). Returns the slab's rows of the unsharded op's
    output (:meth:`Rows.window`) and places them."""
    rows = rows_of(x, comm)
    out = rows.window(extent, stride, pad)
    need, start = _window_need(rows, out, extent, stride, pad)
    s = comm.index
    j0, j1 = out.of(s)
    xp = halo(x, need, comm, fill, rows)
    if j0 == j1:
        y = empty_out(op, xp, extent, fill)
    else:
        used = stride * (j1 - j0 - 1) + extent
        y = op(xp[:, :, start[s]:start[s] + used])
    place(comm, y.shape[3], out)
    return y


def reslab(x: torch.Tensor, src: Rows, dst: Rows, comm: Comm) -> torch.Tensor:
    """Slab ``x`` of ``src`` as its slab of ``dst`` (one global map,
    other bounds): the rows it lacks from the slabs around it, the rows it
    gives up cut away."""
    if src == dst:
        return x
    need, cut = [], []
    for t in range(src.size):
        (a, b), (c, d) = src.of(t), dst.of(t)
        if c == d:
            need.append((0, 0))
            cut.append((0, 0))
            continue
        need.append((max(a - c, 0), max(d - b, 0)))
        cut.append((max(c - a, 0), d - c))
    xp = halo(x, need, comm, rows=src)
    top, n = cut[comm.index]
    return xp[:, :, top:top + n]


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, rows: Rows, comm: Comm):
        ctx.rows, ctx.comm = rows, comm
        heights = [b - a for a, b in map(rows.of, range(rows.size))]
        return torch.cat(comm.gather(x, heights), dim=2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows.of(ctx.comm.index)
        # every slab's share of each row's gradient, summed at its owner
        total = ctx.comm.sum(g.contiguous())
        return total[:, :, a:b].clone(memory_format=_like_format(g)), \
            None, None


def spatial_gather(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The whole H axis of NCHW slab ``x``: the slabs joined top to bottom,
    the same tensor on every slab (replicated); its backward sums the
    slabs' gradients and gives each slab its rows."""
    return _Gather.apply(x, rows_of(x, comm), comm)


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
        # an empty slab gives the max's identity
        own = x.amax(dim=(2, 3), keepdim=True) if x.shape[2] else \
            x.new_full(x.shape[:2] + (1, 1), -math.inf)
        m = comm.max(own)
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
