"""K12a ``sa_pool``, K12b ``sa_apply``, K13a ``sa_grad_stats`` and K13b
``sa_grad_apply``: the spatial-attention gate of the JAX package's train
step, forward and backward, around a middle that maps the pooled (B, 2, H,
W) map to (B, 1, H, W) logits:

- U-Net-SA's ``SpatialAttentionDC`` (``insarseg/ops/blocks.py:152-156``):
  the middle a ``DoubleConv(2 -> 1)`` whose BatchNorms run on K8a-K9b;
- the -SA heads' ``SpatialAttentionConv`` (``:173-184``): the middle one
  bias-free 7x7 (or 3x3) conv.

``out = cdt(x * gate)``, ``gate = sigmoid(middle([mean_c(x), max_c(x)]))``.
Kernels: ``insarseg_torch/csrc/sa_train.cu``. With ``cdt`` the compute
dtype (``x``'s: bf16, f32 or f64) and ``acc`` = ``promote(cdt, f32)``:

- K12a: for each pixel the channel mean ``cdt(acc(sum / C))`` (the sum in
  f64) and max, as the NCHW map ``m`` (B, 2, H, W), and the number of
  channels equal to the max (B, H, W) int32;
- K12b: ``cdt(x * gate[b, h, w])``;
- K13a: for each pixel the sum over C of ``cdt(dout * x)`` in f64 (B, H,
  W): the gate's cotangent, the JAX VJP's product summed;
- K13b: ``dx = cdt(cdt(cdt(dout * gate) + cdt(dmax * hit)) + dmean)``:
  the rescale's cotangent, the max's (``dmax = cdt(acc(dm[:, 1]) /
  acc(cdt(count)))`` at each channel equal to the max: JAX's max VJP
  splits ties equally, its count in cdt) and the mean's (``dmean =
  cdt(acc(dm[:, 0]) / C)``), added in the order of the JAX VJP's jaxpr.

Between them, in torch ops on (B, H, W) maps (:func:`sa_tail`): the
middle, the sigmoid as the JAX program's ``logistic`` (``1 / (1 +
exp(-z))`` rounded at each op, as ``se_train._gate``) and its VJP ``dz =
dgate * (gate * (1 - gate))``. Two autograd functions make the site, so
that x's gradient is one K13b pass: the rescale's backward (K13a, then the
sigmoid's VJP) hands dout and the gate to the pool's, and returns none for
x; the pool's backward, which autograd runs last because it needs the
middle's input cotangent, adds all three terms. Under a spatial mesh x is
an H slab: the reductions run over C within a pixel, so no slab needs
another's, and the middle's convs take their own halo rows.

Each ``*_plain`` function is the kernel's formula in torch ops with the
same roundings; on the card a kernel and its plain version differ only
where their f64 sums, taken in other orders, differ. A wrapper given a
CPU (or meta) tensor runs its plain version; a CUDA tensor launches its
kernel or raises. A map with no pixel (a slab of 0 rows) launches nothing.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import torch

from insarseg_torch.kernels._lib import (
    ACC,
    DTYPES,
    check_cuda,
    check_operand,
    device_guard,
    is_plain,
    launch,
    layout_of,
    like,
    sizes,
    stream_of,
)

# the plans (csrc/sa_train.cu: THREADS, UNROLL): NCHW slices of the
# channels a pixel group, doubled until about TARGET_THREADS threads (8
# blocks of 256 on each of an H100's 132 SMs) or MAX_SLICES, each slice at
# least MIN_SLICE channels; channels-last lanes a pixel, doubled up to a
# warp while each lane keeps UNROLL channel vectors to load at once
THREADS = 256
UNROLL = 4
TARGET_THREADS = 132 * 8 * THREADS
MAX_SLICES = 64
MIN_SLICE = 8
MAX_LANES = 32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sa_pool_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = x.to(torch.float64).sum(dim=1, keepdim=True)
    # a tensor divisor: a true quotient (CUDA's division by a scalar
    # multiplies by its reciprocal)
    mean = (s / torch.full_like(s, x.shape[1])).to(x.dtype)
    mx = x.amax(dim=1, keepdim=True)
    count = (x == mx).sum(dim=1, dtype=torch.int32)
    return torch.cat([mean, mx], dim=1).contiguous(), count


def sa_apply_plain(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return x * gate[:, None]


def sa_grad_stats_plain(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (x * dy).to(torch.float64).sum(dim=1)


def sa_grad_apply_plain(dy: torch.Tensor, x: torch.Tensor,
                        gate: torch.Tensor, m: torch.Tensor,
                        count: torch.Tensor,
                        dm: torch.Tensor) -> torch.Tensor:
    acc, dt = ACC[x.dtype], x.dtype
    d0 = dm[:, 0].to(acc)
    dmean = (d0 / torch.full_like(d0, x.shape[1])).to(dt)
    dmax = (dm[:, 1].to(acc) / count.to(dt).to(acc)).to(dt)
    hit = (x == m[:, 1:2]).to(dt)
    return dy * gate[:, None] + dmax[:, None] * hit + dmean[:, None]


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """A launch over (B, C, H, W): ``layout`` (0 NCHW, 1 channels-last),
    ``vec`` (16-byte vectors), ``split`` the channel slices a pixel group
    (NCHW) or the lanes a pixel (channels-last)."""
    layout: int
    vec: int
    split: int


def _vec(x: torch.Tensor, layout: int, *others: torch.Tensor) -> int:
    """16-byte vectors where a plane (NCHW) or a pixel's row
    (channels-last) is a whole number of them and every pointer of the
    (B, C, H, W) operands is aligned to one."""
    n, c, h, w = x.shape
    v = 16 // x.element_size()
    if (h * w if layout == 0 else c) % v:
        return 0
    return int(all(t.data_ptr() % 16 == 0 for t in (x,) + others))


@functools.lru_cache(maxsize=None)
def partition(n: int, c: int, h: int, w: int, element_size: int,
              layout: int, vec: int) -> Plan:
    """The plan over an (n, c, h, w) map in ``layout`` with or without
    vectors: from these alone, never from the card, so one tensor gives
    the same sums at every call."""
    v = 16 // element_size if vec else 1
    if layout == 0:
        groups = n * h * w // v
        split = 1
        while (split < MAX_SLICES and groups * split < TARGET_THREADS
               and c >= 2 * split * MIN_SLICE):
            split *= 2
    else:
        split = 1
        while split < MAX_LANES and 2 * split * UNROLL <= c // v:
            split *= 2
    return Plan(layout, vec, split)


def plan(x: torch.Tensor, *others: torch.Tensor) -> Plan:
    """The plan of a launch over ``x`` (and ``others``, its (B, C, H, W)
    operands and outputs in x's layout)."""
    layout = layout_of(x)
    return partition(*x.shape, x.element_size(), layout,
                     _vec(x, layout, *others))


def _check(name: str, x: torch.Tensor, operands=(), maps=()) -> None:
    """The checks of a launch, one pass of cheap tests a tensor
    (``check_cuda`` only names a fault): x f32, bf16 or f64 (B, C, H, W)
    on the card (its layout: ``plan``); ``operands`` (label, tensor) of
    x's shape, dtype and device (the wrapper puts them in x's layout);
    ``maps`` (label, tensor, shape, dtype) contiguous per-pixel maps on
    x's card."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: x has dtype {x.dtype}; the kernel takes "
                        "float32, bfloat16 or float64")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    for label, v in operands:
        check_operand(name, label, v, x)
    for label, v, shape, dtype in maps:
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: {label} is {tuple(v.shape)}, expected "
                             f"{shape}")
        if v.device != x.device or v.dtype != dtype or not v.is_contiguous():
            check_cuda(label, v, dtype, x.device)


def _pixels(x: torch.Tensor, planes: int = 0) -> Tuple[int, ...]:
    """The shape of a per-pixel map of x: (B, H, W), or (B, planes, H,
    W)."""
    n, _, h, w = x.shape
    return (n, planes, h, w) if planes else (n, h, w)


def _map(t: torch.Tensor) -> torch.Tensor:
    """A per-pixel map as the kernels read it: contiguous."""
    return t if t.is_contiguous() else t.contiguous()


def sa_pool(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12a. x (B, C, H, W) -> (m, count): m (B, 2, H, W) NCHW in x's
    dtype, the channel mean and max; count (B, H, W) int32, the channels
    equal to the max."""
    if is_plain("sa_pool", x):
        return sa_pool_plain(x)
    _check("sa_pool", x)
    m = x.new_empty(_pixels(x, 2))
    count = x.new_empty(_pixels(x), dtype=torch.int32)
    if not m.numel():
        return m, count
    p = plan(x)
    n, hw, c = sizes(x)
    with device_guard(x.device):
        launch("sa_pool", "insarseg_sa_pool", x.data_ptr(), m.data_ptr(),
               count.data_ptr(), n, hw, c, p.split, DTYPES[x.dtype],
               p.layout, p.vec, stream_of(x))
    return m, count


def sa_apply(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """K12b. ``cdt(x * gate)`` in x's layout; gate (B, H, W) in x's
    dtype."""
    if is_plain("sa_apply", x):
        return sa_apply_plain(x, gate)
    gate = _map(gate)
    _check("sa_apply", x, (), (("gate", gate, _pixels(x), x.dtype),))
    out = torch.empty_like(x)
    if not out.numel():
        return out
    p = plan(x, out)
    n, hw, c = sizes(x)
    with device_guard(x.device):
        launch("sa_apply", "insarseg_sa_apply", x.data_ptr(),
               gate.data_ptr(), out.data_ptr(), n, hw, c, p.split,
               DTYPES[x.dtype], p.layout, p.vec, stream_of(x))
    return out


def sa_grad_stats(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K13a. For each pixel the sum over C of ``cdt(dout * x)`` in f64,
    (B, H, W): the gate's cotangent."""
    if is_plain("sa_grad_stats", x):
        return sa_grad_stats_plain(dy, x)
    _check("sa_grad_stats", x, (("dout", dy),))
    dy = like(dy, x)
    gsum = x.new_empty(_pixels(x), dtype=torch.float64)
    if not gsum.numel():
        return gsum
    p = plan(x, dy)
    n, hw, c = sizes(x)
    with device_guard(x.device):
        launch("sa_grad_stats", "insarseg_sa_grad_stats", dy.data_ptr(),
               x.data_ptr(), gsum.data_ptr(), n, hw, c, p.split,
               DTYPES[x.dtype], p.layout, p.vec, stream_of(x))
    return gsum


def sa_grad_apply(dy: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                  m: torch.Tensor, count: torch.Tensor,
                  dm: torch.Tensor) -> torch.Tensor:
    """K13b. x's gradient in x's layout: ``cdt(cdt(cdt(dout * gate) +
    cdt(dmax * hit)) + dmean)`` from the gate (B, H, W), K12a's m (B, 2,
    H, W) and count (B, H, W) and the middle's input cotangent dm (B, 2,
    H, W), all in x's dtype but the count (int32)."""
    if is_plain("sa_grad_apply", x):
        return sa_grad_apply_plain(dy, x, gate, m, count, dm)
    gate, dm = _map(gate), _map(dm)
    _check("sa_grad_apply", x, (("dout", dy),), (
        ("gate", gate, _pixels(x), x.dtype),
        ("m", m, _pixels(x, 2), x.dtype),
        ("count", count, _pixels(x), torch.int32),
        ("dm", dm, _pixels(x, 2), x.dtype)))
    dy = like(dy, x)
    dx = torch.empty_like(x)
    if not dx.numel():
        return dx
    p = plan(x, dy, dx)
    n, hw, c = sizes(x)
    with device_guard(x.device):
        launch("sa_grad_apply", "insarseg_sa_grad_apply", dy.data_ptr(),
               x.data_ptr(), gate.data_ptr(), m.data_ptr(),
               count.data_ptr(), dm.data_ptr(), dx.data_ptr(), n, hw, c,
               p.split, DTYPES[x.dtype], p.layout, p.vec, stream_of(x))
    return dx


# ---------------------------------------------------------------------------
# the autograd functions
# ---------------------------------------------------------------------------

def _logistic(z: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-z))``, each op rounded to z's dtype: the JAX
    program's ``logistic`` (``se_train._gate``'s)."""
    return torch.reciprocal(torch.exp(z.neg()).add_(1))


class _Handoff:
    """What the rescale's backward leaves for the pool's: dout (in x's
    layout) and the gate."""
    __slots__ = ("dy", "gate")

    def __init__(self):
        self.dy = self.gate = None


class _Pool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, hand):
        m, count = sa_pool(x)
        ctx.save_for_backward(x, m, count)
        ctx.hand = hand
        return m

    @staticmethod
    def backward(ctx, dm):
        x, m, count = ctx.saved_tensors
        hand = ctx.hand
        dy, gate = hand.dy, hand.gate
        if dy is None:
            raise RuntimeError("sa_tail: the pool's backward ran before the "
                               "rescale's")
        hand.dy = hand.gate = None
        return sa_grad_apply(dy, x, gate, m, count, dm), None


class _Apply(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, z, hand):
        gate = _logistic(z)[:, 0]
        ctx.save_for_backward(x, gate)
        ctx.hand = hand
        return sa_apply(x, gate)

    @staticmethod
    def backward(ctx, dout):
        x, gate = ctx.saved_tensors
        dout = like(dout, x)
        dgate = sa_grad_stats(dout, x).to(x.dtype)
        dz = dgate * (gate * (1 - gate))
        ctx.hand.dy, ctx.hand.gate = dout, gate
        # x's gradient comes whole from the pool's backward (K13b)
        return None, dz[:, None], None


def sa_tail(x: torch.Tensor,
            middle: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The spatial-attention gate in train mode on K12a, K12b (forward)
    and K13a, K13b (backward): ``cdt(x * sigmoid(middle(m)))`` with ``m``
    (B, 2, H, W) the channel mean and max of ``x`` (B, C, H, W, NCHW or
    channels-last, in the compute dtype) and ``middle`` a module or
    function from it to (B, 1, H, W) logits (its parameters get their
    gradients through autograd)."""
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        x = x.contiguous()
    hand = _Handoff()
    z = middle(_Pool.apply(x, hand))
    return _Apply.apply(x, z, hand)

