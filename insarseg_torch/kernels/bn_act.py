"""K8a ``bn_stats``, K8b ``bn_apply_relu``, K9a ``bn_relu_grad_stats``
and K9b ``bn_relu_grad_apply``: the train-mode BatchNorm epilogue of the
JAX package's train step, one ``conv -> BatchNorm2d(train) ->`` its
activation (the conv's bias add, ``insarseg/ops/layers.py:121-127``; the
BatchNorm moments and apply, ``:224-246``), forward and backward, in
three modes (:data:`MODES`) of the same four kernels:

- ``"relu"``: ``relu(BN)``, the DoubleConv (``insarseg/ops/blocks.py:
  127-134``), a ResNet's stem, bn1 and bn2 and every head BatchNorm of
  DeepLabV3, FCN and the PSPNet;
- ``"none"``: ``BN``, a ResNet's ``downsample_bn`` and its bn3 before an
  SE block (``insarseg/models/resnet.py:88-98``);
- ``"residual"``: ``relu(cdt(BN + r))``, bn3 with the residual add and
  its relu (``insarseg/models/resnet.py:99``), ``r`` the identity in the
  compute dtype and BN already rounded to it: the JAX program rounds the
  BatchNorm's output (``insarseg/ops/layers.py:246``) and then the sum,
  and so does its ``jit`` on the CPU (a bf16 site's output, dt and dr
  equal the op-by-op run's, ``tests/test_torch_bn_resnet.py``). XLA's
  excess precision keeps a conv's output in f32 into its BatchNorm
  under ``jit`` instead; the port rounds it, as the program states.

Kernels: ``insarseg_torch/csrc/bn_act.cu``. With ``cdt`` the compute
dtype (the conv output's: bf16, f32 or f64) and ``acc`` =
``promote(cdt, f32)``:

- K8a: ``t = cdt(y + cdt(bias))`` (``t = y`` without a bias, as the
  ResNet families' convs have none) and the per-channel sums of t and
  t^2 in f64, then the count: one f64 buffer ``[sum t (C), sum t^2 (C),
  n]``;
- K8b: from that buffer (all-reduced over the ranks when the BatchNorm is
  synced): the JAX moment rule in acc, ``mean = acc(sum t * (1/n))``,
  ``var = max(acc(sum t^2 * (1/n)) - mean^2, 0)``, ``a = rsqrt(var +
  eps) * gamma``; the running statistics ``(1 - m) r + m (mean, var * k /
  max(k - 1, 1))`` with ``k = n / rows_div`` (``rows_div`` the copies of
  each row the sums hold: the slabs of a replicated map, else 1); and
  ``p = cdt((t - mean) * a + beta)`` through the mode: ``relu(p)``,
  ``p`` or ``relu(cdt(p + r))``;
- K9a: ``g = dout`` where the mode's ReLU passes (relu: the pre-ReLU cdt
  value ``p > 0``; none: everywhere; residual: the saved output ``out >
  0``, which holds exactly where ``cdt(p + r) > 0``), else 0; ``xhat =
  (t - mean) * rsqrt(var + eps)``: ``[sum g, sum g * xhat]`` in f64 (the
  beta and gamma gradients);
- K9b: ``dt = cdt(a * ((g - acc(sum g * (1/n))) - xhat * acc(sum g xhat
  * (1/n))))`` from that buffer (all-reduced when synced); in the
  residual mode K9b also writes ``dr = g``, the identity's gradient (the
  elements are in its registers there; a K9a pass would write from a
  reduction kernel).

The sums are f64 (with f32 or bf16 terms each term, t, t^2, g or g *
xhat of f32 values, is exact there) and each mean rounds to acc once:
sums taken in other orders (a kernel's and its plain version's, one
card's and a mesh's, whose ranks add their buffers) then give the same
means but where a sum lies within ~1e-16 of a rounding boundary. The JAX
package reduces in f32; these sums are closer to the exact moments. In
f64 (the yardstick steps) the terms themselves round.

The conv bias gets no gradient (the JAX ``stop_gradient``). Each
``*_plain`` function is the kernel's formula in torch ops, in the kernel's
order, with the same modes; on the card a kernel and its plain version
differ only where their sums, taken in other orders, differ.
:func:`bn_relu_train` is the ``torch.autograd.Function`` over the four. A
wrapper given a CPU (or meta) tensor runs its plain version; a CUDA
tensor launches its kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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
    workspace,
)

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]

# what follows the BatchNorm, the kernels' codes of it (csrc/bn_act.cu:
# RELU / NONE / RESIDUAL; y's dtype: ``_lib.DTYPES``)
MODES = {"relu": 0, "none": 1, "residual": 2}
# the labels of the f64 sum buffers among the per-channel vectors
SUMS = ("stats", "gstats")

# K8b / K9b's plan: about this many blocks a launch (8 per SM of an H100),
# and at least this many elements a slice
TARGET_BLOCKS = 1056
MIN_SLICE = 8192
THREADS = 256
# K8a / K9a's plan (csrc/bn_act.cu: RED_V, GROUP_LANES, TREE, RED_BYTES):
# RED_V channels (channels-last) or elements (NCHW) a load, RED_BYTES of
# loads an operand a thread's trip, GROUP_LANES channel vectors a
# channels-last block, TREE partial sums a first-stage combine; at least
# RED_MIN_TRIPS trips a thread, and about one wave of blocks a launch:
# K8a's kernels hold 4 blocks an SM of an H100 (132 SMs), K9a's 2 (their
# registers; chip_smoke.py::bn_kernel_info), and a grid of one wave beat
# two (PERF.md, PR 14)
RED_V = 4
GROUP_LANES = 16
TREE = 32
RED_BYTES = 32
RED_MIN_TRIPS = 4
STATS_BLOCKS = 4 * 132
GRAD_BLOCKS = 2 * 132
# per (device, stream): the reductions' partial sums and their counters
# (zero between launches: each launch's last blocks reset theirs), at
# least the sizes a bf16 512^2 b8 U-Net step's largest site needs
WORK_SUMS = 1 << 19
WORK_COUNTERS = 1 << 12
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _acc(dtype: torch.dtype) -> torch.dtype:
    return ACC.get(dtype) or torch.promote_types(dtype, torch.float32)


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over (N, C, H, W)."""
    return v[:, None, None]


def _t(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The biased conv output in acc: ``cdt(y + cdt(bias))`` (y without a
    bias)."""
    t = y if bias is None else y + _col(bias.to(y.dtype))
    return t.to(_acc(y.dtype))


def _terms(stats: torch.Tensor, gamma: torch.Tensor, eps: float, acc):
    """n (f64), and in acc the mean, biased var, rsqrt(var + eps) and a =
    rstd * gamma of a ``[sum t, sum t^2, n]`` buffer."""
    c = gamma.shape[0]
    n = stats[2 * c]
    rn = 1.0 / n  # each mean is a sum times 1/n, as in the kernels
    mean = (stats[:c] * rn).to(acc)
    var = ((stats[c:2 * c] * rn).to(acc) - mean.square()).clamp_min(0)
    rstd = torch.rsqrt(var + eps)
    return n, mean, var, rstd, rstd * gamma.to(acc)


def _sum64(t: torch.Tensor) -> torch.Tensor:
    """The per-channel sums of t (N, C, H, W) in f64, summed along its
    memory (NCHW or channels-last)."""
    n, c = t.shape[:2]
    t = t.to(torch.float64)
    if t.is_contiguous():
        return t.view(n, c, -1).sum(2).sum(0)
    return t.permute(0, 2, 3, 1).reshape(-1, c).sum(0)


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"bn_act: mode {mode!r}, not one of {list(MODES)}")
    return MODES[mode]


def _masked(dy, y, bias, stats, gamma, beta, eps, mode, out):
    """(g, xhat, a, n) of the backward: the mode's ReLU mask, recomputed
    from t (relu) or read from the saved output (residual), as a product
    with the mask (the kernels' select for a finite dout, and a quarter of
    a select's time on the CPU)."""
    _mode(mode)
    n, mean, _, rstd, a = _terms(stats, gamma, eps, _acc(y.dtype))
    d = _t(y, bias) - _col(mean)
    g = dy.to(d.dtype)
    if mode == "relu":
        pre = (d * _col(a) + _col(beta.to(d.dtype))).to(y.dtype)
        g = g * (pre > 0)
    elif mode == "residual":
        g = g * (out > 0)
    return g, d * _col(rstd), a, n


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bn_stats_plain(y: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    t = _t(y, bias).to(torch.float64)
    n = y.shape[0] * y.shape[2] * y.shape[3]
    return torch.cat([_sum64(t), _sum64(t * t), t.new_full((1,), n)])


def bn_apply_relu_plain(y, bias, stats, gamma, beta, running_mean,
                        running_var, eps: float, momentum: float,
                        mode: str = "relu", residual=None,
                        rows_div: int = 1):
    _mode(mode)
    acc = _acc(y.dtype)
    n, mean, var, _, a = _terms(stats, gamma, eps, acc)
    with torch.no_grad():
        rows = n / rows_div
        unbias = (rows / (rows - 1).clamp_min(1)).to(acc)
        running_mean.copy_((1.0 - momentum) * running_mean
                           + momentum * mean.to(running_mean.dtype))
        running_var.copy_((1.0 - momentum) * running_var
                          + momentum * (var * unbias).to(running_var.dtype))
    d = _t(y, bias) - _col(mean)
    p = (d * _col(a) + _col(beta.to(d.dtype))).to(y.dtype)
    if mode == "none":
        return p
    if mode == "residual":
        p = p + residual
    return torch.relu(p)


def bn_relu_grad_stats_plain(dy, y, bias, stats, gamma, beta, eps: float,
                             mode: str = "relu", out=None):
    g, xhat, _, _ = _masked(dy, y, bias, stats, gamma, beta, eps, mode, out)
    g = g.to(torch.float64)
    return torch.cat([_sum64(g), _sum64(g * xhat.to(torch.float64))])


def bn_relu_grad_apply_plain(dy, y, bias, stats, gstats, gamma, beta,
                             eps: float, mode: str = "relu", out=None):
    g, xhat, a, n = _masked(dy, y, bias, stats, gamma, beta, eps, mode, out)
    c = gamma.shape[0]
    rn = 1.0 / n
    mg, mgt = (gstats[:c] * rn).to(g.dtype), (gstats[c:] * rn).to(g.dtype)
    dt = (_col(a) * ((g - _col(mg)) - xhat * _col(mgt))).to(y.dtype)
    return (dt, g.to(y.dtype)) if mode == "residual" else dt


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def plan(y: torch.Tensor, *others: torch.Tensor) -> Tuple[int, int, int]:
    """(layout, vec, S) of a K8b / K9b launch over ``y`` (and ``others``,
    in the same layout): 16-byte vectors when a plane (NCHW) or a row
    (channels-last) is a whole number of them and every pointer is
    16-byte aligned; S slices, from the shape alone, so the sums of one
    tensor are the same at every call."""
    n, c, h, w = y.shape
    layout = layout_of(y)
    per = 16 // y.element_size()
    vec = int((h * w if layout == 0 else c) % per == 0
              and _aligned(16, y, *others))
    return layout, vec, apply_slices(n, c, h, w, layout, per if vec else 1)


def _aligned(size: int, *ts: torch.Tensor) -> bool:
    for t in ts:
        if t.data_ptr() % size:
            return False
    return True


@functools.lru_cache(maxsize=None)
def apply_slices(n: int, c: int, h: int, w: int, layout: int,
                 v: int) -> int:
    """K8b / K9b's slices S of an (n, c, h, w) tensor in ``layout``
    loaded ``v`` elements at a time."""
    rows = n * h * w
    if layout == 0:
        s = min(math.ceil(TARGET_BLOCKS / c), math.ceil(rows / MIN_SLICE))
    else:
        cv = c // v
        groups = math.ceil(cv / THREADS)
        rows_a_pass = THREADS // min(cv, THREADS)
        s = min(math.ceil(TARGET_BLOCKS / groups),
                math.ceil(rows * min(cv, THREADS) * v / MIN_SLICE),
                math.ceil(rows / rows_a_pass))
    return max(1, s)


class ReducePlan(NamedTuple):
    """A launch of K8a / K9a: ``layout`` (0 NCHW, 1 channels-last),
    ``vec`` (RED_V-element loads), ``groups`` (grid.y: channels, or
    channel groups of ``lanes`` threads a row), ``slices`` (grid.x), each
    of ``per`` units (rows, or NCHW items of ``item`` elements) of
    ``units`` a group, ``trip`` units a thread's loop trip, ``runs`` the
    first-stage combines a group (``ceil(slices / TREE)``)."""
    layout: int
    vec: int
    groups: int
    slices: int
    per: int
    units: int
    trip: int
    item: int
    lanes: int
    runs: int

    def workspace(self, c: int) -> Tuple[int, int]:
        """(f64 partial sums, counters) a launch over C = ``c`` needs."""
        return ((self.slices + self.runs) * 2 * c,
                self.groups * (self.runs + 1))


def unroll(element_size: int, v: int) -> int:
    """Loads an operand a thread issues before its first add: RED_BYTES of
    V-element vectors, 4 single elements."""
    return 4 if v == 1 else RED_BYTES // (v * element_size)


@functools.lru_cache(maxsize=None)
def reduce_partition(n: int, c: int, h: int, w: int, element_size: int,
                     layout: int, vec: int, blocks: int) -> ReducePlan:
    """K8a / K9a's partition of an (n, c, h, w) tensor into about
    ``blocks`` blocks: from the shape, the element size, the layout and
    whether vectors fit, never from the card, so one tensor gives the same
    sums at every call."""
    v = RED_V if vec else 1
    u = unroll(element_size, v)
    if layout == 0:
        item = THREADS * v * u
        units, groups, trip, lanes = n * math.ceil(h * w / item), c, 1, 0
    else:
        cv = c // v
        lanes = min(cv, GROUP_LANES)
        item, units = 0, n * h * w
        groups, trip = math.ceil(cv / lanes), (THREADS // lanes) * u
    trips = max(RED_MIN_TRIPS,
                math.ceil(math.ceil(units / trip)
                          / math.ceil(blocks / groups)))
    per = trips * trip
    slices = max(1, math.ceil(units / per))
    return ReducePlan(layout, vec, groups, slices, per, units, trip, item,
                      lanes, math.ceil(slices / TREE))


def reduce_plan(y: torch.Tensor, *others: torch.Tensor) -> ReducePlan:
    """K8a's (``y`` alone) or K9a's (``y`` and dout) launch over ``y``
    (``others`` in the same layout): RED_V-element vectors when a plane
    (NCHW) or a row (channels-last) is a whole number of them and every
    pointer is aligned to one (in f64 one element a load)."""
    n, c, h, w = y.shape
    layout = layout_of(y)
    size = y.element_size()
    vec = int((h * w if layout == 0 else c) % RED_V == 0 and size < 8
              and _aligned(RED_V * size, y, *others))
    return reduce_partition(n, c, h, w, size, layout, vec,
                            GRAD_BLOCKS if others else STATS_BLOCKS)


def _workspace(y: torch.Tensor, stream: int, n_sums: int,
               n_counters: int) -> Tuple[int, int]:
    """K8a / K9a's workspace on (y's device, stream) (``_lib.workspace``)."""
    return workspace(_WORK, y, stream, n_sums, n_counters, WORK_SUMS,
                     WORK_COUNTERS)


def _cuda_args(name, y, bias, *vectors, operands=()):
    """The checks of a launch: y f32, bf16 or f64 (N, C, H, W) on the card,
    the per-channel vectors (``bias`` may be None) in acc and the sum
    buffers (``stats``, ``gstats``) f64, each contiguous, aligned and on
    y's card; ``operands`` (the residual's, the saved output) like y. One
    pass of cheap tests a vector; ``check_cuda`` only names a fault."""
    acc = ACC.get(y.dtype)
    if acc is None:
        raise TypeError(f"{name}: y has dtype {y.dtype}; the kernel takes "
                        "float32, bfloat16 or float64")
    if y.dim() != 4:
        raise ValueError(f"{name}: y must be (N, C, H, W), got "
                         f"{tuple(y.shape)}")
    dev, c = y.device, y.shape[1]
    if bias is not None:
        vectors = (("bias", bias),) + vectors
    for label, v in vectors:
        want = torch.float64 if label in SUMS else acc
        if (v.device != dev or v.dtype != want or not v.is_contiguous()
                or v.data_ptr() % 16 or v.shape[0] < c):
            check_cuda(label, v, want, dev)
            if v.shape[0] < c:
                raise ValueError(f"{name}: {label} holds {v.shape[0]} "
                                 f"values for {c} channels")
    for label, v in operands:
        check_operand(name, label, v, y)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def bn_stats(y: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K8a. y (N, C, H, W) the conv output without its bias, bias (C) in
    acc or None -> ``[sum t (C), sum t^2 (C), n]`` in f64, t = cdt(y +
    cdt(bias))."""
    if is_plain("bn_stats", y):
        return bn_stats_plain(y, bias)
    _cuda_args("bn_stats", y, bias)
    p = reduce_plan(y)
    n, hw, c = sizes(y)
    stats = y.new_empty(2 * c + 1, dtype=torch.float64)
    with device_guard(y.device):
        stream = stream_of(y)
        ws, counters = _workspace(y, stream, *p.workspace(c))
        launch("bn_stats", "insarseg_bn_stats", y.data_ptr(), _ptr(bias), ws,
               counters, stats.data_ptr(), n, hw, c, p.slices, p.per,
               p.groups, DTYPES[y.dtype], p.layout, p.vec, stream)
    return stats


def bn_apply_relu(y, bias, stats, gamma, beta, running_mean, running_var,
                  eps: float, momentum: float, mode: str = "relu",
                  residual: Optional[torch.Tensor] = None,
                  rows_div: int = 1) -> torch.Tensor:
    """K8b. ``relu(p)``, ``p`` or ``relu(cdt(p + residual))`` (``mode``),
    ``p = cdt((t - mean) * a + beta)``, in y's layout, and the running
    statistics updated in place from ``stats`` (the unbiased factor from
    the count over ``rows_div``)."""
    if is_plain("bn_apply_relu", y):
        return bn_apply_relu_plain(y, bias, stats, gamma, beta, running_mean,
                                   running_var, eps, momentum, mode,
                                   residual, rows_div)
    m = _mode(mode)
    _cuda_args("bn_apply_relu", y, bias, ("stats", stats), ("gamma", gamma),
               ("beta", beta), ("running_mean", running_mean),
               ("running_var", running_var),
               operands=(("residual", residual),) if mode == "residual"
               else ())
    r = like(residual, y) if mode == "residual" else None
    out = torch.empty_like(y)
    layout, vec, s = plan(y, out, *([r] if r is not None else []))
    n, hw, c = sizes(y)
    with device_guard(y.device):
        launch("bn_apply_relu", "insarseg_bn_apply_relu", y.data_ptr(),
               _ptr(bias), stats.data_ptr(), gamma.data_ptr(),
               beta.data_ptr(), running_mean.data_ptr(),
               running_var.data_ptr(), _ptr(r), out.data_ptr(), n, hw, c, s,
               float(eps), float(1.0 - momentum), float(momentum),
               float(rows_div), DTYPES[y.dtype], layout, vec, m,
               stream_of(y))
    return out


def _backward_args(name, dy, y, bias, mode, out, *vectors):
    """The checks of K9a / K9b and their operands in y's layout: (mode
    code, dout, the saved output or None)."""
    m = _mode(mode)
    _cuda_args(name, y, bias, *vectors,
               operands=(("out", out),) if mode == "residual" else ())
    return m, like(dy, y), like(out, y) if mode == "residual" else None


def bn_relu_grad_stats(dy, y, bias, stats, gamma, beta, eps: float,
                       mode: str = "relu",
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9a. ``[sum g (C), sum g * xhat (C)]`` in f64; ``out`` the site's
    saved output (the residual mode's mask)."""
    if is_plain("bn_relu_grad_stats", y):
        return bn_relu_grad_stats_plain(dy, y, bias, stats, gamma, beta, eps,
                                        mode, out)
    m, dy, o = _backward_args("bn_relu_grad_stats", dy, y, bias, mode, out,
                              ("stats", stats), ("gamma", gamma),
                              ("beta", beta))
    p = reduce_plan(y, dy, *([o] if o is not None else []))
    n, hw, c = sizes(y)
    gstats = y.new_empty(2 * c, dtype=torch.float64)
    with device_guard(y.device):
        stream = stream_of(y)
        ws, counters = _workspace(y, stream, *p.workspace(c))
        launch("bn_relu_grad_stats", "insarseg_bn_relu_grad_stats",
               dy.data_ptr(), y.data_ptr(), _ptr(o), _ptr(bias),
               stats.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ws,
               counters, gstats.data_ptr(), n, hw, c, p.slices, p.per,
               p.groups, float(eps), DTYPES[y.dtype], p.layout, p.vec, m,
               stream)
    return gstats


def bn_relu_grad_apply(dy, y, bias, stats, gstats, gamma, beta, eps: float,
                       mode: str = "relu",
                       out: Optional[torch.Tensor] = None):
    """K9b. ``dt = cdt(a * ((g - acc(sum g / n)) - xhat * acc(sum g xhat /
    n)))``, the gradient of the conv output, in y's layout; in the
    residual mode ``(dt, dr)``, ``dr = g`` the residual's gradient."""
    if is_plain("bn_relu_grad_apply", y):
        return bn_relu_grad_apply_plain(dy, y, bias, stats, gstats, gamma,
                                        beta, eps, mode, out)
    m, dy, o = _backward_args("bn_relu_grad_apply", dy, y, bias, mode, out,
                              ("stats", stats), ("gstats", gstats),
                              ("gamma", gamma), ("beta", beta))
    dt = torch.empty_like(y)
    dr = torch.empty_like(y) if o is not None else None
    layout, vec, s = plan(y, dy, dt, *([o, dr] if o is not None else []))
    n, hw, c = sizes(y)
    with device_guard(y.device):
        launch("bn_relu_grad_apply", "insarseg_bn_relu_grad_apply",
               dy.data_ptr(), y.data_ptr(), _ptr(o), _ptr(bias),
               stats.data_ptr(), gstats.data_ptr(), gamma.data_ptr(),
               beta.data_ptr(), dt.data_ptr(), _ptr(dr), n, hw, c, s,
               float(eps), DTYPES[y.dtype], layout, vec, m, stream_of(y))
    return (dt, dr) if dr is not None else dt


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------

class _BNAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, bias, gamma, beta, residual, running_mean,
                running_var, eps, momentum, reduce, mode, rows_div):
        stats = bn_stats(y, bias)
        if reduce is not None:
            stats = reduce(stats)
        out = bn_apply_relu(y, bias, stats, gamma, beta, running_mean,
                            running_var, eps, momentum, mode, residual,
                            rows_div)
        # the residual mode's mask is the saved output's sign
        ctx.save_for_backward(y, bias, stats, gamma, beta,
                              out if mode == "residual" else None)
        ctx.eps, ctx.reduce, ctx.mode = eps, reduce, mode
        return out

    @staticmethod
    def backward(ctx, dout):
        y, bias, stats, gamma, beta, out = ctx.saved_tensors
        gstats = bn_relu_grad_stats(dout, y, bias, stats, gamma, beta,
                                    ctx.eps, ctx.mode, out)
        c = gamma.shape[0]
        # this rank's dbeta and dgamma (the step sums the ranks' gradients)
        # in one conversion, copied before the all-reduce sums the buffer in
        # place
        d = gstats.to(gamma.dtype, copy=ctx.reduce is not None)
        dbeta, dgamma = d[:c], d[c:]
        if ctx.reduce is not None:
            gstats = ctx.reduce(gstats)
        dy = dr = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[4]:
            dy = bn_relu_grad_apply(dout, y, bias, stats, gstats, gamma, beta,
                                    ctx.eps, ctx.mode, out)
            if ctx.mode == "residual":
                dy, dr = dy
        return (dy if ctx.needs_input_grad[0] else None, None,
                dgamma if ctx.needs_input_grad[2] else None,
                dbeta if ctx.needs_input_grad[3] else None,
                dr if ctx.needs_input_grad[4] else None,
                None, None, None, None, None, None, None)


def bn_relu_train(y: torch.Tensor, bias: Optional[torch.Tensor],
                  gamma: torch.Tensor, beta: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor,
                  eps: float, momentum: float, reduce: Reduce = None,
                  mode: str = "relu", residual: Optional[torch.Tensor] = None,
                  rows_div: int = 1) -> torch.Tensor:
    """A train-mode ``BatchNorm2d(y + bias)`` with the JAX package's
    moments (K8a, K8b forward; K9a, K9b backward) followed by ``mode``:
    ``"relu"`` its ReLU, ``"none"`` nothing, ``"residual"`` the add of
    ``residual`` (the identity, in y's dtype, which gets its gradient) and
    a ReLU. ``y`` (N, C, H, W) is the conv output without its bias, NCHW
    or channels-last; ``bias`` the conv bias (no gradient), or None for a
    bias-free conv; ``gamma`` / ``beta`` the BatchNorm's affine
    parameters; the running statistics are updated in place. ``reduce``
    sums a buffer over the ranks in place and returns it (None on one
    process): called on K8a's buffer in the forward pass and on K9a's in
    the backward pass, so the moments and the input gradient are the
    global batch's, and the running variance's factor comes from the
    global count over ``rows_div`` (the copies of each row the summed
    buffer holds: the slabs of a map every slab holds whole, else 1).
    Under a spatial mesh ``y`` is a rank's H slab and the count in K8a's
    buffer the slab's N x H_slab x W, so the same sum over every rank
    gives the whole batch's moments (``parallel/spatial.py``)."""
    _mode(mode)
    if (mode == "residual") != (residual is not None):
        raise ValueError("bn_relu_train: a residual goes with the residual "
                         "mode and only with it")
    return _BNAct.apply(y, None if bias is None else bias.detach(), gamma,
                        beta, residual, running_mean, running_var, eps,
                        momentum, reduce, mode, rows_div)
