"""K10a ``se_squeeze``, K10b ``se_excite``, K11a ``se_grad_stats`` and
K11b ``se_grad_apply``: the squeeze-excite tail of the JAX package's train
step, forward and backward, in two modes (:data:`MODES`) of the same four
kernels:

- ``"scale"``: ``cdt(x * gate)``, the U-Net's ``SELayer`` (the DoubleConv's
  SE tail, ``insarseg/ops/blocks.py:46-64``, ``:135-136``);
- ``"residual"``: ``relu(cdt(cdt(x * gate) + identity))``, a CA ResNet's
  ``SEBlock`` after bn3 with the residual add and its ReLU
  (``insarseg/models/resnet.py:87-99``, ``insarseg/ops/blocks.py:67-86``).

``gate = sigmoid(fc2(relu(fc1(mean))))`` with ``mean`` the mean of ``x``
over H and W. Kernels: ``insarseg_torch/csrc/se_train.cu``. With ``cdt``
the compute dtype (``x``'s: bf16, f32 or f64) and ``acc`` =
``promote(cdt, f32)``:

- K10a: the per-(b, c) sums of x over H and W in f64 (B, C);
- K10b: ``cdt(x * gate[b, c])``, in the residual mode then ``relu(cdt(. +
  identity))``;
- K11a: ``g = dout`` (in the residual mode masked by the saved output's
  sign, ``out > 0``), and the per-(b, c) sums of ``cdt(g * x)`` in f64:
  the gate's cotangent, the JAX VJP's bf16 product summed;
- K11b: ``dx = cdt(cdt(g * gate) + cdt(dtot))``, ``dtot`` the mean's
  cotangent over H W (the JAX VJP adds the rescale's and the mean's
  cotangents of x in cdt, each rounded to it); in the residual mode also
  ``didn = g``, the identity's gradient.

Between them, in torch ops on (B, C) vectors (:func:`se_train`): the mean
``cdt(acc(sums / (H W)))`` (the JAX ``jnp.mean``: a sum over f32 terms
divided in f32 and cast once; here the sums are f64), the gate MLP with
the module's weights in cdt (its sigmoid the JAX ``logistic``, ``1 / (1 +
exp(-z))`` rounded at each op), and in the backward pass the MLP's VJP in
the JAX program's order and ``dtot = acc(dmean) / (H W)``. Under a
spatial mesh ``x`` is an H slab: ``reduce`` sums K10a's buffer over the
slabs (the whole map's mean, divided by the whole map's H W) and ``dtot``
(as ``parallel/spatial.py::_Sum``'s backward does), while the MLP's weight
gradients stay each slab's own, for the mesh's gradient all-reduce to sum.

Each ``*_plain`` function is the kernel's formula in torch ops with the
same roundings; on the card a kernel and its plain version differ only
where their f64 sums, taken in other orders, differ. A wrapper given a
CPU (or meta) tensor runs its plain version; a CUDA tensor launches its
kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

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

# what follows the rescale, the kernels' codes of it (csrc/se_train.cu:
# SCALE / RESIDUAL; x's dtype: ``_lib.DTYPES``)
MODES = {"scale": 0, "residual": 1}

# the plans (csrc/se_train.cu: THREADS, LANES): about TARGET_BLOCKS blocks
# a launch (8 of 256 threads on each of an H100's 132 SMs), at least
# MIN_SLICE elements a reduction's block and MIN_CHUNK an apply's, at most
# MAX_SLICES partial sums a plane or group for the last block to add
THREADS = 256
LANES = 32
TARGET_BLOCKS = 1056
MIN_SLICE = 8192
MIN_CHUNK = 4096
MAX_SLICES = 64
# per (device, stream): the reductions' partial sums and counters (zero
# between launches: each launch's last blocks reset theirs), at least the
# sizes of a bf16 512^2 b8 U-Net step's largest site
WORK_SUMS = 1 << 18
WORK_COUNTERS = 1 << 14
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"se_train: mode {mode!r}, not one of {list(MODES)}")
    return MODES[mode]


def _col(v: torch.Tensor) -> torch.Tensor:
    """A (B, C) vector broadcast over (B, C, H, W)."""
    return v[:, :, None, None]


def _masked(dy: torch.Tensor, out: Optional[torch.Tensor],
            mode: str) -> torch.Tensor:
    """g: dout, in the residual mode where the saved output is > 0 (a
    product with the mask: the kernels' select for a finite dout)."""
    return dy * (out > 0) if _mode(mode) else dy


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def se_squeeze_plain(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64).sum(dim=(2, 3))


def se_excite_plain(x: torch.Tensor, gate: torch.Tensor,
                    identity: Optional[torch.Tensor] = None,
                    mode: str = "scale") -> torch.Tensor:
    out = x * _col(gate)
    return torch.relu(out + identity) if _mode(mode) else out


def se_grad_stats_plain(dy: torch.Tensor, x: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        mode: str = "scale") -> torch.Tensor:
    return (_masked(dy, out, mode) * x).to(torch.float64).sum(dim=(2, 3))


def se_grad_apply_plain(dy: torch.Tensor, gate: torch.Tensor,
                        dtot: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        mode: str = "scale"):
    g = _masked(dy, out, mode)
    dx = g * _col(gate) + _col(dtot.to(dy.dtype))
    return (dx, g) if _mode(mode) else dx


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """A launch over (B, C, H, W): ``layout`` (0 NCHW, 1 channels-last),
    ``vec`` (16-byte vectors), ``blocks`` (a reduction's slices S, or an
    apply's blocks K, a plane or an (image, channel group)) of ``per``
    elements (NCHW) or rows (channels-last), ``groups`` the planes (NCHW)
    or (image, channel group)s, one counter each."""
    layout: int
    vec: int
    blocks: int
    per: int
    groups: int


def _vec(x: torch.Tensor, layout: int, *others: torch.Tensor) -> int:
    """16-byte vectors where a plane (NCHW) or a row (channels-last) is a
    whole number of them and every pointer is aligned to one."""
    n, c, h, w = x.shape
    v = 16 // x.element_size()
    if (h * w if layout == 0 else c) % v:
        return 0
    return int(all(t.data_ptr() % 16 == 0 for t in (x,) + others))


def _split(units: int, parts: int, step: int) -> Tuple[int, int]:
    """(blocks, per): ``units`` cut into about ``parts`` ranges, each a
    whole number of ``step`` (at least one block, one step)."""
    per = max(step, math.ceil(math.ceil(units / max(parts, 1)) / step) * step)
    return max(1, math.ceil(units / per)), per


@functools.lru_cache(maxsize=None)
def partition(n: int, c: int, h: int, w: int, element_size: int,
              layout: int, vec: int, reduce: bool) -> Plan:
    """The plan of a reduction (``reduce``) or an apply over an (n, c, h,
    w) tensor in ``layout`` with or without vectors: from these alone,
    never from the card."""
    hw = h * w
    v = 16 // element_size if vec else 1
    if layout == 0:
        groups = n * c
        size = math.ceil(hw / (MIN_SLICE if reduce else MIN_CHUNK))
        step = v
    else:
        cvs = c // v
        lanes = min(cvs, LANES if reduce else THREADS)
        groups = n * math.ceil(cvs / lanes)
        size = math.ceil(hw * lanes * v / (MIN_SLICE if reduce else MIN_CHUNK))
        step = 1
    wanted = math.ceil(TARGET_BLOCKS / groups)
    parts = max(1, min(wanted, size, MAX_SLICES if reduce else wanted))
    blocks, per = _split(hw, parts, step)
    return Plan(layout, vec, blocks, per, groups)


def _plan(x: torch.Tensor, reduce: bool, *others: torch.Tensor) -> Plan:
    layout = layout_of(x)
    return partition(*x.shape, x.element_size(), layout,
                     _vec(x, layout, *others), reduce)


def reduce_plan(x: torch.Tensor, *others: torch.Tensor) -> Plan:
    """K10a's (``x`` alone) or K11a's (``x``, dout and the saved output)
    plan; from the shape, the layout and the alignment alone, so one
    tensor gives the same sums at every call."""
    return _plan(x, True, *others)


def apply_plan(x: torch.Tensor, *others: torch.Tensor) -> Plan:
    """K10b's or K11b's plan over ``x`` (and ``others``, its operands and
    outputs in x's layout)."""
    return _plan(x, False, *others)


def _workspace(x: torch.Tensor, stream: int, p: Plan) -> Tuple[int, int]:
    """K10a / K11a's workspace on (x's device, stream) for plan ``p``
    (``_lib.workspace``)."""
    n, c = x.shape[:2]
    return workspace(_WORK, x, stream, p.blocks * n * c if p.blocks > 1
                     else 0, p.groups, WORK_SUMS, WORK_COUNTERS)


def _check(name: str, x: torch.Tensor, operands=(), vectors=()) -> None:
    """The checks of a launch, one pass of cheap tests a tensor
    (``check_cuda`` only names a fault): x f32, bf16 or f64 (B, C, H, W)
    on the card (its layout: ``_plan``); ``operands`` (label,
    tensor) of x's shape, dtype and device (the wrapper puts them in x's
    layout); ``vectors`` (label, tensor, dtype) contiguous (B, C) on x's
    card."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: x has dtype {x.dtype}; the kernel takes "
                        "float32, bfloat16 or float64")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    dev = x.device
    for label, v in operands:
        check_operand(name, label, v, x)
    for label, v, dtype in vectors:
        if v.shape != x.shape[:2]:
            raise ValueError(f"{name}: {label} is {tuple(v.shape)}, expected "
                             f"{tuple(x.shape[:2])}")
        if v.device != dev or v.dtype != dtype or not v.is_contiguous():
            check_cuda(label, v, dtype, dev)


def se_squeeze(x: torch.Tensor) -> torch.Tensor:
    """K10a. x (B, C, H, W) -> the per-(b, c) sums over H and W, (B, C)
    f64."""
    if is_plain("se_squeeze", x):
        return se_squeeze_plain(x)
    _check("se_squeeze", x)
    p = reduce_plan(x)
    n, hw, c = sizes(x)
    sums = x.new_empty((n, c), dtype=torch.float64)
    with device_guard(x.device):
        stream = stream_of(x)
        ws, counters = _workspace(x, stream, p)
        launch("se_squeeze", "insarseg_se_squeeze", x.data_ptr(), ws,
               counters, sums.data_ptr(), n, hw, c, p.blocks, p.per,
               DTYPES[x.dtype], p.layout, p.vec, stream)
    return sums


def se_excite(x: torch.Tensor, gate: torch.Tensor,
              identity: Optional[torch.Tensor] = None,
              mode: str = "scale") -> torch.Tensor:
    """K10b. ``cdt(x * gate)``, or in the residual mode ``relu(cdt(. +
    identity))``, in x's layout; gate (B, C) in x's dtype."""
    if is_plain("se_excite", x):
        return se_excite_plain(x, gate, identity, mode)
    m = _mode(mode)
    _check("se_excite", x, (("identity", identity),) if m else (),
           (("gate", gate, x.dtype),))
    r = like(identity, x) if m else None
    out = torch.empty_like(x)
    p = apply_plan(x, out, *([r] if m else []))
    n, hw, c = sizes(x)
    with device_guard(x.device):
        launch("se_excite", "insarseg_se_excite", x.data_ptr(),
               gate.data_ptr(), None if r is None else r.data_ptr(),
               out.data_ptr(), n, hw, c, p.blocks, p.per, DTYPES[x.dtype],
               p.layout, p.vec, m, stream_of(x))
    return out


def se_grad_stats(dy: torch.Tensor, x: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  mode: str = "scale") -> torch.Tensor:
    """K11a. The per-(b, c) sums over H and W of ``cdt(g * x)`` in f64,
    (B, C): the gate's cotangent; ``out`` the saved output (the residual
    mode's mask)."""
    if is_plain("se_grad_stats", x):
        return se_grad_stats_plain(dy, x, out, mode)
    m = _mode(mode)
    _check("se_grad_stats", x,
           (("dout", dy),) + ((("out", out),) if m else ()))
    dy = like(dy, x)
    o = like(out, x) if m else None
    p = reduce_plan(x, dy, *([o] if m else []))
    n, hw, c = sizes(x)
    gsum = x.new_empty((n, c), dtype=torch.float64)
    with device_guard(x.device):
        stream = stream_of(x)
        ws, counters = _workspace(x, stream, p)
        launch("se_grad_stats", "insarseg_se_grad_stats", dy.data_ptr(),
               x.data_ptr(), None if o is None else o.data_ptr(), ws,
               counters, gsum.data_ptr(), n, hw, c, p.blocks, p.per,
               DTYPES[x.dtype], p.layout, p.vec, m, stream)
    return gsum


def se_grad_apply(dy: torch.Tensor, gate: torch.Tensor, dtot: torch.Tensor,
                  out: Optional[torch.Tensor] = None, mode: str = "scale"):
    """K11b. ``dx = cdt(cdt(g * gate) + cdt(dtot))`` in dout's layout (x's:
    the saved output's, or dout's own in the scale mode); in the residual
    mode ``(dx, didn)``, ``didn = g`` the identity's gradient. gate (B, C)
    in cdt, dtot (B, C) in acc."""
    if is_plain("se_grad_apply", dy):
        return se_grad_apply_plain(dy, gate, dtot, out, mode)
    m = _mode(mode)
    if m:
        _check("se_grad_apply", out, (("dout", dy),),
               (("gate", gate, out.dtype), ("dtot", dtot, ACC[out.dtype])))
        dy = like(dy, out)
    else:
        if not (dy.is_contiguous() or dy.is_contiguous(
                memory_format=torch.channels_last)):
            dy = dy.contiguous()
        _check("se_grad_apply", dy, (),
               (("gate", gate, dy.dtype), ("dtot", dtot, ACC[dy.dtype])))
    dx = torch.empty_like(dy)
    didn = torch.empty_like(dy) if m else None
    p = apply_plan(dy, dx, *([out, didn] if m else []))
    n, hw, c = sizes(dy)
    with device_guard(dy.device):
        launch("se_grad_apply", "insarseg_se_grad_apply", dy.data_ptr(),
               out.data_ptr() if m else None, gate.data_ptr(),
               dtot.data_ptr(), dx.data_ptr(),
               None if didn is None else didn.data_ptr(), n, hw, c,
               p.blocks, p.per, DTYPES[dy.dtype], p.layout, p.vec, m,
               stream_of(dy))
    return (dx, didn) if m else dx


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------

def _mats(w1: torch.Tensor, w2: torch.Tensor, dt: torch.dtype):
    """The MLP's weights as matrices (a Linear's (C/r, C), a 1x1 conv's
    viewed so) in the compute dtype."""
    return (w1.reshape(w1.shape[0], -1).to(dt),
            w2.reshape(w2.shape[0], -1).to(dt))


def _gate(mean: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor):
    """``(h, gate)``: ``h = relu(fc1(mean))`` and ``gate = 1 / (1 +
    exp(-fc2(h)))`` on (B, C) ``mean`` with the weight matrices ``m1``,
    ``m2`` in its dtype, each op rounded to it: the JAX program's
    ``logistic`` (in bf16 its value bit for bit; ``torch.sigmoid`` rounds
    once and differs in about 3% of the bf16 values)."""
    h = torch.relu(F.linear(mean, m1))
    return h, torch.reciprocal(torch.exp(F.linear(h, m2).neg_()).add_(1))


def _gate_vjp(dgate, mean, h, gate, m1, m2, w1, w2):
    """The MLP's VJP in the JAX program's order and dtype: ``(dmean, dw1,
    dw2)``, the weights' gradients in their own dtype and shape."""
    dz = dgate * (gate * (1 - gate))
    dh = (dz @ m2) * (h > 0)
    dw2 = (dz.t() @ h).to(w2.dtype).reshape(w2.shape)
    dw1 = (dh.t() @ mean).to(w1.dtype).reshape(w1.shape)
    return dh @ m1, dw1, dw2


class _SE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, w2, identity, mode, reduce, count):
        sums = se_squeeze(x)
        if reduce is not None:
            sums = reduce(sums)
        # f64 -> cdt rounds through f32 (torch's conversion), as acc(.)
        mean = (sums / count).to(x.dtype)
        m1, m2 = _mats(w1, w2, x.dtype)
        h, gate = _gate(mean, m1, m2)
        out = se_excite(x, gate, identity, mode)
        # the residual mode's mask is the saved output's sign
        ctx.save_for_backward(x, w1, w2, m1, m2, mean, h, gate,
                              out if mode == "residual" else None)
        ctx.mode, ctx.reduce, ctx.count = mode, reduce, count
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, w2, m1, m2, mean, h, gate, out = ctx.saved_tensors
        dgate = se_grad_stats(dout, x, out, ctx.mode).to(x.dtype)
        # this slab's weight gradients (the step sums the ranks'
        # gradients) and the mean's cotangent
        dmean, dw1, dw2 = _gate_vjp(dgate, mean, h, gate, m1, m2, w1, w2)
        dtot = dmean.to(ACC[x.dtype]).div_(ctx.count)
        if ctx.reduce is not None:
            dtot = ctx.reduce(dtot)
        dx = se_grad_apply(dout, gate, dtot, out, ctx.mode)
        didn = None
        if ctx.mode == "residual":
            dx, didn = dx
        return dx, dw1, dw2, didn, None, None, None


def se_train(x: torch.Tensor, fc1_w: torch.Tensor, fc2_w: torch.Tensor,
             identity: Optional[torch.Tensor] = None, mode: str = "scale",
             reduce: Reduce = None,
             count: Optional[int] = None) -> torch.Tensor:
    """The squeeze-excite tail in train mode on K10a, K10b (forward) and
    K11a, K11b (backward): ``out = cdt(x * gate)`` (``"scale"``) or
    ``relu(cdt(cdt(x * gate) + identity))`` (``"residual"``; the identity
    gets its gradient), ``gate = sigmoid(fc2(relu(fc1(mean_hw(x)))))``.
    ``x`` (B, C, H, W) NCHW or channels-last in the compute dtype;
    ``fc1_w`` (C/r, C) and ``fc2_w`` (C, C/r), a Linear's weights or a 1x1
    conv's (C/r, C, 1, 1), in any float dtype (cast to x's; they get their
    gradients through the cast). ``reduce`` sums a (B, C) buffer over the
    slabs of a spatial mesh and returns it (None unsharded): K10a's sums in
    the forward pass and the mean's cotangent in the backward pass;
    ``count`` the whole map's H W (x's own by default)."""
    if (_mode(mode) == 1) != (identity is not None):
        raise ValueError("se_train: an identity goes with the residual mode "
                         "and only with it")
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        x = x.contiguous()
    count = x.shape[2] * x.shape[3] if count is None else count
    return _SE.apply(x, fc1_w, fc2_w, identity, mode, reduce, count)
