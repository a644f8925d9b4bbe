"""K10a ``se_squeeze``, K10b ``se_excite``, K11a ``se_grad_stats`` and
K11b ``se_grad_apply``: the squeeze-excite tail of the JAX package's train
step, forward and backward, in three modes (:data:`MODES`) of the same
four kernels:

- ``"scale"``: ``cdt(x * gate)``, the U-Net's ``SELayer`` (the DoubleConv's
  SE tail, ``insarseg/ops/blocks.py:46-64``, ``:135-136``);
- ``"residual"``: ``relu(cdt(cdt(x * gate) + identity))``, a CA ResNet's
  ``SEBlock`` after bn3 with the residual add and its ReLU
  (``insarseg/models/resnet.py:87-99``, ``insarseg/ops/blocks.py:67-86``);
- ``"cbam"``: ``cdt(x * gate)`` with ``gate = sigmoid(cdt(mlp(mean) +
  mlp(max)))``, one shared MLP on the mean and the max over H and W:
  CBAM's channel attention, DeepLabV3-CA's ``ChannelAttentionModule``
  (``insarseg/ops/blocks.py:89-111``, ``insarseg/models/deeplab.py:114``;
  :func:`cbam_train`).

``gate = sigmoid(fc2(relu(fc1(mean))))`` with ``mean`` the mean of ``x``
over H and W (scale, residual). Kernels:
``insarseg_torch/csrc/se_train.cu``. With ``cdt`` the compute dtype
(``x``'s: bf16, f32 or f64) and ``acc`` = ``promote(cdt, f32)``:

- K10a: the per-(b, c) sums of x over H and W in f64 (B, C); in the cbam
  mode also the max over H and W (B, C) in cdt and the count of positions
  equal to it (B, C) int32;
- K10b: ``cdt(x * gate[b, c])``, in the residual mode then ``relu(cdt(. +
  identity))`` (the cbam mode runs the scale code);
- K11a: ``g = dout`` (in the residual mode masked by the saved output's
  sign, ``out > 0``), and the per-(b, c) sums of ``cdt(g * x)`` in f64:
  the gate's cotangent, the JAX VJP's bf16 product summed (the cbam mode
  runs the scale code);
- K11b: ``dx = cdt(cdt(g * gate) + cdt(dtot))``, ``dtot`` the mean's
  cotangent over H W (the JAX VJP adds the rescale's and the mean's
  cotangents of x in cdt, each rounded to it); in the residual mode also
  ``didn = g``, the identity's gradient; in the cbam mode ``dx =
  cdt(cdt(cdt(g * gate) + tie) + cdt(dtot))`` with ``tie = cdt(acc(dmax)
  / acc(cdt(count)))`` where x equals the max, else 0: the order of the
  JAX VJP's jaxpr, whose reduce-max VJP splits the max's cotangent over
  its ties by a count summed in cdt (``jax/_src/lax/lax.py``,
  ``_reduce_chooser_jvp_rule``), as ``sa_train``'s K13b does over C.

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
The cbam mode's function (:func:`cbam_train`) runs the MLP twice, sums
the two outputs in cdt, and in the backward pass the MLP's VJP on both
branches, max first as the jaxpr does, each weight's two gradients
rounded to cdt and added in the weight's dtype. Under a spatial mesh it
takes the whole map's max as the slabs' largest and its count as the
sum of the counts of the slabs whose max equals it
(``parallel/spatial.py::_Max``'s rule), and sums the max's cotangent over
the slabs as it sums ``dtot``.

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
# SCALE / RESIDUAL / CBAM; x's dtype: ``_lib.DTYPES``)
MODES = {"scale": 0, "residual": 1, "cbam": 2}
SCALE, RESIDUAL, CBAM = MODES["scale"], MODES["residual"], MODES["cbam"]

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
# per (device, stream): the reductions' partial sums (and the cbam mode's
# partial maxes and counts after them) and counters (zero between
# launches: each launch's last blocks reset theirs), at least the sizes of
# a bf16 512^2 b8 U-Net step's largest site
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


def _residual(mode: str) -> bool:
    return _mode(mode) == RESIDUAL


def _masked(dy: torch.Tensor, out: Optional[torch.Tensor],
            mode: str) -> torch.Tensor:
    """g: dout, in the residual mode where the saved output is > 0 (a
    product with the mask: the kernels' select for a finite dout)."""
    return dy * (out > 0) if _residual(mode) else dy


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def se_squeeze_plain(x: torch.Tensor, mode: str = "scale"):
    sums = x.to(torch.float64).sum(dim=(2, 3))
    if _mode(mode) != CBAM:
        return sums
    n, c, h, w = x.shape
    if h * w == 0:  # the max's identity
        return (sums, x.new_full((n, c), -math.inf),
                x.new_zeros((n, c), dtype=torch.int32))
    mx = x.amax(dim=(2, 3))
    return sums, mx, (x == _col(mx)).sum(dim=(2, 3), dtype=torch.int32)


def se_excite_plain(x: torch.Tensor, gate: torch.Tensor,
                    identity: Optional[torch.Tensor] = None,
                    mode: str = "scale") -> torch.Tensor:
    out = x * _col(gate)
    return torch.relu(out + identity) if _residual(mode) else out


def se_grad_stats_plain(dy: torch.Tensor, x: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        mode: str = "scale") -> torch.Tensor:
    return (_masked(dy, out, mode) * x).to(torch.float64).sum(dim=(2, 3))


def se_grad_apply_plain(dy: torch.Tensor, gate: torch.Tensor,
                        dtot: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        mode: str = "scale",
                        x: Optional[torch.Tensor] = None,
                        mx: Optional[torch.Tensor] = None,
                        count: Optional[torch.Tensor] = None,
                        dmax: Optional[torch.Tensor] = None):
    g = _masked(dy, out, mode)
    dx = g * _col(gate)
    if _mode(mode) == CBAM:
        acc, dt = ACC[dy.dtype], dy.dtype
        tie = (dmax.to(acc) / count.to(dt).to(acc)).to(dt)
        dx = dx + _col(tie) * (x == _col(mx)).to(dt)
    dx = dx + _col(dtot.to(dy.dtype))
    return (dx, g) if _residual(mode) else dx


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


def _workspace(x: torch.Tensor, stream: int, p: Plan,
               parts: int = 1) -> Tuple[int, int]:
    """K10a / K11a's workspace on (x's device, stream) for plan ``p``
    (``_lib.workspace``): ``parts`` (B, C) partials a slice (the cbam
    mode's K10a: the sum, the max, the count)."""
    n, c = x.shape[:2]
    return workspace(_WORK, x, stream, parts * p.blocks * n * c
                     if p.blocks > 1 else 0, p.groups, WORK_SUMS,
                     WORK_COUNTERS)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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


def se_squeeze(x: torch.Tensor, mode: str = "scale"):
    """K10a. x (B, C, H, W) -> the per-(b, c) sums over H and W, (B, C)
    f64; in the cbam mode ``(sums, max, count)``: the max over H and W
    (B, C) in x's dtype and the positions equal to it (B, C) int32 (a map
    of no pixel: -inf and 0)."""
    if is_plain("se_squeeze", x):
        return se_squeeze_plain(x, mode)
    m = _mode(mode)
    _check("se_squeeze", x)
    p = reduce_plan(x)
    n, hw, c = sizes(x)
    sums = x.new_empty((n, c), dtype=torch.float64)
    mx = cnt = None
    if m == CBAM:
        mx = x.new_empty((n, c))
        cnt = x.new_empty((n, c), dtype=torch.int32)
    with device_guard(x.device):
        stream = stream_of(x)
        ws, counters = _workspace(x, stream, p, 3 if m == CBAM else 1)
        launch("se_squeeze", "insarseg_se_squeeze", x.data_ptr(), ws,
               counters, sums.data_ptr(), _ptr(mx), _ptr(cnt), n, hw, c,
               p.blocks, p.per, DTYPES[x.dtype], p.layout, p.vec, m, stream)
    return (sums, mx, cnt) if m == CBAM else sums


def se_excite(x: torch.Tensor, gate: torch.Tensor,
              identity: Optional[torch.Tensor] = None,
              mode: str = "scale") -> torch.Tensor:
    """K10b. ``cdt(x * gate)``, or in the residual mode ``relu(cdt(. +
    identity))``, in x's layout; gate (B, C) in x's dtype."""
    if is_plain("se_excite", x):
        return se_excite_plain(x, gate, identity, mode)
    m = _mode(mode)
    res = m == RESIDUAL
    _check("se_excite", x, (("identity", identity),) if res else (),
           (("gate", gate, x.dtype),))
    r = like(identity, x) if res else None
    out = torch.empty_like(x)
    p = apply_plan(x, out, *([r] if res else []))
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
    res = m == RESIDUAL
    _check("se_grad_stats", x,
           (("dout", dy),) + ((("out", out),) if res else ()))
    dy = like(dy, x)
    o = like(out, x) if res else None
    p = reduce_plan(x, dy, *([o] if res else []))
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
                  out: Optional[torch.Tensor] = None, mode: str = "scale",
                  x: Optional[torch.Tensor] = None,
                  mx: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None,
                  dmax: Optional[torch.Tensor] = None):
    """K11b. ``dx = cdt(cdt(g * gate) + cdt(dtot))`` in dout's layout (x's:
    the saved output's, or dout's own in the scale mode); in the residual
    mode ``(dx, didn)``, ``didn = g`` the identity's gradient; in the cbam
    mode the max's cotangent ``dmax`` split over the ties of K10a's ``mx``
    and ``count`` added before dtot, in x's layout. gate, mx and dmax
    (B, C) in cdt, count (B, C) int32, dtot (B, C) in acc."""
    if is_plain("se_grad_apply", dy):
        return se_grad_apply_plain(dy, gate, dtot, out, mode, x, mx, count,
                                   dmax)
    m = _mode(mode)
    if m == RESIDUAL:
        _check("se_grad_apply", out, (("dout", dy),),
               (("gate", gate, out.dtype), ("dtot", dtot, ACC[out.dtype])))
        dy = like(dy, out)
    elif m == CBAM:
        _check("se_grad_apply", x, (("dout", dy),),
               (("gate", gate, x.dtype), ("dtot", dtot, ACC[x.dtype]),
                ("mx", mx, x.dtype), ("count", count, torch.int32),
                ("dmax", dmax, x.dtype)))
        dy = like(dy, x)
    else:
        if not (dy.is_contiguous() or dy.is_contiguous(
                memory_format=torch.channels_last)):
            dy = dy.contiguous()
        _check("se_grad_apply", dy, (),
               (("gate", gate, dy.dtype), ("dtot", dtot, ACC[dy.dtype])))
    dx = torch.empty_like(dy)
    didn = torch.empty_like(dy) if m == RESIDUAL else None
    # the third operand: the saved output (residual) or x (cbam)
    o = out if m == RESIDUAL else x if m == CBAM else None
    p = apply_plan(dy, dx, *[t for t in (o, didn) if t is not None])
    n, hw, c = sizes(dy)
    with device_guard(dy.device):
        launch("se_grad_apply", "insarseg_se_grad_apply", dy.data_ptr(),
               _ptr(o), gate.data_ptr(), dtot.data_ptr(), _ptr(mx),
               _ptr(count), _ptr(dmax), dx.data_ptr(), _ptr(didn), n, hw,
               c, p.blocks, p.per, DTYPES[dy.dtype], p.layout, p.vec, m,
               stream_of(dy))
    return (dx, didn) if m == RESIDUAL else dx


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
        sums = se_squeeze(x, mode)
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
    if _mode(mode) == CBAM:
        raise ValueError("se_train: the cbam mode is cbam_train's")
    if _residual(mode) != (identity is not None):
        raise ValueError("se_train: an identity goes with the residual mode "
                         "and only with it")
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        x = x.contiguous()
    count = x.shape[2] * x.shape[3] if count is None else count
    return _SE.apply(x, fc1_w, fc2_w, identity, mode, reduce, count)


# ---------------------------------------------------------------------------
# the cbam mode: CBAM's channel attention
# ---------------------------------------------------------------------------

def _cbam_gate(mean: torch.Tensor, mx: torch.Tensor, m1: torch.Tensor,
               m2: torch.Tensor):
    """``(h_mean, h_max, gate)``: the shared MLP's hidden layers on the
    (B, C) mean and max, ``gate = logistic(cdt(fc2(h_mean) +
    fc2(h_max)))``, each op rounded to the compute dtype (``_gate``'s
    ``logistic``)."""
    ha = torch.relu(F.linear(mean, m1))
    hm = torch.relu(F.linear(mx, m1))
    z = F.linear(ha, m2) + F.linear(hm, m2)
    return ha, hm, torch.reciprocal(torch.exp(z.neg_()).add_(1))


def _cbam_vjp(dgate, mean, mx, ha, hm, gate, m1, m2, w1, w2):
    """The shared MLP's VJP on both branches in the JAX program's order and
    dtype: ``(dmean, dmax, dw1, dw2)``; each weight's gradient is its two
    branches' products rounded to cdt, cast to the weight's dtype and
    added there (the jaxpr's ``add_any`` after each use's cast)."""
    dz = dgate * (gate * (1 - gate))
    d = dz @ m2
    dhm, dha = d * (hm > 0), d * (ha > 0)
    dw2 = (dz.t() @ hm).to(w2.dtype) + (dz.t() @ ha).to(w2.dtype)
    dw1 = (dhm.t() @ mx).to(w1.dtype) + (dha.t() @ mean).to(w1.dtype)
    return dha @ m1, dhm @ m1, dw1.reshape(w1.shape), dw2.reshape(w2.shape)


class _CBAM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, w2, comm, count):
        sums, mx, ties = se_squeeze(x, "cbam")
        if comm is not None:
            # the whole map's sums, max, and the ties of the slabs whose
            # max is the whole map's
            sums = comm.sum(sums)
            whole = comm.max(mx.to(torch.float64)).to(x.dtype)
            ties = comm.sum(torch.where(mx == whole, ties,
                                        torch.zeros_like(ties)))
            mx = whole
        mean = (sums / count).to(x.dtype)
        m1, m2 = _mats(w1, w2, x.dtype)
        ha, hm, gate = _cbam_gate(mean, mx, m1, m2)
        out = se_excite(x, gate, None, "cbam")
        ctx.save_for_backward(x, w1, w2, m1, m2, mean, mx, ties, ha, hm,
                              gate)
        ctx.comm, ctx.count = comm, count
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, w2, m1, m2, mean, mx, ties, ha, hm, gate = ctx.saved_tensors
        dgate = se_grad_stats(dout, x, None, "cbam").to(x.dtype)
        dmean, dmax, dw1, dw2 = _cbam_vjp(dgate, mean, mx, ha, hm, gate, m1,
                                          m2, w1, w2)
        acc = ACC[x.dtype]
        dtot = dmean.to(acc).div_(ctx.count)
        if ctx.comm is not None:
            dtot = ctx.comm.sum(dtot)
            dmax = ctx.comm.sum(dmax.to(acc)).to(x.dtype)
        dx = se_grad_apply(dout, gate, dtot, None, "cbam", x=x, mx=mx,
                           count=ties, dmax=dmax)
        return dx, dw1, dw2, None, None


def cbam_train(x: torch.Tensor, fc1_w: torch.Tensor, fc2_w: torch.Tensor,
               comm=None, count: Optional[int] = None) -> torch.Tensor:
    """CBAM's channel attention in train mode on K10a, K10b (forward) and
    K11a, K11b (backward) in the cbam mode: ``out = cdt(x * gate)``, ``gate
    = sigmoid(mlp(mean_hw(x)) + mlp(max_hw(x)))``, ``mlp = fc2(relu(fc1(
    .)))`` shared by both. ``x`` (B, C, H, W) NCHW or channels-last in the
    compute dtype; ``fc1_w`` (C/r, C) and ``fc2_w`` (C, C/r), or 1x1 convs'
    (C/r, C, 1, 1), in any float dtype (cast to x's). ``comm`` the spatial
    context whose slabs make the map (its ``sum`` and ``max``), None
    unsharded; ``count`` the whole map's H W (x's own by default)."""
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        x = x.contiguous()
    count = x.shape[2] * x.shape[3] if count is None else count
    return _CBAM.apply(x, fc1_w, fc2_w, comm, count)
