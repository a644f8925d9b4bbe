"""Layer helpers for the port (counterpart of ``insarseg/ops/layers.py``).

Conv, ConvTranspose and Linear are :class:`Conv2d`, :class:`ConvTranspose2d`
and :class:`Linear`, ``nn.Conv2d`` / ``nn.ConvTranspose2d`` / ``nn.Linear``
that compute in their input's dtype; BatchNorm is ``nn.BatchNorm2d`` (eps
1e-5), except where a train step can meet one value per channel
(:class:`MomentBatchNorm2d`); all under the reference's names. What the
packed graphs need beyond them lives here. Internally the float
graphs run NCHW (cuDNN's native layout); the public functions convert at
their NHWC boundary with :func:`nhwc_to_nchw` / :func:`nchw_to_nhwc`.

The compute dtype (``Config.compute_dtype``, bf16 or f32) is the dtype
of the input a model is given, and every layer follows it, as the JAX
package's layers do with ``dtype=None`` and its ``dtype=bfloat16``
models do after their first conv (``insarseg/ops/layers.py:55-63``):

- a conv, transposed conv or linear layer casts its f32 parameters to
  the input's dtype on each call, so the parameters, their gradients and
  Adam's state stay f32 and the gradient reaches them through the cast;
- BatchNorm takes a bf16 input with f32 parameters and statistics, keeps
  the statistics f32 and returns bf16 (``nn.BatchNorm2d`` does this on
  the CPU and on cuDNN; :class:`MomentBatchNorm2d` sums in at least f32);
- ReLU, pooling, the attention gates, resizes and concats follow their
  input; the integral image sums in f32 and casts back
  (:func:`integral_image`); the loss promotes the logits to f32.

``torch.autocast`` is not used: its op lists differ between the CPU and
CUDA (CUDA runs ``cumsum``, ``sum`` and ``rsqrt`` in f32, the CPU keeps
``cumsum`` in bf16), so the CPU tests and the card would run other
rules, and neither list is the JAX package's "follow the input".
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def follow(x: torch.Tensor, p: Optional[torch.Tensor]
           ) -> Optional[torch.Tensor]:
    """Parameter ``p`` in ``x``'s dtype (itself when they agree)."""
    return p if p is None or p.dtype == x.dtype else p.to(x.dtype)


def _spatial():
    """The active spatial context (``parallel/spatial.py``), or None: the
    H axis is then sharded and ``x`` is a slab of it."""
    from insarseg_torch.parallel.spatial import current

    return current()


def _not_local(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} reaches across the H slabs of a spatial mesh; "
        "insarseg_torch shards H for the U-Net families only (ROADMAP "
        "Queue 1 item 21b)")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (f32 parameters cast per call).

    Under a spatial context (``parallel/spatial.py``) a conv of H extent
    above 1 takes its H padding from the neighbouring slabs
    (``spatial.halo``) and convolves with padding ``(0, pw)``: the slab's
    rows of the unsharded conv. It must be a "same" conv of stride 1."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, follow(x, self.weight),
                                  follow(x, self.bias))

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        comm = _spatial()
        if comm is None:
            return super()._conv_forward(x, weight, bias)
        from insarseg_torch.parallel.spatial import halo

        (sh, _), (ph, pw), (dh, _) = self.stride, self.padding, self.dilation
        if sh != 1 or 2 * ph != dh * (self.kernel_size[0] - 1) \
                or self.padding_mode != "zeros":
            raise _not_local(f"a conv of kernel {self.kernel_size}, stride "
                             f"{self.stride}, padding {self.padding}")
        return F.conv2d(halo(x, ph, comm), weight, bias, self.stride,
                        (0, pw), self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype (no ``output_size``).
    Under a spatial context only its slab-local form runs (kernel equal to
    the stride along H, no padding: the U-Net's 2x2 / 2)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _spatial() is not None and (
                self.kernel_size[0] != self.stride[0] or self.padding[0]):
            raise _not_local(f"a transposed conv of kernel "
                             f"{self.kernel_size}, stride {self.stride}")
        return F.conv_transpose2d(
            x, follow(x, self.weight), follow(x, self.bias), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, follow(x, self.weight), follow(x, self.bias))


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks of the process group whose gradient is the
    sum over the ranks of the gradient (every rank's output depends on
    every rank's input)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def _ranks_sum(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t)
    return t


class MomentBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are the JAX
    package's (``insarseg/ops/layers.py::BatchNorm2d``): the batch mean
    and the biased variance ``max(E[x^2] - E[x]^2, 0)`` in at least f32,
    the running variance the unbiased ``n / max(n - 1, 1)`` estimate,
    momentum 0.1. At one value per channel (a 1x1 pooled map at batch 1)
    the variance is 0 and the output the bias, where ``nn.BatchNorm2d``
    raises. Eval mode and the state_dict names are ``nn.BatchNorm2d``'s.

    ``synced`` (set by ``parallel/mesh.py::sync_batchnorm``): inside a
    ``torch.distributed`` group the moments are the global batch's, as
    the JAX package's BatchNorm under a ``data`` mesh (GSPMD reduces them
    over the whole batch): the per-channel sums of x and x^2 and the
    count, in at least f32, summed over the ranks in one differentiable
    all-reduce (:class:`_AllReduceSum`), the running variance's factor
    from the global count. Uneven shards and empty ones are fine.
    ``nn.SyncBatchNorm`` takes no CPU tensors and would lose the moment
    rule at one value per channel."""

    synced = False

    @classmethod
    def taking_over(cls, bn: nn.BatchNorm2d) -> "MomentBatchNorm2d":
        """A synced one holding ``bn``'s parameter and buffer objects."""
        if bn.momentum is None or not (bn.affine and bn.track_running_stats):
            raise ValueError("sync BatchNorm needs an affine BatchNorm2d "
                             "with running statistics and a momentum")
        new = cls(bn.num_features, eps=bn.eps, momentum=bn.momentum,
                  device="meta")
        new.weight, new.bias = bn.weight, bn.bias
        for k in ("running_mean", "running_var", "num_batches_tracked"):
            setattr(new, k, getattr(bn, k))
        new.synced = True
        return new.train(bn.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mean, var, unbias = self._moments(xf)
        with torch.no_grad():
            m = self.momentum
            rm, rv = self.running_mean, self.running_var
            rm.copy_((1.0 - m) * rm + m * mean.to(rm.dtype))
            rv.copy_((1.0 - m) * rv + m * (var * unbias).to(rv.dtype))
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        y = (xf - mean[:, None, None]) * inv[:, None, None] \
            + self.bias.to(acc)[:, None, None]
        return y.to(x.dtype)

    def ranks_sum(self):
        """When this BatchNorm is ``synced`` inside a process group, a
        function that sums a tensor over the ranks in place and returns
        it; else None (the moments are this process's batch's)."""
        if self.synced and dist.is_available() and dist.is_initialized():
            return _ranks_sum
        return None

    def _moments(self, xf: torch.Tensor):
        """The batch's mean and biased variance per channel, and the
        running variance's factor ``n / max(n - 1, 1)``."""
        if self.ranks_sum() is not None:
            c = xf.shape[1]
            sums = torch.cat([xf.sum(dim=(0, 2, 3)),
                              xf.square().sum(dim=(0, 2, 3)),
                              xf.new_full((1,), xf.numel() // c)])
            sums = _AllReduceSum.apply(sums)
            n = sums[2 * c].detach()
            mean = sums[:c] / n
            var = (sums[c:2 * c] / n - mean.square()).clamp_min(0)
            return mean, var, n / (n - 1).clamp_min(1)
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0)
        n = xf.numel() // xf.shape[1]
        return mean, var, n / max(n - 1, 1)


def max_pool_2d(x: torch.Tensor, window: int = 2, stride=None,
                padding: int = 0) -> torch.Tensor:
    """``nn.MaxPool2d(window, stride, padding)`` (floor mode; the padding
    acts as -inf) over NCHW float tensors; under a spatial context only
    its slab-local form (window = stride, no padding)."""
    if _spatial() is not None and (stride not in (None, window) or padding):
        raise _not_local(f"a {window}x{window} / {stride} max-pool")
    return F.max_pool2d(x, window, stride, padding)


def spatial_mean(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean over H and W of NCHW ``x``: ``x.mean(dim=(2, 3))``, or under
    a spatial context the slab's sum in at least f32 summed over the slabs
    (``spatial.spatial_sum``), divided by the whole image's H·W and
    rounded to ``x``'s dtype once."""
    comm = _spatial()
    if comm is None:
        return x.mean(dim=(2, 3), keepdim=keepdim)
    from insarseg_torch.parallel.spatial import spatial_sum

    acc = torch.promote_types(x.dtype, torch.float32)
    total = spatial_sum(x.sum(dim=(2, 3), keepdim=keepdim, dtype=acc), comm)
    return (total / (x.shape[2] * x.shape[3] * comm.size)).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``AdaptiveAvgPool2d(1)`` over NCHW: (B, C, 1, 1) (over every slab
    under a spatial context, :func:`spatial_mean`)."""
    return spatial_mean(x, keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """``AdaptiveMaxPool2d(1)`` over NCHW: (B, C, 1, 1) (CBAM's channel
    attention, a ResNet family's: not under a spatial context)."""
    if _spatial() is not None:
        raise _not_local("a global max-pool")
    return x.amax(dim=(2, 3), keepdim=True)


def gate_mlp(pk, v: torch.Tensor) -> torch.Tensor:
    """An attention gate's bias-free MLP, ``relu(v @ fc1) @ fc2`` over
    (B, C) ``v`` in ``v``'s dtype (``pk`` holds ``fc1`` and ``fc2``), each
    product summed in float64 and rounded once. A GEMM's f32 sum order
    depends on its row count on the card (cuBLAS picks its kernel by M),
    so f32 products would give a tile other gates, and other codes, in
    another batch; a float64 sum rounded once gives each row the same
    gate at any batch."""
    h = torch.relu((v.double() @ pk["fc1"].double()).to(v.dtype))
    return (h.double() @ pk["fc2"].double()).to(v.dtype)


def _bin_edges(n: int, o: int, device: torch.device):
    """torch's variable-window rule: bin i covers [floor(i n / o),
    ceil((i + 1) n / o)), as integer tensors made on ``device`` (an index
    list would be copied from host memory, which synchronises the
    stream)."""
    i = torch.arange(o, device=device)
    return (i * n) // o, ((i + 1) * n + o - 1) // o


def _pair(size: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


def integral_image(x: torch.Tensor) -> torch.Tensor:
    """The f32 integral image of NCHW ``x``, channels innermost, with a
    leading zero row and column: (N, H + 1, W + 1, C). Channels innermost
    make both scans run over outer dimensions, which the card scans in
    parallel over the (W, C) or C elements within (a scan along the
    innermost dimension of 65-element rows took 19 ms of a PSPNet forward
    at 512^2 b8 on an H100)."""
    ii = x.to(torch.float32).permute(0, 2, 3, 1).contiguous()
    return F.pad(ii.cumsum(1).cumsum(2), (0, 0, 1, 0, 1, 0))


def pool_from_integral(ii: torch.Tensor,
                       output_size: Union[int, Tuple[int, int]],
                       dtype: torch.dtype) -> torch.Tensor:
    """The adaptive average pool read from :func:`integral_image`: the four
    corners gathered per bin, the difference divided by the bin's area,
    NCHW in ``dtype``."""
    oh, ow = _pair(output_size)
    h, w = ii.shape[1] - 1, ii.shape[2] - 1
    hs, he = _bin_edges(h, oh, ii.device)
    ws, we = _bin_edges(w, ow, ii.device)

    def corner(r, c):
        return ii.index_select(1, r).index_select(2, c)

    s = corner(he, we) - corner(hs, we) - corner(he, ws) + corner(hs, ws)
    area = ((he - hs)[:, None] * (we - ws)[None, :]).to(torch.float32)
    return (s / area[:, :, None]).permute(0, 3, 1, 2).to(dtype)


def adaptive_avg_pools(x: torch.Tensor,
                       sizes: Sequence[Union[int, Tuple[int, int]]]
                       ) -> List[torch.Tensor]:
    """``nn.AdaptiveAvgPool2d`` over NCHW at each of ``sizes`` in the JAX
    package's form (``insarseg/ops/layers.py::adaptive_avg_pool_2d``): the
    input itself where the size is its own, the global mean at 1, else an
    f32 integral image (built once for all sizes) read per bin and cast
    back to ``x``'s dtype. ``F.adaptive_avg_pool2d`` sums in another
    order."""
    ii = None
    out = []
    sharded = _spatial() is not None
    for size in sizes:
        o = _pair(size)
        if sharded and o != (1, 1):
            raise _not_local(f"an adaptive average pool to {o}")
        if tuple(x.shape[-2:]) == o:
            out.append(x)
        elif o == (1, 1):
            out.append(global_avg_pool(x))
        else:
            if ii is None:
                ii = integral_image(x)
            out.append(pool_from_integral(ii, o, x.dtype))
    return out


def adaptive_avg_pool_2d(x: torch.Tensor,
                         output_size: Union[int, Tuple[int, int]]
                         ) -> torch.Tensor:
    """One size of :func:`adaptive_avg_pools`."""
    return adaptive_avg_pools(x, [output_size])[0]
