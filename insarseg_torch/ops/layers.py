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

import math
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


def _not_sharded(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not a layer the port runs with its H axis sharded: a "
        "spatial mesh runs the registry's families (models/registry.py)")


def _same_along_h(k: int, padding: int, dilation: int = 1) -> bool:
    """Whether a window of ``k`` rows, dilation ``dilation`` and padding
    ``padding`` is "same" along H (``2 p == d (k - 1)``): its H padding is
    a halo of ``padding`` rows."""
    return 2 * padding == dilation * (k - 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (f32 parameters cast per call).

    Under a spatial context (``parallel/spatial.py``) a conv with an H
    extent above 1 or a stride runs as a window along H
    (``spatial.windowed``): the rows its windows read past the slab, its
    H padding among them, come from the slabs around it (as many slabs as
    it reaches), and it convolves with padding ``(0, pw)``: the slab's
    rows of the unsharded conv, at any stride and dilation and on a slab
    of any height, none too. It must be "same" along H (``2 ph == dh (kh
    - 1)``: the ResNets' stem 7x7 / 2, their strided 3x3 and 1x1 / 2, the
    dilated 3x3s, every 3x3 / 1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, follow(x, self.weight),
                                  follow(x, self.bias))

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        comm = _spatial()
        (kh, _), (sh, _) = self.kernel_size, self.stride
        if comm is None or (kh == 1 and sh == 1 and x.shape[2]):
            return super()._conv_forward(x, weight, bias)
        from insarseg_torch.parallel.spatial import windowed

        (ph, pw), (dh, _) = self.padding, self.dilation
        if not _same_along_h(kh, ph, dh) or self.padding_mode != "zeros":
            raise _not_sharded(f"a conv of kernel {self.kernel_size}, "
                               f"padding {self.padding}, dilation "
                               f"{self.dilation}")
        return windowed(lambda t: F.conv2d(t, weight, bias, self.stride,
                                           (0, pw), self.dilation,
                                           self.groups),
                        x, dh * (kh - 1) + 1, sh, ph, comm)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype (no ``output_size``).
    Under a spatial context only its slab-local form runs (kernel equal to
    the stride along H, no padding: the U-Net's 2x2 / 2, whose output
    rows are the input's scaled, ``spatial.Rows.scaled``), on a slab of
    any height, none too."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        comm = _spatial()
        if comm is not None and (
                self.kernel_size[0] != self.stride[0] or self.padding[0]):
            raise _not_sharded(f"a transposed conv of kernel "
                               f"{self.kernel_size}, stride {self.stride}")

        def up(t):
            return F.conv_transpose2d(
                t, follow(x, self.weight), follow(x, self.bias), self.stride,
                self.padding, self.output_padding, self.groups, self.dilation)

        if comm is not None and not x.shape[2]:
            from insarseg_torch.parallel.spatial import empty_out

            return empty_out(up, x, 1, 0.0)
        return up(x)


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
    rule at one value per channel.

    ``replicated`` (the pooled maps' BatchNorms: DeepLabV3's ASPP pool,
    the PSPNet's bins): under a spatial context its input is the same map
    on every slab of a data row (``parallel/spatial.py``), so the synced
    sums and count hold each data row S times; the mean, the variance and
    their gradients are unchanged by that, and the running variance's
    factor takes the count of the rows themselves, ``n / S``, as the JAX
    package's mesh step counts them."""

    synced = False
    replicated = False

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
            comm = _spatial()
            rows = n / comm.size if self.replicated and comm is not None \
                else n
            return mean, var, rows / (rows - 1).clamp_min(1)
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0)
        n = xf.numel() // xf.shape[1]
        return mean, var, n / max(n - 1, 1)


def max_pool_2d(x: torch.Tensor, window: int = 2, stride=None,
                padding: int = 0) -> torch.Tensor:
    """``nn.MaxPool2d(window, stride, padding)`` (floor mode; the padding
    acts as -inf) over NCHW float tensors. Under a spatial context it runs
    as a window along H (``spatial.windowed``): the rows its windows read
    past the slab from a -inf halo, the slab's rows of the unsharded pool
    on a slab of any height (the U-Net's 2 x 2 / 2 of an odd map drops
    its last row, as unsharded)."""
    comm = _spatial()
    stride = window if stride is None else stride
    if comm is None:
        return F.max_pool2d(x, window, stride, padding)
    from insarseg_torch.parallel.spatial import windowed

    return windowed(lambda t: F.max_pool2d(t, window, stride, (0, padding)),
                    x, window, stride, padding, comm, fill=-math.inf)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` through :func:`max_pool_2d` (the U-Net's
    ``down{i}.0``: no parameters, the state_dict names unchanged)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2d(x, self.kernel_size, self.stride, self.padding)


def spatial_mean(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean over H and W of NCHW ``x``: ``x.mean(dim=(2, 3))``, or under
    a spatial context the slab's sum in at least f32 summed over the slabs
    (``spatial.spatial_sum``), divided by the whole map's H·W and rounded
    to ``x``'s dtype once (replicated)."""
    comm = _spatial()
    if comm is None:
        return x.mean(dim=(2, 3), keepdim=keepdim)
    from insarseg_torch.parallel.spatial import rows_of, spatial_sum

    acc = torch.promote_types(x.dtype, torch.float32)
    total = spatial_sum(x.sum(dim=(2, 3), keepdim=keepdim, dtype=acc), comm)
    return (total / (rows_of(x, comm).height * x.shape[3])).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``AdaptiveAvgPool2d(1)`` over NCHW: (B, C, 1, 1) (over every slab
    under a spatial context, :func:`spatial_mean`)."""
    return spatial_mean(x, keepdim=True)


class GlobalAvgPool2d(nn.Module):
    """:func:`global_avg_pool` as a module without parameters (in place of
    ``nn.AdaptiveAvgPool2d(1)``, which would pool the slab alone)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(x)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """``AdaptiveMaxPool2d(1)`` over NCHW: (B, C, 1, 1) (CBAM's channel
    attention; over every slab under a spatial context,
    ``spatial.spatial_max``)."""
    comm = _spatial()
    if comm is None:
        return x.amax(dim=(2, 3), keepdim=True)
    from insarseg_torch.parallel.spatial import spatial_max

    return spatial_max(x, comm)


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


def _bin_sums(ii: torch.Tensor, size: Tuple[int, int], h: int, row0: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 sums over each bin of an image ``h`` rows high whose rows
    ``row0`` on the integral image ``ii`` holds (every row but a slab's
    own clipped away), (N, oh, ow, C), and the bins' areas, (oh, ow):
    the four corners gathered per bin."""
    oh, ow = size
    rows, w = ii.shape[1] - 1, ii.shape[2] - 1
    hs, he = _bin_edges(h, oh, ii.device)
    ws, we = _bin_edges(w, ow, ii.device)
    area = ((he - hs)[:, None] * (we - ws)[None, :]).to(torch.float32)
    if row0 or rows != h:
        hs, he = (hs - row0).clamp(0, rows), (he - row0).clamp(0, rows)

    def corner(r, c):
        return ii.index_select(1, r).index_select(2, c)

    s = corner(he, we) - corner(hs, we) - corner(he, ws) + corner(hs, ws)
    return s, area


def _bins_out(s: torch.Tensor, area: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    return (s / area[:, :, None]).permute(0, 3, 1, 2).to(dtype)


def pool_from_integral(ii: torch.Tensor,
                       output_size: Union[int, Tuple[int, int]],
                       dtype: torch.dtype) -> torch.Tensor:
    """The adaptive average pool read from :func:`integral_image`: the four
    corners gathered per bin, the difference divided by the bin's area,
    NCHW in ``dtype``."""
    return _bins_out(*_bin_sums(ii, _pair(output_size), ii.shape[1] - 1, 0),
                     dtype)


def _sharded_pools(x: torch.Tensor, sizes: List[Tuple[int, int]],
                   comm) -> List[torch.Tensor]:
    """:func:`adaptive_avg_pools` of slab ``x`` at ``sizes`` (none of them
    1 or the image's own): each slab sums its rows of every bin from its
    own integral image, the parts of all sizes summed over the slabs in
    one ``spatial_sum`` and divided by the bins' global areas; the whole
    b x b maps on every slab (replicated)."""
    from insarseg_torch.parallel.spatial import rows_of, spatial_sum

    ii = integral_image(x)
    rows = rows_of(x, comm)
    parts = [_bin_sums(ii, o, rows.height, rows.of(comm.index)[0])
             for o in sizes]
    n = x.shape[0]
    total = spatial_sum(torch.cat([s.reshape(n, -1) for s, _ in parts], 1),
                        comm)
    out = []
    widths = [math.prod(s.shape[1:]) for s, _ in parts]
    for (s, area), t in zip(parts, total.split(widths, 1)):
        out.append(_bins_out(t.reshape(s.shape), area, x.dtype))
    return out


def adaptive_avg_pools(x: torch.Tensor,
                       sizes: Sequence[Union[int, Tuple[int, int]]]
                       ) -> List[torch.Tensor]:
    """``nn.AdaptiveAvgPool2d`` over NCHW at each of ``sizes`` in the JAX
    package's form (``insarseg/ops/layers.py::adaptive_avg_pool_2d``): the
    input itself where the size is its own, the global mean at 1, else an
    f32 integral image (built once for all sizes) read per bin and cast
    back to ``x``'s dtype. ``F.adaptive_avg_pool2d`` sums in another
    order.

    Under a spatial context ``x`` is a slab and every pool is of the whole
    map and replicated (the same map on every slab): the global mean by
    :func:`spatial_mean`, the map's own size by
    ``spatial.spatial_gather``, the other sizes by :func:`_sharded_pools`
    (the bins by global rows)."""
    comm = _spatial()
    if comm is None:
        image = tuple(x.shape[-2:])
    else:
        from insarseg_torch.parallel.spatial import rows_of

        image = (rows_of(x, comm).height, x.shape[3])
    out: List[Optional[torch.Tensor]] = []
    binned = []
    for size in sizes:
        o = _pair(size)
        if image == o:
            if comm is None:
                out.append(x)
            else:
                from insarseg_torch.parallel.spatial import spatial_gather

                out.append(spatial_gather(x, comm))
        elif o == (1, 1):
            out.append(global_avg_pool(x))
        else:
            out.append(None)
            binned.append(o)
    if binned:
        if comm is None:
            ii = integral_image(x)
            pooled = [pool_from_integral(ii, o, x.dtype) for o in binned]
        else:
            pooled = _sharded_pools(x, binned, comm)
        it = iter(pooled)
        out = [next(it) if p is None else p for p in out]
    return out


def adaptive_avg_pool_2d(x: torch.Tensor,
                         output_size: Union[int, Tuple[int, int]]
                         ) -> torch.Tensor:
    """One size of :func:`adaptive_avg_pools`."""
    return adaptive_avg_pools(x, [output_size])[0]
