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
import torch.nn.functional as F
from torch import nn


def follow(x: torch.Tensor, p: Optional[torch.Tensor]
           ) -> Optional[torch.Tensor]:
    """Parameter ``p`` in ``x``'s dtype (itself when they agree)."""
    return p if p is None or p.dtype == x.dtype else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (f32 parameters cast per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, follow(x, self.weight),
                                  follow(x, self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype (no ``output_size``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class MomentBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are the JAX
    package's (``insarseg/ops/layers.py::BatchNorm2d``): the batch mean
    and the biased variance ``max(E[x^2] - E[x]^2, 0)`` in at least f32,
    the running variance the unbiased ``n / max(n - 1, 1)`` estimate,
    momentum 0.1. At one value per channel (a 1x1 pooled map at batch 1)
    the variance is 0 and the output the bias, where ``nn.BatchNorm2d``
    raises. Eval mode and the state_dict names are ``nn.BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            rm, rv = self.running_mean, self.running_var
            rm.copy_((1.0 - m) * rm + m * mean.to(rm.dtype))
            rv.copy_((1.0 - m) * rv + m * (var * (n / max(n - 1, 1)))
                     .to(rv.dtype))
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        y = (xf - mean[:, None, None]) * inv[:, None, None] \
            + self.bias.to(acc)[:, None, None]
        return y.to(x.dtype)


def max_pool_2d(x: torch.Tensor, window: int = 2, stride=None,
                padding: int = 0) -> torch.Tensor:
    """``nn.MaxPool2d(window, stride, padding)`` (floor mode; the padding
    acts as -inf) over NCHW float tensors."""
    return F.max_pool2d(x, window, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``AdaptiveAvgPool2d(1)`` over NCHW: (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """``AdaptiveMaxPool2d(1)`` over NCHW: (B, C, 1, 1)."""
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
    for size in sizes:
        o = _pair(size)
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
