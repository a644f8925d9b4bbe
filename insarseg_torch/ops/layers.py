"""Layer helpers for the port (counterpart of ``insarseg/ops/layers.py``).

Conv, ConvTranspose and BatchNorm are ``nn.Conv2d``, ``nn.ConvTranspose2d``
and ``nn.BatchNorm2d`` (eps 1e-5, eval mode) under the reference's names;
what the packed graphs need beyond them lives here. Internally the float
graphs run NCHW (cuDNN's native layout); the public functions convert at
their NHWC boundary with :func:`nhwc_to_nchw` / :func:`nchw_to_nhwc`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


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
