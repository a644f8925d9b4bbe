"""Layer helpers for the port (counterpart of ``insarseg/ops/layers.py``).

Conv, ConvTranspose and BatchNorm are ``nn.Conv2d``, ``nn.ConvTranspose2d``
and ``nn.BatchNorm2d`` (eps 1e-5, eval mode) under the reference's names;
what the packed graphs need beyond them lives here. Internally the float
graphs run NCHW (cuDNN's native layout); the public functions convert at
their NHWC boundary with :func:`nhwc_to_nchw` / :func:`nchw_to_nhwc`.
"""

from __future__ import annotations

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
