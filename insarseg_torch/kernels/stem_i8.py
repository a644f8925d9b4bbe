"""K7 ``stem_pool_i8``: the exit of the int8 ResNet's bf16 stem — the 3x3 /
stride-2 / pad-1 max-pool, the requant to the first block's scale and the
NCHW -> NHWC transpose — in one pass.

Replaces ``insarseg/models/resnet_int8.py::resnet_int8_apply`` lines
278-280. Kernel: ``insarseg_torch/csrc/stem_i8.cu``.
"""

from __future__ import annotations

import torch

from insarseg_torch.kernels._lib import (
    check_cuda,
    device_guard,
    launch,
    stream_of,
)
from insarseg_torch.ops import layers
from insarseg_torch.ops.quant import requant


def stem_pool_i8_plain(y: torch.Tensor, s: float) -> torch.Tensor:
    pooled = layers.max_pool_2d(y, 3, 2, 1)
    return requant(layers.nchw_to_nhwc(pooled).to(torch.float32), s)


def stem_pool_i8(y: torch.Tensor, s: float) -> torch.Tensor:
    """(B, C, H, W) bf16, NCHW or channels-last as the stem conv leaves
    it, -> (B, Ho, Wo, C) int8 codes at ``s`` of its 3x3 / stride-2 / pad-1
    max-pool, Ho = (H - 1) // 2 + 1 (Wo alike). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if y.device.type == "cpu":
        return stem_pool_i8_plain(y, s)
    if y.device.type != "cuda":
        raise ValueError(f"stem_pool_i8: unsupported device {y.device}")
    b, c, h, w = y.shape
    if c % 16:
        raise ValueError(f"stem_pool_i8 takes C % 16 == 0, got {c}")
    nhwc = not y.is_contiguous()
    if nhwc and not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("stem_pool_i8 takes NCHW or channels-last y")
    check_cuda("y", y.permute(0, 2, 3, 1) if nhwc else y, torch.bfloat16,
               y.device)
    out = torch.empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
                      dtype=torch.int8, device=y.device)
    if out.numel() == 0:
        return out
    with device_guard(y.device):
        launch("stem_pool_i8", "insarseg_stem_pool_i8", y.data_ptr(),
               out.data_ptr(), b, c, h, w, int(nhwc), float(s),
               stream_of(y))
    return out
