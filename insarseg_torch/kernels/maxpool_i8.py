"""K3 ``maxpool2x2_i8``: 2x2 / stride-2 max-pool on NHWC int8 codes, and
K3s ``maxpool_exit_s2d_i8``: the same window on H-s2d codes, leaving the
s2d layout.

K3 replaces ``insarseg/models/unet_int8.py::_maxpool_i8``; K3s replaces
``insarseg/models/unet_s2d.py::_maxpool_exit_s2d`` on the int8 codes of
the level-1 exit (``unet_int8.py:335``). Kernels:
``insarseg_torch/csrc/maxpool2x2_i8.cu``.
"""

from __future__ import annotations

import torch

from insarseg_torch.kernels._lib import check_cuda, launch, stream_of


def maxpool2x2_i8_plain(q: torch.Tensor) -> torch.Tensor:
    b, h, w, c = q.shape
    ho, wo = h // 2, w // 2
    q = q[:, : 2 * ho, : 2 * wo]
    return q.reshape(b, ho, 2, wo, 2, c).amax(dim=(2, 4))


def maxpool2x2_i8(q: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B, H//2, W//2, C) int8 (floor mode)."""
    if q.device.type == "cpu":
        return maxpool2x2_i8_plain(q)
    if q.device.type != "cuda":
        raise ValueError(f"maxpool2x2_i8: unsupported device {q.device}")
    b, h, w, c = q.shape
    if c % 16:
        raise ValueError(f"maxpool2x2_i8 takes C % 16 == 0, got {c}")
    check_cuda("q", q, torch.int8, q.device)
    out = torch.empty((b, h // 2, w // 2, c), dtype=torch.int8,
                      device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        launch("maxpool2x2_i8", "insarseg_maxpool2x2_i8", q.data_ptr(),
               out.data_ptr(), b, h, w, c, stream_of(q))
    return out


def maxpool_exit_s2d_i8_plain(q: torch.Tensor) -> torch.Tensor:
    b, r, w, c2 = q.shape
    wo, c = w // 2, c2 // 2
    return q[:, :, : 2 * wo].reshape(b, r, wo, 2, 2, c).amax(dim=(3, 4))


def maxpool_exit_s2d_i8(q: torch.Tensor) -> torch.Tensor:
    """H-s2d (B, R, W, 2C) int8 codes (channel ``a*C + c`` holds row parity
    a) -> the standard-layout 2x2 max-pool output (B, R, W//2, C)."""
    if q.device.type == "cpu":
        return maxpool_exit_s2d_i8_plain(q)
    if q.device.type != "cuda":
        raise ValueError(f"maxpool_exit_s2d_i8: unsupported device {q.device}")
    b, r, w, c2 = q.shape
    if c2 % 32:
        raise ValueError(f"maxpool_exit_s2d_i8 takes 2C % 32 == 0, got {c2}")
    check_cuda("q", q, torch.int8, q.device)
    out = torch.empty((b, r, w // 2, c2 // 2), dtype=torch.int8,
                      device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        launch("maxpool_exit_s2d_i8", "insarseg_maxpool_exit_s2d_i8",
               q.data_ptr(), out.data_ptr(), b, r, w, c2 // 2, stream_of(q))
    return out
