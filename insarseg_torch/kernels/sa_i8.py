"""K4a ``sa_stats_i8`` + K4b ``sa_gate_i8``: the U-Net-SA gate on int8 codes.

Replace ``insarseg/models/unet_int8.py::_sa_gate_i8``. Kernels:
``insarseg_torch/csrc/sa_i8.cu``. The gate's DoubleConv(2 -> 1) and sigmoid
between them stay torch f32 ops (``insarseg_torch.models.unet_int8``).
"""

from __future__ import annotations

import torch

from insarseg_torch.kernels._lib import check_cuda, launch, stream_of
from insarseg_torch.ops.quant import f32_scalar


def _check_channels(name: str, c: int) -> None:
    if c % 16:
        raise ValueError(f"{name} takes C % 16 == 0, got {c}")


def sa_stats_i8_plain(q: torch.Tensor, s: float) -> torch.Tensor:
    """The kernel's formula: an exact integer sum and a code max, then
    ``sum * s / C`` and ``max * s`` in f32 (scale and divisor as device
    tensors: a CUDA operation with a host scalar may round otherwise)."""
    st = f32_scalar(s, q.device)
    ct = f32_scalar(q.shape[-1], q.device)
    mean = q.sum(dim=-1, dtype=torch.int32).to(torch.float32) * st / ct
    mx = q.amax(dim=-1).to(torch.float32) * st
    return torch.stack([mean, mx], dim=-1)


def sa_stats_i8(q: torch.Tensor, s: float) -> torch.Tensor:
    """(B, H, W, C) int8 codes at scale ``s`` -> (B, H, W, 2) f32: the mean
    and the max over C of the dequantized codes."""
    if q.device.type == "cpu":
        return sa_stats_i8_plain(q, s)
    if q.device.type != "cuda":
        raise ValueError(f"sa_stats_i8: unsupported device {q.device}")
    _check_channels("sa_stats_i8", q.shape[-1])
    check_cuda("q", q, torch.int8, q.device)
    out = torch.empty(q.shape[:-1] + (2,), dtype=torch.float32,
                      device=q.device)
    pixels = out.numel() // 2
    if pixels == 0:
        return out
    with torch.cuda.device(q.device):
        launch("sa_stats_i8", "insarseg_sa_stats_i8", q.data_ptr(),
               out.data_ptr(), pixels, q.shape[-1], float(s), stream_of(q))
    return out


def sa_gate_i8_plain(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.round(q.to(torch.float32) * g[..., None]) \
        .clamp_(-127, 127).to(torch.int8)


def sa_gate_i8(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 codes x (B, H, W) f32 gate -> int8 codes
    ``clip(rint(q * g), ±127)`` at the input's scale."""
    if q.device.type == "cpu":
        return sa_gate_i8_plain(q, g)
    if q.device.type != "cuda":
        raise ValueError(f"sa_gate_i8: unsupported device {q.device}")
    _check_channels("sa_gate_i8", q.shape[-1])
    check_cuda("q", q, torch.int8, q.device)
    check_cuda("g", g, torch.float32, q.device)
    if tuple(g.shape) != tuple(q.shape[:-1]):
        raise ValueError(f"g must have shape {tuple(q.shape[:-1])}, got "
                         f"{tuple(g.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        launch("sa_gate_i8", "insarseg_sa_gate_i8", q.data_ptr(),
               g.data_ptr(), out.data_ptr(), q.numel() // 16, q.shape[-1],
               stream_of(q))
    return out
