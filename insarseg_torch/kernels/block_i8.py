"""K5b ``se_residual_i8``: SE excite + residual add + ReLU + requant of an
int8 SE bottleneck, one elementwise pass.

Replaces the SE branch of ``insarseg/models/resnet_int8.py::_block_i8``.
Kernel: ``insarseg_torch/csrc/block_i8.cu``. The squeeze before it is
K2's ``se_squeeze_i8`` and the MLP stays in torch
(``insarseg_torch.models.resnet_int8._block_i8``).
"""

from __future__ import annotations

from typing import Optional

import torch

from insarseg_torch.kernels._lib import (
    check_cuda,
    device_guard,
    launch,
    stream_of,
)
from insarseg_torch.ops.quant import dequant, requant


def se_residual_i8_plain(y3q: torch.Tensor, gate: torch.Tensor,
                         idn: torch.Tensor, in_s: Optional[float],
                         out_s: float) -> torch.Tensor:
    idn = dequant(idn, in_s) if idn.dtype == torch.int8 else idn
    y = y3q.to(torch.float32) * gate[:, None, None, :] + idn
    return requant(torch.relu(y), out_s)


def se_residual_i8(y3q: torch.Tensor, gate: torch.Tensor, idn: torch.Tensor,
                   in_s: Optional[float], out_s: float) -> torch.Tensor:
    """``clip(rint(relu(y3q * gate[b, c] + idn) / out_s), ±127)``.

    y3q (B, H, W, C) int8 codes; gate (B, C) f32; idn (B, H, W, C): int8
    codes at scale ``in_s``, or f32. Returns int8 codes at ``out_s``. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if y3q.device.type == "cpu":
        return se_residual_i8_plain(y3q, gate, idn, in_s, out_s)
    if y3q.device.type != "cuda":
        raise ValueError(f"se_residual_i8: unsupported device {y3q.device}")
    b, h, w, c = y3q.shape
    if c % 16:
        raise ValueError(f"se_residual_i8 takes C % 16 == 0, got {c}")
    dev = y3q.device
    check_cuda("y3q", y3q, torch.int8, dev)
    check_cuda("gate", gate, torch.float32, dev)
    if idn.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"idn must be int8 or float32, got {idn.dtype}")
    check_cuda("idn", idn, idn.dtype, dev)
    if gate.shape != (b, c) or idn.shape != y3q.shape:
        raise ValueError(f"gate must be {(b, c)} and idn "
                         f"{tuple(y3q.shape)}; got {tuple(gate.shape)}, "
                         f"{tuple(idn.shape)}")
    idn_f32 = idn.dtype == torch.float32
    if not idn_f32 and in_s is None:
        raise ValueError("an int8 identity needs its scale in_s")
    out = torch.empty(y3q.shape, dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    with device_guard(dev):
        launch("se_residual_i8", "insarseg_se_residual_i8", y3q.data_ptr(),
               gate.data_ptr(), idn.data_ptr(), out.data_ptr(),
               y3q.numel() // 16, h * w * c, c, int(idn_f32),
               1.0 if in_s is None else float(in_s), float(out_s),
               stream_of(y3q))
    return out
