"""K2 ``se_squeeze_i8`` + ``se_excite_i8``: the int8 squeeze-excite tail.

Replaces the SE tail of ``insarseg/models/unet_int8.py::_dc_i8``. Kernels:
``insarseg_torch/csrc/se_i8.cu``. The MLP between squeeze and excite stays
in torch (``insarseg_torch.models.unet_int8._dc_i8``).
"""

from __future__ import annotations

import torch

from insarseg_torch.kernels._lib import check_cuda, launch, stream_of

_SQUEEZE_THREADS = 256
_TARGET_BLOCKS = 4 * 132  # a few waves of the H100's 132 SMs


def _check_channels(c: int) -> None:
    if c % 16 or c > 16 * _SQUEEZE_THREADS:
        raise ValueError(
            f"SE kernels take C % 16 == 0 and C <= 4096 channels, got {c}")


def se_squeeze_i8_plain(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)


def se_squeeze_i8(q: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 codes -> (B, C) int32 per-channel sums (exact)."""
    if q.device.type == "cpu":
        return se_squeeze_i8_plain(q)
    if q.device.type != "cuda":
        raise ValueError(f"se_squeeze_i8: unsupported device {q.device}")
    b, h, w, c = q.shape
    _check_channels(c)
    check_cuda("q", q, torch.int8, q.device)
    hw = h * w
    sums = torch.zeros((b, c), dtype=torch.int32, device=q.device)
    ppi = _SQUEEZE_THREADS // (c // 16)  # pixels a block reads per step
    splits = max(1, min(-(-_TARGET_BLOCKS // b), -(-hw // ppi)))
    per_block = -(-hw // splits)
    splits = -(-hw // per_block)
    with torch.cuda.device(q.device):
        launch("se_squeeze_i8", "insarseg_se_squeeze_i8", q.data_ptr(),
               sums.data_ptr(), b, hw, c, splits, per_block, stream_of(q))
    return sums


def se_excite_i8_plain(q: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    g = gain[:, None, None, :]
    if gain.dtype == torch.bfloat16:
        return q.to(torch.bfloat16) * g
    return torch.round(q.to(torch.float32) * g).clamp_(-127, 127) \
        .to(torch.int8)


def se_excite_i8(q: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) int8 codes x (B, C) gain. An f32 gain gives int8 codes
    ``clip(rint(q * gain), ±127)``; a bf16 gain gives bf16 ``q * gain``."""
    if q.device.type == "cpu":
        return se_excite_i8_plain(q, gain)
    if q.device.type != "cuda":
        raise ValueError(f"se_excite_i8: unsupported device {q.device}")
    b, h, w, c = q.shape
    _check_channels(c)
    bf16 = gain.dtype == torch.bfloat16
    check_cuda("q", q, torch.int8, q.device)
    check_cuda("gain", gain, torch.bfloat16 if bf16 else torch.float32,
               q.device)
    if gain.shape != (b, c):
        raise ValueError(f"gain must have shape {(b, c)}, got "
                         f"{tuple(gain.shape)}")
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.bfloat16 if bf16 else torch.int8)
    with torch.cuda.device(q.device):
        launch("se_excite_i8", "insarseg_se_excite_i8", q.data_ptr(),
               gain.data_ptr(), out.data_ptr(), q.numel() // 16, h * w * c,
               c, int(bf16), stream_of(q))
    return out
