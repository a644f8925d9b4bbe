"""K1 ``int8_conv3x3_epilogue``: int8 3x3 conv + fused epilogue.

Replaces ``insarseg/models/unet_int8.py::_conv_i8`` (``_conv_acc`` +
``_epilogue``). Kernel: ``insarseg_torch/csrc/int8_conv3x3.cu``.

``y = relu(acc * mult[c] + off[c])`` on the int32 accumulator of the conv,
then int8 codes ``clip(rint(y / out_s), ±127)``, or bf16 when ``out_s`` is
None. The plain version computes the accumulator exactly with ``F.conv2d``
on float64 codes (|acc| < 2^53) and the epilogue in eager f32 ops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from insarseg_torch.kernels._lib import check_cuda, launch, stream_of
from insarseg_torch.ops.quant import requant


def repack_conv_weight(q_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO int8 codes (3, 3, Cin, Cout) -> the kernel's layout
    (Cout, 3, 3, Cin4), Cin zero-padded to a multiple of 4 (exact)."""
    kh, kw, cin, cout = q_hwio.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(q_hwio.shape)}")
    cin4 = -(-cin // 4) * 4
    w = torch.zeros((cout, 3, 3, cin4), dtype=torch.int8,
                    device=q_hwio.device)
    w[..., :cin] = q_hwio.permute(3, 0, 1, 2)
    return w


def _pad_channels(x: torch.Tensor, c: int) -> torch.Tensor:
    if x.shape[-1] == c:
        return x
    xp = torch.zeros(x.shape[:-1] + (c,), dtype=x.dtype, device=x.device)
    xp[..., : x.shape[-1]] = x
    return xp


def conv3x3_i8_plain(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                     off: torch.Tensor,
                     out_s: Optional[float]) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments)."""
    x = _pad_channels(x, w.shape[-1])
    acc = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                   w.permute(0, 3, 1, 2).to(torch.float64), padding=1)
    # every partial sum is an integer below 2^53; the round only guards
    # against a conv algorithm that is not exact in float64
    acc = acc.round().permute(0, 2, 3, 1).to(torch.float32)
    y = torch.relu(acc * mult + off)
    return y.to(torch.bfloat16) if out_s is None else requant(y, out_s)


def conv3x3_i8(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
               off: torch.Tensor, out_s: Optional[float]) -> torch.Tensor:
    """x (B, H, W, Cin) int8 codes; w (Cout, 3, 3, Cin4) from
    :func:`repack_conv_weight`; mult, off (Cout,) f32. Returns
    (B, H, W, Cout) int8 codes at scale ``out_s``, or bf16 if it is None.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return conv3x3_i8_plain(x, w, mult, off, out_s)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_i8: unsupported device {x.device}")
    b, h, wd, _ = x.shape
    cout, _, _, cin4 = w.shape
    x = _pad_channels(x, cin4)
    dev = x.device
    for name, t, dt in (("x", x, torch.int8), ("w", w, torch.int8),
                        ("mult", mult, torch.float32),
                        ("off", off, torch.float32)):
        check_cuda(name, t, dt, dev)
    if mult.shape != (cout,) or off.shape != (cout,):
        raise ValueError("mult/off must have shape (Cout,)")
    out = torch.empty((b, h, wd, cout), device=dev,
                      dtype=torch.bfloat16 if out_s is None else torch.int8)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        launch("int8_conv3x3_epilogue", "insarseg_conv3x3_i8",
               x.data_ptr(), w.data_ptr(), mult.data_ptr(), off.data_ptr(),
               out.data_ptr(), b, h, wd, cin4, cout,
               1.0 if out_s is None else float(out_s),
               int(out_s is None), stream_of(x))
    return out
