"""The int8 convolutions with a fused epilogue.

K1 ``int8_conv3x3_epilogue`` (:func:`conv3x3_i8`) replaces
``insarseg/models/unet_int8.py::_conv_i8`` (``_conv_acc`` + ``_epilogue``),
kernel ``insarseg_torch/csrc/int8_conv3x3.cu``: a 3x3 same-pad conv, then
``y = relu(acc * mult[c] + off[c])``, then int8 codes
``clip(rint(y / out_s), ±127)``, or bf16 when ``out_s`` is None.

K5a ``int8_conv_epilogue`` (:func:`conv_i8`) replaces
``insarseg/models/resnet_int8.py::_conv_i8`` and the residual add of its
``_block_i8``, kernel ``insarseg_torch/csrc/conv_i8.cu``: a k x k conv
(k in {1, 3}) with stride, dilation and padding ``d * (k - 1) // 2``, then
``y = acc * mult[c] + off[c]`` (+ the identity) (+ReLU), then int8 codes,
f32 or bf16.

Both kernels are one tensor-core implicit GEMM (``csrc/igemm_i8.cuh``,
``wgmma`` on sm_90a); the host picks its N tile with :func:`tile_n`.

The plain versions compute the accumulator exactly with ``F.conv2d`` on
float64 codes (|acc| < 2^53) and the epilogue in eager f32 ops, one
rounding per op as the kernels and the JAX graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from insarseg_torch.kernels._lib import check_cuda, launch, stream_of
from insarseg_torch.ops.quant import dequant, requant


CIN_ALIGN = 16  # the kernels copy 16-byte chunks of each pixel's channels


def repack_conv_weight(q_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO int8 codes (k, k, Cin, Cout), k in {1, 3} -> the kernels'
    layout (Cout, k, k, Cin16), Cin zero-padded to a multiple of 16
    (exact: zero codes add nothing to the sums)."""
    kh, kw, cin, cout = q_hwio.shape
    if kh != kw or kh not in (1, 3):
        raise ValueError(f"expected a 1x1 or 3x3 kernel, got "
                         f"{tuple(q_hwio.shape)}")
    cin16 = -(-cin // CIN_ALIGN) * CIN_ALIGN
    w = torch.zeros((cout, kh, kw, cin16), dtype=torch.int8,
                    device=q_hwio.device)
    w[..., :cin] = q_hwio.permute(3, 0, 1, 2)
    return w


def tile_n(cout: int) -> int:
    """Output channels a kernel block computes (its GEMM N tile): 64 where
    Cout <= 64 or where 128-wide tiles would leave the last one half
    empty (an odd number of 64-channel groups), else 128."""
    groups = -(-cout // 64)
    return 64 if groups == 1 or groups % 2 else 128


def _pad_channels(x: torch.Tensor, c: int) -> torch.Tensor:
    if x.shape[-1] == c:
        return x
    xp = torch.zeros(x.shape[:-1] + (c,), dtype=x.dtype, device=x.device)
    xp[..., : x.shape[-1]] = x
    return xp


def _check_cuda_args(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                     off: torch.Tensor) -> torch.Tensor:
    """Checks a conv kernel's arguments; returns ``x`` with its channels
    zero-padded to the kernel's Cin16."""
    cout, cin16, cin = w.shape[0], w.shape[3], x.shape[-1]
    if cin16 % CIN_ALIGN or not cin16 - CIN_ALIGN < cin <= cin16:
        raise ValueError(f"x has {cin} channels; w takes {cin16} (padded)")
    x = _pad_channels(x, cin16)
    for name, t, dt in (("x", x, torch.int8), ("w", w, torch.int8),
                        ("mult", mult, torch.float32),
                        ("off", off, torch.float32)):
        check_cuda(name, t, dt, x.device)
    if mult.shape != (cout,) or off.shape != (cout,):
        raise ValueError("mult/off must have shape (Cout,)")
    return x


def conv3x3_i8_plain(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                     off: torch.Tensor,
                     out_s: Optional[float]) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments)."""
    return conv_i8_plain(x, w, mult, off, out_s=out_s, bf16=out_s is None)


def conv3x3_i8(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
               off: torch.Tensor, out_s: Optional[float]) -> torch.Tensor:
    """x (B, H, W, Cin) int8 codes; w (Cout, 3, 3, Cin16) from
    :func:`repack_conv_weight`; mult, off (Cout,) f32. Returns
    (B, H, W, Cout) int8 codes at scale ``out_s``, or bf16 if it is None.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return conv3x3_i8_plain(x, w, mult, off, out_s)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_i8: unsupported device {x.device}")
    if w.shape[1] != 3:
        raise ValueError("conv3x3_i8 takes a 3x3 kernel")
    b, h, wd, _ = x.shape
    cout, cin16 = w.shape[0], w.shape[3]
    x = _check_cuda_args(x, w, mult, off)
    dev = x.device
    out = torch.empty((b, h, wd, cout), device=dev,
                      dtype=torch.bfloat16 if out_s is None else torch.int8)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        launch("int8_conv3x3_epilogue", "insarseg_conv3x3_i8",
               x.data_ptr(), w.data_ptr(), mult.data_ptr(), off.data_ptr(),
               out.data_ptr(), b, h, wd, cin16, cout,
               1.0 if out_s is None else float(out_s),
               int(out_s is None), tile_n(cout), stream_of(x))
    return out


def _out_hw(h: int, w: int, k: int, stride: int, dilation: int):
    pad = dilation * (k - 1) // 2
    span = dilation * (k - 1) + 1
    return (h + 2 * pad - span) // stride + 1, (w + 2 * pad - span) // stride + 1


def conv_i8_plain(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                  off: torch.Tensor, stride: int = 1, dilation: int = 1,
                  relu: bool = True, out_s: Optional[float] = None,
                  idn: Optional[torch.Tensor] = None,
                  in_s: Optional[float] = None,
                  bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv_i8` (same arguments)."""
    x = _pad_channels(x, w.shape[-1])
    k = w.shape[1]
    acc = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                   w.permute(0, 3, 1, 2).to(torch.float64), stride=stride,
                   padding=dilation * (k - 1) // 2, dilation=dilation)
    # every partial sum is an integer below 2^53; the round only guards
    # against a conv algorithm that is not exact in float64
    acc = acc.round().permute(0, 2, 3, 1).to(torch.float32)
    y = acc * mult + off
    if idn is not None:
        y = y + (dequant(idn, in_s) if idn.dtype == torch.int8 else idn)
    if relu:
        y = torch.relu(y)
    if out_s is not None:
        return requant(y, out_s)
    return y.to(torch.bfloat16) if bf16 else y


def conv_i8(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
            off: torch.Tensor, stride: int = 1, dilation: int = 1,
            relu: bool = True, out_s: Optional[float] = None,
            idn: Optional[torch.Tensor] = None, in_s: Optional[float] = None,
            bf16: bool = False) -> torch.Tensor:
    """K5a. x (B, H, W, Cin) int8 codes; w (Cout, k, k, Cin16) from
    :func:`repack_conv_weight`, k in {1, 3}; mult, off (Cout,) f32; padding
    ``dilation * (k - 1) // 2``. Optional identity ``idn`` (B, Ho, Wo,
    Cout): int8 codes at scale ``in_s``, or f32. Returns (B, Ho, Wo, Cout)
    int8 codes at ``out_s``; with ``out_s`` None, f32, or bf16 if ``bf16``.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return conv_i8_plain(x, w, mult, off, stride, dilation, relu, out_s,
                             idn, in_s, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"conv_i8: unsupported device {x.device}")
    b, h, wd, _ = x.shape
    cout, k, _, cin16 = w.shape
    ho, wo = _out_hw(h, wd, k, stride, dilation)
    x = _check_cuda_args(x, w, mult, off)
    dev = x.device
    idn_kind = 0
    if idn is not None:
        idn_kind = 1 if idn.dtype == torch.int8 else 2
        check_cuda("idn", idn, idn.dtype, dev)
        if idn.dtype not in (torch.int8, torch.float32):
            raise TypeError(f"idn must be int8 or float32, got {idn.dtype}")
        if tuple(idn.shape) != (b, ho, wo, cout):
            raise ValueError(f"idn must have shape {(b, ho, wo, cout)}, got "
                             f"{tuple(idn.shape)}")
        if idn_kind == 1 and in_s is None:
            raise ValueError("an int8 identity needs its scale in_s")
    if out_s is not None:
        exit_kind, dtype = 0, torch.int8
    elif bf16:
        exit_kind, dtype = 2, torch.bfloat16
    else:
        exit_kind, dtype = 1, torch.float32
    out = torch.empty((b, ho, wo, cout), device=dev, dtype=dtype)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        launch("int8_conv_epilogue", "insarseg_conv_i8",
               x.data_ptr(), w.data_ptr(), mult.data_ptr(), off.data_ptr(),
               0 if idn is None else idn.data_ptr(), out.data_ptr(),
               b, h, wd, cin16, ho, wo, cout, k, stride, dilation,
               int(relu), idn_kind, 1.0 if in_s is None else float(in_s),
               1.0 if out_s is None else float(out_s), exit_kind,
               tile_n(cout), stream_of(x))
    return out
