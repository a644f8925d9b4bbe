"""K6 ``up_concat_i8``: one decoder level of the int8 U-Net — the bf16
transposed conv as a per-pixel GEMM, the bf16 bias, the requant to the
concat's scale and the concat with the skip's codes — in one launch.

Replaces ``insarseg/models/unet_int8.py::unet_int8_apply`` lines 345-350
(up1-3) and 355-358 (up4; in the H-s2d layout ``models/unet_s2d.py::
_up4_s2d``). Kernel: ``insarseg_torch/csrc/up_i8.cu``.

Two forms, one weight layout ``w`` (Cin, taps * Cout) bf16 with column
``t * Cout + c`` (:func:`pack_up_weight`):

- ConvT k2 s2 (``s2d=False``): tap ``t = 2a + e`` of input pixel (i, j)
  is output pixel (2i + a, 2j + e), ``z = y[i, j] @ k[a, e]``;
- the H-s2d up4 (``s2d=True``): a W-only transposed conv, tap ``e`` is
  output pixel (i, 2j + e), ``z = y[i, j] @ k[0, 1 - e]``.
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
from insarseg_torch.ops.quant import requant


def pack_up_weight(k: torch.Tensor, s2d: bool = False) -> torch.Tensor:
    """A packed transposed-conv kernel (kh, kw, Cin, Cout) in the JAX
    package's layout — (2, 2, Cin, Cout), or (1, 2, Cin, 2f) for the H-s2d
    up4 — -> K6's (Cin, taps * Cout) bf16, rounded as the JAX graph's
    ``k.astype(bfloat16)``."""
    if s2d:
        k = k.flip(1)  # tap e takes k[0, 1 - e]
    cin, cout = k.shape[2], k.shape[3]
    return k.permute(2, 0, 1, 3).reshape(cin, -1).to(torch.bfloat16) \
        .contiguous()


def up_bf16_plain(y: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor], s2d: bool = False
                  ) -> torch.Tensor:
    """The transposed conv as the kernel rounds it: the f32 sum in
    ascending k (each bf16 product is exact in f32), bf16, the bias as a
    bf16 add; the taps placed on their output pixels. (B, H, W, Cin) ->
    (B, Ho, Wo, Cout) bf16."""
    b, h, wd, cin = y.shape
    rt = 1 if s2d else 2
    n = w.shape[1]
    y2 = y.reshape(-1, cin).to(torch.float32)
    w2 = w.to(torch.float32)
    acc = torch.zeros((y2.shape[0], n), dtype=torch.float32, device=y.device)
    for k in range(cin):
        acc.addcmul_(y2[:, k:k + 1], w2[k:k + 1])
    z = acc.to(torch.bfloat16)
    if bias is not None:
        z = (z.to(torch.float32) + bias.to(torch.float32).repeat(2 * rt)) \
            .to(torch.bfloat16)
    return z.reshape(b, h, wd, rt, 2, n // (2 * rt)) \
        .permute(0, 1, 3, 2, 4, 5).reshape(b, rt * h, 2 * wd, -1)


def up_concat_i8_plain(y: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor], skip: torch.Tensor,
                       cat_s: float, s2d: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: :func:`up_bf16_plain`, requant,
    then the concat."""
    z = up_bf16_plain(y, w, bias, s2d)
    return torch.cat([skip, requant(z.to(torch.float32), cat_s)], dim=-1)


def up_concat_i8(y: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], skip: torch.Tensor,
                 cat_s: float, s2d: bool = False) -> torch.Tensor:
    """``concat([skip, clip(rint(bf16(bf16(ConvT(y, w)) + bias) / cat_s),
    ±127)], -1)``.

    y (B, H, W, Cin) bf16 NHWC; w (Cin, taps * Cout) bf16 from
    :func:`pack_up_weight`; bias (Cout,) bf16 or None; skip (B, Ho, Wo, Cs)
    int8 at ``cat_s`` with Ho = 2H (or H with ``s2d``) and Wo = 2W.
    Returns (B, Ho, Wo, Cs + Cout) int8 codes. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if y.device.type == "cpu":
        return up_concat_i8_plain(y, w, bias, skip, cat_s, s2d)
    if y.device.type != "cuda":
        raise ValueError(f"up_concat_i8: unsupported device {y.device}")
    b, h, wd, cin = y.shape
    rt = 1 if s2d else 2
    n = w.shape[1]
    cout, cs = n // (2 * rt), skip.shape[-1]
    if cin % 8 or cout % 16 or cs % 16 or n != 2 * rt * cout:
        raise ValueError(f"up_concat_i8 takes Cin % 8 == 0 and Cout, Cs % 16 "
                         f"== 0; got Cin {cin}, {n} columns, Cs {cs}")
    dev = y.device
    check_cuda("y", y, torch.bfloat16, dev)
    check_cuda("w", w, torch.bfloat16, dev)
    check_cuda("skip", skip, torch.int8, dev)
    if bias is not None:
        check_cuda("bias", bias, torch.bfloat16, dev)
    shape = (b, rt * h, 2 * wd)
    if tuple(w.shape) != (cin, n) or tuple(skip.shape[:3]) != shape or (
            bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError(f"up_concat_i8: w {tuple(w.shape)}, skip "
                         f"{tuple(skip.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)} do "
                         f"not fit y {tuple(y.shape)}")
    out = torch.empty(shape + (cs + cout,), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    with device_guard(dev):
        launch("up_concat_i8", "insarseg_up_concat_i8", y.data_ptr(),
               w.data_ptr(), None if bias is None else bias.data_ptr(),
               skip.data_ptr(), out.data_ptr(), b * h * wd, cin, n, cout, wd,
               cs, rt, float(cat_s), stream_of(y))
    return out
