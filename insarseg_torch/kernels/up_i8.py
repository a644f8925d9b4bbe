"""K6 ``up_concat_i8``: one decoder level of the int8 U-Net — the bf16
transposed conv as a per-pixel GEMM, the bf16 bias, the requant to the
concat's scale and the concat with the skip's codes — in one launch.

Replaces ``insarseg/models/unet_int8.py::unet_int8_apply`` lines 345-350
(up1-3) and 355-358 (up4; in the H-s2d layout ``models/unet_s2d.py::
_up4_s2d``). Kernel: ``insarseg_torch/csrc/up_i8.cu``.

Two forms, one weight layout ``w`` (taps * Cout, Cin) bf16 with row
``t * Cout + c`` (:func:`pack_up_weight`), K-major as the kernel's
tensor-core GEMM reads it:

- ConvT k2 s2 (``s2d=False``): tap ``t = 2a + e`` of input pixel (i, j)
  is output pixel (2i + a, 2j + e), ``z = y[i, j] @ k[a, e]``;
- the H-s2d up4 (``s2d=True``): a W-only transposed conv, tap ``e`` is
  output pixel (i, 2j + e), ``z = y[i, j] @ k[0, 1 - e]``.

The kernel sums on the tensor cores in their own order, the plain version
in ascending k in f32, so the two may differ by a code of one where the
f32 sums straddle a bf16 rounding boundary or a tie of the requant:
:func:`assert_up_codes_close` is the counted bar that holds them together.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    up4 — -> K6's (taps * Cout, Cin) bf16, row ``t * Cout + c`` with tap
    ``t = 2a + e`` of kernel position (a, e), rounded as the JAX graph's
    ``k.astype(bfloat16)``."""
    if s2d:
        k = k.flip(1)  # tap e takes k[0, 1 - e]
    return k.permute(0, 1, 3, 2).reshape(-1, k.shape[2]) \
        .to(torch.bfloat16).contiguous()


def up_bf16_plain(y: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor], s2d: bool = False
                  ) -> torch.Tensor:
    """The transposed conv as the kernel rounds it: the f32 sum in
    ascending k (each bf16 product is exact in f32), bf16, the bias as a
    bf16 add; the taps placed on their output pixels. (B, H, W, Cin) ->
    (B, Ho, Wo, Cout) bf16."""
    b, h, wd, cin = y.shape
    rt = 1 if s2d else 2
    n = w.shape[0]
    y2 = y.reshape(-1, cin).to(torch.float32)
    w2 = w.t().to(torch.float32).contiguous()  # (Cin, N)
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


# K6's counted bar: the share of the ConvT's codes that may differ by one
# from the plain version. Measured on an H100 (PERF.md §6) and rounded up:
# at most 7.4e-6 a call on the activations of the U-Net main paths' int8
# forwards, 6.5e-5 on z about N(0, 1) at cat_s 0.015, 3.0e-5 on the
# tie-heavy case, z about N(0, 20^2) at cat_s 0.5 (a quarter of the bf16
# z on a tie of z / cat_s).
UP_SHARE_MAIN, UP_SHARE_RANDOM, UP_SHARE_TIES = 5e-5, 2e-4, 1e-4


def assert_up_codes_close(got: torch.Tensor, want: torch.Tensor, cs: int,
                          max_share: float) -> Tuple[int, float]:
    """K6's counted bar: ``got`` and ``want`` (B, Ho, Wo, Cs + Cout) int8
    agree exactly on the skip's ``cs`` channels, and on the ConvT's codes
    every code lies within 1 and at most ``max_share`` of them differ.
    Returns (max |delta|, share of the ConvT's codes that differ); raises
    AssertionError otherwise."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(got[..., :cs], want[..., :cs]):
        raise AssertionError("the skip's codes differ")
    d = (got[..., cs:].to(torch.int16) - want[..., cs:].to(torch.int16)) \
        .abs()
    n = d.numel()
    dmax = int(d.max()) if n else 0
    share = float((d != 0).sum()) / n if n else 0.0
    if dmax > 1:
        raise AssertionError(f"a code differs by {dmax} (bar: 1)")
    if share > max_share:
        raise AssertionError(f"{share:.3g} of the codes differ (bar: "
                             f"{max_share:.3g})")
    return dmax, share


def up_concat_i8(y: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], skip: torch.Tensor,
                 cat_s: float, s2d: bool = False) -> torch.Tensor:
    """``concat([skip, clip(rint(bf16(bf16(ConvT(y, w)) + bias) / cat_s),
    ±127)], -1)``.

    y (B, H, W, Cin) bf16 NHWC; w (taps * Cout, Cin) bf16 from
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
    n = w.shape[0]
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
    if tuple(w.shape) != (n, cin) or tuple(skip.shape[:3]) != shape or (
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
