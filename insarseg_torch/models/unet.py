"""U-Net, plain, channel-attention (``use_se``) and spatial-attention
(``use_sa``) (counterpart of ``insarseg/models/unet.py::UNet``).

NCHW in and out, as the reference; module names follow the reference's
state_dict (``inc``, ``down{i}`` = ``Sequential(MaxPool2d(2), DoubleConv)``,
``up{i}``, ``conv{i}``, ``outc``), so the output of
``insarseg_torch.compat.unet_variables_to_torch`` loads with
``strict=True``. Topology: ``inc`` C_in->f, 4x (MaxPool2 + DoubleConv) to
16f channels at H/16, 4x (ConvTranspose k2 s2 + concat[skip, up] +
DoubleConv), 1x1 head. With ``use_se`` the decoder bilinear-resizes the
upsampled tensor to the skip's size before the concat when they differ
(``shape_fix``, default on iff ``use_se``, as the reference CA script).
With ``use_sa`` a ``SpatialAttentionDC`` named ``sa{i}`` gates each
decoder concat before ``conv{i}``. ``features_plan`` replaces the channel
plan ``(f, 2f, 4f, 8f, 16f)`` of levels 1-5, as the JAX module's does (the
fast cell's inner UNet, ``models/unet_stem.py``). ``remat`` recomputes
the encoder and decoder DoubleConvs (``inc``, ``down{i}[1]``,
``conv{i}``) in the backward pass of a train step, where the JAX module
puts ``nn.remat`` (``insarseg/models/unet.py:74-75``); the SA gates'
``compress_and_map`` is not rematerialized there either. The module
computes in its input's dtype (``ops/layers.py``).

Under a spatial context (``parallel/spatial.py``: the H axis sharded,
``x`` one slab of it) the 3x3 convs exchange halo rows, the max-pools
run as windows along H (``ops/layers.py::max_pool_2d``: a pool gives
output row j to the slab holding input row 2j, and an odd map drops its
last row, as unsharded), and the SE squeezes sum over the slabs. The
2x2 / 2 transposed conv makes the rows ``[2 ceil(a / 2), 2 ceil(b /
2))`` of a slab whose skip holds ``[a, b)``: each up path moves at most a
row across each slab boundary to the skip's rows before the concat
(``spatial.reslab``), or, where ``shape_fix`` resizes, resizes between
the two in global coordinates (``ops/resize.py::resize_rows``). So any H
that the slabs divide runs, slabs of no row among them; what the module
takes unsharded it takes sharded: U-Net-CA any H, the plain U-Net and
U-Net-SA a multiple of 16.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from insarseg_torch.ops.blocks import DoubleConv, SpatialAttentionDC
from insarseg_torch.ops.layers import Conv2d, ConvTranspose2d, MaxPool2d
from insarseg_torch.ops.resize import resize_bilinear, resize_rows
from insarseg_torch.parallel import spatial


class UNet(nn.Module):
    def __init__(self, num_classes: int = 2, base_features: int = 64,
                 use_se: bool = False, shape_fix: Optional[bool] = None,
                 in_channels: int = 1, use_sa: bool = False,
                 features_plan: Optional[Sequence[int]] = None,
                 remat: bool = False):
        super().__init__()
        f = base_features
        plan = (f, 2 * f, 4 * f, 8 * f, 16 * f) if features_plan is None \
            else tuple(features_plan)
        if len(plan) != 5:
            raise ValueError(f"features_plan needs 5 levels, got {plan}")
        self.num_classes = num_classes
        self.use_se, self.use_sa = use_se, use_sa
        self.shape_fix = use_se if shape_fix is None else shape_fix
        self.inc = DoubleConv(in_channels, plan[0], use_se, remat)
        for i in range(1, 5):
            setattr(self, f"down{i}", nn.Sequential(
                MaxPool2d(2),
                DoubleConv(plan[i - 1], plan[i], use_se, remat)))
        for i in range(1, 5):
            cin, cout = plan[5 - i], plan[4 - i]
            setattr(self, f"up{i}", ConvTranspose2d(cin, cout, 2, stride=2))
            setattr(self, f"conv{i}", DoubleConv(2 * cout, cout, use_se,
                                                 remat))
            if use_sa:
                setattr(self, f"sa{i}", SpatialAttentionDC())
        self.outc = Conv2d(plan[0], num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.down4(x4)
        for i, skip in ((1, x4), (2, x3), (3, x2), (4, x1)):
            y = self._up_to(getattr(self, f"up{i}"), y, skip)
            y = torch.cat([skip, y], dim=1)
            if self.use_sa:
                y = getattr(self, f"sa{i}")(y)
            y = getattr(self, f"conv{i}")(y)
        return self.outc(y)

    def _up_to(self, up: nn.Module, y: torch.Tensor,
               skip: torch.Tensor) -> torch.Tensor:
        """``up(y)`` on the skip's rows and, with ``shape_fix``, at its
        size."""
        comm = spatial.current()
        if comm is None:
            u = up(y)
            if self.shape_fix and u.shape[2:] != skip.shape[2:]:
                u = resize_bilinear(u, skip.shape[2:])
            return u
        src = spatial.rows_of(y, comm).scaled(2)
        dst = spatial.rows_of(skip, comm)
        u = up(y)
        if self.shape_fix and (src.height, u.shape[3]) != \
                (dst.height, skip.shape[3]):
            return resize_rows(u, src, dst, skip.shape[3], comm)
        return spatial.reslab(u, src, dst, comm)
