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
``x`` one slab of it) the 3x3 convs exchange halo rows and the SE
squeezes sum over the slabs; the max-pools, the 2x2 / 2 transposed convs
and the skip concats stay inside the slab when its height is a multiple
of 16 (four halvings), which is checked: the JAX package's GSPMD pads any
H, the port does not (ROADMAP Queue 1 item 21c).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from insarseg_torch.ops.blocks import DoubleConv, SpatialAttentionDC
from insarseg_torch.ops.layers import Conv2d, ConvTranspose2d, slab_rule
from insarseg_torch.ops.resize import resize_bilinear


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
                nn.MaxPool2d(2),
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
        slab_rule(x, 16, "the U-Net (it halves H four times)")
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.down4(x4)
        for i, skip in ((1, x4), (2, x3), (3, x2), (4, x1)):
            y = getattr(self, f"up{i}")(y)
            if self.shape_fix and y.shape[2:] != skip.shape[2:]:
                y = resize_bilinear(y, skip.shape[2:])
            y = torch.cat([skip, y], dim=1)
            if self.use_sa:
                y = getattr(self, f"sa{i}")(y)
            y = getattr(self, f"conv{i}")(y)
        return self.outc(y)
