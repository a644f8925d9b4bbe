"""DoubleConv and the Linear-MLP squeeze-excite (counterpart of
``insarseg/ops/blocks.py::DoubleConv`` / ``SELayer``), NCHW.

The Sequential indices reproduce the reference state_dict names:
``double_conv.{0,1,3,4,6}`` (conv, BN, ReLU, conv, BN, ReLU, SE) and
``fc.{0,2}`` (Linear, ReLU, Linear; no bias, reduction 16).
"""

from __future__ import annotations

import torch
from torch import nn


class SELayer(nn.Module):
    """GAP -> Linear(C, C/r) -> ReLU -> Linear(C/r, C) -> sigmoid ->
    channelwise rescale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(inplace=True),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x.mean(dim=(2, 3)))
        return x * y[:, :, None, None]


class DoubleConv(nn.Module):
    """(Conv3x3 same-pad -> BN -> ReLU) x2, optional SE tail."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_se: bool = False):
        super().__init__()
        layers = [
            nn.Conv2d(in_channels, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        ]
        if use_se:
            layers.append(SELayer(out_channels))
        self.double_conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)
