"""Blocks of the port (counterparts in ``insarseg/ops/blocks.py``), NCHW.

- :class:`DoubleConv` and :class:`SELayer` (U-Net): the Sequential indices
  reproduce the reference state_dict names ``double_conv.{0,1,3,4,6}``
  (conv, BN, ReLU, conv, BN, ReLU, SE) and ``fc.{0,2}`` (Linear, ReLU,
  Linear; no bias, reduction 16); in train mode the two convs' biases get
  no gradient (:class:`BNFedConv2d`);
- :class:`SEBlock` (FCN-CA bottlenecks): the same squeeze-excite with a
  bias-free 1x1-conv MLP, ``fc.{0,2}``;
- :class:`ChannelAttentionModule` (DeepLab-CA, CBAM channel): avg- and
  max-pooled descriptors through one shared 1x1-conv MLP ``mlp.{0,2}``,
  summed, sigmoid;
- :class:`SpatialAttentionDC` (U-Net-SA): channel mean and max ->
  ``compress_and_map`` = DoubleConv(2 -> 1) -> sigmoid -> per-pixel rescale;
- :class:`SpatialAttentionConv` (DeepLab-SA / FCN-SA, CBAM spatial):
  channel mean and max -> ``conv`` (2 -> 1, k x k, no bias) -> sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn

from insarseg_torch.ops.layers import global_avg_pool, global_max_pool


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


class BNFedConv2d(nn.Conv2d):
    """A conv whose output feeds a BatchNorm directly (the JAX package's
    ``Conv2d(stop_bias_grad=train)``, ``insarseg/ops/layers.py:80-89``). In
    train mode BN subtracts the batch mean, so a per-channel shift cancels
    and the bias's gradient is exactly zero; autograd would give float
    noise (~1e-8) instead, on which Adam takes full-size steps. So in train
    mode the conv uses the detached bias, and the bias gets no gradient
    and keeps its value; the state_dict names are ``nn.Conv2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias
        if self.training and bias is not None:
            bias = bias.detach()
        return self._conv_forward(x, self.weight, bias)


class DoubleConv(nn.Module):
    """(Conv3x3 same-pad -> BN -> ReLU) x2, optional SE tail."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_se: bool = False):
        super().__init__()
        layers = [
            BNFedConv2d(in_channels, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
            BNFedConv2d(out_channels, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        ]
        if use_se:
            layers.append(SELayer(out_channels))
        self.double_conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class SEBlock(nn.Module):
    """GAP -> 1x1 conv (C -> C/r) -> ReLU -> 1x1 conv (C/r -> C) ->
    sigmoid -> channelwise rescale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Conv2d(channels, channels // reduction, 1, bias=False),
            nn.ReLU(inplace=True),
            nn.Conv2d(channels // reduction, channels, 1, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(global_avg_pool(x))


class ChannelAttentionModule(nn.Module):
    """sigmoid(MLP(avgpool(x)) + MLP(maxpool(x))) * x, one shared MLP."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Conv2d(channels, channels // reduction, 1, bias=False),
            nn.ReLU(inplace=True),
            nn.Conv2d(channels // reduction, channels, 1, bias=False),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = self.mlp(global_avg_pool(x)) + self.mlp(global_max_pool(x))
        return x * torch.sigmoid(att)


def _mean_max(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 2, H, W): the channel mean and max."""
    return torch.cat([x.mean(dim=1, keepdim=True),
                      x.amax(dim=1, keepdim=True)], dim=1)


class SpatialAttentionDC(nn.Module):
    """x * sigmoid(DoubleConv(2 -> 1)([mean_c(x), max_c(x)]))."""

    def __init__(self):
        super().__init__()
        self.compress_and_map = DoubleConv(2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.compress_and_map(_mean_max(x)))


class SpatialAttentionConv(nn.Module):
    """x * sigmoid(conv([mean_c(x), max_c(x)])), kernel 3 or 7."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        if kernel_size not in (3, 7):
            raise ValueError("kernel size must be 3 or 7")
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(_mean_max(x)))
