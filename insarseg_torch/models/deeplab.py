"""DeepLabV3-ResNet50 family: plain / channel / spatial attention
(counterpart of ``insarseg/models/deeplab.py``), NCHW in and out.

torchvision's ``deeplabv3_resnet50`` graph under its names: ``classifier``
is ``0`` :class:`ASPP`, ``1`` conv3x3 (256 -> 256, bias-free), ``2`` BN,
``3`` ReLU, ``4`` conv1x1 (256 -> num_classes). The attention variants put
``attention_module`` (CBAM channel or CBAM spatial, k7) between
``classifier.3`` and ``classifier.4``. The SA variant keeps the reference's
quirk: ``classifier.1`` is a bare conv, with no ``classifier.2`` BN and no
ReLU. The logits are bilinearly resized to the input size.

ASPP: ``convs.0`` 1x1 + ``convs.1..3`` 3x3 atrous at rates 12/24/36
(pad = rate) + ``convs.4`` image pooling (GAP -> 1x1 -> BN -> ReLU, then
broadcast back), each 256 wide, concatenated (1280) -> ``project`` 1x1 ->
BN -> ReLU -> Dropout(0.5).
"""

from __future__ import annotations

from collections import OrderedDict
import torch
from torch import nn

from insarseg_torch.models.resnet import build_backbone
from insarseg_torch.ops.blocks import (
    ChannelAttentionModule,
    SpatialAttentionConv,
)
from insarseg_torch.ops.resize import resize_bilinear


def _conv_bn_relu(cin: int, cout: int, k: int = 1, dilation: int = 1):
    return [nn.Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2,
                      dilation=dilation, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU(inplace=True)]


ASPP_RATES = (12, 24, 36)


class ASPP(nn.Module):
    """2048 -> 256 channels at rates :data:`ASPP_RATES`."""

    def __init__(self, in_channels: int = 2048, features: int = 256):
        super().__init__()
        branches = [nn.Sequential(*_conv_bn_relu(in_channels, features))]
        branches += [nn.Sequential(*_conv_bn_relu(in_channels, features, 3, r))
                     for r in ASPP_RATES]
        branches.append(nn.Sequential(
            nn.AdaptiveAvgPool2d(1), *_conv_bn_relu(in_channels, features)))
        self.convs = nn.ModuleList(branches)
        self.project = nn.Sequential(
            *_conv_bn_relu(features * len(branches), features),
            nn.Dropout(0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [c(x) for c in self.convs]
        ys[-1] = ys[-1].expand(-1, -1, x.shape[2], x.shape[3])
        return self.project(torch.cat(ys, dim=1))


class DeepLabV3(nn.Module):
    def __init__(self, num_classes: int = 2, attention: str = "none",
                 backbone: str = "resnet50", in_channels: int = 1):
        super().__init__()
        if attention not in ("none", "channel", "spatial"):
            raise ValueError(f"unknown attention {attention!r}")
        self.num_classes = num_classes
        self.attention = attention
        self.backbone = build_backbone(backbone, False, in_channels)
        head = [("0", ASPP()),
                ("1", nn.Conv2d(256, 256, 3, padding=1, bias=False))]
        if attention != "spatial":
            head += [("2", nn.BatchNorm2d(256)), ("3", nn.ReLU(inplace=True))]
        head.append(("4", nn.Conv2d(256, num_classes, 1)))
        self.classifier = nn.Sequential(OrderedDict(head))
        if attention == "channel":
            self.attention_module = ChannelAttentionModule(256)
        elif attention == "spatial":
            self.attention_module = SpatialAttentionConv(7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.backbone(x)["out"]
        for name, mod in self.classifier.named_children():
            if name == "4" and self.attention != "none":
                y = self.attention_module(y)
            y = mod(y)
        return resize_bilinear(y, x.shape[-2:])
