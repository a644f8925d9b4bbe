"""FCN-ResNet50 family — the models the reference calls "PSPNet"
(counterpart of ``insarseg/models/fcn.py``), NCHW in and out.

``attention``: 'none'; 'channel' puts an SE block in every bottleneck;
'spatial' applies CBAM-spatial (``spatial_attention``) to the backbone
output before the head. The head is torchvision's ``FCNHead`` under the
name ``classifier``: ``0`` conv3x3 (2048 -> 512, bias-free), ``1`` BN,
``2`` ReLU, ``3`` Dropout(0.1), ``4`` conv1x1 (512 -> num_classes); the
logits are bilinearly resized to the input size (align_corners=False).

Under a spatial context (``parallel/spatial.py``, ``x`` a slab of the H
axis) the backbone runs as ``models/resnet.py`` says, and the head's 3x3
(and CBAM-spatial's 7x7) take halos and the final resize reads the
neighbouring slabs' edge rows (``ops/resize.py``). Dropout draws per
rank, as on the data mesh, so a spatial step equals one device's only
with dropout off.
"""

from __future__ import annotations

import torch
from torch import nn

from insarseg_torch.models.resnet import build_backbone
from insarseg_torch.ops.blocks import SpatialAttentionConv
from insarseg_torch.ops.layers import BNSequential, Conv2d
from insarseg_torch.ops.resize import resize_bilinear


class FCNHead(BNSequential):
    """torchvision's ``FCNHead``; in train mode its BN and ReLU run as one
    ``ops/layers.py::bn_train`` call."""

    def __init__(self, in_channels: int, num_classes: int):
        inter = in_channels // 4
        super().__init__(
            Conv2d(in_channels, inter, 3, padding=1, bias=False),
            nn.BatchNorm2d(inter),
            nn.ReLU(inplace=True),
            nn.Dropout(0.1),
            Conv2d(inter, num_classes, 1),
        )


class FCN(nn.Module):
    def __init__(self, num_classes: int = 2, attention: str = "none",
                 backbone: str = "resnet50", in_channels: int = 1):
        super().__init__()
        if attention not in ("none", "channel", "spatial"):
            raise ValueError(f"unknown attention {attention!r}")
        self.num_classes = num_classes
        self.attention = attention
        self.backbone = build_backbone(backbone, attention == "channel",
                                       in_channels)
        if attention == "spatial":
            self.spatial_attention = SpatialAttentionConv(7)
        self.classifier = FCNHead(2048, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.backbone(x)["out"]
        if self.attention == "spatial":
            y = self.spatial_attention(y)
        return resize_bilinear(self.classifier(y), x.shape[-2:])
