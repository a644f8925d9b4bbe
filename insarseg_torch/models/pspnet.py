"""The true PSPNet, a pyramid-pooling head on the dilated ResNet-50
(counterpart of ``insarseg/models/pspnet.py``), NCHW in and out.

``attention``: 'none'; 'channel' puts an SE block in every bottleneck;
'spatial' applies CBAM-spatial (``spatial_attention``) to the backbone
output before the head. The head: for bins (1, 2, 3, 6), the backbone
output adaptive-average-pooled to bin x bin (``ops/layers.py``, the JAX
package's integral-image form) -> ``ppm.conv_bin{b}`` 1x1 (2048 -> 512,
bias-free) -> ``ppm.bn_bin{b}`` (the JAX package's batch statistics,
which a 1x1 bin at batch 1 needs: ``ops/layers.py::MomentBatchNorm2d``)
-> ReLU -> bilinear resize back; the four concatenated after the input
(4096 channels) -> ``bottleneck_conv`` 3x3
(4096 -> 512, bias-free) -> ``bottleneck_bn`` -> ReLU -> Dropout(0.1) ->
``classifier`` 1x1 -> bilinear resize to the input size.

Under a spatial context (``parallel/spatial.py``, ``x`` a slab of the H
axis) the backbone runs as ``models/resnet.py`` says; the pools read
every slab and give each slab the whole bin maps (``ops/layers.py::
adaptive_avg_pools``), whose convs run as they are and whose BNs are
marked ``replicated``; each map is resized to the slab's rows of the
global output (``resize_bilinear(..., replicated=True)``), and
``bottleneck_conv`` takes a halo. Dropout draws per rank, so a spatial
step equals one device's only with it off. In train mode each BN ->
ReLU pair (``ppm.bn_bin{b}``, ``bottleneck_bn``) runs as one
``ops/layers.py::bn_train`` call (K8a-K9b on the card; ``bn_act``).

The reference has no such model (its "PSPNet" scripts are FCN-ResNet50),
so the module names follow the JAX package's parameter tree, and weights
cross with ``compat.pspnet_variables_to_torch``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from insarseg_torch.models.resnet import build_backbone
from insarseg_torch.ops.blocks import SpatialAttentionConv
from insarseg_torch.ops.layers import (
    Conv2d,
    MomentBatchNorm2d,
    adaptive_avg_pools,
    bn_act,
)
from insarseg_torch.ops.resize import resize_bilinear

BINS = (1, 2, 3, 6)


class PyramidPooling(nn.Module):
    def __init__(self, in_channels: int = 2048, bins: Sequence[int] = BINS,
                 branch_features: int = 512):
        super().__init__()
        self.bins = tuple(bins)
        for b in self.bins:
            setattr(self, f"conv_bin{b}",
                    Conv2d(in_channels, branch_features, 1, bias=False))
            bn = MomentBatchNorm2d(branch_features)
            bn.replicated = True  # the same map on every slab
            setattr(self, f"bn_bin{b}", bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[-2:]
        outs = [x]
        for b, pooled in zip(self.bins, adaptive_avg_pools(x, self.bins)):
            p = getattr(self, f"conv_bin{b}")(pooled)
            p = bn_act(p, getattr(self, f"bn_bin{b}"))
            outs.append(resize_bilinear(p, size, replicated=True))
        return torch.cat(outs, dim=1)


class PSPNet(nn.Module):
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
        self.ppm = PyramidPooling(2048)
        self.bottleneck_conv = Conv2d(4096, 512, 3, padding=1, bias=False)
        self.bottleneck_bn = nn.BatchNorm2d(512)
        self.dropout = nn.Dropout(0.1)
        self.classifier = Conv2d(512, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.backbone(x)["out"]
        if self.attention == "spatial":
            y = self.spatial_attention(y)
        y = bn_act(self.bottleneck_conv(self.ppm(y)), self.bottleneck_bn)
        y = self.classifier(self.dropout(y))
        return resize_bilinear(y, x.shape[-2:])
