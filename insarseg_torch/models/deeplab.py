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
(pad = rate) + ``convs.4`` image pooling (GAP -> 1x1 -> BN with the JAX
package's batch statistics, ``ops/layers.py::MomentBatchNorm2d`` -> ReLU,
then broadcast back), each 256 wide, concatenated (1280) -> ``project``
1x1 -> BN -> ReLU -> Dropout(0.5).

Under a spatial context (``parallel/spatial.py``, ``x`` a slab of the H
axis) the backbone runs as ``models/resnet.py`` says; the atrous
branches take halos of 12, 24 and 36 rows (from as many slabs as they
reach), the pooled branch is the whole image's mean
(``ops/layers.py::GlobalAvgPool2d``) on every slab, its BN marked
``replicated``, broadcast to the slab's rows; the head's 3x3, CBAM
channel (the global average and max over every slab) or spatial (a 7x7
halo) and the final resize (``ops/resize.py``) read across the slabs.
Dropout draws per rank, so a spatial step equals one device's only with
it off.

In train mode each BN -> ReLU pair (the ASPP branches, the pooled
branch, ``project``, ``classifier.2`` / ``.3``) runs as one
``ops/layers.py::bn_train`` call (K8a-K9b on the card;
:class:`~insarseg_torch.ops.layers.BNSequential`).
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
from insarseg_torch.ops.layers import (
    BNSequential,
    Conv2d,
    GlobalAvgPool2d,
    MomentBatchNorm2d,
)
from insarseg_torch.ops.resize import resize_bilinear


def _conv_bn_relu(cin: int, cout: int, k: int = 1, dilation: int = 1,
                  bn=nn.BatchNorm2d):
    return [Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2,
                   dilation=dilation, bias=False),
            bn(cout), nn.ReLU(inplace=True)]


ASPP_RATES = (12, 24, 36)


class ASPP(nn.Module):
    """2048 -> 256 channels at rates :data:`ASPP_RATES`."""

    def __init__(self, in_channels: int = 2048, features: int = 256):
        super().__init__()
        branches = [BNSequential(*_conv_bn_relu(in_channels, features))]
        branches += [BNSequential(*_conv_bn_relu(in_channels, features, 3, r))
                     for r in ASPP_RATES]
        # the pooled branch has one value per channel at batch 1, and the
        # same map on every slab of a spatial mesh
        pooled = _conv_bn_relu(in_channels, features, bn=MomentBatchNorm2d)
        pooled[1].replicated = True
        branches.append(BNSequential(GlobalAvgPool2d(), *pooled))
        self.convs = nn.ModuleList(branches)
        self.project = BNSequential(
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
                ("1", Conv2d(256, 256, 3, padding=1, bias=False))]
        if attention != "spatial":
            head += [("2", nn.BatchNorm2d(256)), ("3", nn.ReLU(inplace=True))]
        head.append(("4", Conv2d(256, num_classes, 1)))
        self.classifier = BNSequential(OrderedDict(head))
        if attention == "channel":
            self.attention_module = ChannelAttentionModule(256)
        elif attention == "spatial":
            self.attention_module = SpatialAttentionConv(7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.backbone(x)["out"]
        head = self.classifier
        if self.attention != "none":
            # the attention sits before the last conv, "4"
            y = self.attention_module(head[:-1](y))
            head = head[-1]
        return resize_bilinear(head(y), x.shape[-2:])
