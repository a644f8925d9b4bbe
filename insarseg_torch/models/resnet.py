"""Dilated ResNet-50/101 backbone with torchvision's module names
(counterpart of ``insarseg/models/resnet.py``), NCHW.

- stem: ``conv1`` 7x7 s2 p3 (bias-free, ``in_channels`` -> 64) -> ``bn1``
  -> ReLU -> max-pool 3x3 s2 p1;
- ``layer1..layer4`` of :class:`Bottleneck` blocks, widths 64/128/256/512,
  expansion 4; torchvision's dilation bookkeeping with
  ``replace_stride_with_dilation=(False, True, True)`` (output stride 8):
  a dilated layer's stride turns into dilation, and its *first* block keeps
  the previous dilation, so layer3 runs at d(1,2,2,2,2,2) and layer4 at
  d(2,4,4) (:func:`layer_schedule`);
- the stride sits on the 3x3 ``conv2`` and on ``downsample.0``;
- optional SE (``se_block``, :class:`~insarseg_torch.ops.blocks.SEBlock`)
  after ``bn3``, before the residual add;
- torchvision's init, as the JAX package draws it
  (``insarseg/models/resnet.py:39-43``): every backbone conv (not the SE
  MLP) kaiming-normal with fan_out (:class:`KaimingConv2d`), BN gamma 1
  and beta 0.

``forward`` returns ``{'out': layer4, 'aux': layer3}``.

Every BatchNorm runs through ``ops/layers.py::bn_act`` with what
follows it: the stem's, bn1's and bn2's with their ReLU, ``downsample.1``
alone, bn3 with the residual add and its ReLU (``relu(bn3 +
identity)``), or, with an SE block, bn3 alone, then the SE, the add and
the ReLU as one ``SEBlock(x, identity)`` call. In train mode each
BatchNorm is one ``bn_train`` call (K8a-K9b on the card, the JAX
package's moment rule, the identity's gradient from K9b) and the SE tail
one ``kernels/se_train.py::se_train`` call in its residual mode (K10a-K11b
on the card, the identity's gradient from K11b); in eval mode the
modules and the torch ops.

Under a spatial context (``parallel/spatial.py``: the H axis sharded,
``x`` one slab of it) every conv and the stem's max-pool run as windows
along H (``ops/layers.py::Conv2d``, ``max_pool_2d``): the stem's 7x7 / 2
and 3x3 / 2 pool (a -inf halo), each strided ``conv2`` and
``downsample.0`` (output row j on the slab holding input row 2j), the
dilated 3x3s of layer3 and layer4, whose halos reach past small and
empty slabs. Any H that the slabs divide runs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from insarseg_torch.ops.blocks import SEBlock
from insarseg_torch.ops.layers import Conv2d, bn_act, max_pool_2d

WIDTHS = (64, 128, 256, 512)
BACKBONE_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def backbone_layers(name: str) -> Tuple[int, ...]:
    if name not in BACKBONE_LAYERS:
        raise ValueError(f"Unsupported backbone: {name}")
    return BACKBONE_LAYERS[name]


def layer_schedule(layers: Sequence[int],
                   replace_stride_with_dilation=(False, True, True)
                   ) -> List[List[Tuple[int, int]]]:
    """torchvision's stride / dilation bookkeeping: per layer, the
    (stride, dilation) of each block."""
    dilation = 1
    sched = []
    for li, stride in enumerate((1, 2, 2, 2)):
        dilate = li > 0 and replace_stride_with_dilation[li - 1]
        previous_dilation = dilation
        if dilate:
            dilation *= stride
            stride = 1
        sched.append([(stride, previous_dilation)]
                     + [(1, dilation)] * (layers[li] - 1))
    return sched


class KaimingConv2d(Conv2d):
    """A bias-free ``ops/layers.py::Conv2d`` drawn
    ``kaiming_normal_(mode='fan_out', nonlinearity='relu')``,
    N(0, 2 / (cout kh kw)), from torch's default generator."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, bias=False, **kwargs)

    def reset_parameters(self) -> None:
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4), optional SE before the
    residual add."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_se: bool = False):
        super().__init__()
        out = planes * 4
        self.conv1 = KaimingConv2d(in_planes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = KaimingConv2d(planes, planes, 3, stride=stride,
                                   padding=dilation, dilation=dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = KaimingConv2d(planes, out, 1)
        self.bn3 = nn.BatchNorm2d(out)
        self.se_block = SEBlock(out) if use_se else None
        self.downsample = None
        if stride != 1 or in_planes != out:
            self.downsample = nn.Sequential(
                KaimingConv2d(in_planes, out, 1, stride=stride),
                nn.BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = bn_act(self.conv1(x), self.bn1)
        y = bn_act(self.conv2(y), self.bn2)
        identity = x
        if self.downsample is not None:
            identity = bn_act(self.downsample[0](x), self.downsample[1],
                              "none")
        if self.se_block is None:
            return bn_act(self.conv3(y), self.bn3, "residual", identity)
        return self.se_block(bn_act(self.conv3(y), self.bn3, "none"),
                             identity)


class ResNet50(nn.Module):
    """ResNet-50 (``layers=(3, 4, 6, 3)``) or -101 (``(3, 4, 23, 3)``)
    feature extractor at output stride 8, no avgpool / fc."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 use_se: bool = False, in_channels: int = 1):
        super().__init__()
        self.conv1 = KaimingConv2d(in_channels, 64, 7, stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(64)
        in_planes = 64
        for li, blocks in enumerate(layer_schedule(layers)):
            mods = []
            for stride, dilation in blocks:
                mods.append(Bottleneck(in_planes, WIDTHS[li], stride,
                                       dilation, use_se))
                in_planes = WIDTHS[li] * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = max_pool_2d(bn_act(self.conv1(x), self.bn1), 3, 2, 1)
        x = self.layer2(self.layer1(x))
        aux = self.layer3(x)
        return {"out": self.layer4(aux), "aux": aux}


def build_backbone(name: str = "resnet50", use_se: bool = False,
                   in_channels: int = 1) -> ResNet50:
    return ResNet50(backbone_layers(name), use_se, in_channels)
