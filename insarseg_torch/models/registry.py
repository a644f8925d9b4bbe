"""Model registry (counterpart of ``insarseg/models/registry.py``): the
port's ``nn.Module`` for a (model, attention) cell of the reference, by
name or from a ``config.Config``."""

from __future__ import annotations

from torch import nn

from insarseg_torch.models.deeplab import DeepLabV3
from insarseg_torch.models.fcn import FCN
from insarseg_torch.models.pspnet import PSPNet
from insarseg_torch.models.unet import UNet


REMAT_TODO = ("insarseg_torch does not rematerialize activations yet; "
              "remat=True is ROADMAP Queue 1 item 19 "
              "(torch.utils.checkpoint)")


def build_model(cfg) -> nn.Module:
    """The module a ``config.Config`` describes (f32 weights; the compute
    dtype is the train step's, ``train/engine.py::fit``)."""
    if cfg.remat:
        raise NotImplementedError(REMAT_TODO)
    return build(cfg.model, cfg.attention, num_classes=cfg.num_classes,
                 backbone=cfg.backbone, in_channels=cfg.in_channels)


def build(model: str, attention: str = "none", num_classes: int = 2,
          backbone: str = "resnet50", in_channels: int = 1) -> nn.Module:
    """The port's module for ``model`` in {unet, unet-fast, deeplabv3,
    fcn, pspnet} and ``attention`` in {none, channel, spatial}."""
    model, attention = model.lower().replace("_", "-"), attention.lower()
    if attention not in ("none", "channel", "spatial"):
        raise ValueError(f"unknown attention {attention!r}")
    if model == "unet":
        return UNet(num_classes=num_classes, use_se=attention == "channel",
                    use_sa=attention == "spatial", in_channels=in_channels)
    if model == "unet-fast":
        from insarseg_torch.models.unet_stem import UNetFastS2D

        return UNetFastS2D(num_classes=num_classes,
                           use_se=attention == "channel",
                           use_sa=attention == "spatial",
                           in_channels=in_channels)
    if model == "deeplabv3":
        return DeepLabV3(num_classes, attention, backbone, in_channels)
    if model == "fcn":
        return FCN(num_classes, attention, backbone, in_channels)
    if model == "pspnet":
        return PSPNet(num_classes, attention, backbone, in_channels)
    raise KeyError(f"unknown model {model!r}; expected "
                   "unet|unet-fast|deeplabv3|fcn|pspnet")
