"""Model registry (counterpart of ``insarseg/models/registry.py``): the
port's ``nn.Module`` for a (model, attention) cell of the reference, by
name or from a ``config.Config``.

The modules hold f32 parameters and compute in their input's dtype
(``ops/layers.py``): ``Config.compute_dtype`` is applied where the input
enters, by the train and eval steps (``train/engine.py``) and the module
engine (``parallel/inference.py``, ``input_dtype``), not by the module.
``remat`` rematerializes the U-Net families' DoubleConvs; the other
families raise the JAX package's ``ValueError``."""

from __future__ import annotations

from typing import Union

from torch import nn

from insarseg_torch.models.deeplab import DeepLabV3
from insarseg_torch.models.fcn import FCN
from insarseg_torch.models.pspnet import PSPNet
from insarseg_torch.models.unet import UNet


# the families a spatial mesh runs (``parallel/spatial.py``)
SHARDS_H = ("unet", "unet-fast", "deeplabv3", "fcn", "pspnet")


def check_spatial(model: Union[str, nn.Module]) -> None:
    """Raise ``NotImplementedError`` unless ``model`` (a name, or a module)
    is of a family whose H axis a spatial mesh shards: every family of the
    registry (:data:`SHARDS_H`), at any H that the slabs divide and the
    module takes unsharded (``parallel/spatial.py``)."""
    from insarseg_torch.models.unet_stem import UNetFastS2D

    ok = isinstance(model, (UNet, UNetFastS2D, DeepLabV3, FCN, PSPNet)) \
        if isinstance(model, nn.Module) \
        else model.lower().replace("_", "-") in SHARDS_H
    if not ok:
        raise NotImplementedError(
            f"a spatial mesh (mesh_spatial > 1) shards the H axis of the "
            f"registry's families {SHARDS_H}, not of {model!r}")


def build_model(cfg) -> nn.Module:
    """The module a ``config.Config`` describes (f32 weights; the compute
    dtype is the steps', ``train/engine.py::fit``)."""
    return build(cfg.model, cfg.attention, num_classes=cfg.num_classes,
                 backbone=cfg.backbone, in_channels=cfg.in_channels,
                 remat=cfg.remat)


def build(model: str, attention: str = "none", num_classes: int = 2,
          backbone: str = "resnet50", in_channels: int = 1,
          remat: bool = False) -> nn.Module:
    """The port's module for ``model`` in {unet, unet-fast, deeplabv3,
    fcn, pspnet} and ``attention`` in {none, channel, spatial}."""
    model, attention = model.lower().replace("_", "-"), attention.lower()
    if attention not in ("none", "channel", "spatial"):
        raise ValueError(f"unknown attention {attention!r}")
    if model == "unet":
        return UNet(num_classes=num_classes, use_se=attention == "channel",
                    use_sa=attention == "spatial", in_channels=in_channels,
                    remat=remat)
    if model == "unet-fast":
        from insarseg_torch.models.unet_stem import UNetFastS2D

        return UNetFastS2D(num_classes=num_classes,
                           use_se=attention == "channel",
                           use_sa=attention == "spatial",
                           in_channels=in_channels, remat=remat)
    if remat:
        raise ValueError(
            f"remat is implemented for the UNet families only, not "
            f"{model!r}")
    if model == "deeplabv3":
        return DeepLabV3(num_classes, attention, backbone, in_channels)
    if model == "fcn":
        return FCN(num_classes, attention, backbone, in_channels)
    if model == "pspnet":
        return PSPNet(num_classes, attention, backbone, in_channels)
    raise KeyError(f"unknown model {model!r}; expected "
                   "unet|unet-fast|deeplabv3|fcn|pspnet")
