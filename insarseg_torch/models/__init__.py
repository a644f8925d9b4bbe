"""Models and packed serving graphs of the port."""

from insarseg_torch.models.unet import UNet

__all__ = ["UNet"]
