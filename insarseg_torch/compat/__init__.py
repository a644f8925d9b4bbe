"""Weight bridges between the JAX package's trees and torch state_dicts."""

from insarseg_torch.compat.torch_io import (
    load_torch_state_dict,
    pspnet_variables_to_torch,
    segmentation_variables_to_torch,
    state_dict_to_torch,
    unet_variables_to_torch,
)

__all__ = ["load_torch_state_dict", "pspnet_variables_to_torch",
           "segmentation_variables_to_torch", "state_dict_to_torch",
           "unet_variables_to_torch"]
