"""The space-to-depth fast U-Net, ``model='unet-fast'`` (counterpart of
``insarseg/models/unet_stem.py``).

A lossless space-to-depth stem ``(B, H, W, C) -> (B, H/f, W/f, f*f*C)``,
an inner :class:`~insarseg_torch.models.unet.UNet` named ``unet`` with the
channel plan ``(l1, l1, 2 l1, 4 l1, 8 l1)`` and ``f*f*num_classes``
outputs, and depth-to-space back to ``(B, H, W, num_classes)``. It is not
the reference's architecture: its weights come from training the fast cell
(JAX weights cross through the inner tree, :func:`fast_variables_to_torch`).

Its engines run the inner UNet's graphs with the stem and its inverse at
the rim: serve is the deferred-SE graph (``models/unet_serve.py``), int8
the standard-layout int8 graph (``models/unet_int8.py``, ``s2d=False``),
so the int8 forward runs kernels K1-K3 and K6 (and K4 for the SA cell) at
the inner UNet's widths and needs no kernel of its own. ``remat``
rematerializes the inner UNet's DoubleConvs, as the JAX module's does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from insarseg_torch.engines import check_hw
from insarseg_torch.models.unet import UNet
from insarseg_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw, slab_rule


def space_to_depth(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f*f*C); channel order (dr, dc, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)


def depth_to_space(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(B, H, W, f*f*C) -> (B, f*H, f*W, C); inverse of space_to_depth."""
    b, h, w, fc = x.shape
    c = fc // (f * f)
    x = x.reshape(b, h, w, f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, f * h, f * w, c)


class UNetFastS2D(nn.Module):
    """Space-to-depth-stem UNet. NCHW in and out, as the port's UNet;
    H and W divisible by ``16 * factor``. Under a spatial mesh
    (``parallel/spatial.py``) the stem and its inverse are local to a slab
    whose height is a multiple of ``16 * factor``, which is checked."""

    def __init__(self, num_classes: int = 2, level1_features: int = 128,
                 use_se: bool = False, use_sa: bool = False, factor: int = 2,
                 in_channels: int = 1, remat: bool = False):
        super().__init__()
        f, l1 = factor, level1_features
        self.num_classes, self.factor = num_classes, factor
        self.use_se, self.use_sa = use_se, use_sa
        self.unet = UNet(num_classes=num_classes * f * f,
                         in_channels=in_channels * f * f, use_se=use_se,
                         use_sa=use_sa, shape_fix=False,
                         features_plan=(l1, l1, 2 * l1, 4 * l1, 8 * l1),
                         remat=remat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor
        slab_rule(x, 16 * f, f"unet-fast (space-to-depth by {f}, then the "
                  "U-Net's four halvings)")
        y = self.unet(nhwc_to_nchw(space_to_depth(nchw_to_nhwc(x), f)))
        return nhwc_to_nchw(depth_to_space(nchw_to_nhwc(y), f))


def fast_variables_to_torch(variables: Mapping[str, Any], use_se: bool = False,
                            use_sa: bool = False) -> Dict[str, np.ndarray]:
    """The JAX fast cell's variables -> a :class:`UNetFastS2D` state_dict
    (numpy): the inner tree ``params['unet']`` / ``batch_stats['unet']``
    through ``compat.unet_variables_to_torch``, under ``unet.``."""
    from insarseg_torch.compat import unet_variables_to_torch

    inner = {"params": variables["params"]["unet"],
             "batch_stats": variables["batch_stats"]["unet"]}
    sd = unet_variables_to_torch(inner, use_se=use_se, use_sa=use_sa)
    return {f"unet.{k}": v for k, v in sd.items()}


def pack_fast(state_dict: Mapping[str, torch.Tensor], engine: str,
              factor: int, calib_batches: Optional[List[Any]] = None,
              calib_stat: str = "absmax", device=None) -> Dict[str, Any]:
    """The serve or int8 tree of the inner UNet (the JAX package's
    ``pack_engine('unet-fast', ...)`` tree) from a :class:`UNetFastS2D`
    state_dict; int8 calibrates on the space-to-depth calibration batches
    in the standard layout."""
    inner = {k[len("unet."):]: v for k, v in state_dict.items()
             if k.startswith("unet.")}
    if engine == "serve":
        from insarseg_torch.models.unet_serve import pack_unet_serve

        return pack_unet_serve(inner)
    from insarseg_torch.models.unet_int8 import pack_unet_int8

    calib = [space_to_depth(torch.as_tensor(np.asarray(b, np.float32)),
                            factor).numpy() for b in calib_batches]
    return pack_unet_int8(inner, calib, s2d=False, calib_stat=calib_stat,
                          device=device)


def make_fast_predict_fn(packed: Dict[str, Any], engine: str, factor: int,
                         num_classes: int, argmax: bool = False,
                         input_dtype: Optional[torch.dtype] = None):
    """``predict(images)`` of the fast cell's serve or int8 engine over a
    packed inner tree already on its device (for int8, a ``prepare_int8``
    tree in the standard layout): space-to-depth, the inner graph, then
    depth-to-space (or one argmax per stem position)."""
    if engine == "serve":
        from insarseg_torch.models.unet_serve import unet_serve_apply as apply
    else:
        from insarseg_torch.models.unet_int8 import unet_int8_apply as apply
    device = packed["outc"]["k"].device
    f = factor

    @torch.inference_mode()
    def predict(images):
        check_hw(tuple(images.shape), 16 * f, 16 * f, engine, "unet-fast")
        images = torch.as_tensor(images, device=device).to(
            input_dtype or torch.float32)
        y = apply(packed, space_to_depth(images, f))
        if not argmax:
            return depth_to_space(y, f)
        b, h, w, _ = y.shape
        cls = y.reshape(b, h, w, f * f, num_classes).argmax(-1)
        return depth_to_space(cls.to(torch.int32), f)[..., 0]

    return predict
