"""JAX ``{'params','batch_stats'}`` trees <-> reference PyTorch state_dicts.

Own copy of ``insarseg/compat/torch_io.py::unet_variables_to_torch`` (the
port imports nothing of the JAX package). Input: the JAX variables as numpy
arrays (or anything ``np.asarray`` takes). Output: numpy arrays under the
reference's state_dict names (``inc.double_conv.0``, ``down{i}.1.…``,
``….double_conv.6.fc.0/2``, ``up{i}``, ``outc``), which
``insarseg_torch.models.unet.UNet.load_state_dict(strict=True)`` accepts.

Layout maps (NHWC/HWIO jax -> NCHW/OIHW torch):

- Conv kernel (kh, kw, I, O)  -> Conv2d.weight (O, I, kh, kw)
- ConvT kernel (kh, kw, I, O) -> ConvTranspose2d.weight (I, O, kh, kw)
- Dense kernel (I, O)         -> Linear.weight (O, I)
- BN scale/bias + mean/var    -> weight/bias + running_mean/var
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a ``.pth`` state_dict into numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}


def state_dict_to_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """numpy state_dict -> torch tensors (for ``load_state_dict``)."""
    return {k: torch.as_tensor(np.ascontiguousarray(_np(v)))
            for k, v in sd.items()}


def unet_variables_to_torch(
    variables: Mapping[str, Any], use_se: bool = False, use_sa: bool = False
) -> Dict[str, np.ndarray]:
    """insarseg UNet variables -> reference torch state_dict (numpy)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}

    def put_conv(jp, tmod, transpose=False):
        k = _np(jp["kernel"])
        out[f"{tmod}.weight"] = (
            k.transpose(2, 3, 0, 1) if transpose else k.transpose(3, 2, 0, 1)
        )
        if "bias" in jp:
            out[f"{tmod}.bias"] = _np(jp["bias"])

    def put_bn(jp, js, tmod):
        out[f"{tmod}.weight"] = _np(jp["scale"])
        out[f"{tmod}.bias"] = _np(jp["bias"])
        out[f"{tmod}.running_mean"] = _np(js["mean"])
        out[f"{tmod}.running_var"] = _np(js["var"])
        out[f"{tmod}.num_batches_tracked"] = np.asarray(0)

    def put_dc(jp, js, tmod, se):
        put_conv(jp["conv1"], f"{tmod}.double_conv.0")
        put_bn(jp["bn1"], js["bn1"], f"{tmod}.double_conv.1")
        put_conv(jp["conv2"], f"{tmod}.double_conv.3")
        put_bn(jp["bn2"], js["bn2"], f"{tmod}.double_conv.4")
        if se:
            out[f"{tmod}.double_conv.6.fc.0.weight"] = \
                _np(jp["se"]["fc1"]["kernel"]).T
            out[f"{tmod}.double_conv.6.fc.2.weight"] = \
                _np(jp["se"]["fc2"]["kernel"]).T

    put_dc(params["inc"], stats["inc"], "inc", use_se)
    for i in range(1, 5):
        put_dc(params[f"down{i}"], stats[f"down{i}"], f"down{i}.1", use_se)
        put_conv(params[f"up{i}"], f"up{i}", transpose=True)
        put_dc(params[f"conv{i}"], stats[f"conv{i}"], f"conv{i}", use_se)
        if use_sa:
            put_dc(
                params[f"sa{i}"]["compress_and_map"],
                stats[f"sa{i}"]["compress_and_map"],
                f"sa{i}.compress_and_map", False,
            )
    put_conv(params["outc"], "outc")
    return out
