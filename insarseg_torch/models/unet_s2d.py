"""BN-folded standard-layout packing and the float conv helpers the packed
graphs share (counterpart of the standard-layout half of
``insarseg/models/unet_s2d.py``: ``_fold_dc``, ``pack_unet_folded``,
``_conv_affine``, ``_conv_transpose_k2s2``).

Packed trees keep the JAX package's keys and layouts — conv kernels HWIO,
transposed-conv kernels (kh, kw, I, O), SE MLPs (in, out), the head (f, nc)
— so a tree the JAX package packed (``insarseg_torch.engines_io``) and one
packed here are interchangeable. The packers read the port's state_dict.
The H-space-to-depth layout (``pack_unet_s2d`` and its forward) is ROADMAP
Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from insarseg_torch.ops.fold import fold_bn


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """Conv2d weight (O, I, kh, kw) -> HWIO."""
    return w.detach().to(torch.float32).permute(2, 3, 1, 0).contiguous()


def _fold_dc(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    """One DoubleConv's state_dict entries under ``prefix`` -> folded
    {'k1','s1','b1','k2','s2','b2'[, 'fc1','fc2']}."""
    out: Dict[str, Any] = {}
    for tag, ci, bi in (("1", 0, 1), ("2", 3, 4)):
        conv, bn = f"{prefix}.double_conv.{ci}", f"{prefix}.double_conv.{bi}"
        s, b = fold_bn(sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                       sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                       sd.get(f"{conv}.bias"))
        out[f"k{tag}"], out[f"s{tag}"], out[f"b{tag}"] = \
            _hwio(sd[f"{conv}.weight"]), s, b
    fc = f"{prefix}.double_conv.6.fc"
    if f"{fc}.0.weight" in sd:
        out["fc1"] = sd[f"{fc}.0.weight"].detach().to(torch.float32).t() \
            .contiguous()
        out["fc2"] = sd[f"{fc}.2.weight"].detach().to(torch.float32).t() \
            .contiguous()
    return out


def _optional(sd: Mapping[str, torch.Tensor],
              key: str) -> Optional[torch.Tensor]:
    v = sd.get(key)
    return None if v is None else v.detach().to(torch.float32)


def pack_unet_folded(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """UNet state_dict -> BN-folded tree in the standard layout (the tree of
    ``insarseg.models.unet_s2d.pack_unet_folded``)."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    if any(k.startswith("sa1.") for k in sd):
        raise NotImplementedError(
            "the SA UNet variant is not ported yet (ROADMAP Queue 1 item 2, "
            "Queue 2 K4)")
    packed: Dict[str, Any] = {"inc": _fold_dc(sd, "inc")}
    for i in range(1, 5):
        packed[f"down{i}"] = _fold_dc(sd, f"down{i}.1")
    for i in range(1, 5):
        packed[f"up{i}"] = {
            # ConvTranspose2d (I, O, kh, kw) -> (kh, kw, I, O)
            "k": sd[f"up{i}.weight"].to(torch.float32).permute(2, 3, 0, 1)
            .contiguous(),
            "bias": _optional(sd, f"up{i}.bias"),
        }
        packed[f"conv{i}"] = _fold_dc(sd, f"conv{i}")
    wo = sd["outc.weight"].to(torch.float32)[:, :, 0, 0].t().contiguous()
    packed["outc"] = {"k": wo, "bias": _optional(sd, "outc.bias"),
                      "nc": int(wo.shape[-1])}
    return packed


# ---------------------------------------------------------------------------
# forward helpers (NCHW; dtype follows the input, params cast on the fly)
# ---------------------------------------------------------------------------

def _chan(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype)[None, :, None, None]


def _conv_affine(x: torch.Tensor, k: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Same-pad conv with an HWIO kernel, then the folded-BN affine."""
    pad = (k.shape[0] - 1) // 2
    y = F.conv2d(x, k.permute(3, 2, 0, 1).to(x.dtype), padding=pad)
    y = y * _chan(scale, y.dtype) + _chan(bias, y.dtype)
    return torch.relu(y) if relu else y


def _conv_transpose_k2s2(x: torch.Tensor, k: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """ConvTranspose(k2, s2) with a (kh, kw, I, O) kernel."""
    y = F.conv_transpose2d(x, k.permute(2, 3, 0, 1).to(x.dtype), stride=2)
    return y if bias is None else y + _chan(bias, y.dtype)
