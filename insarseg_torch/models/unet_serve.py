"""Exact-parity UNet serving graph with deferred SE gates, standard layout
(counterpart of ``insarseg/models/unet_serve.py``).

Same math as the module in eval mode: BN folded into the conv epilogues
and each SE excite multiply moved to where its result is consumed —
``maxpool2(x * g) == maxpool2(x) * g`` for the positive per-channel gate,
skip tensors gated at the decoder concat, the last block at the head's
input. The SA variant's per-pixel gates stay in place after each decoder
concat (they do not commute with pooling); their DoubleConv BNs fold like
everything else. Public functions are NHWC; the graph runs NCHW inside.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from insarseg_torch.engines import check_hw
from insarseg_torch.models.unet_s2d import (
    _conv_affine,
    _conv_transpose_k2s2,
    _sa_gate,
    pack_unet_folded,
)
from insarseg_torch.ops.layers import max_pool_2d, nchw_to_nhwc, nhwc_to_nchw


def pack_unet_serve(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """UNet state_dict -> BN-folded serving tree (the tree of
    ``insarseg.models.unet_serve.pack_unet_serve``; the head kernel stays
    HWIO (1, 1, f, nc))."""
    packed = pack_unet_folded(state_dict)
    wo = packed["outc"]["k"]
    packed["outc"] = {"k": wo[None, None], "bias": packed["outc"]["bias"]}
    return packed


def _dc_gate(pk: Dict, x: torch.Tensor):
    """DoubleConv body; returns (pre-gate output, gate-or-None)."""
    x = _conv_affine(x, pk["k1"], pk["s1"], pk["b1"])
    x = _conv_affine(x, pk["k2"], pk["s2"], pk["b2"])
    if "fc1" not in pk:
        return x, None
    pooled = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
    g = torch.relu(pooled @ pk["fc1"].to(pooled.dtype))
    g = torch.sigmoid((g @ pk["fc2"].to(g.dtype)).to(torch.float32))
    return x, g.to(x.dtype)[:, :, None, None]


def _gated(x: torch.Tensor, g) -> torch.Tensor:
    return x if g is None else x * g


def unet_serve_apply(packed: Dict[str, Any], x: torch.Tensor,
                     argmax: bool = False) -> torch.Tensor:
    """Eval-mode UNet forward, deferred SE gates.

    x: (B, H, W, C_in), H and W divisible by 16, in the compute dtype
    (f32, or bf16 for the bf16 serving path). Returns logits (B, H, W, nc)
    or the argmax class map (B, H, W) int32."""
    y, g = _dc_gate(packed["inc"], nhwc_to_nchw(x))
    feats = {"l1": (y, g)}
    for i in range(1, 5):
        y, g = _dc_gate(packed[f"down{i}"], _gated(max_pool_2d(y), g))
        feats[f"l{i + 1}"] = (y, g)

    for i, skip in ((1, "l4"), (2, "l3"), (3, "l2"), (4, "l1")):
        z = _conv_transpose_k2s2(_gated(y, g), packed[f"up{i}"]["k"],
                                 packed[f"up{i}"]["bias"])
        sk, gsk = feats[skip]
        cat = torch.cat([sk, z], dim=1)
        if gsk is not None:
            cat = cat * torch.cat([gsk, torch.ones_like(gsk)], dim=1)
        if f"sa{i}" in packed:
            cat = _sa_gate(packed[f"sa{i}"], cat)
        y, g = _dc_gate(packed[f"conv{i}"], cat)

    y = _gated(y, g)
    k = packed["outc"]["k"]
    logits = F.conv2d(y, k.permute(3, 2, 0, 1).to(y.dtype))
    if packed["outc"]["bias"] is not None:
        logits = logits + packed["outc"]["bias"].to(logits.dtype)[
            None, :, None, None]
    if argmax:
        return logits.argmax(dim=1).to(torch.int32)
    return nchw_to_nhwc(logits)


def make_serve_predict_fn(packed: Dict[str, Any], argmax: bool = False,
                          input_dtype: Optional[torch.dtype] = None):
    """``predict(images)`` over a packed tree already on its device."""
    device = packed["outc"]["k"].device

    @torch.inference_mode()
    def predict(images):
        check_hw(tuple(images.shape), 16, 16, "serve", "unet")
        images = torch.as_tensor(images, device=device).to(
            input_dtype or torch.float32)
        return unet_serve_apply(packed, images, argmax=argmax)

    return predict
