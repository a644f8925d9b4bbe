"""int8 post-training-quantized UNet inference, standard layout
(counterpart of ``insarseg/models/unet_int8.py`` with ``s2d=False``).

The graph is the JAX package's:

- all eighteen 3x3 convs run int8 x int8 -> int32 with per-output-channel
  weight scales and per-tensor activation scales; the folded-BN affine,
  ReLU and requantization are the conv's epilogue (kernel K1);
- SE blocks quantize conv2's output at a calibrated pre-SE scale, squeeze
  from the int8 codes and excite + requantize (or excite + exit to bf16)
  in one pass (kernel K2);
- max-pooling runs on the codes (kernel K3);
- activation scales come from an f32 replay of the folded graph on
  calibration batches; each tensor gets one scale where it is consumed;
- the SE MLPs, the transposed convs and the 1x1 head stay bf16 torch ops.

Packed trees have the JAX package's keys, so a tree packed by either
package serves in the port (``prepare_int8`` places it on a device and
repacks the codes into K1's layout). The H-space-to-depth layout (the JAX
package's UNet-CA default) is ROADMAP Queue 1 item 7; a tree with
``"s2d": True`` raises. The SA variant's gate (K4) is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.engines import check_hw
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.kernels import (
    conv3x3_i8,
    maxpool2x2_i8,
    repack_conv_weight,
    se_excite_i8,
    se_squeeze_i8,
)
from insarseg_torch.models.unet_s2d import (
    _conv_affine,
    _conv_transpose_k2s2,
    pack_unet_folded,
)
from insarseg_torch.ops.layers import max_pool_2d, nchw_to_nhwc, nhwc_to_nchw
from insarseg_torch.ops.quant import (
    absmax_to_scale,
    calib_stat_fn,
    quant_weight,
    requant,
)

S2D_TODO = ("the H-space-to-depth int8 layout is not ported yet (ROADMAP "
            "Queue 1 item 7); pack with s2d=False")

# (input scale, t1 scale, output scale-or-None) per DoubleConv; None means
# the block exits to bf16 (decoder blocks feed bf16 transposed convs; the
# bottom feeds up1)
_DC_IO = {
    "inc": ("in", "inc.t1", "cat4"),
    "down1": ("cat4", "down1.t1", "cat3"),
    "down2": ("cat3", "down2.t1", "cat2"),
    "down3": ("cat2", "down3.t1", "cat1"),
    "down4": ("cat1", "down4.t1", None),
    "conv1": ("cat1", "conv1.t1", None),
    "conv2": ("cat2", "conv2.t1", None),
    "conv3": ("cat3", "conv3.t1", None),
    "conv4": ("cat4", "conv4.t1", None),
}


# ---------------------------------------------------------------------------
# calibration: statistic replay of the f32 folded graph (NCHW inside)
# ---------------------------------------------------------------------------

def _se_scales(pk: Mapping, pooled: torch.Tensor) -> torch.Tensor:
    y = torch.relu(pooled @ pk["fc1"].to(pooled.dtype))
    return torch.sigmoid(y @ pk["fc2"].to(y.dtype))


def _dc_f32(pk: Mapping, x: torch.Tensor):
    """f32 replay of one DoubleConv; returns (t1, t2_pre_se, out)."""
    t1 = _conv_affine(x, pk["k1"], pk["s1"], pk["b1"])
    t2 = _conv_affine(t1, pk["k2"], pk["s2"], pk["b2"])
    y = t2
    if "fc1" in pk:
        sc = _se_scales(pk, t2.mean(dim=(2, 3)))
        y = t2 * sc[:, :, None, None]
    return t1, t2, y


@torch.inference_mode()
def _replay_absmax(pf: Mapping, x: torch.Tensor, s2d: bool = False,
                   calib_stat: str = "absmax") -> Dict[str, torch.Tensor]:
    """One f32 forward of the folded graph recording the calibration
    statistic of every tensor that will be int8. ``x``: (B, H, W, C_in)."""
    if s2d:
        raise NotImplementedError(S2D_TODO)
    stat = calib_stat_fn(calib_stat)
    am: Dict[str, torch.Tensor] = {}

    def rec(name, *ts):
        vals = [stat(t) for t in ts]
        am[name] = vals[0] if len(vals) == 1 else torch.maximum(*vals)

    def dc(name, x):
        t1, t2, y = _dc_f32(pf[name], x)
        rec(f"{name}.t1", t1)
        if "fc1" in pf[name]:
            rec(f"{name}.pre", t2)
        return y

    x = nhwc_to_nchw(x.to(torch.float32))
    rec("in", x)
    x1 = dc("inc", x)
    feats = {"l1": x1}
    y = max_pool_2d(x1)
    for i in range(1, 5):
        y = dc(f"down{i}", y)
        feats[f"l{i + 1}"] = y
        if i < 4:
            y = max_pool_2d(y)
    for i, skip in ((1, "l4"), (2, "l3"), (3, "l2"), (4, "l1")):
        z = _conv_transpose_k2s2(y, pf[f"up{i}"]["k"], pf[f"up{i}"]["bias"])
        rec(f"cat{i}", feats[skip], z)
        y = dc(f"conv{i}", torch.cat([feats[skip], z], dim=1))
    return am


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_unet_int8(
    state_dict: Mapping[str, torch.Tensor],
    calib_batches: List[Any],
    s2d: bool = False,
    calib_stat: str = "absmax",
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """UNet state_dict + calibration images -> int8 serving tree (on the
    CPU, in the JAX package's format).

    ``calib_batches``: a few (B, H, W, C_in) f32 batches as fed to the
    model; the replay runs on ``device`` (``None`` means ``cuda``). The
    packing arithmetic is numpy f32 in the JAX package's order, so equal
    calibration statistics give equal codes and scales bit for bit."""
    if s2d:
        raise NotImplementedError(S2D_TODO)
    dev = resolve_device(device)
    pf = pack_unet_folded(state_dict)
    pf_dev = to_torch_tree(pf, dev)
    am: Dict[str, float] = {}
    for batch in calib_batches:
        xb = torch.as_tensor(np.asarray(batch, np.float32), device=dev)
        for k, v in _replay_absmax(pf_dev, xb, calib_stat=calib_stat).items():
            am[k] = max(am.get(k, 0.0), float(v))
    scales = {k: absmax_to_scale(v) for k, v in am.items()}

    packed: Dict[str, Any] = {"scales": scales, "s2d": False}
    for name, (s_in, s_t1, s_out) in _DC_IO.items():
        src = pf[name]
        has_se = "fc1" in src
        # with SE, conv2 requantizes at the calibrated pre-SE scale and the
        # excite pass carries the final requant (or the bf16 exit)
        s_c2_out = f"{name}.pre" if has_se else s_out
        blk: Dict[str, Any] = {}
        for tag, kname, sname, bname, s_src, s_dst in (
            ("c1", "k1", "s1", "b1", s_in, s_t1),
            ("c2", "k2", "s2", "b2", s_t1, s_c2_out),
        ):
            qw = quant_weight(src[kname])
            mult = scales[s_src] * qw["ws"] * src[sname].numpy()
            blk[tag] = {
                "q": torch.from_numpy(qw["q"]),
                "mult": torch.from_numpy(mult),
                "off": src[bname],
                "out_s": None if s_dst is None else scales[s_dst],
            }
        if has_se:
            blk["fc1"], blk["fc2"] = src["fc1"], src["fc2"]
            blk["se_pre_s"] = scales[f"{name}.pre"]
            blk["se_out_s"] = None if s_out is None else scales[s_out]
        packed[name] = blk
    for i in range(1, 5):
        packed[f"up{i}"] = dict(pf[f"up{i}"], cat_s=scales[f"cat{i}"])
    packed["outc"] = pf["outc"]
    packed["in_s"] = scales["in"]
    return packed


def prepare_int8(packed: Mapping[str, Any],
                 device: DeviceLike) -> Dict[str, Any]:
    """Place an int8 tree (packed here, or by the JAX package and read with
    ``insarseg_torch.engines_io``) on ``device`` as torch tensors, and add
    each conv's codes in K1's layout under ``"w"`` (done once, here)."""
    if packed.get("s2d", True):
        raise NotImplementedError(S2D_TODO)
    tree = to_torch_tree(packed, torch.device(device))
    for name in _DC_IO:
        for tag in ("c1", "c2"):
            blk = tree[name][tag]
            blk["w"] = repack_conv_weight(blk["q"])
    return tree


# ---------------------------------------------------------------------------
# int8 forward (NHWC; the kernels take NHWC codes)
# ---------------------------------------------------------------------------

def _conv_i8(xq: torch.Tensor, blk: Mapping) -> torch.Tensor:
    return conv3x3_i8(xq, blk["w"], blk["mult"], blk["off"], blk["out_s"])


def _dc_i8(blk: Mapping, xq: torch.Tensor) -> torch.Tensor:
    """One DoubleConv on int8 codes: s8 codes at the block's output scale,
    or bf16 when the block exits the int8 domain."""
    yq = _conv_i8(_conv_i8(xq, blk["c1"]), blk["c2"])
    if "fc1" not in blk:
        return yq
    hw = torch.tensor(float(yq.shape[1] * yq.shape[2]), device=yq.device)
    pooled = se_squeeze_i8(yq).to(torch.float32) / hw * blk["se_pre_s"]
    sc = _se_scales(blk, pooled)
    if blk["se_out_s"] is None:  # excite + bf16 exit, one pass
        gain = (sc * blk["se_pre_s"]).to(torch.bfloat16)
    else:  # excite + requant, one pass
        gain = sc * (blk["se_pre_s"] / blk["se_out_s"])
    return se_excite_i8(yq, gain.contiguous())


def _up_requant(y: torch.Tensor, up: Mapping) -> torch.Tensor:
    """bf16 ConvT(k2, s2) on NHWC, then int8 codes at the concat's scale."""
    z = _conv_transpose_k2s2(nhwc_to_nchw(y), up["k"], up["bias"])
    return requant(nchw_to_nhwc(z).to(torch.float32), up["cat_s"])


def unet_int8_apply(packed: Mapping[str, Any], x: torch.Tensor,
                    argmax: bool = False) -> torch.Tensor:
    """int8 eval-mode forward over a :func:`prepare_int8` tree. ``x``:
    (B, H, W, C_in) float, H and W divisible by 16. Returns bf16 logits
    (B, H, W, nc), or the int32 argmax map (B, H, W)."""
    if packed.get("s2d", True):
        raise NotImplementedError(S2D_TODO)
    xq = requant(x.to(torch.float32), packed["in_s"])
    x1 = _dc_i8(packed["inc"], xq)  # s8 at the cat4 scale
    y = maxpool2x2_i8(x1)
    skips = {"l1": x1}
    for i in range(1, 5):
        y = _dc_i8(packed[f"down{i}"], y)
        skips[f"l{i + 1}"] = y
        if i < 4:
            y = maxpool2x2_i8(y)
    # the bottom is bf16 (down4 exits the int8 domain for the decoder)
    for i, skip in ((1, "l4"), (2, "l3"), (3, "l2"), (4, "l1")):
        zq = _up_requant(y, packed[f"up{i}"])
        y = _dc_i8(packed[f"conv{i}"], torch.cat([skips[skip], zq], dim=-1))

    out = packed["outc"]
    logits = y @ out["k"].to(y.dtype)
    if out["bias"] is not None:
        logits = logits + out["bias"].to(logits.dtype)
    if argmax:
        return logits.argmax(dim=-1).to(torch.int32)
    return logits


def make_int8_predict_fn(packed: Mapping[str, Any], argmax: bool = False):
    """``predict(images)`` over a :func:`prepare_int8` tree."""
    device = packed["outc"]["k"].device

    @torch.inference_mode()
    def predict(images):
        check_hw(tuple(images.shape), 16, 16, "int8", "unet")
        images = torch.as_tensor(images, device=device)
        return unet_int8_apply(packed, images, argmax=argmax)

    return predict
