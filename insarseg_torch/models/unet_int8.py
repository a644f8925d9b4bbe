"""int8 post-training-quantized UNet inference (counterpart of
``insarseg/models/unet_int8.py``), in both of its layouts:

- ``s2d=True`` (the default, as in the JAX package): the H-space-to-depth
  graph of ``models/unet_s2d.py`` for the plain and channel-attention
  U-Nets — level 1 runs over (H/2, W) with 2C channels, the SE squeeze
  averages the two parity halves, the max-pool exit leaves the s2d layout
  (kernel K3s), up4 is a W-only transposed conv and the head is
  block-diagonal over parity;
- ``s2d=False``: the standard layout, the only one the SA variant has
  (its per-pixel gates run on the concat codes, kernels K4a / K4b).

The graph is the JAX package's:

- all eighteen 3x3 convs run int8 x int8 -> int32 with per-output-channel
  weight scales and per-tensor activation scales; the folded-BN affine,
  ReLU and requantization are the conv's epilogue (kernel K1);
- SE blocks quantize conv2's output at a calibrated pre-SE scale, squeeze
  from the int8 codes and excite + requantize (or excite + exit to bf16)
  in one pass (kernel K2);
- max-pooling runs on the codes (kernels K3, K3s);
- the SA gate takes the channel mean / max of the dequantized concat codes
  (K4a), runs its DoubleConv(2 -> 1) and sigmoid in torch f32 and rescales
  the codes in place (K4b): the gate is in (0, 1), so the concat's scale
  still bounds the gated tensor;
- each decoder level's bf16 transposed conv (k2 s2, or the H-s2d up4),
  its bf16 bias, the requant to the concat's scale and the concat with the
  skip's codes are one launch (kernel K6) on the bf16 NHWC decoder tensor;
- activation scales come from an f32 replay of the folded graph on
  calibration batches; each tensor gets one scale where it is consumed;
- the SE MLPs and the 1x1 head stay bf16 torch ops.

Packed trees have the JAX package's keys, so a tree packed by either
package serves in the port (``prepare_int8`` places it on a device and
repacks the codes into K1's layout and the transposed-conv kernels into
K6's).
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
    maxpool_exit_s2d_i8,
    pack_up_weight,
    repack_conv_weight,
    sa_gate_i8,
    sa_stats_i8,
    se_excite_i8,
    se_squeeze_i8,
    up_concat_i8,
)
from insarseg_torch.models.unet_s2d import (
    _conv_transpose_k2s2,
    _dc_f32,
    _h_d2s,
    _h_s2d,
    _maxpool_exit_s2d,
    _s2d_argmax,
    _sa_gate,
    _sa_sigmoid,
    _se_scales,
    _up4_s2d,
    pack_unet_folded,
    pack_unet_s2d,
)
from insarseg_torch.ops.layers import max_pool_2d, nhwc_to_nchw
from insarseg_torch.ops.quant import (
    absmax_to_scale,
    calib_stat_fn,
    f32_scalar,
    quant_weight,
    requant,
)

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

@torch.inference_mode()
def _replay_absmax(pf: Mapping, x: torch.Tensor, s2d: bool = True,
                   calib_stat: str = "absmax") -> Dict[str, torch.Tensor]:
    """One f32 forward of the folded graph (H-s2d, or standard with
    ``s2d=False``) recording the calibration statistic of every tensor that
    will be int8. ``x``: (B, H, W, C_in)."""
    stat = calib_stat_fn(calib_stat)
    am: Dict[str, torch.Tensor] = {}

    def rec(name, *ts):
        vals = [stat(t) for t in ts]
        am[name] = vals[0] if len(vals) == 1 else torch.maximum(*vals)

    def dc(name, x, flag=False):
        t1, t2, y = _dc_f32(pf[name], x, flag)
        rec(f"{name}.t1", t1)
        if "fc1" in pf[name]:
            rec(f"{name}.pre", t2)
        return y

    def gate(i, cat):
        # SA variant: the replay sees the gated decoder inputs, so the
        # downstream scales match the int8 forward
        return _sa_gate(pf[f"sa{i}"], cat) if f"sa{i}" in pf else cat

    x = x.to(torch.float32)
    x = nhwc_to_nchw(_h_s2d(x) if s2d else x)
    rec("in", x)
    x1 = dc("inc", x, s2d)
    feats = {"l1": x1}
    y = _maxpool_exit_s2d(x1) if s2d else max_pool_2d(x1)
    for i in range(1, 5):
        y = dc(f"down{i}", y)
        feats[f"l{i + 1}"] = y
        if i < 4:
            y = max_pool_2d(y)
    for i, skip in ((1, "l4"), (2, "l3"), (3, "l2")):
        z = _conv_transpose_k2s2(y, pf[f"up{i}"]["k"], pf[f"up{i}"]["bias"])
        rec(f"cat{i}", feats[skip], z)
        y = dc(f"conv{i}", gate(i, torch.cat([feats[skip], z], dim=1)))
    up4 = _up4_s2d if s2d else _conv_transpose_k2s2
    z = up4(y, pf["up4"]["k"], pf["up4"]["bias"])
    rec("cat4", feats["l1"], z)
    dc("conv4", gate(4, torch.cat([feats["l1"], z], dim=1)), s2d)
    return am


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_unet_int8(
    state_dict: Mapping[str, torch.Tensor],
    calib_batches: List[Any],
    s2d: bool = True,
    calib_stat: str = "absmax",
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """UNet state_dict + calibration images -> int8 serving tree (on the
    CPU, in the JAX package's format). ``s2d=True`` packs the H-s2d graph
    (plain and SE variants); ``s2d=False`` the standard layout (every
    variant; the SA variant has only this one).

    ``calib_batches``: a few (B, H, W, C_in) f32 batches as fed to the
    model; the replay runs on ``device`` (``None`` means ``cuda``). The
    packing arithmetic is numpy f32 in the JAX package's order, so equal
    calibration statistics give equal codes and scales bit for bit."""
    dev = resolve_device(device)
    pf = pack_unet_s2d(state_dict) if s2d else pack_unet_folded(state_dict)
    pf_dev = to_torch_tree(pf, dev)
    am: Dict[str, float] = {}
    for batch in calib_batches:
        xb = torch.as_tensor(np.asarray(batch, np.float32), device=dev)
        for k, v in _replay_absmax(pf_dev, xb, s2d=s2d,
                                   calib_stat=calib_stat).items():
            am[k] = max(am.get(k, 0.0), float(v))
    scales = {k: absmax_to_scale(v) for k, v in am.items()}

    packed: Dict[str, Any] = {"scales": scales, "s2d": s2d}
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
    for i in range(1, 5):  # SA variant (standard layout): f32 gate convs
        if f"sa{i}" in pf:
            packed[f"sa{i}"] = pf[f"sa{i}"]
    return packed


def prepare_int8(packed: Mapping[str, Any],
                 device: DeviceLike) -> Dict[str, Any]:
    """Place an int8 tree of either layout (packed here, or by the JAX
    package and read with ``insarseg_torch.engines_io``) on ``device`` as
    torch tensors, and add each conv's codes in K1's layout under ``"w"``
    and each transposed conv's kernel and bias in K6's bf16 layout under
    ``"w"`` and ``"wb"`` (done once, here)."""
    tree = to_torch_tree(packed, torch.device(device))
    for name in _DC_IO:
        for tag in ("c1", "c2"):
            blk = tree[name][tag]
            blk["w"] = repack_conv_weight(blk["q"])
    s2d = tree.get("s2d", True)
    for i in range(1, 5):
        up = tree[f"up{i}"]
        up["w"] = pack_up_weight(up["k"], s2d and i == 4)
        up["wb"] = None if up["bias"] is None \
            else up["bias"].to(torch.bfloat16).contiguous()
    return tree


# ---------------------------------------------------------------------------
# int8 forward (NHWC; the kernels take NHWC codes)
# ---------------------------------------------------------------------------

def _conv_i8(xq: torch.Tensor, blk: Mapping) -> torch.Tensor:
    return conv3x3_i8(xq, blk["w"], blk["mult"], blk["off"], blk["out_s"])


def _dc_i8(blk: Mapping, xq: torch.Tensor, s2d: bool = False) -> torch.Tensor:
    """One DoubleConv on int8 codes: s8 codes at the block's output scale,
    or bf16 when the block exits the int8 domain.

    The SE squeeze follows the JAX order: the sum (K2) over the pixel
    count, then (s2d) the mean of the two parity halves, then the pre-SE
    scale. K2's integer sum is exact and rounds once to f32; JAX's f32
    ``mean`` rounds as it sums. The two agree while 127 * H * W < 2^24
    (at 512^2 tiles in s2d: 127 * 256 * 512 = 16,646,144 < 16,777,216);
    above it they differ by a few ulps, which moved no code in the test of
    a 384^2 squeeze with sums past 2^24 (``tests/test_torch_kernels.py::
    test_k2_squeeze_past_2_24_matches_dc_i8``)."""
    yq = _conv_i8(_conv_i8(xq, blk["c1"]), blk["c2"])
    if "fc1" not in blk:
        return yq
    hw = f32_scalar(yq.shape[1] * yq.shape[2], yq.device)
    pooled = se_squeeze_i8(yq).to(torch.float32) / hw
    if s2d:
        c = yq.shape[-1] // 2
        pooled = 0.5 * (pooled[:, :c] + pooled[:, c:])
    sc = _se_scales(blk, pooled * blk["se_pre_s"])
    if s2d:
        # the gate of both parity halves (``repeat`` would run aten::cat)
        sc = sc[:, None].expand(-1, 2, -1).reshape(sc.shape[0], -1)
    if blk["se_out_s"] is None:  # excite + bf16 exit, one pass
        gain = (sc * blk["se_pre_s"]).to(torch.bfloat16)
    else:  # excite + requant, one pass
        gain = sc * (blk["se_pre_s"] / blk["se_out_s"])
    return se_excite_i8(yq, gain.contiguous())


def _sa_gate_i8(pk: Mapping, catq: torch.Tensor, cat_s: float) -> torch.Tensor:
    """SA gate on the concat codes (standard layout): K4a's [mean, max] of
    the dequantized codes, the f32 gate convs and sigmoid, then K4b."""
    m = nhwc_to_nchw(sa_stats_i8(catq, cat_s))
    g = _sa_sigmoid(pk, m)[:, 0].contiguous()  # (B, H, W)
    return sa_gate_i8(catq, g)


def unet_int8_apply(packed: Mapping[str, Any], x: torch.Tensor,
                    argmax: bool = False) -> torch.Tensor:
    """int8 eval-mode forward over a :func:`prepare_int8` tree. ``x``:
    (B, H, W, C_in) float, H divisible by 32 (H-s2d) or 16 (standard) and
    W by 16. Returns bf16 logits (B, H, W, nc), or the int32 argmax map
    (B, H, W)."""
    s2d = packed.get("s2d", True)
    x = x.to(torch.float32)
    xq = requant(_h_s2d(x) if s2d else x, packed["in_s"])
    x1 = _dc_i8(packed["inc"], xq, s2d)  # s8 at the cat4 scale
    y = maxpool_exit_s2d_i8(x1) if s2d else maxpool2x2_i8(x1)
    skips = {"l1": x1}
    for i in range(1, 5):
        y = _dc_i8(packed[f"down{i}"], y)
        skips[f"l{i + 1}"] = y
        if i < 4:
            y = maxpool2x2_i8(y)
    # the bottom is bf16 (down4 exits the int8 domain for the decoder); K6
    # takes it NHWC and writes the int8 concat [skip, up] at the cat scale
    for i, skip in ((1, "l4"), (2, "l3"), (3, "l2"), (4, "l1")):
        up = packed[f"up{i}"]
        catq = up_concat_i8(y, up["w"], up["wb"], skips[skip], up["cat_s"],
                            s2d and i == 4)
        if f"sa{i}" in packed:
            catq = _sa_gate_i8(packed[f"sa{i}"], catq, up["cat_s"])
        y = _dc_i8(packed[f"conv{i}"], catq, s2d and i == 4)

    out = packed["outc"]
    logits = y @ out["k"].to(y.dtype)
    if out["bias"] is not None:
        logits = logits + out["bias"].to(logits.dtype)
    if not s2d:
        return logits.argmax(dim=-1).to(torch.int32) if argmax else logits
    nc = out["nc"]
    return _s2d_argmax(logits, nc) if argmax else _h_d2s(logits, nc)


def make_int8_predict_fn(packed: Mapping[str, Any], argmax: bool = False):
    """``predict(images)`` over a :func:`prepare_int8` tree."""
    device = packed["outc"]["k"].device
    # the H-s2d graph halves H before the 5-level pyramid
    hdiv = 32 if packed.get("s2d", True) else 16

    @torch.inference_mode()
    def predict(images):
        check_hw(tuple(images.shape), hdiv, 16, "int8", "unet")
        images = torch.as_tensor(images, device=device)
        return unet_int8_apply(packed, images, argmax=argmax)

    return predict
