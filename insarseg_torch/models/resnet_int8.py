"""int8 post-training-quantized DeepLabV3 / FCN / true-PSPNet inference
(counterpart of ``insarseg/models/resnet_int8.py``), every attention
variant.

The graph is the JAX package's:

- every backbone bottleneck conv (1x1, 3x3 strided or dilated, 1x1, the
  downsample), every ASPP conv and the 3x3 head conv run int8 x int8 ->
  int32 with per-output-channel weight scales and per-tensor activation
  scales; the folded-BN affine, the residual add of a non-SE block, ReLU
  and the requantization are the conv's epilogue (kernel K5a);
- an SE bottleneck (FCN-CA) requantizes conv3 at a calibrated pre-SE
  scale, squeezes from the codes (kernel K2's integer sum), runs the MLP
  in f32 torch, and applies excite + residual + ReLU + requant in one
  pass (kernel K5b);
- the ASPP image-pool branch is the mean of the codes (K2's sum) times
  their scale, an f32 1x1 conv, and a requant at the shared concat scale;
- the 7x7 stem conv, the CBAM heads and the classifier stay bf16 torch ops
  (the FCN-SA gate runs f32 on the dequantized backbone output); the
  stem's max-pool and the requant to NHWC codes are one pass (kernel K7);
- the PSPNet's backbone is int8 as above; its last codes are dequantized
  to bf16, and the attention, the pyramid-pooling head and the folded
  bottleneck conv run bf16, in calls of a fixed number of tiles so that
  a tile's logits do not depend on its batch (nothing past the backbone
  is int8, so the calibration records nothing there);
- activation scales come from an f32 replay of the folded graph on
  calibration batches.

Packed trees have the JAX package's keys, so a tree packed by either
package serves in the port (:func:`prepare_resnet_int8` places it on a
device and repacks the codes into K5a's layout).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.kernels import (
    conv_i8,
    repack_conv_weight,
    se_residual_i8,
    se_squeeze_i8,
    stem_pool_i8,
)
from insarseg_torch.models.resnet_serve import (
    _attention_apply,
    _ca,
    _classify,
    _ppm_apply,
    _se_gate,
    block_chain,
    pack_resnet_serve,
)
from insarseg_torch.ops.layers import max_pool_2d, nchw_to_nhwc, nhwc_to_nchw
from insarseg_torch.ops.quant import (
    absmax_to_scale,
    calib_stat_fn,
    dequant,
    f32_scalar,
    quant_weight,
    requant,
)

# ---------------------------------------------------------------------------
# calibration: statistic replay of the f32 folded graph (NCHW inside)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def _replay_absmax(pf: Mapping, x: torch.Tensor,
                   calib_stat: str = "absmax") -> Dict[str, torch.Tensor]:
    """One f32 forward of the folded serving graph recording the
    calibration statistic of every tensor that will carry int8 codes.
    ``x``: (B, H, W, C_in)."""
    stat = calib_stat_fn(calib_stat)
    am: Dict[str, torch.Tensor] = {}

    def rec(name, *ts):
        m = stat(ts[0])
        for t in ts[1:]:
            m = torch.maximum(m, stat(t))
        am[name] = m

    pb = pf["backbone"]
    y = max_pool_2d(_ca(nhwc_to_nchw(x.to(torch.float32)), pb["stem"], 2),
                    3, 2, 1)
    rec("stem.out", y)
    for name in block_chain(pb):
        blk = pb[name]
        t1 = _ca(y, blk["c1"])
        rec(f"{name}.t1", t1)
        t2 = _ca(t1, blk["c2"], blk["stride"], blk["dilation"])
        rec(f"{name}.t2", t2)
        y3 = _ca(t2, blk["c3"], relu=False)
        if "fc1" in blk:
            rec(f"{name}.pre", y3)
            y3 = y3 * _se_gate(blk, y3.mean(dim=(2, 3)))[:, :, None, None]
        idn = y if "ds" not in blk else _ca(y, blk["ds"], blk["stride"],
                                            relu=False)
        y = torch.relu(y3 + idn)
        rec(f"{name}.out", y)

    if pf["kind"] == "deeplab":
        pa = pf["aspp"]
        branches = [_ca(y, pa["b0"])]
        for i, rate in enumerate(pa["rates"], start=1):
            branches.append(_ca(y, pa[f"b{i}"], dilation=rate))
        p = _ca(y.mean(dim=(2, 3), keepdim=True), pa["pool"])
        branches.append(p.expand(-1, -1, y.shape[2], y.shape[3]))
        # the image-pool branch is requantized at this same concat scale in
        # the int8 forward, so it takes part in the calibration
        rec("aspp.cat", *branches)
        proj = _ca(torch.cat(branches, dim=1), pa["project"])
        rec("aspp.proj", proj)
    elif pf["kind"] == "fcn" and pf["attention"] is not None:
        # FCN-SA gates before the head
        rec("head.in", _attention_apply(pf["attention"], y))
    # pspnet: the pyramid-pooling head stays bf16, nothing past the
    # backbone is int8
    return am


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _qconv(c: Mapping, s_in: float, s_out: Optional[float],
           relu: bool = True) -> Dict[str, Any]:
    """Folded conv {'k','s','b'} (or bare {'k'}) -> int8 conv pack with the
    dequant / affine (+ReLU) (+requant) epilogue parameters. ``mult`` is
    ``s_in * ws (* s)`` in numpy f32, in the JAX package's order."""
    qw = quant_weight(c["k"])
    mult = s_in * qw["ws"]
    if "s" in c:
        mult = mult * np.asarray(c["s"], np.float32)
        off = np.asarray(c["b"], np.float32)
    else:
        off = np.zeros(qw["q"].shape[-1], np.float32)
    return {"q": torch.from_numpy(qw["q"]), "mult": torch.from_numpy(mult),
            "off": torch.from_numpy(off), "out_s": s_out, "relu": relu}


def pack_resnet_int8(
    state_dict: Mapping[str, torch.Tensor],
    calib_batches: List[Any],
    calib_stat: str = "absmax",
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """DeepLabV3 / FCN / PSPNet state_dict + calibration images -> int8
    serving tree (on the CPU, in the JAX package's format).

    ``calib_batches``: a few (B, H, W, C_in) f32 batches as fed to the
    model; the replay runs on ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    pf = pack_resnet_serve(state_dict)
    pf_dev = to_torch_tree(pf, dev)
    am: Dict[str, float] = {}
    for batch in calib_batches:
        xb = torch.as_tensor(np.asarray(batch, np.float32), device=dev)
        for k, v in _replay_absmax(pf_dev, xb, calib_stat).items():
            am[k] = max(am.get(k, 0.0), float(v))
    scales = {k: absmax_to_scale(v) for k, v in am.items()}

    pb = pf["backbone"]
    packed: Dict[str, Any] = {
        "kind": pf["kind"],
        "scales": scales,
        "stem": pb["stem"],  # bf16 torch conv: C_in = 1
        "stem_out_s": scales["stem.out"],
        "layers": pb["layers"],
        "attention": pf["attention"],
        "classifier": pf["classifier"],
    }
    s_in = scales["stem.out"]
    for name in block_chain(pb):
        blk = pb[name]
        has_se = "fc1" in blk
        s_out = scales[f"{name}.out"]
        qblk: Dict[str, Any] = {
            "c1": _qconv(blk["c1"], s_in, scales[f"{name}.t1"]),
            "c2": _qconv(blk["c2"], scales[f"{name}.t1"],
                         scales[f"{name}.t2"]),
            # conv3: f32 exit in the JAX tree (the residual add, ReLU and
            # requant ride its epilogue); SE blocks requant at pre_s
            "c3": _qconv(blk["c3"], scales[f"{name}.t2"],
                         scales[f"{name}.pre"] if has_se else None,
                         relu=False),
            "stride": blk["stride"], "dilation": blk["dilation"],
            "in_s": s_in, "out_s": s_out,
        }
        if "ds" in blk:
            qblk["ds"] = _qconv(blk["ds"], s_in, None, relu=False)
        if has_se:
            qblk["fc1"], qblk["fc2"] = blk["fc1"], blk["fc2"]
            qblk["pre_s"] = scales[f"{name}.pre"]
        packed[name] = qblk
        s_in = s_out

    if pf["kind"] == "deeplab":
        pa = pf["aspp"]
        cat_s = scales["aspp.cat"]
        qa: Dict[str, Any] = {
            "b0": _qconv(pa["b0"], s_in, cat_s),
            "rates": pa["rates"],
            "pool": pa["pool"],  # (B, 1, 1, C) f32 conv
            "cat_s": cat_s,
            "project": _qconv(pa["project"], cat_s, scales["aspp.proj"]),
        }
        for i in range(1, 4):
            qa[f"b{i}"] = _qconv(pa[f"b{i}"], s_in, cat_s)
        packed["aspp"] = qa
        # int8 -> bf16 exit; the SA variant's head is a bare conv
        packed["head"] = _qconv(pf["head"], scales["aspp.proj"], None,
                                relu="s" in pf["head"])
    elif pf["kind"] == "fcn":
        s_head_in = scales["head.in"] if pf["attention"] is not None \
            else s_in
        packed["head_in_s"] = s_head_in
        packed["head"] = _qconv(pf["head"], s_head_in, None, relu=True)
    else:  # pspnet: the folded bf16 head on the dequantized backbone out
        packed["ppm"] = pf["ppm"]
        packed["head"] = pf["head"]
    return packed


def _qconvs(tree: Mapping[str, Any]):
    """Every int8 conv pack of a tree."""
    for name in block_chain(tree):
        for tag in ("c1", "c2", "c3", "ds"):
            if tag in tree[name]:
                yield tree[name][tag]
    if tree["kind"] == "deeplab":
        for tag in ("b0", "b1", "b2", "b3", "project"):
            yield tree["aspp"][tag]
    if tree["kind"] != "pspnet":
        yield tree["head"]


def prepare_resnet_int8(packed: Mapping[str, Any],
                        device: DeviceLike) -> Dict[str, Any]:
    """Place an int8 tree (packed here, or by the JAX package and read with
    ``insarseg_torch.engines_io``) on ``device`` as torch tensors, and add
    each conv's codes in K5a's layout under ``"w"`` (done once, here)."""
    if packed["kind"] not in ("deeplab", "fcn", "pspnet"):
        raise ValueError(f"unknown packed kind {packed['kind']!r}")
    tree = to_torch_tree(packed, torch.device(device))
    for c in _qconvs(tree):
        c["w"] = repack_conv_weight(c["q"])
    return tree


# ---------------------------------------------------------------------------
# int8 forward (NHWC; the kernels take NHWC codes)
# ---------------------------------------------------------------------------

def _conv_i8(xq: torch.Tensor, c: Mapping, stride: int = 1,
             dilation: int = 1, bf16: bool = False) -> torch.Tensor:
    """One int8 conv with its own epilogue: s8 codes at ``c['out_s']``, or
    f32 (bf16 with ``bf16``) when it is None."""
    return conv_i8(xq, c["w"], c["mult"], c["off"], stride, dilation,
                   c["relu"], c["out_s"], bf16=bf16)


def _mean_codes(yq: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) codes -> (B, C) f32 mean, exact: K2's integer sum over
    H, W is below 127 * H * W < 2^24 at every size the engine sees, so its
    f32 value and the division by H * W (a power of two at the served
    sizes) equal the JAX package's f32 ``mean``."""
    hw = f32_scalar(yq.shape[1] * yq.shape[2], yq.device)
    return se_squeeze_i8(yq).to(torch.float32) / hw


def _block_i8(blk: Mapping, xq: torch.Tensor) -> torch.Tensor:
    """One bottleneck on int8 codes -> int8 codes at ``blk['out_s']``."""
    t1 = _conv_i8(xq, blk["c1"])
    t2 = _conv_i8(t1, blk["c2"], blk["stride"], blk["dilation"])
    if "ds" in blk:
        idn, in_s = _conv_i8(xq, blk["ds"], blk["stride"]), None  # f32
    else:
        idn, in_s = xq, blk["in_s"]
    c3 = blk["c3"]
    if "fc1" in blk:
        y3q = _conv_i8(t2, c3)  # s8 at pre_s
        pooled = _mean_codes(y3q) * blk["pre_s"]
        gate = _se_gate(blk, pooled) * blk["pre_s"]
        return se_residual_i8(y3q, gate.contiguous(), idn, in_s,
                              blk["out_s"])
    # the residual add, ReLU and requant ride conv3's epilogue
    return conv_i8(t2, c3["w"], c3["mult"], c3["off"], relu=True,
                   out_s=blk["out_s"], idn=idn, in_s=in_s)


def pspnet_head(packed: Mapping[str, Any], h: torch.Tensor) -> torch.Tensor:
    """The PSPNet's bf16 head on the dequantized backbone output (NCHW):
    attention, pyramid pooling, the folded 3x3 bottleneck conv."""
    h = _attention_apply(packed["attention"], h)
    return _ca(_ppm_apply(packed["ppm"], h), packed["head"])


# the tiles a call of the PSPNet's bf16 head takes (the main path's batch)
HEAD_CHUNK = 8


def pspnet_head_i8(packed: Mapping[str, Any],
                   x: torch.Tensor) -> torch.Tensor:
    """:func:`pspnet_head` of NHWC bf16 ``x`` in calls of ``HEAD_CHUNK``
    tiles, the last padded with zero tiles. cuDNN picks the bottleneck
    conv's kernel (4096 -> 512 channels), and with it the sum order, by
    the batch: at one shape a tile gets the same logits in any batch, as
    the int8 engines' other layers give it. One tile a call would do as
    much, but cuDNN's batch-1 kernel made the forward several times slower
    on the H100 (PERF.md)."""
    b = x.shape[0]
    pad = -b % HEAD_CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    # an NCHW view of the NHWC values: the bf16 head runs channels-last
    # (cuDNN's NHWC convs, and the pyramid pool's integral image wants
    # channels innermost), with no transposing copy
    outs = [pspnet_head(packed, c)
            for c in x.permute(0, 3, 1, 2).split(HEAD_CHUNK)]
    return (outs[0] if len(outs) == 1 else torch.cat(outs))[:b]


def resnet_int8_apply(packed: Mapping[str, Any], x: torch.Tensor,
                      argmax: bool = False) -> torch.Tensor:
    """int8 eval-mode forward over a :func:`prepare_resnet_int8` tree.
    ``x``: (B, H, W, C_in) float (normalized). Returns bf16 logits
    (B, H, W, nc), or the int32 argmax map (B, H, W)."""
    input_size = x.shape[1:3]
    y = _ca(nhwc_to_nchw(x.to(torch.bfloat16)), packed["stem"], 2)
    yq = stem_pool_i8(y, packed["stem_out_s"])  # bf16 -> NHWC codes
    chain = block_chain(packed)
    for name in chain:
        yq = _block_i8(packed[name], yq)
    last_s = packed[chain[-1]]["out_s"]

    if packed["kind"] == "deeplab":
        pa = packed["aspp"]
        branches = [_conv_i8(yq, pa["b0"])]
        for i, rate in enumerate(pa["rates"], start=1):
            branches.append(_conv_i8(yq, pa[f"b{i}"], dilation=rate))
        p = (_mean_codes(yq) * last_s)[:, :, None, None]
        pq = requant(_ca(p, pa["pool"])[:, :, 0, 0], pa["cat_s"])
        b, h, w, _ = yq.shape
        branches.append(pq[:, None, None, :].expand(b, h, w, -1))
        proj = _conv_i8(torch.cat(branches, dim=-1), pa["project"])
        h = nhwc_to_nchw(_conv_i8(proj, packed["head"], bf16=True))
        h = _attention_apply(packed["attention"], h)
    elif packed["kind"] == "pspnet":
        h = pspnet_head_i8(packed, dequant(yq, last_s).to(torch.bfloat16))
    else:
        if packed["attention"] is not None:  # FCN-SA, f32 gate
            yf = _attention_apply(packed["attention"],
                                  nhwc_to_nchw(dequant(yq, last_s)))
            yq = requant(nchw_to_nhwc(yf), packed["head_in_s"])
        h = nhwc_to_nchw(_conv_i8(yq, packed["head"], bf16=True))
    return _classify(packed["classifier"], h, input_size, argmax)


def make_resnet_int8_predict_fn(packed: Mapping[str, Any],
                                argmax: bool = False):
    """``predict(images)`` over a :func:`prepare_resnet_int8` tree."""
    device = packed["classifier"]["k"].device

    @torch.inference_mode()
    def predict(images):
        if len(images.shape) != 4:
            raise ValueError(f"engine 'int8' expects NHWC images, got "
                             f"shape {tuple(images.shape)}")
        images = torch.as_tensor(images, device=device)
        return resnet_int8_apply(packed, images, argmax=argmax)

    return predict
