"""BN-folded serving graphs for DeepLabV3, FCN and the true PSPNet
(counterpart of ``insarseg/models/resnet_serve.py``), every attention
variant.

Every BatchNorm is folded (in numpy f32, ``ops/fold.py``) into the
preceding conv's ``y * s + b`` epilogue, so the graph is a chain of
conv + affine (+ReLU) steps; dropout is the identity in eval mode. The
packers read a torchvision-naming state_dict (the port's modules, or
``segmentation_variables_to_torch``) and return the JAX package's tree:
conv kernels HWIO, MLP matrices (in, out), ``backbone.layer{l}_{b}``
blocks with ``stride`` / ``dilation``, ``layers`` a list, ``rates`` and
the PSPNet's ``ppm.bins`` tuples, the DeepLab-SA head a bare ``{'k'}``
(no BN, no ReLU). A tree the JAX package packed serves here unchanged.

The public functions take and return NHWC; the float graph runs NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from insarseg_torch.models.deeplab import ASPP_RATES
from insarseg_torch.models.pspnet import BINS
from insarseg_torch.models.resnet import layer_schedule
from insarseg_torch.models.unet_s2d import _chan, _hwio, _optional
from insarseg_torch.ops.fold import fold_bn
from insarseg_torch.ops.layers import (
    adaptive_avg_pools,
    max_pool_2d,
    nchw_to_nhwc,
    nhwc_to_nchw,
)
from insarseg_torch.ops.resize import resize_bilinear

# ---------------------------------------------------------------------------
# pack (host side, once)
# ---------------------------------------------------------------------------

def _fold_conv(sd: Mapping[str, torch.Tensor], conv: str,
               bn: str) -> Dict[str, Any]:
    s, b = fold_bn(sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                   sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                   sd.get(f"{conv}.bias"))
    return {"k": _hwio(sd[f"{conv}.weight"]), "s": s, "b": b}


def _mlp(w: torch.Tensor) -> torch.Tensor:
    """1x1 conv weight (O, I, 1, 1) -> (I, O) matrix."""
    return w.detach().to(torch.float32)[:, :, 0, 0].t().contiguous()


def pack_backbone(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``backbone.*`` entries -> folded backbone tree. Block counts, SE and
    downsample branches are read off the state_dict."""
    layers = []
    for li in range(1, 5):
        n = 0
        while f"backbone.layer{li}.{n}.conv1.weight" in sd:
            n += 1
        layers.append(n)
    sched = layer_schedule(layers)
    packed: Dict[str, Any] = {
        "stem": _fold_conv(sd, "backbone.conv1", "backbone.bn1"),
        "layers": layers,
    }
    for li in range(4):
        for bi in range(layers[li]):
            t = f"backbone.layer{li + 1}.{bi}"
            stride, dilation = sched[li][bi]
            blk: Dict[str, Any] = {
                f"c{i}": _fold_conv(sd, f"{t}.conv{i}", f"{t}.bn{i}")
                for i in (1, 2, 3)}
            blk["stride"], blk["dilation"] = stride, dilation
            if f"{t}.se_block.fc.0.weight" in sd:
                blk["fc1"] = _mlp(sd[f"{t}.se_block.fc.0.weight"])
                blk["fc2"] = _mlp(sd[f"{t}.se_block.fc.2.weight"])
            if f"{t}.downsample.0.weight" in sd:
                blk["ds"] = _fold_conv(sd, f"{t}.downsample.0",
                                       f"{t}.downsample.1")
            packed[f"layer{li + 1}_{bi}"] = blk
    return packed


def _pack_attention(sd: Mapping[str, torch.Tensor],
                    prefix: str) -> Optional[Dict[str, Any]]:
    if f"{prefix}.mlp.0.weight" in sd:  # CBAM channel
        return {"type": "channel", "fc1": _mlp(sd[f"{prefix}.mlp.0.weight"]),
                "fc2": _mlp(sd[f"{prefix}.mlp.2.weight"])}
    if f"{prefix}.conv.weight" in sd:  # CBAM spatial
        return {"type": "spatial", "k": _hwio(sd[f"{prefix}.conv.weight"])}
    return None


def _pack_classifier(sd: Mapping[str, torch.Tensor],
                     conv: str) -> Dict[str, Any]:
    return {"k": _hwio(sd[f"{conv}.weight"]),
            "bias": _optional(sd, f"{conv}.bias")}


def pack_deeplab_serve(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """DeepLabV3 state_dict -> BN-folded serving tree."""
    a = "classifier.0"
    aspp = {"b0": _fold_conv(sd, f"{a}.convs.0.0", f"{a}.convs.0.1"),
            "rates": ASPP_RATES,
            "pool": _fold_conv(sd, f"{a}.convs.4.1", f"{a}.convs.4.2"),
            "project": _fold_conv(sd, f"{a}.project.0", f"{a}.project.1")}
    for i in range(1, 4):
        aspp[f"b{i}"] = _fold_conv(sd, f"{a}.convs.{i}.0", f"{a}.convs.{i}.1")
    if "classifier.2.weight" in sd:
        head = _fold_conv(sd, "classifier.1", "classifier.2")
    else:  # the SA quirk: a bare 3x3 conv, no BN, no ReLU
        head = {"k": _hwio(sd["classifier.1.weight"])}
    return {"kind": "deeplab", "backbone": pack_backbone(sd), "aspp": aspp,
            "head": head,
            "attention": _pack_attention(sd, "attention_module"),
            "classifier": _pack_classifier(sd, "classifier.4")}


def pack_fcn_serve(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """FCN state_dict -> BN-folded serving tree."""
    return {"kind": "fcn", "backbone": pack_backbone(sd),
            "head": _fold_conv(sd, "classifier.0", "classifier.1"),
            "classifier": _pack_classifier(sd, "classifier.4"),
            "attention": _pack_attention(sd, "spatial_attention")}


def pack_pspnet_serve(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """True-PSPNet state_dict -> BN-folded serving tree: each bin's conv and
    BN, and the bottleneck conv and BN, folded."""
    ppm: Dict[str, Any] = {"bins": BINS}
    for b in BINS:
        ppm[f"bin{b}"] = _fold_conv(sd, f"ppm.conv_bin{b}", f"ppm.bn_bin{b}")
    return {"kind": "pspnet", "backbone": pack_backbone(sd), "ppm": ppm,
            "head": _fold_conv(sd, "bottleneck_conv", "bottleneck_bn"),
            "classifier": _pack_classifier(sd, "classifier"),
            "attention": _pack_attention(sd, "spatial_attention")}


def pack_resnet_serve(
        state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Detect DeepLabV3 / FCN / PSPNet from the state_dict and pack (on the
    CPU)."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    if "classifier.0.project.0.weight" in sd:
        return pack_deeplab_serve(sd)
    if "ppm.conv_bin1.weight" in sd:
        return pack_pspnet_serve(sd)
    return pack_fcn_serve(sd)


# ---------------------------------------------------------------------------
# forward (NCHW; dtype follows the input, params cast on the fly)
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, k: torch.Tensor, stride: int = 1,
          dilation: int = 1) -> torch.Tensor:
    """Same-padded conv (pad = dilation * (k - 1) // 2), HWIO kernel."""
    return F.conv2d(x, k.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                    padding=dilation * (k.shape[0] - 1) // 2,
                    dilation=dilation)


def _ca(x: torch.Tensor, c: Mapping, stride: int = 1, dilation: int = 1,
        relu: bool = True) -> torch.Tensor:
    """conv + folded-BN affine (+ReLU)."""
    y = _conv(x, c["k"], stride, dilation)
    y = y * _chan(c["s"], y.dtype) + _chan(c["b"], y.dtype)
    return torch.relu(y) if relu else y


def _se_gate(blk: Mapping, pooled: torch.Tensor) -> torch.Tensor:
    g = torch.relu(pooled @ blk["fc1"].to(pooled.dtype))
    return torch.sigmoid(g @ blk["fc2"].to(g.dtype))


def _bottleneck(blk: Mapping, x: torch.Tensor) -> torch.Tensor:
    y = _ca(x, blk["c1"])
    y = _ca(y, blk["c2"], blk["stride"], blk["dilation"])
    y = _ca(y, blk["c3"], relu=False)
    if "fc1" in blk:  # SE before the residual add
        g = torch.relu(y.mean(dim=(2, 3)) @ blk["fc1"].to(y.dtype))
        g = torch.sigmoid((g @ blk["fc2"].to(g.dtype)).to(torch.float32))
        y = y * g.to(y.dtype)[:, :, None, None]
    identity = x if "ds" not in blk else _ca(x, blk["ds"], blk["stride"],
                                             relu=False)
    return torch.relu(y + identity)


def block_chain(pb: Mapping) -> list:
    return [f"layer{li + 1}_{bi}" for li in range(4)
            for bi in range(pb["layers"][li])]


def backbone_apply(pb: Mapping, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Folded ResNet forward (NCHW); returns {'out': layer4, 'aux': layer3}."""
    y = max_pool_2d(_ca(x, pb["stem"], stride=2), 3, 2, 1)
    feats = {}
    for li in range(4):
        for bi in range(pb["layers"][li]):
            y = _bottleneck(pb[f"layer{li + 1}_{bi}"], y)
        if li == 2:
            feats["aux"] = y
    feats["out"] = y
    return feats


def _aspp_apply(pa: Mapping, x: torch.Tensor) -> torch.Tensor:
    branches = [_ca(x, pa["b0"])]
    for i, rate in enumerate(pa["rates"], start=1):
        branches.append(_ca(x, pa[f"b{i}"], dilation=rate))
    p = _ca(x.mean(dim=(2, 3), keepdim=True), pa["pool"])
    branches.append(p.expand(-1, -1, x.shape[2], x.shape[3]))
    return _ca(torch.cat(branches, dim=1), pa["project"])


def _ppm_apply(pp: Mapping, x: torch.Tensor) -> torch.Tensor:
    """The pyramid-pooling head on the folded tree: per bin, pool, conv +
    affine + ReLU, resize back; concatenated after ``x``. The bins share
    one integral image."""
    outs = [x]
    for b, pooled in zip(pp["bins"], adaptive_avg_pools(x, pp["bins"])):
        p = _ca(pooled, pp[f"bin{b}"])
        outs.append(resize_bilinear(p, x.shape[-2:]))
    return torch.cat(outs, dim=1)


def _attention_apply(att: Optional[Mapping], y: torch.Tensor) -> torch.Tensor:
    if att is None:
        return y
    if att["type"] == "channel":
        def mlp(v):
            h = torch.relu(v @ att["fc1"].to(v.dtype))
            return h @ att["fc2"].to(h.dtype)

        g = torch.sigmoid((mlp(y.mean(dim=(2, 3)))
                           + mlp(y.amax(dim=(2, 3)))).to(torch.float32))
        return y * g.to(y.dtype)[:, :, None, None]
    m = torch.cat([y.mean(dim=1, keepdim=True), y.amax(dim=1, keepdim=True)],
                  dim=1)
    m = _conv(m, att["k"])
    return y * torch.sigmoid(m.to(torch.float32)).to(y.dtype)


def _classify(pc: Mapping, y: torch.Tensor, input_size,
              argmax: bool) -> torch.Tensor:
    """1x1 classifier (+bias), bilinear resize to ``input_size``; returns
    NHWC logits or the int32 argmax map (B, H, W)."""
    logits = _conv(y, pc["k"])
    if pc["bias"] is not None:
        logits = logits + _chan(pc["bias"], logits.dtype)
    logits = resize_bilinear(logits, input_size)
    if argmax:
        return logits.argmax(dim=1).to(torch.int32)
    return nchw_to_nhwc(logits)


def resnet_serve_apply(packed: Mapping[str, Any], x: torch.Tensor,
                       argmax: bool = False) -> torch.Tensor:
    """Eval-mode DeepLabV3 / FCN / PSPNet forward on the folded tree. ``x``:
    (B, H, W, C_in) in the compute dtype; returns logits (B, H, W, nc) or
    the int32 class map (B, H, W)."""
    input_size = x.shape[1:3]
    y = backbone_apply(packed["backbone"], nhwc_to_nchw(x))["out"]
    if packed["kind"] == "deeplab":
        y = _aspp_apply(packed["aspp"], y)
        head = packed["head"]
        y = _ca(y, head) if "s" in head else _conv(y, head["k"])
        y = _attention_apply(packed["attention"], y)
    elif packed["kind"] == "pspnet":
        y = _attention_apply(packed["attention"], y)
        y = _ca(_ppm_apply(packed["ppm"], y), packed["head"])
    elif packed["kind"] == "fcn":
        y = _attention_apply(packed["attention"], y)
        y = _ca(y, packed["head"])
    else:
        raise ValueError(f"unknown packed kind {packed['kind']!r}")
    return _classify(packed["classifier"], y, input_size, argmax)


def make_resnet_serve_predict_fn(packed: Mapping[str, Any],
                                 argmax: bool = False,
                                 input_dtype: Optional[torch.dtype] = None):
    """``predict(images)`` over a packed tree already on its device. No
    H / W envelope: the strided stem pads as the module does and the head
    resizes back to the input size."""
    device = packed["classifier"]["k"].device

    @torch.inference_mode()
    def predict(images):
        if len(images.shape) != 4:
            raise ValueError(f"expected NHWC images, got shape "
                             f"{tuple(images.shape)}")
        images = torch.as_tensor(images, device=device).to(
            input_dtype or torch.float32)
        return resnet_serve_apply(packed, images, argmax=argmax)

    return predict
