"""BN-folded packing and the float graphs of the UNet family (counterpart
of ``insarseg/models/unet_s2d.py``).

- the standard layout: ``_fold_dc``, :func:`pack_unet_folded` (with the SA
  variant's ``sa{i}`` gate convs), ``_conv_affine``, ``_conv_transpose_k2s2``;
- the H-space-to-depth (H-s2d) layout of the int8 engine's U-Net-CA /
  plain-UNet graph: row parity folds into channels,
  ``X2[rh, w, a*C + c] = x[2rh + a, w, c]``, so the level-1 convs run over
  (H/2, W) with 2C channels and the kernels of
  :func:`s2d_conv3x3_kernel`. The numpy weight transforms, the packer
  :func:`pack_unet_s2d` and the f32 forward :func:`unet_s2d_apply` are the
  JAX package's; the f32 graph is the check of the transforms (within
  1e-4 of the module) before any int8 code runs.

Packed trees keep the JAX package's keys and layouts — conv kernels HWIO,
transposed-conv kernels (kh, kw, I, O), SE MLPs (in, out), the head (f, nc)
or, in H-s2d, the block-diagonal (2f, 2nc) — so a tree the JAX package
packed (``insarseg_torch.engines_io``) and one packed here are
interchangeable. The packers read the port's state_dict. The float
helpers run NCHW; :func:`_h_s2d` / :func:`_h_d2s` act on NHWC tensors at
the graphs' boundaries.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.engines import check_hw
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.ops.fold import fold_bn
from insarseg_torch.ops.layers import max_pool_2d, nchw_to_nhwc, nhwc_to_nchw


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


def _up(sd: Mapping[str, torch.Tensor], i: int) -> Dict[str, Any]:
    # ConvTranspose2d (I, O, kh, kw) -> (kh, kw, I, O)
    return {"k": sd[f"up{i}.weight"].to(torch.float32).permute(2, 3, 0, 1)
            .contiguous(), "bias": _optional(sd, f"up{i}.bias")}


def _cpu_sd(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def pack_unet_folded(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """UNet state_dict -> BN-folded tree in the standard layout (the tree of
    ``insarseg.models.unet_s2d.pack_unet_folded``), the SA variant's gate
    DoubleConvs folded under ``sa{i}``."""
    sd = _cpu_sd(state_dict)
    packed: Dict[str, Any] = {"inc": _fold_dc(sd, "inc")}
    for i in range(1, 5):
        packed[f"down{i}"] = _fold_dc(sd, f"down{i}.1")
    for i in range(1, 5):
        packed[f"up{i}"] = _up(sd, i)
        packed[f"conv{i}"] = _fold_dc(sd, f"conv{i}")
        if f"sa{i}.compress_and_map.double_conv.0.weight" in sd:
            packed[f"sa{i}"] = _fold_dc(sd, f"sa{i}.compress_and_map")
    wo = sd["outc.weight"].to(torch.float32)[:, :, 0, 0].t().contiguous()
    packed["outc"] = {"k": wo, "bias": _optional(sd, "outc.bias"),
                      "nc": int(wo.shape[-1])}
    return packed


# ---------------------------------------------------------------------------
# H-s2d weight transforms (numpy, once at pack time)
# ---------------------------------------------------------------------------

def s2d_conv3x3_kernel(w: np.ndarray, in_parity: np.ndarray,
                       in_channel: np.ndarray) -> np.ndarray:
    """(3, kw, Cin, Cout) kernel -> (3, kw, Jin, 2*Cout) H-s2d kernel:
    ``K2[alpha+1, v, j, d*Cout+o] = W[u+1, v, in_channel[j], o]`` with
    ``u = 2*alpha + in_parity[j] - d``, zero where |u| > 1.

    ``in_parity[j]`` / ``in_channel[j]`` give the original (row parity,
    channel) carried by s2d input channel j — identity layout is
    ``j = a*Cin + c``; the skip-concat permutation is expressed the same way.
    """
    w = np.asarray(w)
    kh, kw, cin, cout = w.shape
    if kh != 3:
        raise ValueError(f"expected a 3-row kernel, got {w.shape}")
    jin = len(in_parity)
    k2 = np.zeros((3, kw, jin, 2 * cout), w.dtype)
    for ai in range(3):  # alpha = ai - 1
        for d in range(2):
            u = 2 * (ai - 1) + np.asarray(in_parity) - d
            idx = np.where((u >= -1) & (u <= 1))[0]
            if idx.size:
                # w[u+1, :, k, :] -> (n, kw, cout); target slot (kw, n, cout)
                k2[ai, :, idx, d * cout: (d + 1) * cout] = w[
                    u[idx] + 1, :, np.asarray(in_channel)[idx], :]
    return k2


def _identity_layout(cin: int):
    j = np.arange(2 * cin)
    return j // cin, j % cin


def _concat_layout(c: int):
    """s2d channel layout of concat([skip_s2d(2c), up_s2d(2c)]) expressed in
    the original concat's (parity, channel-of-2c) coordinates."""
    j = np.arange(4 * c)
    parity = (j % (2 * c)) // c
    chan = np.where(j < 2 * c, j % c, c + j % c)
    return parity, chan


def _tile2(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, v])


def _s2d_k(k: torch.Tensor, layout) -> torch.Tensor:
    return torch.from_numpy(s2d_conv3x3_kernel(k.numpy(), *layout))


def _s2d_dc(sd: Mapping[str, torch.Tensor], prefix: str,
            conv1_layout=None) -> Dict[str, Any]:
    """DoubleConv -> s2d-domain folded params. ``conv1_layout`` is the
    (parity, channel) layout of conv1's s2d input channels (identity when
    None)."""
    dc = _fold_dc(sd, prefix)
    cin1, cin2 = dc["k1"].shape[2], dc["k2"].shape[2]
    out = {
        "k1": _s2d_k(dc["k1"], conv1_layout if conv1_layout is not None
                     else _identity_layout(cin1)),
        "s1": _tile2(dc["s1"]), "b1": _tile2(dc["b1"]),
        "k2": _s2d_k(dc["k2"], _identity_layout(cin2)),
        "s2": _tile2(dc["s2"]), "b2": _tile2(dc["b2"]),
    }
    if "fc1" in dc:
        out["fc1"], out["fc2"] = dc["fc1"], dc["fc2"]
    return out


def pack_unet_s2d(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """UNet state_dict -> folded + level-1-H-s2d tree (the tree of
    ``insarseg.models.unet_s2d.pack_unet_s2d``). Plain and SE variants; the
    SA variant raises (its per-pixel gates are meaningless across parity
    lanes: it serves in the standard layout)."""
    sd = _cpu_sd(state_dict)
    if any(k.startswith("sa1.") for k in sd):
        raise ValueError("the SA UNet variant has no H-s2d layout; pack the "
                         "standard layout (pack_unet_folded, s2d=False)")
    f = int(sd["inc.double_conv.0.weight"].shape[0])
    packed: Dict[str, Any] = {"inc": _s2d_dc(sd, "inc")}
    for i in range(1, 5):
        packed[f"down{i}"] = _fold_dc(sd, f"down{i}.1")
    for i in range(1, 4):
        packed[f"up{i}"] = _up(sd, i)
        packed[f"conv{i}"] = _fold_dc(sd, f"conv{i}")
    # up4: ConvT(k2, s2, 2f -> f) -> a W-only lhs-dilated conv emitting the
    # s2d layout. Row parity d folds into output channels (d*f + o); the W
    # parity e becomes a width-2 tap: out[.., 2j+e, d*f+o] uses K[0, 1-e]
    wt = _up(sd, 4)["k"].numpy()  # (2, 2, 2f, f)
    k_up = np.zeros((1, 2, 2 * f, 2 * f), wt.dtype)
    for e in range(2):
        for d in range(2):
            k_up[0, 1 - e, :, d * f: (d + 1) * f] = wt[d, e]
    bias = _optional(sd, "up4.bias")
    packed["up4"] = {"k": torch.from_numpy(k_up),
                     "bias": None if bias is None else _tile2(bias)}
    packed["conv4"] = _s2d_dc(sd, "conv4", _concat_layout(f))
    # the 1x1 head: block-diagonal over parity
    wo = sd["outc.weight"].to(torch.float32)[:, :, 0, 0].t().numpy()
    nc = wo.shape[-1]
    ko = np.zeros((2 * f, 2 * nc), wo.dtype)
    ko[:f, :nc] = wo
    ko[f:, nc:] = wo
    bo = _optional(sd, "outc.bias")
    packed["outc"] = {"k": torch.from_numpy(ko),
                      "bias": None if bo is None else _tile2(bo), "nc": nc}
    return packed


# ---------------------------------------------------------------------------
# forward helpers (NCHW; dtype follows the input, params cast on the fly)
# ---------------------------------------------------------------------------

def _chan(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype)[None, :, None, None]


def _conv_affine(x: torch.Tensor, k: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Same-pad conv with an HWIO kernel, then the folded-BN affine."""
    pad = ((k.shape[0] - 1) // 2, (k.shape[1] - 1) // 2)
    y = F.conv2d(x, k.permute(3, 2, 0, 1).to(x.dtype), padding=pad)
    y = y * _chan(scale, y.dtype) + _chan(bias, y.dtype)
    return torch.relu(y) if relu else y


def _conv_transpose_k2s2(x: torch.Tensor, k: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """ConvTranspose(k2, s2) with a (kh, kw, I, O) kernel."""
    y = F.conv_transpose2d(x, k.permute(2, 3, 0, 1).to(x.dtype), stride=2)
    return y if bias is None else y + _chan(bias, y.dtype)


def _up4_s2d(y: torch.Tensor, k: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, 2f, H/2, W/2) -> (B, 2f, H/2, W): the s2d-layout ConvT(k2, s2).
    The JAX package's lhs-dilated (1, 2) conv with W padding (1, 1) gives
    ``out[.., 2j+e] = y[.., j] @ k[0, 1-e]``: a transposed conv of stride
    (1, 2) with the kernel's width taps reversed."""
    w = k.flip(1).permute(2, 3, 0, 1).to(y.dtype)  # (I, O, 1, 2)
    z = F.conv_transpose2d(y, w, stride=(1, 2))
    return z if bias is None else z + _chan(bias, z.dtype)


def _maxpool_exit_s2d(x2s: torch.Tensor) -> torch.Tensor:
    """s2d (B, 2C, H/2, W) -> the standard-domain max-pool output
    (B, C, H/2, W/2): the max of the two parity halves, then of W pairs."""
    c = x2s.shape[1] // 2
    return F.max_pool2d(torch.maximum(x2s[:, :c], x2s[:, c:]), (1, 2))


def _h_s2d(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, H/2, W, 2C), channel ``a*C + c`` = row
    parity a."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w, c).permute(0, 1, 3, 2, 4).reshape(
        b, h // 2, w, 2 * c)


def _h_d2s(y2: torch.Tensor, nc: int) -> torch.Tensor:
    """NHWC (B, H/2, W, 2nc) -> (B, H, W, nc)."""
    b, rh, w, _ = y2.shape
    return y2.reshape(b, rh, w, 2, nc).permute(0, 1, 3, 2, 4).reshape(
        b, 2 * rh, w, nc)


def _s2d_argmax(logits2: torch.Tensor, nc: int) -> torch.Tensor:
    """(B, H/2, W, 2nc) s2d logits -> the (B, H, W) int32 class map: one
    argmax per parity half, interleaved on the class map."""
    b, rh, w, _ = logits2.shape
    cls2 = torch.stack([logits2[..., :nc].argmax(-1),
                        logits2[..., nc:].argmax(-1)], dim=2)  # (B, H/2, 2, W)
    return cls2.to(torch.int32).reshape(b, 2 * rh, w)


def _se_scales(pk: Mapping, pooled: torch.Tensor) -> torch.Tensor:
    """The SE MLP: (B, C) pooled -> (B, C) f32 sigmoid gate."""
    y = torch.relu(pooled @ pk["fc1"].to(pooled.dtype))
    return torch.sigmoid((y @ pk["fc2"].to(y.dtype)).to(torch.float32))


def _se_pool(y: torch.Tensor, s2d: bool) -> torch.Tensor:
    """The SE squeeze; in s2d the mean of the two parity halves."""
    pooled = y.mean(dim=(2, 3))
    if s2d:
        c = y.shape[1] // 2
        pooled = 0.5 * (pooled[:, :c] + pooled[:, c:])
    return pooled


def _dc_f32(pk: Mapping, x: torch.Tensor, s2d: bool = False):
    """One folded DoubleConv (+ SE; in s2d the gate tiles over the parity
    halves). Returns (t1, t2 before SE, output): the int8 calibration
    replay records the first two."""
    t1 = _conv_affine(x, pk["k1"], pk["s1"], pk["b1"])
    t2 = _conv_affine(t1, pk["k2"], pk["s2"], pk["b2"])
    if "fc1" not in pk:
        return t1, t2, t2
    sc = _se_scales(pk, _se_pool(t2, s2d))
    if s2d:
        sc = torch.cat([sc, sc], dim=-1)
    return t1, t2, t2 * sc.to(t2.dtype)[:, :, None, None]


def _dc(pk: Mapping, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
    return _dc_f32(pk, x, s2d)[2]


def _sa_sigmoid(pk: Mapping, m: torch.Tensor) -> torch.Tensor:
    """The SA gate's folded DoubleConv(2 -> 1) and sigmoid on the NCHW
    (B, 2, H, W) [channel mean, channel max] map: the (B, 1, H, W) f32
    gate."""
    m = _conv_affine(m, pk["k1"], pk["s1"], pk["b1"])
    m = _conv_affine(m, pk["k2"], pk["s2"], pk["b2"])
    return torch.sigmoid(m.to(torch.float32))


def _sa_gate(pk: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Folded SpatialAttentionDC on NCHW ``x`` (f32, or bf16 with an f32
    channel mean): the per-pixel rescale by :func:`_sa_sigmoid`."""
    m = torch.cat([x.mean(dim=1, keepdim=True, dtype=torch.float32)
                   .to(x.dtype), x.amax(dim=1, keepdim=True)], dim=1)
    return x * _sa_sigmoid(pk, m).to(x.dtype)


def unet_s2d_apply(packed: Mapping[str, Any], x: torch.Tensor,
                   argmax: bool = False) -> torch.Tensor:
    """Eval-mode UNet forward over the H-s2d level-1 graph (f32 check of
    the weight transforms; no engine serves it).

    x: (B, H, W, C_in) with H and W divisible by 16. Returns logits
    (B, H, W, nc), or the int32 argmax map (B, H, W) interleaved on the
    class map."""
    nc = packed["outc"]["nc"]
    x1s = _dc(packed["inc"], nhwc_to_nchw(_h_s2d(x)), s2d=True)
    x2 = _dc(packed["down1"], _maxpool_exit_s2d(x1s))
    x3 = _dc(packed["down2"], max_pool_2d(x2))
    x4 = _dc(packed["down3"], max_pool_2d(x3))
    y = _dc(packed["down4"], max_pool_2d(x4))
    for i, skip in ((1, x4), (2, x3), (3, x2)):
        up = packed[f"up{i}"]
        y = _conv_transpose_k2s2(y, up["k"], up["bias"])
        y = _dc(packed[f"conv{i}"], torch.cat([skip, y], dim=1))
    z = _up4_s2d(y, packed["up4"]["k"], packed["up4"]["bias"])
    y2 = _dc(packed["conv4"], torch.cat([x1s, z], dim=1), s2d=True)
    out = packed["outc"]
    logits2 = nchw_to_nhwc(y2) @ out["k"].to(y2.dtype)
    if out["bias"] is not None:
        logits2 = logits2 + out["bias"].to(logits2.dtype)
    if argmax:
        return _s2d_argmax(logits2, nc)
    return _h_d2s(logits2, nc)


def make_s2d_predict_fn(state_dict: Mapping[str, torch.Tensor],
                        argmax: bool = False, device: DeviceLike = None):
    """Pack once onto ``device`` (``None`` means ``cuda``); return
    ``predict(images)`` over the H-s2d graph."""
    dev = resolve_device(device)
    packed = to_torch_tree(pack_unet_s2d(state_dict), dev)

    @torch.inference_mode()
    def predict(images):
        check_hw(tuple(images.shape), 16, 16, "s2d", "unet")
        images = torch.as_tensor(images, device=dev).to(torch.float32)
        return unet_s2d_apply(packed, images, argmax=argmax)

    return predict
