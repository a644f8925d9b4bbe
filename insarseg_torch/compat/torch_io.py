"""JAX ``{'params','batch_stats'}`` trees <-> reference PyTorch state_dicts.

Own copy of ``insarseg/compat/torch_io.py::unet_variables_to_torch`` and
``segmentation_variables_to_torch`` (the port imports nothing of the JAX
package; the DeepLabV3 / FCN names are torchvision's, see
:func:`segmentation_variables_to_torch`), and
:func:`pspnet_variables_to_torch` for the true PSPNet, which has no
reference twin. Input: the JAX variables as numpy
arrays (or anything ``np.asarray`` takes). Output: numpy arrays under the
reference's state_dict names (``inc.double_conv.0``, ``down{i}.1.…``,
``….double_conv.6.fc.0/2``, ``up{i}``, ``outc``), which
``insarseg_torch.models.unet.UNet.load_state_dict(strict=True)`` accepts;
and :func:`graft_grayscale_stem`, which the CLI's ``--torch-checkpoint``
applies to a ResNet family's RGB stem.

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

from insarseg_torch.models.pspnet import BINS
from insarseg_torch.models.resnet import backbone_layers


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


def graft_grayscale_stem(kernel: Any) -> np.ndarray:
    """An RGB stem conv kernel averaged over its 3 input channels to one,
    the reference's adaptation of pretrained weights
    (``original_conv1.weight.mean(dim=1, keepdim=True)``; own copy of
    ``insarseg/compat/torch_io.py::graft_grayscale_stem``). Either layout:
    HWIO (kh, kw, 3, cout) -> (kh, kw, 1, cout), or torch OIHW (cout, 3,
    kh, kw) -> (cout, 1, kh, kw)."""
    k = _np(kernel)
    if k.ndim != 4:
        raise ValueError(f"expected a 4D conv kernel, got shape {k.shape}")
    if k.shape[2] == 3:  # HWIO
        return k.mean(axis=2, keepdims=True)
    if k.shape[1] == 3:  # OIHW
        return k.mean(axis=1, keepdims=True)
    raise ValueError(
        f"no 3-channel input axis found in kernel shape {k.shape}")


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


# ---------------------------------------------------------------------------
# torchvision-segmentation family (DeepLabV3 / FCN), export direction: own
# copy of ``insarseg/compat/torch_io.py::_resnet_backbone`` /
# ``_map_segmentation`` with the ``_Exporter`` side only
# ---------------------------------------------------------------------------

class _Exporter:
    """Writes JAX-tree leaves under torchvision state_dict names, in the
    JAX package's key order."""

    def __init__(self, variables: Mapping[str, Any], prefix: str):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.prefix = prefix
        self.out: Dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def has(self, *jpath: str) -> bool:
        try:
            self._get(self.params, jpath)
            return True
        except KeyError:
            return False

    def conv(self, tkey: str, *jpath: str) -> None:
        p = self._get(self.params, jpath)
        self.out[self.prefix + tkey + ".weight"] = \
            _np(p["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in p:
            self.out[self.prefix + tkey + ".bias"] = _np(p["bias"])

    def bn(self, tkey: str, *jpath: str) -> None:
        p, s = self._get(self.params, jpath), self._get(self.stats, jpath)
        t = self.prefix + tkey
        self.out[t + ".weight"] = _np(p["scale"])
        self.out[t + ".bias"] = _np(p["bias"])
        self.out[t + ".running_mean"] = _np(s["mean"])
        self.out[t + ".running_var"] = _np(s["var"])
        self.out[t + ".num_batches_tracked"] = np.asarray(0)


def _backbone(m: _Exporter, backbone: str, use_se: bool) -> None:
    """The ResNet backbone under torchvision's ``backbone.*`` names."""
    m.conv("backbone.conv1", "backbone", "conv1")
    m.bn("backbone.bn1", "backbone", "bn1")
    for li, blocks in enumerate(backbone_layers(backbone), start=1):
        for bi in range(blocks):
            t, j = f"backbone.layer{li}.{bi}", ("backbone", f"layer{li}_{bi}")
            for ci in (1, 2, 3):
                m.conv(f"{t}.conv{ci}", *j, f"conv{ci}")
                m.bn(f"{t}.bn{ci}", *j, f"bn{ci}")
            if m.has(*j, "downsample_conv"):
                m.conv(f"{t}.downsample.0", *j, "downsample_conv")
                m.bn(f"{t}.downsample.1", *j, "downsample_bn")
            if use_se:
                m.conv(f"{t}.se_block.fc.0", *j, "se_block", "fc1")
                m.conv(f"{t}.se_block.fc.2", *j, "se_block", "fc2")


def segmentation_variables_to_torch(
    variables: Mapping[str, Any],
    model: str,
    attention: str = "none",
    prefix: str = "",
    backbone: str = "resnet50",
) -> Dict[str, np.ndarray]:
    """insarseg DeepLabV3 / FCN variables -> torchvision-naming state_dict
    (numpy), which ``insarseg_torch.models.registry.build(model,
    attention)`` loads with ``strict=True``. ``model`` is 'deeplabv3' or
    'fcn'; ``prefix`` prepends a wrapper prefix to every key."""
    m = _Exporter(variables, prefix)
    _backbone(m, backbone, model == "fcn" and attention == "channel")
    if model == "deeplabv3":
        for i in range(4):  # ASPP convs.0..3: 1x1 + three atrous branches
            m.conv(f"classifier.0.convs.{i}.0", "aspp", f"conv{i}")
            m.bn(f"classifier.0.convs.{i}.1", "aspp", f"bn{i}")
        m.conv("classifier.0.convs.4.1", "aspp", "pool_conv")
        m.bn("classifier.0.convs.4.2", "aspp", "pool_bn")
        m.conv("classifier.0.project.0", "aspp", "project_conv")
        m.bn("classifier.0.project.1", "aspp", "project_bn")
        m.conv("classifier.1", "head_conv")
        if attention != "spatial":  # the SA variant drops classifier.2
            m.bn("classifier.2", "head_bn")
        m.conv("classifier.4", "classifier")
        if attention == "channel":
            m.conv("attention_module.mlp.0", "attention", "mlp_fc1")
            m.conv("attention_module.mlp.2", "attention", "mlp_fc2")
        elif attention == "spatial":
            m.conv("attention_module.conv", "attention", "conv")
    elif model == "fcn":
        m.conv("classifier.0", "classifier", "conv1")
        m.bn("classifier.1", "classifier", "bn1")
        m.conv("classifier.4", "classifier", "conv2")
        if attention == "spatial":
            m.conv("spatial_attention.conv", "spatial_attention", "conv")
    else:
        raise KeyError(f"unknown model {model!r}")
    return m.out


def pspnet_variables_to_torch(
    variables: Mapping[str, Any],
    attention: str = "none",
    prefix: str = "",
    backbone: str = "resnet50",
) -> Dict[str, np.ndarray]:
    """insarseg true-PSPNet variables -> the port's state_dict (numpy),
    which ``insarseg_torch.models.registry.build('pspnet', attention)``
    loads with ``strict=True``: torchvision's names for the backbone, the
    JAX package's module names for the head (``ppm.conv_bin{b}``,
    ``ppm.bn_bin{b}``, ``bottleneck_conv``, ``bottleneck_bn``,
    ``classifier``; the reference has no PSPNet to name them)."""
    m = _Exporter(variables, prefix)
    _backbone(m, backbone, attention == "channel")
    if attention == "spatial":
        m.conv("spatial_attention.conv", "spatial_attention", "conv")
    for b in BINS:
        m.conv(f"ppm.conv_bin{b}", "ppm", f"conv_bin{b}")
        m.bn(f"ppm.bn_bin{b}", "ppm", f"bn_bin{b}")
    m.conv("bottleneck_conv", "bottleneck_conv")
    m.bn("bottleneck_bn", "bottleneck_bn")
    m.conv("classifier", "classifier")
    return m.out
