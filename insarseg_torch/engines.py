"""Inference-engine factory (counterpart of ``insarseg/engines.py``).

- ``module`` — the ``nn.Module`` graph in eval mode;
- ``serve``  — the BN-folded exact graph: UNet with deferred SE gates
  (``models/unet_serve.py``; the fast cell's inner UNet, with the
  space-to-depth stem at the rim, ``models/unet_stem.py``), DeepLabV3 /
  FCN / the true PSPNet (``models/resnet_serve.py``);
- ``int8``   — post-training quantization (needs calibration batches):
  UNet through the hand-written kernels K1-K4 and K6
  (``models/unet_int8.py``; the H-space-to-depth layout for attention
  ``none`` and ``channel``, the standard layout for ``spatial`` and for
  the fast cell's inner UNet, as the JAX package packs them), DeepLabV3 /
  FCN / PSPNet through K5a, K5b, K7 and K2's squeeze
  (``models/resnet_int8.py``; the PSPNet's head stays bf16).

The port serves ``unet``, ``unet-fast``, ``deeplabv3``, ``fcn`` and
``pspnet`` with attention ``none``, ``channel`` or ``spatial``. Every
``predict`` takes and returns NHWC tensors and runs on the engine's
device.

Every engine runs over a ``data`` mesh too (``mesh=``, a
``parallel/mesh.py::Mesh``), as the JAX package's engines do with the
batch sharded over ``data`` and the weights replicated: one predict a
mesh device, each over its own copy of the weights (for serve and int8
the tree is packed, and for int8 calibrated, once on the first device
and copied to the others by ``parallel/mesh.py::replicate_arrays``, so
every device holds bit-equal codes and scales), the batch split along
dim 0 and the outputs gathered in order on the first device
(``mesh_engine``). The hand-written kernels then launch on every device
of the mesh. The int8 engines are batch-invariant, so a mesh's int8
logits equal one device's bit for bit; the module and serve engines are
not (cuDNN picks its kernels by the batch), and differ within float
rounding. Given a mesh with a ``spatial`` axis, the serve and int8
engines split the batch over its data axis alone (``Mesh.over_data``),
as the JAX package's ``jit_engine`` does; the module engine shards H as
``parallel/inference.py::make_predict_fn`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.parallel.mesh import Mesh, mesh_engine, replicate_arrays

ENGINES = ("module", "serve", "int8")
KNOWN_MODELS = ("unet", "unet-fast", "deeplabv3", "fcn", "pspnet")
ATTENTIONS = ("none", "channel", "spatial")


def supported(model_name: str, attention: str, engine: str) -> bool:
    """Whether (model, attention) runs on ``engine`` (the JAX package's
    ``supported``): whether :func:`_check_cell` takes the cell."""
    try:
        _check_cell(model_name, attention, engine, None)
    except ValueError:
        return False
    return True


def _check_cell(model_name: str, attention: str, engine: str,
                mesh: Any) -> str:
    model_name = model_name.lower().replace("_", "-")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if model_name not in KNOWN_MODELS:
        raise ValueError(f"unknown model {model_name!r}; known models: "
                         f"{KNOWN_MODELS}")
    if attention not in ATTENTIONS:
        raise ValueError(f"unknown attention {attention!r}")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be an insarseg_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    return model_name


def check_hw(shape: Tuple[int, ...], hdiv: int, wdiv: int,
             engine: str, model: str) -> None:
    """Guard for the packed engines' shape envelope: NHWC with H and W
    divisible so every pooling level is even (the CA resize never fires,
    so its omission from the packed graphs is exact)."""
    if len(shape) != 4:
        raise ValueError(
            f"engine {engine!r} ({model}) expects NHWC images, got shape "
            f"{tuple(shape)}")
    _, h, w, _ = shape
    if h % hdiv or w % wdiv:
        raise ValueError(
            f"engine {engine!r} ({model}) requires H divisible by {hdiv} "
            f"and W divisible by {wdiv}; got H={h}, W={w}. Pad the input "
            "or use engine='module' (no shape envelope).")


def make_engine(
    model_name: str,
    attention: str,
    model: torch.nn.Module,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    engine: str = "serve",
    calib_batches: Optional[List[Any]] = None,
    argmax: bool = False,
    input_dtype: Optional[torch.dtype] = None,
    mesh: Optional[Mesh] = None,
    calib_stat: str = "absmax",
    device: DeviceLike = None,
):
    """Build ``predict(images) -> logits | int32 class map`` on ``device``
    (``None`` means ``cuda``), or over ``mesh`` (its first device then
    packs, calibrates and gathers; ``device`` is not read).

    ``state_dict`` defaults to ``model.state_dict()``. ``calib_batches``
    (normalized f32 NHWC batches) is required for ``engine='int8'``;
    ``calib_stat`` is 'absmax' or 'p<percent>'."""
    model_name = _check_cell(model_name, attention, engine, mesh)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    sd = model.state_dict() if state_dict is None else state_dict

    if engine == "module":
        from insarseg_torch.parallel.inference import make_predict_fn

        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        return make_predict_fn(model, argmax=argmax, input_dtype=input_dtype,
                               device=dev, mesh=mesh)
    meta = _meta(model_name, model)
    if engine == "serve":
        return _placed(lambda t, d: _serve_predict(
            model_name, t, d, argmax, input_dtype, meta),
            _pack(model_name, attention, sd, engine, meta=meta), dev, mesh)
    if not calib_batches:
        raise ValueError(
            "engine='int8' needs at least one calibration batch "
            "(calib_batches was "
            f"{'None' if calib_batches is None else 'empty'}); collect "
            "them with insarseg_torch.engines.collect_calib_batches")
    tree = _pack(model_name, attention, sd, engine, calib_batches,
                 calib_stat, dev, meta)
    return _placed(lambda t, d: _int8_predict(model_name, t, d, argmax,
                                              meta), tree, dev, mesh)


def _placed(build, tree: Mapping[str, Any], dev: torch.device,
            mesh: Optional[Mesh]):
    """``build(tree, device)``'s predict on ``dev``, or one a device of the
    mesh's data axis over copies of ``tree`` (``replicate_arrays``), split
    and gathered by ``mesh_engine``: a packed engine never shards H, as
    the JAX package's ``jit_engine`` shards its batch over ``data``
    alone."""
    if mesh is None:
        return build(tree, dev)
    mesh = mesh.over_data()
    return mesh_engine([build(t, d) for t, d in
                        zip(replicate_arrays(tree, mesh),
                            mesh.devices)], mesh)


def _meta(model_name: str, model: torch.nn.Module) -> Dict[str, Any]:
    """An artifact's ``meta``: the class count, and for the fast cell its
    space-to-depth factor (the JAX package's keys)."""
    nc = getattr(model, "num_classes", None)
    meta: Dict[str, Any] = {}
    if model_name == "unet-fast":
        meta["factor"] = int(model.factor)
    meta["num_classes"] = int(nc) if nc is not None else None
    return meta


def _pack(model_name: str, attention: str, sd: Mapping[str, torch.Tensor],
          engine: str, calib_batches: Optional[List[Any]] = None,
          calib_stat: str = "absmax",
          device: Optional[torch.device] = None,
          meta: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """The packed tree of a serve or int8 engine (on the CPU, in the JAX
    package's format); int8 calibrates on ``device``. The U-Net int8 tree
    is H-s2d except for the SA variant and the fast cell's inner UNet, as
    the JAX package packs them."""
    if model_name == "unet-fast":
        from insarseg_torch.models.unet_stem import pack_fast

        return pack_fast(sd, engine, meta["factor"], calib_batches,
                         calib_stat, device)
    if model_name == "unet":
        if engine == "serve":
            from insarseg_torch.models.unet_serve import pack_unet_serve

            return pack_unet_serve(sd)
        from insarseg_torch.models.unet_int8 import pack_unet_int8

        return pack_unet_int8(sd, calib_batches, s2d=attention != "spatial",
                              calib_stat=calib_stat, device=device)
    if engine == "serve":
        from insarseg_torch.models.resnet_serve import pack_resnet_serve

        return pack_resnet_serve(sd)
    from insarseg_torch.models.resnet_int8 import pack_resnet_int8

    return pack_resnet_int8(sd, calib_batches, calib_stat=calib_stat,
                            device=device)


def _serve_predict(model_name: str, tree: Mapping[str, Any],
                   dev: torch.device, argmax: bool,
                   input_dtype: Optional[torch.dtype],
                   meta: Mapping[str, Any]):
    from insarseg_torch.engines_io import to_torch_tree

    if model_name == "unet-fast":
        from insarseg_torch.models.unet_stem import make_fast_predict_fn

        return make_fast_predict_fn(
            to_torch_tree(tree, dev), "serve", int(meta["factor"]),
            int(meta["num_classes"]), argmax=argmax, input_dtype=input_dtype)
    if model_name == "unet":
        from insarseg_torch.models.unet_serve import make_serve_predict_fn
    else:
        from insarseg_torch.models.resnet_serve import (
            make_resnet_serve_predict_fn as make_serve_predict_fn,
        )
    return make_serve_predict_fn(to_torch_tree(tree, dev), argmax=argmax,
                                 input_dtype=input_dtype)


def _int8_predict(model_name: str, tree: Mapping[str, Any],
                  dev: torch.device, argmax: bool, meta: Mapping[str, Any]):
    if model_name == "unet-fast":
        from insarseg_torch.models.unet_int8 import prepare_int8
        from insarseg_torch.models.unet_stem import make_fast_predict_fn

        return make_fast_predict_fn(
            prepare_int8(tree, dev), "int8", int(meta["factor"]),
            int(meta["num_classes"]), argmax=argmax)
    if model_name == "unet":
        from insarseg_torch.models.unet_int8 import (
            make_int8_predict_fn,
            prepare_int8,
        )

        return make_int8_predict_fn(prepare_int8(tree, dev), argmax=argmax)
    from insarseg_torch.models.resnet_int8 import (
        make_resnet_int8_predict_fn,
        prepare_resnet_int8,
    )

    return make_resnet_int8_predict_fn(prepare_resnet_int8(tree, dev),
                                       argmax=argmax)


def pack_engine(
    model_name: str,
    attention: str,
    model: torch.nn.Module,
    state_dict: Optional[Mapping[str, torch.Tensor]],
    engine: str,
    calib_batches: Optional[List[Any]] = None,
    calib_stat: str = "absmax",
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Pack (and for int8: calibrate on ``device``) a serving engine into
    a portable artifact dict, the JAX package's format 1."""
    model_name = _check_cell(model_name, attention, engine, None)
    if engine == "module":
        raise ValueError("the module engine is the live nn.Module graph; "
                         "artifacts exist for 'serve' and 'int8' only")
    sd = model.state_dict() if state_dict is None else state_dict
    if engine == "int8" and not calib_batches:
        raise ValueError("engine='int8' needs calibration batches")
    meta = _meta(model_name, model)
    tree = _pack(model_name, attention, sd, engine, calib_batches,
                 calib_stat,
                 resolve_device(device) if engine == "int8" else None, meta)
    return {"format": 1, "model": model_name, "attention": attention,
            "engine": engine, "meta": meta, "tree": tree}


def engine_from_artifact(
    artifact: Dict[str, Any],
    argmax: bool = False,
    input_dtype: Optional[torch.dtype] = None,
    mesh: Optional[Mesh] = None,
    device: DeviceLike = None,
):
    """Rebuild ``predict(images)`` from an artifact (in memory, or read
    with ``insarseg_torch.engines_io.load_artifact``), written by either
    package; a U-Net int8 tree serves in the layout it was packed in. On
    ``device``, or over ``mesh`` as :func:`make_engine` serves."""
    model_name, engine = artifact.get("model"), artifact.get("engine")
    if artifact.get("format") != 1:
        raise ValueError(
            f"unsupported engine-artifact format {artifact.get('format')!r}"
            " (this build reads format 1)")
    if model_name not in KNOWN_MODELS or engine not in ("serve", "int8"):
        raise ValueError(
            f"bad engine artifact: model={model_name!r}, engine={engine!r}"
            f" (known models: {KNOWN_MODELS})")
    _check_cell(model_name, artifact.get("attention", "none"), engine, mesh)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    meta = artifact.get("meta") or {}
    if engine == "serve":
        return _placed(lambda t, d: _serve_predict(
            model_name, t, d, argmax, input_dtype, meta),
            artifact["tree"], dev, mesh)
    return _placed(lambda t, d: _int8_predict(model_name, t, d, argmax,
                                              meta), artifact["tree"], dev,
                   mesh)


def collect_calib_batches(loader, n: int, normalize_mean: float = 0.5,
                          normalize_std: float = 0.5) -> List[np.ndarray]:
    """Peek the first ``n`` batches off a loader as normalized f32 NHWC
    arrays (uint8 images are renormalized). Raises if the loader yields
    nothing."""
    peek = iter(loader)
    calib: List[np.ndarray] = []
    for _ in range(max(n, 1)):
        try:
            b = next(peek)
        except StopIteration:
            break
        raw = b["image"]
        img = np.asarray(raw, np.float32)
        if np.asarray(raw).dtype == np.uint8:
            img = (img / 255.0 - normalize_mean) / normalize_std
        calib.append(img)
    if hasattr(peek, "close"):
        peek.close()
    if not calib:
        raise ValueError("loader yielded no batches to calibrate on")
    return calib
