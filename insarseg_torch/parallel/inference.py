"""Batched inference over the ``nn.Module`` graph (counterpart of
``insarseg/parallel/inference.py::make_predict_fn``), on one device or
over a ('data', 'spatial') mesh (``parallel/mesh.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw
from insarseg_torch.parallel.mesh import (
    Mesh,
    mesh_engine,
    replicate,
    spatial_engine,
)


def make_predict_fn(
    model: nn.Module,
    argmax: bool = False,
    input_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``predict(images)``: NHWC images in, NHWC logits (or the int32
    argmax map (B, H, W)) out, on ``device`` (``None`` means ``cuda``).

    With ``input_dtype`` (e.g. ``torch.bfloat16``, the CLI's
    ``--compute-dtype``) the images enter in that dtype and the graph
    follows it (``ops/layers.py``): the convs and linears cast their f32
    weights per call, BatchNorm keeps f32 parameters and statistics, as
    the JAX module does for a bf16 input; the logits come out in it.

    With ``mesh`` (``device`` is then not read) there is one eval-mode
    copy of ``model`` a mesh device (``replicate``), and the batch is
    split over them and gathered on the first (``mesh_engine``). On a
    mesh with ``spatial`` above 1 the H axis is sharded too, as the JAX
    package's ``make_predict_fn`` shards it (``spatial_engine``: one
    thread a slab, each entering inference mode itself), for every family
    of the registry (``models/registry.py::check_spatial``), their slabs
    a multiple of 16 rows for the U-Nets, 32 for ``unet-fast`` and 8 for
    the ResNet families."""
    if mesh is not None:
        engine = mesh_engine
        if mesh.spatial > 1:
            from insarseg_torch.models.registry import check_spatial

            check_spatial(model)
            engine = spatial_engine
        return engine([make_predict_fn(m, argmax, input_dtype, d)
                       for m, d in zip(replicate(model, mesh),
                                       mesh.devices)], mesh)
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def predict(images):
        x = torch.as_tensor(images, device=dev).to(
            input_dtype or torch.float32)
        logits = model(nhwc_to_nchw(x))
        if argmax:
            return logits.argmax(dim=1).to(torch.int32)
        return nchw_to_nhwc(logits)

    return predict
