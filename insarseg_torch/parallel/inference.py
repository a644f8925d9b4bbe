"""Batched inference over the ``nn.Module`` graph (counterpart of
``insarseg/parallel/inference.py::make_predict_fn``, single device; the
mesh-sharded form is ROADMAP Queue 1 item 16)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.ops.layers import nchw_to_nhwc, nhwc_to_nchw


def make_predict_fn(
    model: nn.Module,
    argmax: bool = False,
    input_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``predict(images)``: NHWC images in, NHWC logits (or the int32
    argmax map (B, H, W)) out, on ``device`` (``None`` means ``cuda``).

    With ``input_dtype`` (e.g. ``torch.bfloat16``, the CLI's
    ``--compute-dtype``) the images enter in that dtype and the graph
    follows it (``ops/layers.py``): the convs and linears cast their f32
    weights per call, BatchNorm keeps f32 parameters and statistics, as
    the JAX module does for a bf16 input; the logits come out in it."""
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
