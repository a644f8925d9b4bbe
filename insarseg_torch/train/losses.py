"""Loss of the train step (counterpart of ``insarseg/train/losses.py``)."""

from __future__ import annotations

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255) -> torch.Tensor:
    """Mean softmax cross-entropy over valid pixels, differentiable.

    ``logits``: (B, H, W, C) float, promoted to at least f32; ``labels``:
    (B, H, W) integer class ids. ``ignore_index`` pixels contribute
    nothing; an all-ignored batch gives 0 (``F.cross_entropy`` gives NaN),
    and a label outside [0, C) that is not ``ignore_index`` counts as the
    last class, as in the JAX package."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    ll = logp.gather(-1, safe.long()[..., None])[..., 0]
    num = torch.where(valid, -ll, 0.0).sum()
    return num / valid.sum().clamp_min(1)
