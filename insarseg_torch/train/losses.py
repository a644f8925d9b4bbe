"""Loss of the train step (counterpart of ``insarseg/train/losses.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255) -> torch.Tensor:
    """Mean softmax cross-entropy over valid pixels, differentiable.

    ``logits``: (B, H, W, C) float, promoted to at least f32; ``labels``:
    (B, H, W) integer class ids. ``ignore_index`` pixels contribute
    nothing; an all-ignored batch gives 0 (``F.cross_entropy`` gives NaN),
    and a label outside [0, C) that is not ``ignore_index`` counts as the
    last class, as in the JAX package."""
    num, valid = cross_entropy_terms(logits, labels, ignore_index)
    return num / valid.clamp_min(1)


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = 255
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss's numerator, the summed cross-entropy over the valid
    pixels (differentiable), and its denominator, the count of valid
    pixels (int64). Under a data mesh a rank sums its own pixels and the
    counts are summed over the ranks: the JAX loss is ``num / max(valid,
    1)`` over the global batch, which a mean per rank misses whenever the
    ranks hold different numbers of valid pixels."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    ll = logp.gather(-1, safe.long()[..., None])[..., 0]
    return torch.where(valid, -ll, 0.0).sum(), valid.sum()
