"""Segmentation metrics on the device (counterpart of
``insarseg/train/metrics.py``), both of the reference's variants:

- v1 (:func:`metrics_v1`): pixel accuracy correct / valid, and the mIoU
  over the classes with a non-empty union;
- v2 (:func:`metrics_v2`): {acc, miou, mpa, mf1}, with the reference's OA
  quirk kept: its denominator is TP + FP + FN summed over classes, so a
  wrong pixel counts twice and OA = correct / (correct + 2 wrong).

Counts are summed as integers on the device and cast to f32, as the JAX
package casts them. The metric functions reduce over the last (class)
axis, so a stack of per-step counts (S, C) gives S metrics at once.
"""

from __future__ import annotations

from typing import Dict

import torch


def confusion_counts(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int,
                     ignore_index: int = 255) -> Dict[str, torch.Tensor]:
    """Per-class TP / FP / FN (C,) and the correct / valid totals, f32.

    ``logits``: (B, H, W, C) float (argmax over the last axis) or an
    integer (B, H, W) prediction map; ``labels``: (B, H, W)."""
    preds = logits.argmax(-1) if logits.dim() == labels.dim() + 1 \
        else logits
    valid = labels != ignore_index
    cls = torch.arange(num_classes, device=labels.device)
    p = (preds[..., None] == cls) & valid[..., None]
    t = (labels[..., None] == cls) & valid[..., None]
    axes = tuple(range(labels.dim()))

    def count(m):
        return m.sum(dim=axes).to(torch.float32)

    return {"tp": count(p & t), "fp": count(p & ~t), "fn": count(~p & t),
            "correct": ((preds == labels) & valid).sum().to(torch.float32),
            "valid": valid.sum().to(torch.float32)}


def merge_counts(a: Dict[str, torch.Tensor],
                 b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Accumulate confusion counts (the global-confusion metric mode)."""
    return {k: a[k] + b[k] for k in a}


def _safe_div(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.where(d > 0, n / torch.where(d > 0, d, 1.0), 0.0)


def _mean_over(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _safe_div((v * mask).sum(-1), mask.sum(-1))


def metrics_v1(counts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """(pixel accuracy, mIoU), the reference's ``Unet.py`` metrics."""
    tp, fp, fn = counts["tp"], counts["fp"], counts["fn"]
    union = tp + fp + fn
    present = (union > 0).to(torch.float32)
    return {"acc": _safe_div(counts["correct"], counts["valid"]),
            "miou": _mean_over(_safe_div(tp, union), present)}


def metrics_v2(counts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{acc, miou, mpa, mf1}, the reference's ``Unet-ChannalAttention.py``
    metrics, OA quirk kept."""
    tp, fp, fn = counts["tp"], counts["fp"], counts["fn"]
    acc = _safe_div(tp.sum(-1), tp.sum(-1) + fp.sum(-1) + fn.sum(-1))
    union = tp + fp + fn
    miou = _mean_over(_safe_div(tp, union),
                      (union > 0).to(torch.float32))
    recall = _safe_div(tp, tp + fn)
    has_gt = (tp + fn > 0).to(torch.float32)
    precision = _safe_div(tp, tp + fp)
    f1 = _safe_div(2.0 * precision * recall, precision + recall)
    return {"acc": acc, "miou": miou, "mpa": _mean_over(recall, has_gt),
            "mf1": _mean_over(f1, has_gt)}


def compute(counts: Dict[str, torch.Tensor],
            version: int = 2) -> Dict[str, torch.Tensor]:
    return metrics_v1(counts) if version == 1 else metrics_v2(counts)
