"""Batched inference (single device in this slice)."""

from insarseg_torch.parallel.inference import make_predict_fn

__all__ = ["make_predict_fn"]
