"""Inference-time BatchNorm folding (counterpart of ``insarseg/ops/fold.py``).

Eval-mode BN is ``y = x * s + t`` with ``s = gamma / sqrt(var + eps)`` and
``t = beta - mean * s``. Computed in numpy f32 as ``1.0 / sqrt(var + eps)``
(not ``rsqrt``): numpy's f32 square root is correctly rounded, as XLA's is,
where torch's vectorized CPU ``sqrt`` is not, so the folded scales equal
the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy()


def fold_bn(
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    conv_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scale, bias) f32 CPU tensors such that
    ``relu(conv(x) * scale + bias)`` == ``relu(bn(conv(x) + conv_bias))``
    in eval mode."""
    gamma, beta = _f32(weight), _f32(bias)
    mean, var = _f32(running_mean), _f32(running_var)
    s = gamma * (np.float32(1.0) / np.sqrt(var + np.float32(eps)))
    t = beta - mean * s
    if conv_bias is not None:
        t = t + _f32(conv_bias) * s
    return torch.from_numpy(s), torch.from_numpy(t)
