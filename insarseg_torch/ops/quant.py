"""Symmetric int8 post-training-quantization primitives (counterpart of
``insarseg/ops/quant.py``):

- weights: per-output-channel symmetric absmax scales, codes in [-127, 127];
  computed in numpy f32 in the JAX package's order, so codes and scales
  match it bit for bit;
- activations: per-tensor scales from a calibration statistic, floored at
  1e-12;
- requantization: ``y / s`` (a true division, never a multiply by ``1/s``),
  round half to even (``torch.round``), clip to [-127, 127].
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

QMAX = 127.0


def quant_weight(k) -> Dict[str, np.ndarray]:
    """HWIO (or 2-D) kernel -> {'q': int8 codes, 'ws': per-out-channel
    scales}, symmetric absmax over all non-output axes."""
    if isinstance(k, torch.Tensor):
        k = k.detach().cpu().numpy()
    k = np.asarray(k, np.float32)
    s = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0) / QMAX
    s = np.maximum(s, 1e-12)
    q = np.clip(np.rint(k / s), -127, 127).astype(np.int8)
    return {"q": q, "ws": s}


def absmax_to_scale(absmax: float) -> float:
    """Calibrated tensor statistic -> activation scale (floored)."""
    return max(float(absmax), 1e-12) / QMAX


def _percentile(q: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """``jnp.quantile(|t|.ravel(), q)`` with jnp's 'linear' method, in the
    same f32 arithmetic. Uses ``kthvalue`` for the two order statistics:
    ``torch.quantile`` refuses inputs above 2^24 elements."""

    def stat(t: torch.Tensor) -> torch.Tensor:
        a = t.detach().abs().to(torch.float32).reshape(-1)
        n = a.numel()
        one = np.float32(1)
        pos = np.float32(q) * (np.float32(n) - one)
        low, high = np.floor(pos), np.ceil(pos)
        high_w = pos - low
        low_w = one - high_w
        last = np.float32(n) - one
        lo = int(np.clip(low, 0, last))
        hi = int(np.clip(high, 0, last))
        lo_v = a.kthvalue(lo + 1).values
        hi_v = lo_v if hi == lo else a.kthvalue(hi + 1).values
        return lo_v * float(low_w) + hi_v * float(high_w)

    return stat


def calib_stat_fn(stat: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Calibration statistic over |t| for activation scales: 'absmax', or
    'p<percent>' (50 < percent < 100, e.g. 'p99.9')."""
    if stat == "absmax":
        return lambda t: t.detach().abs().max().to(torch.float32)
    if stat.startswith("p"):
        try:
            pct = float(stat[1:])
        except ValueError:
            pct = float("nan")
        if not 50.0 < pct < 100.0:
            raise ValueError(
                f"bad calibration percentile {stat!r}: expected "
                "'p<percent>' with 50 < percent < 100, e.g. 'p99.9'")
        return _percentile(pct / 100.0)
    raise ValueError(
        f"unknown calibration stat {stat!r}; expected 'absmax' or "
        "'p<percent>' (e.g. 'p99.9' for the 99.9th percentile)")


def f32_scalar(v: float, device: torch.device) -> torch.Tensor:
    """A 0-d f32 tensor holding ``v`` (rounded to f32 as
    ``torch.tensor(v, dtype=torch.float32)`` rounds it) on ``device``,
    filled there: ``torch.tensor(v, device=cuda)`` copies from pageable
    host memory, which synchronises the stream."""
    return torch.full((), v, dtype=torch.float32, device=device)


def dequant(q: torch.Tensor, s: float) -> torch.Tensor:
    """int8 codes at scale ``s`` -> f32 ``q * s``, one f32 multiply by a
    scale on ``q``'s device."""
    return q.to(torch.float32) * f32_scalar(s, q.device)


def requant(y: torch.Tensor, s: float) -> torch.Tensor:
    """f32 values -> int8 codes at scale ``s``. The divisor is a tensor on
    ``y``'s device: a CUDA division by a host scalar is computed as a
    multiply by its reciprocal, which rounds differently."""
    d = f32_scalar(s, y.device)
    return torch.round(y.to(torch.float32) / d).clamp_(-127, 127) \
        .to(torch.int8)
