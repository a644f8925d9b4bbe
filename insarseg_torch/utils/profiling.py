"""Step timers, the profiler trace and debugging switches (counterpart of
``insarseg/utils/profiling.py``, its names and arguments):

- :func:`sync` waits for the work queued on a tensor's CUDA device (on the
  CPU there is nothing to wait for);
- :class:`StepTimer` times steps on the host clock, skipping ``warmup``
  steps, with ``mean``, ``p50`` and a ``summary`` line;
- :func:`tiles_per_sec` is the 512^2-equivalent tiles a second per
  device;
- :func:`trace` is a ``torch.profiler`` window whose trace lands in a
  directory (TensorBoard's format);
- :func:`enable_nan_debugging` is the CLI's ``--debug-nans``.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import List, Optional

import torch


def sync(x: torch.Tensor) -> None:
    """Wait for the work queued on ``x``'s device if ``x`` is on a card."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class StepTimer:
    """Per-step host-clock times; the first ``warmup`` steps are not
    kept."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """The seconds since :meth:`start`, after :func:`sync` of
        ``result`` when one is given."""
        if result is not None:
            sync(result)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return statistics.mean(self._times) if self._times else float("nan")

    @property
    def p50(self) -> float:
        return statistics.median(self._times) if self._times else float("nan")

    def summary(self) -> str:
        if not self._times:
            return "no timed steps"
        return (
            f"steps={len(self._times)} mean={self.mean * 1e3:.2f}ms "
            f"p50={self.p50 * 1e3:.2f}ms "
            f"min={min(self._times) * 1e3:.2f}ms "
            f"max={max(self._times) * 1e3:.2f}ms"
        )


def tiles_per_sec(timer: StepTimer, batch: int, tile_px: int,
                  n_chips: Optional[int] = None, ref_px: int = 512) -> float:
    """512^2-equivalent tiles a second per device from a
    :class:`StepTimer`'s mean; ``n_chips`` defaults to
    ``torch.cuda.device_count()`` (1 without a card)."""
    n_chips = n_chips or max(torch.cuda.device_count(), 1)
    scale = (tile_px / ref_px) ** 2
    return batch * scale / timer.mean / n_chips


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('trace_dir'):`` profiles the CPU and, with a card, the
    CUDA activity of the block and writes the trace into ``log_dir``
    (``torch.profiler.tensorboard_trace_handler``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise at the backward operation that makes a NaN
    (``torch.autograd.set_detect_anomaly``; the JAX package's
    ``jax_debug_nans`` / ``jax_debug_infs``). Anomaly mode checks every
    backward output, so a step runs slower while it is on."""
    torch.autograd.set_detect_anomaly(enable)
