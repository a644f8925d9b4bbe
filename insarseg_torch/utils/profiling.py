"""Debugging switches (the part of ``insarseg/utils/profiling.py`` that
the CLI's ``--debug-nans`` reads; tracing and timing are ROADMAP Queue 1
item 16)."""

from __future__ import annotations

import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise at the backward operation that makes a NaN
    (``torch.autograd.set_detect_anomaly``; the JAX package's
    ``jax_debug_nans`` / ``jax_debug_infs``). Anomaly mode checks every
    backward output, so a step runs slower while it is on."""
    torch.autograd.set_detect_anomaly(enable)
