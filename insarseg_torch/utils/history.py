"""The training-history JSON (own copy of ``insarseg/utils/history.py``): a
list of per-epoch dicts keyed ``epoch``, ``train_loss``, ``train_acc``,
``train_miou`` (and ``train_mpa`` / ``train_mf1`` under metrics v2) and
their ``val_*`` twins, the reference's format, so plots written against
it read the port's files."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch


def _to_py(v: Any) -> Any:
    """numpy and torch scalars -> Python numbers; other values as they
    are."""
    if isinstance(v, torch.Tensor) and v.dim() == 0:
        v = v.item()
    elif isinstance(v, np.generic):
        v = v.item()
    return v


def sanitize_history(history: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [{k: _to_py(v) for k, v in epoch.items()} for epoch in history]


def save_history(history: List[Dict[str, Any]], path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(sanitize_history(history), f, indent=4)


def load_history(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return json.load(f)
