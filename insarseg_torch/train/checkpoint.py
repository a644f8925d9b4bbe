"""Checkpoints: the best weights by validation mIoU, and the latest state
with its optimizer for resume (counterpart of
``insarseg/train/checkpoint.py``, torch files in place of Orbax).

- ``best.pt``: the model's state_dict (the reference's names, so it loads
  with ``strict=True`` into ``models.registry.build(...)``), with the
  ``best_miou.json`` sidecar;
- ``latest.pt``: {'step', 'model', 'optimizer'}, the step, the
  state_dict and the optimizer's state_dict.

Each file is written under a temporary name and moved into place, so a
crash never leaves a torn checkpoint. Files saved on the card load on the
CPU: restores read them there, and the loads copy the tensors to the
parameters' device. Under a ``torch.distributed`` group only rank 0
writes (every rank holds the same state); every rank may restore.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from insarseg_torch.device import DeviceLike
from insarseg_torch.parallel.mesh import rank


def _save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "best.pt")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latest.pt")

    @property
    def _best_metric_path(self) -> str:
        return os.path.join(self.directory, "best_miou.json")

    def save_best(self, state, miou: float) -> None:
        if rank():
            return
        _save(state.model.state_dict(), self.best_path)
        tmp = self._best_metric_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"miou": float(miou)}, f)
        os.replace(tmp, self._best_metric_path)

    def best_metric(self) -> float:
        """The best validation mIoU saved so far, or -1.0 if none."""
        if os.path.exists(self._best_metric_path):
            with open(self._best_metric_path) as f:
                return float(json.load(f)["miou"])
        return -1.0

    def save_latest(self, state) -> None:
        if rank():
            return
        _save({"step": state.step, "model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict()}, self.latest_path)

    def restore_best(self, model: Optional[torch.nn.Module] = None,
                     map_location: DeviceLike = "cpu"
                     ) -> Dict[str, torch.Tensor]:
        """The best state_dict on ``map_location``; loaded strictly into
        ``model`` too when one is given."""
        sd = torch.load(self.best_path, map_location=map_location,
                        weights_only=True)
        if model is not None:
            model.load_state_dict(sd, strict=True)
        return sd

    def restore_latest(self, state):
        """Load the latest checkpoint into ``state`` (its model strictly,
        its optimizer, its step); returns ``state``. Read on the CPU: the
        loads copy the tensors to the parameters' device, and Adam's step
        counts stay host tensors, as Adam keeps them (a step count on the
        card would make each update read it back)."""
        ck = torch.load(self.latest_path, map_location="cpu",
                        weights_only=True)
        state.model.load_state_dict(ck["model"], strict=True)
        state.optimizer.load_state_dict(ck["optimizer"])
        state.step = int(ck["step"])
        return state

    def has_latest(self) -> bool:
        return os.path.exists(self.latest_path)
