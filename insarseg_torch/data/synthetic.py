"""In-memory synthetic batches for smoke training (own copy of
``insarseg/data/synthetic.py::synthetic_batch``, numpy only). The on-disk
VOC fixture waits for the port's data reader (ROADMAP Queue 1 item 11)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def synthetic_batch(batch_size: int, size: int,
                    seed: int = 0) -> Dict[str, Any]:
    """{'image': (B, size, size, 1) f32 in [-1, 1], 'mask': (B, size, size)
    int32 in {0, 1}, 'n_valid': B}, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (batch_size, size, size, 1)).astype(np.float32)
    mask = (rng.random((batch_size, size, size)) > 0.8).astype(np.int32)
    return {"image": img, "mask": mask, "n_valid": batch_size}
