"""Configuration and the named experiment presets (own copy of the part
of ``insarseg/config.py`` that training reads: the port imports nothing of
the JAX package). The model, data-path, remat and save-path fields come
with the code that reads them (ROADMAP Queue 1 items 11 and 12).

The reference's configuration is a block of constants at the top of each
training script; the per-script differences (tile 64 or 128, batch 8 or
128, 25 or 100 epochs, metrics v1 or v2) are the experiment grid. Here it
is one frozen dataclass with one preset per reference script, named after
the script, plus the two extensions. The port trains in f32 only:
``compute_dtype='bfloat16'`` is ROADMAP Queue 1 item 18, and
``mesh_data`` / ``mesh_spatial`` above 1 are item 16 (``train/engine.py``
raises for both).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's fields that :func:`train.engine.fit` reads, with
    the same defaults. The model is built by the caller and passed to
    ``fit`` beside its config."""

    num_classes: int = 2

    # -- data --
    image_size: int = 64
    ignore_index: int = 255
    normalize_mean: float = 0.5
    normalize_std: float = 0.5
    # the on-device D4 augment of the train step (the reference has none)
    augment: bool = False

    # -- training --
    batch_size: int = 8
    num_epochs: int = 25
    learning_rate: float = 1e-4
    seed: int = 0
    log_every_steps: int = 100
    # 1: (acc, miou) of the reference's Unet.py; 2: {acc, miou, mpa, mf1}
    # of its Unet-ChannalAttention.py, OA quirk kept
    metrics_version: int = 2
    # batch_mean: per-batch metrics weighted by batch size (the
    # reference); global: one confusion matrix over the epoch
    metrics_mode: str = "batch_mean"  # batch_mean | global

    # -- execution --
    compute_dtype: str = "float32"  # float32 | bfloat16
    mesh_data: int = -1  # -1 = all devices on the data axis
    mesh_spatial: int = 1  # spatial partitioning of H


# One preset per reference script (SURVEY.md §2.1), named after it: tile
# size, batch, epochs and metrics version as the script sets them. The
# reference's "PSPNet" scripts train FCN-ResNet50 (SURVEY.md §0); the last
# two are the extensions with no reference script (the fast cell, and the
# true PSPNet under the 'pspnet' protocol).
PRESETS: Dict[str, Config] = {
    "unet": Config(image_size=64, batch_size=8, num_epochs=25,
                   metrics_version=1),
    "unet-channelattention": Config(image_size=128, batch_size=8,
                                    num_epochs=25),
    "unet-spatialattention": Config(image_size=64, batch_size=128,
                                    num_epochs=25),
    "deeplabv3": Config(image_size=64, batch_size=8, num_epochs=25,
                        metrics_version=1),
    "deeplabv3-channelattention": Config(image_size=64, batch_size=128,
                                         num_epochs=25),
    "deeplabv3-spatialattention": Config(image_size=64, batch_size=128,
                                         num_epochs=25),
    "pspnet": Config(image_size=64, batch_size=8, num_epochs=25),
    "pspnet-channelattention": Config(image_size=64, batch_size=128,
                                      num_epochs=100),
    "pspnet-spatialattention": Config(image_size=64, batch_size=128,
                                      num_epochs=100),
    "unet-fast-ca": Config(image_size=128, batch_size=8, num_epochs=25),
    "pspnet-true": Config(image_size=64, batch_size=8, num_epochs=25),
}


def get_preset(name: str, **overrides) -> Config:
    key = name.lower().replace("_", "-")
    if key not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}")
    cfg = PRESETS[key]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
