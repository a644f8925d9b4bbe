"""Configuration and the named experiment presets (own copy of
``insarseg/config.py``: the port imports nothing of the JAX package).

The reference's configuration is a block of constants at the top of each
training script; the per-script differences (tile 64 or 128, batch 8 or
128, 25 or 100 epochs, metrics v1 or v2) are the experiment grid. Here it
is one frozen dataclass with one preset per reference script, named after
the script, plus the two extensions; the CLI overrides any field.

``compute_dtype`` ('float32' or 'bfloat16', :func:`compute_dtype`) is
the dtype the train and eval steps and the module engine compute in
(``train/engine.py``, ``ops/layers.py``); ``remat`` rematerializes the
U-Net families' DoubleConvs (``models/registry.py::build_model``).
``mesh_data`` is the data axis (``parallel/mesh.py``): -1 every device,
as the JAX package's. ``train/engine.py::fit`` runs as one rank of a
process group of that size (-1 or the group's), and the CLI starts the
ranks (``train``) or serves over the devices (``eval``, ``predict``).
``mesh_spatial`` is the spatial axis: ``fit`` and the CLI's ``train``
shard the image H axis over that many ranks a data row (the U-Net
families; ``parallel/spatial.py``); ``eval`` and ``predict`` ignore it,
as the JAX CLI's do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's fields, with the same defaults."""

    # -- model --
    model: str = "unet"  # unet | unet-fast | deeplabv3 | fcn | pspnet
    attention: str = "none"  # none | channel | spatial
    num_classes: int = 2
    in_channels: int = 1
    backbone: str = "resnet50"  # for deeplabv3 / fcn / pspnet

    # -- data --
    voc_root: str = "data/VOCdevkit/VOC2012"
    image_size: int = 64
    ignore_index: int = 255
    # legacy: the reference's {0, 255} masks through ToTensor() and
    # .long() (only 255 becomes class 1); index: raw class ids
    mask_contract: str = "legacy"  # legacy | index
    normalize_mean: float = 0.5
    normalize_std: float = 0.5
    # the on-device D4 augment of the train step (the reference has none)
    augment: bool = False

    # -- training --
    batch_size: int = 8
    num_epochs: int = 25
    learning_rate: float = 1e-4
    seed: int = 0
    # drop the last partial train batch; by default it is zero-padded to
    # the batch size and the padded images enter BN's batch statistics
    drop_last: bool = False
    # recompute each U-Net DoubleConv in the backward pass
    # (torch.utils.checkpoint); the U-Net families only
    remat: bool = False
    log_every_steps: int = 100
    # 1: (acc, miou) of the reference's Unet.py; 2: {acc, miou, mpa, mf1}
    # of its Unet-ChannalAttention.py, OA quirk kept
    metrics_version: int = 2
    # batch_mean: per-batch metrics weighted by batch size (the
    # reference); global: one confusion matrix over the epoch
    metrics_mode: str = "batch_mean"  # batch_mean | global

    # -- checkpoint / history --
    model_save_path: str = "trained_models/model_best.ckpt"
    metrics_save_path: str = "training_metrics/history.json"

    # -- execution --
    compute_dtype: str = "float32"  # float32 | bfloat16
    mesh_data: int = -1  # -1 = all devices on the data axis
    mesh_spatial: int = 1  # ranks a data row sharding H (train)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype``."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; "
                         f"expected one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.compute_dtype]


def _p(model: str, attention: str, image_size: int, batch_size: int,
       num_epochs: int, stem: str, metrics_version: int = 2) -> Config:
    return Config(model=model, attention=attention, image_size=image_size,
                  batch_size=batch_size, num_epochs=num_epochs,
                  metrics_version=metrics_version,
                  model_save_path=f"trained_models/{stem}_best.ckpt",
                  metrics_save_path=f"training_metrics/{stem}.json")


# One preset per reference script (SURVEY.md §2.1), named after it: model,
# attention, tile size, batch, epochs, metrics version and save paths as
# the JAX package sets them. The reference's "PSPNet" scripts train
# FCN-ResNet50 (SURVEY.md §0); the last two are the extensions with no
# reference script (the fast cell, and the true PSPNet under the
# 'pspnet' protocol).
PRESETS: Dict[str, Config] = {
    "unet": _p("unet", "none", 64, 8, 25, "unet_64", metrics_version=1),
    "unet-channelattention": _p("unet", "channel", 128, 8, 25,
                                "unet_ca_128"),
    "unet-spatialattention": _p("unet", "spatial", 64, 128, 25,
                                "unet_sa_64"),
    "deeplabv3": _p("deeplabv3", "none", 64, 8, 25, "deeplabv3_64",
                    metrics_version=1),
    "deeplabv3-channelattention": _p("deeplabv3", "channel", 64, 128, 25,
                                     "deeplabv3_ca_64"),
    "deeplabv3-spatialattention": _p("deeplabv3", "spatial", 64, 128, 25,
                                     "deeplabv3_sa_64"),
    "pspnet": _p("fcn", "none", 64, 8, 25, "fcn_64"),
    "pspnet-channelattention": _p("fcn", "channel", 64, 128, 100,
                                  "fcn_se_64"),
    "pspnet-spatialattention": _p("fcn", "spatial", 64, 128, 100,
                                  "fcn_sa_64"),
    "unet-fast-ca": _p("unet-fast", "channel", 128, 8, 25, "unet_fast_ca"),
    "pspnet-true": _p("pspnet", "none", 64, 8, 25, "pspnet_true_64"),
}


def get_preset(name: str, **overrides) -> Config:
    key = name.lower().replace("_", "-")
    if key not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}")
    cfg = PRESETS[key]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
