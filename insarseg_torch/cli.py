"""Command-line entry points: train / eval / predict / export-torch
(counterpart of ``insarseg/cli.py``, with its commands, flags, messages
and exit codes).

``python -m insarseg_torch.cli train --preset unet-channelattention
--voc-root ...``; every ``config.Config`` field is a flag
(``--image-size 128``). Each command runs on ``--device`` (default
``cuda``) and never moves to the CPU on its own: without a card it exits
with the port's no-CUDA error unless ``--device cpu`` is given.

Weights: ``--torch-checkpoint`` loads a reference ``.pth`` state_dict
(``strict=True``: the port's module names are the reference's);
``--checkpoint`` reads the port's own checkpoint directory
(``train/checkpoint.py``, as ``train`` writes it); without either, the
weights are a fresh init drawn from ``--seed``. JAX Orbax directories
cross through the JAX package's ``export-torch`` and
``--torch-checkpoint``.

``predict --stream`` streams each scene band by band through
``data/serve.py::stream_scene_inference`` (the device stitch, argmax on
the device): ``.npy`` scenes open memory-mapped, so a strip larger than
host memory never loads whole.

``--compute-dtype bfloat16`` computes in bf16 as the JAX CLI's bf16
model does: ``train``, the module engine of ``eval`` and ``predict``
(with ``--stream`` too) run the graph in bf16 over f32 parameters; the
serve and int8 engines pack the f32 weights and run as they do without
it, as the JAX package's engines ignore the model's dtype.
``--remat true`` rematerializes the U-Net families' DoubleConvs in
``train``; the other families raise the JAX package's ``ValueError``.

Every card, as the JAX CLI uses every chip (``parallel/mesh.py``):
``train`` with ``--mesh-data N`` above 1, or -1 (the default) on a
machine with more than one card, runs one process a card under
``torch.distributed`` (``launch``, NCCL). At the presets' batches four
H100s train ``unet-channelattention`` x1.034-x1.175 as fast as one card
a step and ``pspnet-channelattention`` x0.414-x0.990 (PERF.md §5; every
rank reads the whole global batch); ``--mesh-data 1`` trains on one
card, the faster choice for the ResNet families. ``eval`` over
an engine, ``predict`` and ``predict --stream`` serve over a mesh of the
cards in one process (``eval``: the largest data axis that divides the batch,
``_eval_mesh``; ``predict``: all of them, the default tile batch 128 a
card). ``--mesh-data 1``, or ``--device cuda:K`` with the default -1,
pins one card; ``--device cuda:K --mesh-data N`` takes N cards from K
on. Under ``torchrun`` (or inside a process group its caller made)
``train`` runs as one rank, on ``LOCAL_RANK``'s card (or the caller's).
With ``--device cpu``, ``--mesh-data N`` gives N gloo ranks (``train``)
or N CPU replicas. The module engine's ``eval`` runs on one device, as
the JAX CLI's does. ``--mesh-data`` above the visible cards raises.

``train --mesh-spatial S`` shards the image H axis over S ranks (every
family; ``parallel/spatial.py``): ``--mesh-data D`` rows of S ranks, D x
S in all (``--mesh-data -1``: every card, D = cards / S; on the CPU, D =
1), ``--device cpu`` giving gloo ranks and ``--device cuda:K`` cards K
onward; ``H / S`` must be a multiple of 16 for the U-Nets (32 for
``unet-fast``) and of 8 for the ResNet families. ``eval`` and
``predict`` ignore ``--mesh-spatial``, as the JAX CLI's do.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

def _add_config_overrides(p: argparse.ArgumentParser) -> None:
    from insarseg_torch.config import Config

    for f in dataclasses.fields(Config):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true",
                                                              "yes"),
                           default=None)
        else:
            p.add_argument(flag, type=type(f.default), default=None)


def _build_cfg(args):
    from insarseg_torch.config import Config, compute_dtype, get_preset

    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    cfg = (get_preset(args.preset, **overrides) if args.preset
           else Config(**overrides))
    compute_dtype(cfg)  # an unknown dtype ends the command here
    return cfg


def _mesh_devices(cfg, dev: torch.device,
                  spatial: int = 1) -> List[torch.device]:
    """The devices a command may use, ``spatial`` a data row (``train``:
    ``--mesh-spatial``; ``eval`` and ``predict``: 1): ``--mesh-data`` N rows
    of cards from ``dev``'s on (``--device cuda``: from the first; -1:
    every visible card, or one row when ``--device`` names one); ``dev``
    alone for one device; on the CPU, N rows of replicas of it (one row
    for -1). More than the cards there are raises."""
    from insarseg_torch.parallel.mesh import make_mesh

    data = cfg.mesh_data
    if dev.type == "cpu":
        return [dev] * (max(data, 1) * spatial)
    if data == -1 and dev.index is not None:
        data = 1
    if data * spatial == 1:
        return [dev]
    cards = [torch.device("cuda", i)
             for i in range(dev.index or 0, torch.cuda.device_count())]
    return list(make_mesh(data, spatial, devices=cards).devices)


def _eval_mesh(cfg, devices):
    """The serving mesh of an engine-scored ``eval`` over ``devices``:
    the largest data axis that divides the loader's batch (the JAX CLI's
    ``_eval_mesh``), or None for one device."""
    from insarseg_torch.parallel.mesh import make_mesh

    data = max(d for d in range(1, len(devices) + 1)
               if cfg.batch_size % d == 0)
    return make_mesh(data, devices=devices) if data > 1 else None


def _serving_mesh(cfg, dev: torch.device):
    """The mesh of ``predict``: every device the command may use (uneven
    shards are fine), or None for one."""
    from insarseg_torch.parallel.mesh import make_mesh

    devices = _mesh_devices(cfg, dev)
    return make_mesh(devices=devices) if len(devices) > 1 else None


def _device(args) -> torch.device:
    """``--device``, checked before any work: without a card a CUDA
    device ends the command with the port's error."""
    from insarseg_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None


def _dataset_cls(args):
    if args.native:
        from insarseg_torch.data.native_loader import NativeVOCSegDataset

        return NativeVOCSegDataset
    from insarseg_torch.data.voc import VOCSegDataset

    return VOCSegDataset


def _dataset(args, cfg, split: str):
    return _dataset_cls(args)(
        cfg.voc_root, cfg.image_size, split,
        mask_contract=cfg.mask_contract, normalize_mean=cfg.normalize_mean,
        normalize_std=cfg.normalize_std, ignore_index=cfg.ignore_index,
        raw_u8=args.raw_u8)


def _prefetched(args, loader):
    if not args.native:
        return loader
    from insarseg_torch.data.native_loader import PrefetchLoader

    return PrefetchLoader(loader)


def cmd_train(args) -> int:
    from insarseg_torch.parallel.mesh import env_rank, grouped, joined

    dev = _device(args)
    cfg = _build_cfg(args)
    if not os.path.isdir(os.path.join(cfg.voc_root, "JPEGImages")):
        print(f"error: dataset not found under {cfg.voc_root!r} "
              "(expected VOC layout with JPEGImages/)", file=sys.stderr)
        return 2
    if cfg.mesh_spatial > 1:
        from insarseg_torch.models.registry import check_spatial

        check_spatial(cfg.model)
    if grouped() or env_rank():
        # a rank that torchrun (or the caller's group) started
        with joined(dev) as rank_dev:
            return _train(args, cfg, rank_dev)
    devices = _mesh_devices(cfg, dev, cfg.mesh_spatial)
    if len(devices) > 1:
        from insarseg_torch.parallel.mesh import launch

        launch(_train_rank, len(devices), devices, args=(args, devices))
        return 0
    return _train(args, cfg, dev)


def _train_rank(args, devices: List[torch.device]) -> None:
    """``train`` as rank r of a ('data', 'spatial') mesh over ``devices``,
    on ``devices[r]`` (``parallel/mesh.py::launch`` starts one a device;
    ``fit`` is SPMD)."""
    from insarseg_torch.parallel.mesh import rank

    _train(args, _build_cfg(args), devices[rank()])


def _train(args, cfg, dev: torch.device) -> int:
    from insarseg_torch.data.voc import BatchLoader
    from insarseg_torch.models.registry import build_model
    from insarseg_torch.parallel.mesh import rank
    from insarseg_torch.train import engine
    from insarseg_torch.train.checkpoint import Checkpointer
    from insarseg_torch.utils.history import load_history, save_history

    lead = rank() == 0
    train_loader = _prefetched(args, BatchLoader(
        _dataset(args, cfg, "train"), cfg.batch_size, shuffle=True,
        seed=cfg.seed, ignore_index=cfg.ignore_index,
        drop_last=cfg.drop_last, num_workers=args.num_workers))
    val_loader = _prefetched(args, BatchLoader(
        _dataset(args, cfg, "val"), cfg.batch_size,
        ignore_index=cfg.ignore_index, num_workers=args.num_workers))
    model = build_model(cfg)
    # one checkpoint directory per preset (model_save_path minus its
    # extension), so presets never overwrite or resume each other's state;
    # eval / predict --checkpoint take this directory
    ckpt_dir = os.path.splitext(cfg.model_save_path)[0] or "."
    ckpt = Checkpointer(ckpt_dir)
    if lead:
        print(f"checkpoints -> {ckpt_dir}/{{best,latest}}")
    if lead and args.resume and not ckpt.has_latest():
        print(f"warning: --resume found no latest checkpoint under "
              f"{ckpt_dir!r}; training starts from step 0.", file=sys.stderr)
    anomaly = torch.is_anomaly_enabled()
    if args.debug_nans:
        from insarseg_torch.utils.profiling import enable_nan_debugging

        enable_nan_debugging(True)
    try:
        state = engine.create_state(model, cfg.learning_rate, seed=cfg.seed,
                                    device=dev)
        history = engine.fit(model, cfg, train_loader, val_loader,
                             state=state, checkpointer=ckpt,
                             resume=args.resume, device=dev)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
    if not lead:
        return 0
    if args.resume and os.path.exists(cfg.metrics_save_path):
        # keep the interrupted run's epochs, replace the ones the resumed
        # run trained again, append the new ones
        redone = {h["epoch"] for h in history}
        history = [h for h in load_history(cfg.metrics_save_path)
                   if h["epoch"] not in redone] + history
        history.sort(key=lambda h: h["epoch"])
    save_history(history, cfg.metrics_save_path)
    print(f"history saved to {cfg.metrics_save_path}")
    return 0


def _resolve_calib_flags(args) -> bool:
    """Fill in the calibration flags' defaults (4 batches, absmax); True
    when either was given explicitly (an artifact then ignores them)."""
    explicit = (getattr(args, "calib_batches", None) is not None
                or getattr(args, "calib_stat", None) is not None)
    if getattr(args, "calib_batches", None) is None:
        args.calib_batches = 4
    if getattr(args, "calib_stat", None) is None:
        args.calib_stat = "absmax"
    return explicit


def _check_artifact_vs_cfg(art, cfg, args, explicit_calib: bool) -> None:
    """--engine-artifact serves a prebuilt engine: the CLI config must
    agree with what the artifact was packed from, or the metrics come out
    silently wrong."""
    mismatches = []
    if art.get("model") != cfg.model:
        mismatches.append(f"model: artifact={art.get('model')!r} "
                          f"config={cfg.model!r}")
    if art.get("attention") != cfg.attention:
        mismatches.append(f"attention: artifact={art.get('attention')!r} "
                          f"config={cfg.attention!r}")
    art_nc = (art.get("meta") or {}).get("num_classes")
    if art_nc is not None and int(art_nc) != cfg.num_classes:
        mismatches.append(f"num_classes: artifact={art_nc} "
                          f"config={cfg.num_classes}")
    if mismatches:
        raise SystemExit(
            "--engine-artifact does not match the CLI config ("
            + "; ".join(mismatches)
            + "); pass the preset the artifact was packed from")
    engine_name = getattr(args, "engine", "module") or "module"
    if engine_name != "module" and engine_name != art.get("engine"):
        raise SystemExit(
            f"--engine {engine_name} conflicts with --engine-artifact "
            f"(the artifact is a packed {art.get('engine')!r} engine); "
            "drop --engine when serving an artifact")
    if explicit_calib and art.get("engine") == "int8":
        print("warning: --calib-batches/--calib-stat are ignored with "
              "--engine-artifact (the int8 scales were calibrated at pack "
              "time and are baked into the artifact)", file=sys.stderr)


def _artifact_engine(args, cfg, explicit_calib: bool, dev: torch.device,
                     mesh=None):
    from insarseg_torch.engines import engine_from_artifact
    from insarseg_torch.engines_io import load_artifact

    art = load_artifact(args.engine_artifact)
    _check_artifact_vs_cfg(art, cfg, args, explicit_calib)
    return engine_from_artifact(art, device=dev, mesh=mesh)


# the families whose --torch-checkpoint import grafts an RGB stem (the
# JAX package's ``_resnet_backbone``)
RESNET_MODELS = ("deeplabv3", "fcn", "pspnet")


def _load_weights(args, cfg, model: torch.nn.Module) -> None:
    """Fill ``model`` (on the CPU) from --torch-checkpoint, --checkpoint
    or, without either, a fresh init drawn from ``cfg.seed``. A
    --torch-checkpoint of a ResNet family with an RGB stem (a pretrained
    torchvision file) has its ``backbone.conv1`` averaged to one channel
    first, as the JAX package's import does; a U-Net file is not
    grafted."""
    if getattr(args, "torch_checkpoint", None):
        from insarseg_torch.compat import (
            graft_grayscale_stem,
            load_torch_state_dict,
            state_dict_to_torch,
        )

        sd = load_torch_state_dict(args.torch_checkpoint)
        stem = sd.get("backbone.conv1.weight")
        if cfg.model in RESNET_MODELS and stem is not None \
                and stem.shape[1] == 3:
            sd["backbone.conv1.weight"] = graft_grayscale_stem(stem)
        model.load_state_dict(state_dict_to_torch(sd), strict=True)
    elif getattr(args, "checkpoint", None):
        from insarseg_torch.train.checkpoint import Checkpointer

        Checkpointer(args.checkpoint).restore_best(model)
    else:
        from insarseg_torch.train.engine import init_weights

        init_weights(model, cfg.seed)


def _build_engine_maybe_save(args, cfg, model, engine_name: str, calib,
                             dev: torch.device, mesh=None):
    """The save-engine flow shared by eval and predict: pack (and save the
    artifact when --save-engine is set) or build the live engine (the
    module engine in ``cfg.compute_dtype``), on ``dev`` or over ``mesh``
    (``dev`` its first device, which packs and calibrates)."""
    from insarseg_torch.config import compute_dtype
    from insarseg_torch.engines import make_engine

    if getattr(args, "save_engine", None):
        from insarseg_torch.engines import engine_from_artifact, pack_engine
        from insarseg_torch.engines_io import save_artifact

        art = pack_engine(cfg.model, cfg.attention, model, None, engine_name,
                          calib_batches=calib, calib_stat=args.calib_stat,
                          device=dev)
        print(f"engine artifact written to "
              f"{save_artifact(args.save_engine, art)}")
        return engine_from_artifact(art, device=dev, mesh=mesh)
    return make_engine(cfg.model, cfg.attention, model, None, engine_name,
                       calib_batches=calib, calib_stat=args.calib_stat,
                       device=dev, mesh=mesh,
                       input_dtype=(compute_dtype(cfg)
                                    if engine_name == "module" else None))


def _check_supported(cfg, engine_name: str, hint: str = "") -> None:
    from insarseg_torch.engines import supported

    if not supported(cfg.model, cfg.attention, engine_name):
        raise SystemExit(f"--engine {engine_name} does not support "
                         f"({cfg.model}, {cfg.attention}){hint}")


SAVE_MODULE = ("--save-engine needs a packed engine: pass --engine serve or "
               "--engine int8 (the module engine is the live nn.Module graph "
               "and has no artifact form)")


def cmd_eval(args) -> int:
    from insarseg_torch.config import compute_dtype
    from insarseg_torch.data.voc import BatchLoader
    from insarseg_torch.models.registry import build_model
    from insarseg_torch.train import engine

    dev = _device(args)
    cfg = _build_cfg(args)
    model = build_model(cfg)
    loader = _prefetched(args, BatchLoader(
        _dataset(args, cfg, args.split), cfg.batch_size,
        ignore_index=cfg.ignore_index, num_workers=args.num_workers))
    norm = (cfg.normalize_mean, cfg.normalize_std)
    explicit_calib = _resolve_calib_flags(args)
    engine_name = getattr(args, "engine", "module") or "module"
    # an engine scores over every device the batch divides among; its
    # outputs gather on the first
    mesh = _eval_mesh(cfg, _mesh_devices(cfg, dev))
    if mesh is not None:
        dev = mesh.devices[0]
    if getattr(args, "engine_artifact", None):
        # a prebuilt engine: no checkpoint, no calibration
        predict = _artifact_engine(args, cfg, explicit_calib, dev, mesh)
        eval_step = engine.make_engine_eval_step(
            predict, cfg.num_classes, cfg.ignore_index, normalize=norm,
            device=dev)
    elif engine_name != "module":
        _load_weights(args, cfg, model)
        _check_supported(cfg, engine_name, "; use --engine module")
        calib = None
        if engine_name == "int8":
            # calibrate on the first N batches of real data; the default
            # source is the scored split (a calibration-QA bound),
            # --calib-split train keeps calibration off the scored split
            from insarseg_torch.engines import collect_calib_batches

            calib_split = getattr(args, "calib_split", None)
            calib_loader = loader
            if calib_split and calib_split != args.split:
                calib_loader = BatchLoader(
                    _dataset(args, cfg, calib_split), cfg.batch_size,
                    ignore_index=cfg.ignore_index,
                    num_workers=args.num_workers)
            calib = collect_calib_batches(calib_loader, args.calib_batches,
                                          *norm)
        predict = _build_engine_maybe_save(args, cfg, model, engine_name,
                                           calib, dev, mesh)
        eval_step = engine.make_engine_eval_step(
            predict, cfg.num_classes, cfg.ignore_index, normalize=norm,
            device=dev)
    else:
        if getattr(args, "save_engine", None):
            raise SystemExit(SAVE_MODULE)
        _load_weights(args, cfg, model)
        eval_step = engine.make_eval_step(model.to(dev), cfg.num_classes,
                                          cfg.ignore_index, normalize=norm,
                                          compute_dtype=compute_dtype(cfg))
    res = engine.evaluate(eval_step, loader, cfg.metrics_version,
                          cfg.metrics_mode)
    print(res)
    return 0


def read_scene(path: str) -> np.ndarray:
    """A scene file as (H, W) uint8 grayscale."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.uint8)


def write_prediction(path: str, pred: np.ndarray, num_classes: int) -> None:
    """An (H, W) class map as a grayscale PNG, the classes spread over the
    gray range without uint8 wraparound (class k -> k * (255 // (nc -
    1)))."""
    from PIL import Image

    gray_step = max(255 // max(num_classes - 1, 1), 1)
    Image.fromarray(pred.astype(np.uint8) * np.uint8(gray_step),
                    "L").save(path)


def normalize_scene(u8: np.ndarray, cfg) -> np.ndarray:
    """(H, W) uint8 -> the (H, W, 1) f32 model input."""
    x = np.asarray(u8, np.float32) / 255.0
    return ((x - cfg.normalize_mean) / cfg.normalize_std)[..., None]


def cmd_predict(args) -> int:
    """Full-scene sliding-window inference on grayscale scene files, one
    ``*_pred.png`` each. Same-shaped scenes share one tile plan and stream
    through batched forward chunks
    (``data/stitch.py::sliding_window_inference_batched``)."""
    from insarseg_torch.models.registry import build_model

    dev = _device(args)
    cfg = _build_cfg(args)
    explicit_calib = _resolve_calib_flags(args)
    # every device the command may use serves a share of each tile batch
    mesh = _serving_mesh(cfg, dev)
    if mesh is not None:
        dev = mesh.devices[0]
    if getattr(args, "stream", False):
        return predict_stream(args, cfg, explicit_calib, dev, mesh)
    model = build_model(cfg)
    scenes = [normalize_scene(read_scene(p), cfg) for p in args.input]
    engine_name = getattr(args, "engine", "module") or "module"
    _check_supported(cfg, engine_name)
    if getattr(args, "engine_artifact", None):
        eng = _artifact_engine(args, cfg, explicit_calib, dev, mesh)
    else:
        _load_weights(args, cfg, model)
        if getattr(args, "save_engine", None) and engine_name == "module":
            raise SystemExit(SAVE_MODULE)
        # int8 calibrates on tiles of the first scene (the scenes of one
        # call are taken to be alike; calibrate offline with eval
        # --save-engine when they are not)
        calib = (scene_calib(scenes[0], args.tile, args.overlap,
                             args.calib_batches)
                 if engine_name == "int8" else None)
        eng = _build_engine_maybe_save(args, cfg, model, engine_name, calib,
                                       dev, mesh)
    preds = predict_scenes(eng, scenes, args.tile, args.overlap,
                           args.tile_batch, dev, mesh.size if mesh else 1)
    if args.output and len(args.input) > 1:
        os.makedirs(args.output, exist_ok=True)
    out_paths = _output_paths(args)
    for path, pred in zip(args.input, preds):
        out = out_paths[path]
        write_prediction(out, pred, cfg.num_classes)
        print(f"prediction written to {out}")
    return 0


def _calib_groups(h: int, w: int, tile: int, overlap: int,
                  calib_batches: int) -> List[List[tuple]]:
    """The tile origins of the int8 calibration batches of an (h, w)
    scene: groups of 4 spread over the whole plan (not just the top-left
    corner), ``calib_batches`` groups at most; the groups stay 4 tiles (no
    ragged last group). The JAX package's tiles, in its order."""
    from insarseg_torch.data.stitch import plan_tiles

    pos = plan_tiles(max(h, tile), max(w, tile), tile, overlap)
    n = min(len(pos), 4 * max(calib_batches, 1))
    if n > 4:
        n -= n % 4
    stride = max(len(pos) // n, 1)
    pos = pos[::stride][:n]
    group = min(4, len(pos))
    return [pos[i:i + group] for i in range(0, len(pos) - group + 1, group)]


def scene_calib(scene: np.ndarray, tile: int, overlap: int,
                calib_batches: int) -> List[np.ndarray]:
    """int8 calibration batches from one normalized (H, W, 1) scene
    (:func:`_calib_groups`' tiles)."""
    h, w = scene.shape[:2]
    padded = np.pad(scene, ((0, max(0, tile - h)), (0, max(0, tile - w)),
                            (0, 0)))
    return [np.stack([padded[r:r + tile, c:c + tile] for r, c in g])
            for g in _calib_groups(h, w, tile, overlap, calib_batches)]


def stream_calib(scene: np.ndarray, tile: int, overlap: int,
                 calib_batches: int, cfg) -> List[np.ndarray]:
    """:func:`scene_calib` of a ``--stream`` scene, an (H, W) uint8 or
    pre-normalized f32 array (a memory map), reading only the calibration
    tiles; uint8 tiles are normalized on the host (``normalize_scene``)."""
    def one(t):
        if t.dtype == np.uint8:
            return normalize_scene(t, cfg)
        return np.asarray(t, np.float32)[..., None]

    h, w = scene.shape
    return [np.stack([one(scene[r:r + tile, c:c + tile]) for r, c in g])
            for g in _calib_groups(h, w, tile, overlap, calib_batches)]


def open_stream_scene(path: str) -> np.ndarray:
    """A ``--stream`` scene: a ``.npy`` file memory-mapped (a trailing
    channel of 1 dropped), which must be 2D uint8 or pre-normalized f32, or
    an image file read as (H, W) uint8 grayscale."""
    if not path.endswith(".npy"):
        return read_scene(path)
    arr = np.load(path, mmap_mode="r")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim != 2 or arr.dtype not in (np.uint8, np.float32):
        raise SystemExit(
            f"--stream .npy scene must be 2D uint8 or f32 "
            f"(pre-normalized), got {arr.shape} {arr.dtype}: {path}")
    return arr


def predict_stream(args, cfg, explicit_calib: bool,
                   dev: torch.device, mesh=None) -> int:
    """``predict --stream``: each scene streams band by band through
    ``data/serve.py::stream_scene_inference`` on ``dev``, its class rows
    argmaxed on the device and written into an (H, W) uint8 prediction;
    with a ``mesh`` (``dev`` its first device) each engine call is split
    over it, 128 tiles a device by default.
    Memory on the device is one call of tiles and one band's accumulator,
    never the (H, W, C) f32 logits of the in-memory path; uint8 scenes are
    normalized on the device. int8 calibrates on tiles of the first scene,
    read alone."""
    from insarseg_torch.data.serve import stream_scene_inference
    from insarseg_torch.models.registry import build_model

    engine_name = getattr(args, "engine", "module") or "module"
    _check_supported(cfg, engine_name)
    scenes = {p: open_stream_scene(p) for p in args.input}
    for p, arr in scenes.items():
        if min(arr.shape) < args.tile:
            raise SystemExit(
                f"--stream needs scenes >= tile ({args.tile}); {p} is "
                f"{arr.shape} — drop --stream or lower --tile")
    norm = (cfg.normalize_mean, cfg.normalize_std)
    if getattr(args, "engine_artifact", None):
        eng = _artifact_engine(args, cfg, explicit_calib, dev, mesh)
    else:
        model = build_model(cfg)
        _load_weights(args, cfg, model)
        if getattr(args, "save_engine", None) and engine_name == "module":
            raise SystemExit(SAVE_MODULE)
        calib = (stream_calib(next(iter(scenes.values())), args.tile,
                              args.overlap, args.calib_batches, cfg)
                 if engine_name == "int8" else None)
        eng = _build_engine_maybe_save(args, cfg, model, engine_name, calib,
                                       dev, mesh)
    if args.output and len(args.input) > 1:
        os.makedirs(args.output, exist_ok=True)
    out_paths = _output_paths(args)
    tile_batch = args.tile_batch or 128 * (mesh.size if mesh else 1)
    for path, arr in scenes.items():
        h, w = arr.shape
        pred = np.empty((h, w), np.uint8)
        stream_scene_inference(
            eng, arr, (h, w), cfg.num_classes, tile=args.tile,
            overlap=args.overlap, batch_size=tile_batch,
            normalize=norm if arr.dtype == np.uint8 else None, writer=pred,
            emit="argmax", device=dev)
        write_prediction(out_paths[path], pred, cfg.num_classes)
        print(f"prediction written to {out_paths[path]}")
    return 0


def predict_scenes(eng, scenes: List[np.ndarray], tile: int, overlap: int,
                   tile_batch: Optional[int], dev: torch.device,
                   n_devices: int = 1) -> List[np.ndarray]:
    """The (H, W) uint8 class map of each (H, W, 1) scene, in order. Scenes
    of one shape share one tile plan and, two or more, run through the
    batched multi-scene stitch; the logits are stitched in f32 whatever
    the engine returns, then argmaxed. ``eng`` may serve over a mesh of
    ``n_devices`` (its outputs on ``dev``)."""
    from insarseg_torch.data.stitch import (
        plan_tiles,
        sliding_window_inference,
        sliding_window_inference_batched,
    )

    def f32(x):
        return eng(x).to(torch.float32)

    groups: Dict[tuple, List[int]] = {}
    for i, sc in enumerate(scenes):
        groups.setdefault(sc.shape, []).append(i)
    preds: List[Optional[np.ndarray]] = [None] * len(scenes)
    for shape, idxs in groups.items():
        h, w = shape[:2]
        n_tiles = len(plan_tiles(max(h, tile), max(w, tile), tile, overlap))
        # the forward chunk: --tile-batch, else all tiles up to 128 a
        # device (a bound on a chunk's memory; the JAX CLI's default)
        bs = tile_batch or min(n_tiles * len(idxs), 128 * n_devices)
        with torch.inference_mode():
            if len(idxs) == 1:
                logits = sliding_window_inference(
                    f32, scenes[idxs[0]], tile=tile, overlap=overlap,
                    batch_size=bs, device=dev)[None]
            else:
                logits = sliding_window_inference_batched(
                    f32, np.stack([scenes[i] for i in idxs]), tile=tile,
                    overlap=overlap, batch_size=bs, device=dev)
            classes = logits.argmax(-1).to(torch.uint8).cpu().numpy()
        for i, pred in zip(idxs, classes):
            preds[i] = pred
    return preds


def _output_paths(args) -> Dict[str, str]:
    """The output path of each --input scene. Two scenes with one file name
    from different directories must not overwrite each other in --output:
    later ones get a numeric suffix."""
    out_names: Dict[str, str] = {}
    taken = set()
    for p in args.input:
        base = os.path.splitext(os.path.basename(p))[0] + "_pred.png"
        name, k = base, 1
        while name in taken:
            k += 1
            name = base[: -len(".png")] + f"_{k}.png"
        taken.add(name)
        out_names[p] = name

    def _one(path: str) -> str:
        if not args.output:
            return os.path.splitext(path)[0] + "_pred.png"
        if len(args.input) == 1:
            return args.output
        return os.path.join(args.output, out_names[path])

    return {p: _one(p) for p in args.input}


def cmd_export_torch(args) -> int:
    """Export a checkpoint (or a fresh init) as a reference-compatible
    ``.pth`` state_dict, the inverse of --torch-checkpoint: the
    reference's U-Net names, torchvision's for DeepLabV3 / FCN."""
    from insarseg_torch.models.registry import build_model

    _device(args)
    cfg = _build_cfg(args)
    if cfg.model not in ("unet", "deeplabv3", "fcn"):
        print(f"error: export-torch has no reference naming for "
              f"{cfg.model!r} (the true-PSPNet extension has no torch twin)",
              file=sys.stderr)
        return 2
    model = build_model(cfg)
    _load_weights(args, cfg, model)
    tensors = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    torch.save(tensors, args.output)
    print(f"exported {len(tensors)} tensors to {args.output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="insarseg_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    for name, fn in (("train", cmd_train), ("eval", cmd_eval),
                     ("predict", cmd_predict),
                     ("export-torch", cmd_export_torch)):
        p = sub.add_parser(name)
        p.add_argument("--preset", default=None)
        p.add_argument("--device", default="cuda",
                       help="torch device the command runs on (default "
                            "cuda; 'cpu' runs the plain PyTorch path)")
        p.add_argument("--num-workers", type=int, default=0)
        p.add_argument("--native", action="store_true",
                       help="C++ preprocessing kernels + prefetch thread")
        p.add_argument("--debug-nans", action="store_true",
                       help="raise at the backward operation that makes a "
                            "NaN (autograd anomaly mode)")
        p.add_argument("--raw-u8", action="store_true",
                       help="ship uint8 tiles to the device and normalize "
                            "there (4x less host->device transfer)")
        p.add_argument("--resume", action="store_true",
                       help="restore the latest state (weights, optimizer, "
                            "step) from the checkpoint dir and continue the "
                            "epoch count")
        p.add_argument("--checkpoint", default=None,
                       help="checkpoint directory written by train")
        p.add_argument("--torch-checkpoint", default=None,
                       help="reference .pth state_dict to import")
        _add_config_overrides(p)
        if name == "eval":
            p.add_argument("--split", default="val")
            p.add_argument("--engine", default="module",
                           choices=["module", "serve", "int8"],
                           help="score a serving engine instead of the "
                                "module graph; int8 calibrates on the "
                                "first --calib-batches batches")
            p.add_argument("--calib-split", default=None,
                           choices=["train", "val"],
                           help="int8 engine: the split the calibration "
                                "batches come from (default: the scored "
                                "--split; 'train' keeps calibration off "
                                "the scored split)")
        if name in ("eval", "predict"):
            # None defaults let the artifact path tell an explicit flag
            # apart (they resolve to 4 / 'absmax')
            p.add_argument("--calib-batches", type=int, default=None,
                           help="int8 engine: number of batches to "
                                "calibrate activation scales on (default 4)")
            p.add_argument("--calib-stat", default=None,
                           help="int8 activation-scale statistic: 'absmax' "
                                "(default) or a percentile like 'p99.9'")
            p.add_argument("--save-engine", default=None,
                           help="after packing (and int8 calibration), save "
                                "the serving-engine artifact to this .npz")
            p.add_argument("--engine-artifact", default=None,
                           help="serve a prebuilt engine artifact (either "
                                "package's) instead of packing from a "
                                "checkpoint")
        if name == "predict":
            p.add_argument("--input", required=True, nargs="+",
                           help="grayscale scene image(s); same-sized "
                                "scenes share one tile plan and stream "
                                "through batched forward chunks")
            p.add_argument("--output", default=None,
                           help="output path (single input) or directory "
                                "(multiple inputs); default: "
                                "<input>_pred.png beside each scene")
            p.add_argument("--tile", type=int, default=512)
            p.add_argument("--overlap", type=int, default=64)
            p.add_argument("--tile-batch", type=int, default=None)
            p.add_argument("--stream", action="store_true",
                           help="bounded-memory streaming inference for "
                                "scenes larger than memory (.npy scenes "
                                "open memory-mapped; the prediction is "
                                "argmaxed on the device)")
            p.add_argument("--engine", default="module",
                           choices=["module", "serve", "int8"],
                           help="inference engine: 'module' (the nn.Module "
                                "graph), 'serve' (BN-folded exact graph), "
                                "'int8' (PTQ, calibrated on the first "
                                "scene)")
        if name == "export-torch":
            p.add_argument("--output", required=True)
        p.set_defaults(fn=fn)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
