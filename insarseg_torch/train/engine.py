"""Training and evaluation on one device (counterpart of
``insarseg/train/engine.py``).

The reference's loop (Adam 1e-4, cross-entropy with ignore 255, per-step
metrics, a validation pass each epoch, the best weights by validation
mIoU) with the JAX package's additions: the u8 normalize and the optional
D4 augment run on the device inside the step, the confusion counts stay on
the device until an epoch ends (a step never synchronises the stream),
and the latest state with its optimizer is saved each epoch for resume.

The steps compute in ``compute_dtype`` (``fit``: ``cfg.compute_dtype``),
the dtype the image is cast to before the model, which every layer then
follows (``ops/layers.py``): in bf16 the convs and matmuls run in bf16
while the parameters, their gradients, Adam's state and the BN running
statistics stay f32, and the loss is f32. In f32, TF32 stays off for the
convolutions and matmuls. Multi-GPU training (``mesh_data`` /
``mesh_spatial`` above 1) is ROADMAP Queue 1 item 16; ``fit`` raises for
it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from insarseg_torch.config import compute_dtype as cfg_dtype
from insarseg_torch.data.augment import normalize_u8, random_dihedral
from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.ops.layers import nhwc_to_nchw
from insarseg_torch.train import metrics as M
from insarseg_torch.train.losses import cross_entropy_loss

MESH_TODO = ("insarseg_torch trains on one device; multi-GPU training "
             "(mesh_data / mesh_spatial > 1) is ROADMAP Queue 1 item 16")


@dataclasses.dataclass
class TrainState:
    """The module (its parameters and BN statistics), its Adam optimizer
    and the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter anew from the CPU generator seeded with
    ``seed``, so a seed gives the same weights on any device; the caller's
    RNG state is kept. BN statistics are reset. The distributions are the
    JAX package's: each module's own initializer (the ResNet backbones'
    convs kaiming-normal with fan_out, ``models/resnet.py::KaimingConv2d``;
    the rest torch's, the reference's)."""
    dev = next(model.parameters()).device
    model.to("cpu")
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        for m in model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
    return model.to(dev)


def create_state(model: nn.Module, learning_rate: float = 1e-4,
                 seed: Optional[int] = None,
                 device: DeviceLike = None) -> TrainState:
    """Move ``model`` to ``device`` (``None`` means ``cuda``) and give it
    Adam with torch's defaults, b1 0.9, b2 0.999, eps 1e-8 (the reference's
    ``optim.Adam``). With ``seed`` the weights are drawn anew first
    (:func:`init_weights`)."""
    dev = resolve_device(device)
    if seed is not None:
        init_weights(model, seed)
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt)


@contextlib.contextmanager
def _f32():
    """TF32 off for cuDNN convolutions and matmuls inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _to_float(image: torch.Tensor, normalize: Optional[Tuple[float, float]]
              ) -> torch.Tensor:
    """uint8 -> normalized f32 on the device; ``normalize=None`` scales to
    [0, 1] only. Other dtypes pass through."""
    if image.dtype != torch.uint8:
        return image
    if normalize is None:
        return image.to(torch.float32) / 255.0
    return normalize_u8(image, *normalize)


def _cast(image: torch.Tensor, dtype: Optional[torch.dtype]
          ) -> torch.Tensor:
    return image if dtype is None else image.to(dtype)


def step_seeds(seed: int, step: int) -> Tuple[int, int]:
    """(augment seed, dropout seed) of step ``step`` of a run with base
    ``seed``: a resumed run redraws the stream the first run drew."""
    a, d = np.random.SeedSequence([seed, step]).generate_state(2)
    return int(a), int(d)


def _default_generator(dev: torch.device) -> torch.Generator:
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def _scores(logits: torch.Tensor, mask: torch.Tensor, num_classes: int,
            ignore_index: int, loss: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    if loss is None:
        loss = cross_entropy_loss(logits, mask, ignore_index)
    return {"loss": loss.detach(),
            **M.confusion_counts(logits.detach(), mask, num_classes,
                                 ignore_index)}


def make_train_step(model: nn.Module, num_classes: int,
                    ignore_index: int = 255, augment: bool = False,
                    normalize: Optional[Tuple[float, float]] = (0.5, 0.5),
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Callable:
    """``step(state, image, mask, seed=0) -> {loss, tp, fp, fn, correct,
    valid}``: one Adam step of ``model`` (``state.model``) on an NHWC batch
    (uint8 images are normalized on the device), in train mode (BN batch
    statistics, running statistics updated, dropout live), then the
    confusion counts of that forward. The image enters the model in
    ``compute_dtype`` (``None``: the float dtype it comes in, f32 for
    uint8). ``seed`` is the run's base seed: the
    augment's D4 flags and dropout are drawn from generators seeded with
    ``step_seeds(seed, state.step)``. Returns device tensors and never
    synchronises the stream."""

    def step(state: TrainState, image, mask, seed: int = 0):
        dev = next(model.parameters()).device
        image = _to_float(torch.as_tensor(image, device=dev), normalize)
        mask = torch.as_tensor(mask, device=dev)
        aug_seed, drop_seed = step_seeds(seed, state.step)
        if augment:
            g = torch.Generator(device=dev)
            g.manual_seed(aug_seed)
            image, mask = random_dihedral(image, mask, generator=g)
        model.train()
        with _f32(), torch.random.fork_rng(
                devices=[dev] if dev.type == "cuda" else []):
            _default_generator(dev).manual_seed(drop_seed)
            logits = model(nhwc_to_nchw(_cast(image, compute_dtype))) \
                .permute(0, 2, 3, 1)
            loss = cross_entropy_loss(logits, mask, ignore_index)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            return _scores(logits, mask, num_classes, ignore_index, loss)

    return step


def make_eval_step(model: nn.Module, num_classes: int,
                   ignore_index: int = 255,
                   normalize: Optional[Tuple[float, float]] = (0.5, 0.5),
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> Callable:
    """``step(image, mask) -> {loss, counts}`` of ``model`` in eval mode
    (BN running statistics, no dropout), on the model's device, the image
    entering the model in ``compute_dtype`` (as in
    :func:`make_train_step`)."""

    @torch.no_grad()
    def step(image, mask):
        dev = next(model.parameters()).device
        image = _to_float(torch.as_tensor(image, device=dev), normalize)
        mask = torch.as_tensor(mask, device=dev)
        model.eval()
        with _f32():
            logits = model(nhwc_to_nchw(_cast(image, compute_dtype))) \
                .permute(0, 2, 3, 1)
        return _scores(logits, mask, num_classes, ignore_index)

    return step


def make_engine_eval_step(predict: Callable, num_classes: int,
                          ignore_index: int = 255,
                          normalize: Optional[Tuple[float, float]] = (0.5,
                                                                      0.5),
                          device: DeviceLike = None) -> Callable:
    """The eval step over a serving engine's ``predict(images) -> logits``
    (``insarseg_torch.engines``) in place of the module, with the same
    loss and counts, so ``evaluate`` scores the serve and int8 engines
    (``device``: the engine's, ``None`` means ``cuda``)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(image, mask):
        image = _to_float(torch.as_tensor(image, device=dev), normalize)
        logits = predict(image).to(torch.float32)
        return _scores(logits, torch.as_tensor(mask, device=dev),
                       num_classes, ignore_index)

    return step


class _Averager:
    """The epoch's metrics from the steps' device tensors, reduced once at
    :meth:`result` (the only host read of the counts): per-batch metrics
    weighted by the batch's real size (``batch_mean``, the reference's
    averaging), or one confusion matrix over the epoch (``global``)."""

    _KEYS = ("loss", "tp", "fp", "fn", "correct", "valid")
    _COUNTS = ("tp", "fp", "fn", "correct", "valid")

    def __init__(self, version: int, mode: str):
        self.version = version
        self.mode = mode
        self._outs: List[Dict[str, torch.Tensor]] = []
        self._weights: List[int] = []

    def update(self, out: Mapping[str, torch.Tensor], n_valid: int) -> None:
        self._outs.append({k: out[k] for k in self._KEYS})
        self._weights.append(int(n_valid))

    def result(self, prefix: str) -> Dict[str, float]:
        if not self._outs:
            return {f"{prefix}_loss": 0.0}
        n = max(sum(self._weights), 1)
        stacked = {k: torch.stack([o[k] for o in self._outs]).cpu()
                   for k in self._KEYS}
        w = torch.tensor(self._weights, dtype=torch.float32)
        counts = {k: stacked[k] for k in self._COUNTS}
        res = {f"{prefix}_loss": float((stacked["loss"] * w).sum()) / n}
        if self.mode == "batch_mean":
            for k, v in M.compute(counts, self.version).items():
                res[f"{prefix}_{k}"] = float((v * w).sum()) / n
        else:
            summed = {k: v.sum(0) for k, v in counts.items()}
            for k, v in M.compute(summed, self.version).items():
                res[f"{prefix}_{k}"] = float(v)
        return res


def evaluate(eval_step: Callable, loader, version: int = 2,
             mode: str = "batch_mean", prefix: str = "val",
             verbose: bool = True,
             place: Optional[Callable] = None) -> Dict[str, float]:
    """Run ``eval_step`` over ``loader`` (dicts with 'image', 'mask',
    'n_valid'); returns ``{prefix}_loss`` and the metrics."""
    avg = _Averager(version, mode)
    for batch in loader:
        if place is not None:
            batch = place(batch)
        avg.update(eval_step(batch["image"], batch["mask"]),
                   batch["n_valid"])
    res = avg.result(prefix)
    if verbose:
        keys = ", ".join(f"{k}={v:.4f}" for k, v in res.items())
        print(f"--- validation: {keys} ---")
    return res


def _placer(dev: torch.device) -> Callable:
    """A batch's arrays onto ``dev``; host arrays go through pinned memory
    with a non-blocking copy, so the host does not wait for the stream."""
    def put(a):
        t = torch.as_tensor(a)
        if dev.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    return lambda b: {**b, "image": put(b["image"]), "mask": put(b["mask"])}


def fit(model: nn.Module, cfg, train_loader, val_loader=None,
        seed: Optional[int] = None, state: Optional[TrainState] = None,
        checkpointer=None, verbose: bool = True, resume: bool = False,
        device: DeviceLike = None) -> List[Dict[str, Any]]:
    """A training run of ``cfg.num_epochs`` epochs on ``device`` (``None``
    means ``cuda``), its steps in ``cfg.compute_dtype``. Returns the
    history, the reference's JSON keys: epoch, train_loss / acc / miou
    (/ mpa / mf1), and the val_* twins.

    Loaders yield dicts with 'image' (NHWC, f32 or uint8), 'mask' and
    'n_valid', and must be re-iterable (each epoch iterates afresh;
    ``set_epoch(epoch)`` is called where the loader has it). ``state``
    (trained in place) defaults to :func:`create_state` over the weights
    ``model`` holds now (loaded, crossed from the JAX package or a
    fine-tuning start are kept; pass ``state=create_state(model,
    seed=...)`` for a seeded init); ``seed`` (default ``cfg.seed``) seeds
    the augment and dropout streams. With a ``checkpointer`` the best weights by
    validation mIoU and the latest state are saved each epoch;
    ``resume=True`` restores the latest state first and continues from
    epoch ``step // len(train_loader)`` (the history then covers the
    resumed epochs only)."""
    dev = resolve_device(device)
    dtype = cfg_dtype(cfg)
    if cfg.mesh_data > 1 or cfg.mesh_spatial > 1:
        raise NotImplementedError(MESH_TODO)
    if iter(train_loader) is train_loader:
        raise ValueError("fit needs a re-iterable train loader (each epoch "
                         "iterates it afresh), not an iterator")
    seed = cfg.seed if seed is None else seed
    if state is None:
        state = create_state(model, cfg.learning_rate, device=dev)
    start_epoch, best_miou = 0, -1.0
    if resume and checkpointer is not None and checkpointer.has_latest():
        checkpointer.restore_latest(state)
        start_epoch = min(state.step // max(len(train_loader), 1),
                          cfg.num_epochs)
        best_miou = checkpointer.best_metric()
        if verbose:
            print(f"resumed from step {state.step} (epoch {start_epoch}, "
                  f"best val mIoU {best_miou:.4f})")
    norm = (cfg.normalize_mean, cfg.normalize_std)
    train_step = make_train_step(state.model, cfg.num_classes,
                                 cfg.ignore_index, augment=cfg.augment,
                                 normalize=norm, compute_dtype=dtype)
    eval_step = make_eval_step(state.model, cfg.num_classes,
                               cfg.ignore_index, normalize=norm,
                               compute_dtype=dtype)
    place = _placer(dev)

    history: List[Dict[str, Any]] = []
    t_start = time.time()
    for epoch in range(start_epoch, cfg.num_epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        avg = _Averager(cfg.metrics_version, cfg.metrics_mode)
        for i, batch in enumerate(train_loader):
            placed = place(batch)
            out = train_step(state, placed["image"], placed["mask"], seed)
            avg.update(out, batch["n_valid"])
            if verbose and (i + 1) % cfg.log_every_steps == 0:
                sm = M.compute({k: out[k] for k in _Averager._COUNTS},
                               cfg.metrics_version)
                print(f"epoch [{epoch + 1}/{cfg.num_epochs}] step [{i + 1}] "
                      f"loss {float(out['loss']):.4f} acc "
                      f"{float(sm['acc']):.4f} miou {float(sm['miou']):.4f}")
        epoch_metrics: Dict[str, Any] = {"epoch": epoch + 1,
                                         **avg.result("train")}
        if verbose:
            keys = ", ".join(f"{k}={v:.4f}" for k, v in epoch_metrics.items()
                             if k != "epoch")
            print(f"=== epoch {epoch + 1}/{cfg.num_epochs}: {keys} ===")
        if val_loader is not None:
            val = evaluate(eval_step, val_loader, cfg.metrics_version,
                           cfg.metrics_mode, verbose=verbose, place=place)
            epoch_metrics.update(val)
            cur = val.get("val_miou", 0.0)
            if cur > best_miou:
                best_miou = cur
                if checkpointer is not None:
                    checkpointer.save_best(state, best_miou)
                if verbose:
                    print(f"*** val mIoU improved to {best_miou:.4f} ***")
        if checkpointer is not None:
            checkpointer.save_latest(state)
        history.append(epoch_metrics)
    if verbose:
        print(f"training done in {(time.time() - t_start) / 60:.2f} min")
    return history
