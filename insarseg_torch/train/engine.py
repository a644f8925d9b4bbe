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
convolutions and matmuls.

Under a ``torch.distributed`` group (one process per device,
``parallel/mesh.py::launch`` or ``torchrun``) the steps compute the JAX
package's global-batch math on a ``data`` mesh. Every rank is given the
same global batch and takes its rows (``rows_of``); the BatchNorms are
synced ``MomentBatchNorm2d``s (global moments on K8a-K9b); the loss is the
rank's summed cross-entropy over the global valid count; the gradients
are summed over the ranks in one flattened all-reduce a dtype before the
optimizer step; the counts and the reported loss are global. No
``DistributedDataParallel``: ``BNFedConv2d``'s detached bias gets no
gradient, which DDP takes for a fault every step. The all-reduce moves
the f32 gradients once: U-Net-CA (base 64) has about 31M parameters,
124 MB; FCN-ResNet50-CA about 33M. The augment's D4 flags are drawn for
the global batch from the step's seed on every rank, each rank taking its
columns, so the mesh augments as one device does; dropout draws rank 0's
mask from the one-device seed and rank r's from ``SeedSequence([seed,
step, r])``, so a mesh step equals a one-device step only with dropout
off.

With ``spatial`` S above 1 (``fit``: ``cfg.mesh_spatial``; the JAX
package's ``spatial`` mesh axis) the ranks form ``world / S`` data rows
of S ranks, rank ``d * S + s`` holding rows ``rows_of(n, d, world / S)``
of the global batch and slab ``s`` of their H axis (``slab_of``). The
rank's rows are copied, normalized and augmented at full H x W (the D4
flips and the transpose move rows between slabs), and then cut to the
slab; the forward and backward run under the row's spatial group
(``parallel/mesh.py::spatial_comm``): the convs and pools exchange halo
rows and the global and pyramid pools and the resizes read across the
slabs (``parallel/spatial.py``). The BN moments, the loss's valid count,
the gradients and the counts are summed over every rank as on a data
mesh, which sums the slabs too (a pooled map's BN, the same map on every
slab, counts each data row once for its running variance:
``MomentBatchNorm2d.replicated``). Every family of the registry
(``models/registry.py::check_spatial``); dropout draws per rank, so a
spatial step equals one device's only with it off.
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
from insarseg_torch.parallel import mesh as P
from insarseg_torch.parallel.spatial import active as spatial_context
from insarseg_torch.train import metrics as M
from insarseg_torch.train.losses import cross_entropy_terms


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
    (:func:`init_weights`). Under a process group every rank then takes
    rank 0's weights and statistics."""
    dev = resolve_device(device)
    if seed is not None:
        init_weights(model, seed)
    model.to(dev)
    if P.grouped():
        P.broadcast_state(model)
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


def augment_flags(aug_seed: int, n: int, dev: torch.device
                  ) -> torch.Tensor:
    """The D4 flags (3, n) of a global batch of ``n`` for the augment seed
    ``aug_seed`` (``step_seeds``), drawn on ``dev`` (the same on every
    rank)."""
    g = torch.Generator(device=dev)
    g.manual_seed(aug_seed)
    return torch.rand((3, n), generator=g, device=dev) < 0.5


def step_seeds(seed: int, step: int, rank: int = 0) -> Tuple[int, int]:
    """(augment seed, dropout seed) of step ``step`` of a run with base
    ``seed``: a resumed run redraws the stream the first run drew. The
    augment seed is every rank's; rank r > 0 of a mesh draws its dropout
    from ``SeedSequence([seed, step, r])``."""
    a, d = np.random.SeedSequence([seed, step]).generate_state(2)
    if rank:
        d = np.random.SeedSequence([seed, step, rank]).generate_state(1)[0]
    return int(a), int(d)


def _default_generator(dev: torch.device) -> torch.Generator:
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def _scores(logits: torch.Tensor, mask: torch.Tensor, num_classes: int,
            ignore_index: int, terms: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
            grouped: bool = False) -> Dict[str, torch.Tensor]:
    """The loss and the confusion counts of a forward; ``terms``: its
    loss's (numerator, valid count) when already computed. ``grouped``
    (a rank's rows of the global batch): both are summed over the ranks
    first (one all-reduce), the global batch's loss and counts."""
    num, valid = terms if terms is not None \
        else cross_entropy_terms(logits, mask, ignore_index)
    counts = M.confusion_counts(logits.detach(), mask, num_classes,
                                ignore_index)
    num = num.detach()
    if grouped:
        num, valid, counts = _summed(num, valid, counts)
    return {"loss": num / valid.clamp_min(1), **counts}


def _summed(num: torch.Tensor, valid: torch.Tensor,
            counts: Dict[str, torch.Tensor]):
    """``num``, ``valid`` and ``counts`` summed over the ranks in one
    all-reduce, in f64 (which holds the counts exactly)."""
    parts = [num.reshape(1), valid.reshape(1),
             *(v.reshape(-1) for v in counts.values())]
    flat = torch.cat([t.to(torch.float64) for t in parts])
    torch.distributed.all_reduce(flat)
    out, i = [], 0
    for t in parts:
        out.append(flat[i:i + t.numel()].to(t.dtype))
        i += t.numel()
    summed = {k: o.reshape(v.shape)
              for (k, v), o in zip(counts.items(), out[2:])}
    return out[0][0], out[1][0], summed


def _put(a, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev``; a host array goes to a card through pinned memory
    with a non-blocking copy, so the host does not wait for the stream."""
    t = torch.as_tensor(a)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _local(image, mask, dev: torch.device, grouped: bool,
           spatial: int = 1):
    """The image and mask on ``dev``; ``grouped``, this rank's rows of the
    global batch (by its data coordinate on a mesh of ``spatial`` slabs a
    row), taken before the copy (a host batch sends each card its rows
    alone)."""
    if grouped:
        rows = _data_rows(len(image), spatial)
        image, mask = image[rows], mask[rows]
    return _put(image, dev), _put(mask, dev)


def _data_rows(n: int, spatial: int) -> slice:
    """This rank's rows of an ``n``-row global batch: its data row's
    (``rows_of`` by the data coordinate)."""
    return P.rows_of(n, P.coords(spatial)[0], P.world() // spatial)


def _slab(image: torch.Tensor, mask: torch.Tensor, comm
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's slab of the NHWC image and NHW mask (both whole
    without a spatial group); the group forgets the last image's maps."""
    if comm is None:
        return image, mask
    comm.new_image()
    rows = P.slab_of(image.shape[1], comm.index, comm.size)
    return image[:, rows], mask[:, rows]


def _spatial_comm(model: nn.Module, spatial: int):
    """The spatial group of the steps of ``model`` (None for 1)."""
    if spatial == 1:
        return None
    from insarseg_torch.models.registry import check_spatial

    check_spatial(model)
    return P.spatial_comm(spatial)


def make_train_step(model: nn.Module, num_classes: int,
                    ignore_index: int = 255, augment: bool = False,
                    normalize: Optional[Tuple[float, float]] = (0.5, 0.5),
                    compute_dtype: Optional[torch.dtype] = None,
                    spatial: int = 1) -> Callable:
    """``step(state, image, mask, seed=0) -> {loss, tp, fp, fn, correct,
    valid}``: one Adam step of ``model`` (``state.model``) on an NHWC batch
    (uint8 images are normalized on the device), in train mode (BN batch
    statistics, running statistics updated, dropout live), then the
    confusion counts of that forward. The image enters the model in
    ``compute_dtype`` (``None``: the float dtype it comes in, f32 for
    uint8). ``seed`` is the run's base seed: the
    augment's D4 flags and dropout are drawn from generators seeded with
    ``step_seeds(seed, state.step)``. Returns device tensors and never
    synchronises the stream.

    Under a process group (made when the step is built) ``image`` and
    ``mask`` are the global batch, the model's BatchNorms are synced
    (``parallel/mesh.py::sync_batchnorm``) and the step is the global
    batch's (the module docstring); with ``spatial`` above 1 each rank
    holds a slab of its rows' H axis (building the step makes the spatial
    groups: every rank builds it)."""
    grouped = P.grouped()
    if grouped:
        P.sync_batchnorm(model)
    comm = _spatial_comm(model, spatial)

    def step(state: TrainState, image, mask, seed: int = 0):
        dev = next(model.parameters()).device
        aug_seed, drop_seed = step_seeds(seed, state.step, P.rank())
        flags = None
        if augment:
            flags = augment_flags(aug_seed, len(image), dev)
            if grouped:
                flags = flags[:, _data_rows(len(image), spatial)]
        image, mask = _local(image, mask, dev, grouped, spatial)
        image = _to_float(image, normalize)
        if augment:
            image, mask = random_dihedral(image, mask, flags=flags)
        image, mask = _slab(image, mask, comm)
        model.train()
        with _f32(), spatial_context(comm), torch.random.fork_rng(
                devices=[dev] if dev.type == "cuda" else []):
            _default_generator(dev).manual_seed(drop_seed)
            logits = model(nhwc_to_nchw(_cast(image, compute_dtype))) \
                .permute(0, 2, 3, 1)
            num, valid = cross_entropy_terms(logits, mask, ignore_index)
            den = valid
            if grouped:
                den = valid.clone()
                torch.distributed.all_reduce(den)
            loss = num / den.clamp_min(1)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if grouped:
                P.all_reduce_grads(model.parameters())
            state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            return _scores(logits, mask, num_classes, ignore_index,
                           (num, valid), grouped)

    return step


def make_eval_step(model: nn.Module, num_classes: int,
                   ignore_index: int = 255,
                   normalize: Optional[Tuple[float, float]] = (0.5, 0.5),
                   compute_dtype: Optional[torch.dtype] = None,
                   spatial: int = 1) -> Callable:
    """``step(image, mask) -> {loss, counts}`` of ``model`` in eval mode
    (BN running statistics, no dropout), on the model's device, the image
    entering the model in ``compute_dtype`` (as in
    :func:`make_train_step`). Under a process group (made when the step
    is built) each rank scores its rows of the global batch (with
    ``spatial`` above 1, their slab) and the loss and counts are the
    global batch's."""
    grouped = P.grouped()
    comm = _spatial_comm(model, spatial)

    @torch.no_grad()
    def step(image, mask):
        dev = next(model.parameters()).device
        image, mask = _local(image, mask, dev, grouped, spatial)
        image, mask = _slab(_to_float(image, normalize), mask, comm)
        model.eval()
        with _f32(), spatial_context(comm):
            logits = model(nhwc_to_nchw(_cast(image, compute_dtype))) \
                .permute(0, 2, 3, 1)
        return _scores(logits, mask, num_classes, ignore_index,
                       grouped=grouped)

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
    """A batch's arrays onto ``dev`` (:func:`_put`). Under a process group
    the batch stays where it is: the steps copy this rank's rows alone."""
    if P.grouped():
        return lambda b: b
    return lambda b: {**b, "image": _put(b["image"], dev),
                      "mask": _put(b["mask"], dev)}


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
    resumed epochs only).

    ``fit`` is SPMD: inside a ``torch.distributed`` group (``launch``,
    ``torchrun``) it runs as one rank of a ('data', 'spatial') mesh of
    ``world / cfg.mesh_spatial`` rows of ``cfg.mesh_spatial`` ranks,
    every rank iterating the same loader (the global batches) and
    ``device`` this rank's; ``cfg.mesh_data`` must then be -1 or ``world /
    mesh_spatial``. Only rank 0 prints and saves checkpoints, every rank
    restores on resume, and the ranks meet after each save. Without a
    group ``fit`` runs on one device, and ``mesh_data`` or
    ``mesh_spatial`` above 1 raises ``ValueError``, as ``mesh_spatial``
    above the ranks does; under ``mesh_spatial`` above 1 any H that it
    divides runs (``parallel/spatial.py``). A batch that the data axis does
    not divide splits unevenly (``rows_of``), as on a data mesh, where
    the JAX package shrinks its data axis to a divisor."""
    dev = resolve_device(device)
    dtype = cfg_dtype(cfg)
    n_s = cfg.mesh_spatial
    if n_s > 1:
        from insarseg_torch.models.registry import check_spatial

        check_spatial(cfg.model)
    if P.grouped():
        w = P.world()
        if n_s > w or w % n_s:
            raise ValueError(f"mesh_spatial={n_s} in a process group of {w} "
                             "ranks: the ranks must split into groups of "
                             "mesh_spatial")
        if cfg.mesh_data not in (-1, w // n_s):
            raise ValueError(f"mesh_data={cfg.mesh_data} in a process "
                             f"group of {w} ranks"
                             + (f" at mesh_spatial={n_s}" if n_s > 1 else ""))
    elif cfg.mesh_data > 1 or n_s > 1:
        raise ValueError(P.NEEDS_LAUNCH)
    verbose = verbose and P.rank() == 0
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
                                 normalize=norm, compute_dtype=dtype,
                                 spatial=n_s)
    eval_step = make_eval_step(state.model, cfg.num_classes,
                               cfg.ignore_index, normalize=norm,
                               compute_dtype=dtype, spatial=n_s)
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
                    P.barrier()
                if verbose:
                    print(f"*** val mIoU improved to {best_miou:.4f} ***")
        if checkpointer is not None:
            checkpointer.save_latest(state)
            P.barrier()
        history.append(epoch_metrics)
    if verbose:
        print(f"training done in {(time.time() - t_start) / 60:.2f} min")
    return history
