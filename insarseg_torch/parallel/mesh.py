"""The device mesh: the ``data`` axis of the JAX package's mesh
(counterpart of ``insarseg/parallel/mesh.py``), in the two forms the
paths need.

- **Serving** (the module, serve and int8 engines, ``evaluate`` over an
  engine, ``predict``, ``predict --stream``) runs in one process over a
  :class:`Mesh`, a list of devices. The JAX forward holds no collective
  (the batch sharded over ``data``, the weights replicated), so neither
  does the port's: :func:`mesh_engine` splits the batch along dim 0,
  queues each shard's forward on its own device in turn with no host
  sync between them, and gathers the outputs in order on the first
  device. A device may repeat (two replicas on one card, four CPU
  replicas in the tests).
- **Training** (``train/engine.py``: the train and eval steps, ``fit``,
  the CLI's ``train``) runs one process per device under
  ``torch.distributed`` (NCCL on cards, gloo on the CPU), started by
  :func:`launch` or by ``torchrun`` (:func:`joined`). Every rank reads
  the same global batch and takes its rows (:func:`rows_of`); the step
  computes the JAX package's global-batch math: BatchNorm moments over the
  global batch (``ops/layers.py::MomentBatchNorm2d`` marked ``synced`` by
  :func:`sync_batchnorm`), the loss's valid count summed over the ranks,
  the gradients summed (:func:`all_reduce_grads`), and the counts summed.

The ``spatial`` axis (the image H axis sharded over S ranks, a
:class:`Mesh` of ``data x spatial`` devices) runs every family of the
registry (``models/registry.py::check_spatial``):
device ``(d, s)`` of the mesh (rank ``d * S + s``, :func:`coords`) holds
rows :func:`rows_of` ``d`` of ``data`` of the global batch and their slab
:func:`slab_of` ``s`` of ``S``; the convs and pools exchange halo rows,
the SE squeezes sum over the slabs, and the ResNet families' global
pools, pyramid pools and resizes read across the slabs too
(``parallel/spatial.py``). Training makes one process group a data row
(:func:`spatial_comm`); serving runs one thread a slab
(``parallel/inference.py::make_predict_fn``). The packed engines split
the batch over ``data`` alone, as the JAX package's ``jit_engine`` does.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import os
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from insarseg_torch.device import DeviceLike, resolve_device
from insarseg_torch.engines_io import to_torch_tree
from insarseg_torch.ops.layers import MomentBatchNorm2d

# a collective that waits this long has lost a rank: the launch fails
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)
NEEDS_LAUNCH = ("mesh_data > 1 or mesh_spatial > 1 trains one process per "
                "device: run fit inside insarseg_torch.parallel.launch (or "
                "torchrun), or set mesh_data to -1 or 1 and mesh_spatial "
                "to 1")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'spatial') grid of devices: ``devices`` in the JAX
    package's ``reshape(data, spatial)`` order (row d holds
    ``devices[d * spatial:(d + 1) * spatial]``, its slabs top to bottom);
    repeats allowed."""

    devices: Tuple[torch.device, ...]
    spatial: int = 1

    @property
    def data(self) -> int:
        return len(self.devices) // self.spatial

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "spatial": self.spatial}

    @property
    def size(self) -> int:
        return len(self.devices)

    def over_data(self) -> "Mesh":
        """The data axis alone: each row's first device (the packed
        engines split the batch over it and never shard H)."""
        return Mesh(self.devices[::self.spatial])


def _device(d: DeviceLike) -> torch.device:
    """``d`` resolved (a card raises without one), ``cuda`` given its
    index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(data: int = -1, spatial: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A ('data', 'spatial') mesh over ``devices`` (default: every visible
    card; without one this raises, as ``device.resolve_device`` does), the
    first ``data * spatial`` of them. ``data=-1`` takes ``n // spatial``,
    where ``spatial`` must divide the ``n`` devices; a mesh larger than
    the devices given raises, as the JAX package's ``make_mesh``
    asserts."""
    if spatial < 1:
        raise ValueError(f"mesh spatial must be >= 1, got {spatial}")
    if devices is None:
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_device(d) for d in devices]
    n = len(devs)
    if data == -1:
        if n % spatial:
            raise ValueError(f"{n} devices do not split into groups of "
                             f"spatial={spatial}")
        data = n // spatial
    if data < 1 or data * spatial > n:
        raise ValueError(f"a mesh of data={data} x spatial={spatial} needs "
                         f"{data * spatial} devices; {n} are given")
    return Mesh(tuple(devs[:data * spatial]), spatial)


def rows_of(n: int, r: Optional[int] = None,
            w: Optional[int] = None) -> slice:
    """The rows of an ``n``-row global batch that rank ``r`` of ``w``
    holds (default: this process's), ``torch.tensor_split``'s split: the
    first ``n % w`` ranks take one row more. On a spatial mesh ``r`` and
    ``w`` are the data coordinate and the data axis (:func:`coords`)."""
    r = rank() if r is None else r
    w = world() if w is None else w
    q, m = divmod(n, w)
    start = r * q + min(r, m)
    return slice(start, start + q + (r < m))


def slab_of(h: int, s: int, spatial: int) -> slice:
    """The rows of an image of height ``h`` that slab ``s`` of
    ``spatial`` holds: equal slabs, so ``spatial`` must divide ``h``."""
    if h % spatial:
        raise ValueError(f"an image of height {h} does not split into "
                         f"{spatial} equal slabs")
    q = h // spatial
    return slice(s * q, (s + 1) * q)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A host batch dict with its 'image' (NHWC) and 'mask' (NHW) split
    into one shard a mesh device, each on its device (a tuple, in
    ``mesh.devices`` order): B over ``data`` (``torch.tensor_split``) and
    H over ``spatial`` (:func:`slab_of`); other entries pass through."""
    out = dict(batch)
    for k in ("image", "mask"):
        if k in batch:
            a = torch.as_tensor(batch[k])
            parts = [rows[:, slab_of(a.shape[1], s, mesh.spatial)]
                     for rows in torch.tensor_split(a, mesh.data)
                     for s in range(mesh.spatial)]
            out[k] = tuple(p.to(d) for p, d in zip(parts, mesh.devices))
    return out


def _copy_to(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, nn.Module):
        return copy.deepcopy(tree).to(dev)
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_to(v, dev) for v in tree)
    if isinstance(tree, (bool, int, float)):
        return torch.tensor(tree, device=dev)
    return to_torch_tree(tree, dev)


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of ``tree`` per mesh device: modules deep-copied onto it,
    every array and Python number a tensor there (as ``jax.device_put``
    makes every leaf an array)."""
    return [_copy_to(tree, d) for d in mesh.devices]


def replicate_arrays(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of ``tree`` per mesh device with only its array leaves
    (tensors, numpy arrays) placed there. Python scalars, bools and
    ``None`` stay as they are: in the packed serving trees they pick
    branches (``blk['out_s'] is None``, ``packed['s2d']``)."""
    return [to_torch_tree(tree, d) for d in mesh.devices]


def mesh_engine(predicts: Sequence[Callable], mesh: Mesh) -> Callable:
    """``predict(images)`` over one per-device ``predict`` a mesh device
    (the counterpart of the JAX package's ``jit_engine`` with a mesh):
    the batch goes to the first device, splits along dim 0
    (``torch.tensor_split``: uneven shards are fine), each shard is
    copied to its device, each shard's forward is queued on its own
    device in turn, and the outputs are gathered in order on the first
    device. Cross-device copies are ordered on the streams, so the host
    never waits between shards. A copy runs on its source's stream, so
    every shard's copy is queued before the first device's forward: a
    copy queued after it would hold its device until that forward ends."""
    if len(predicts) != mesh.size:
        raise ValueError(f"{len(predicts)} predicts for a mesh of "
                         f"{mesh.size} devices")
    first = mesh.devices[0]

    def predict(images):
        x = torch.as_tensor(images)
        if x.device.type == "cpu" and first.type == "cuda":
            x = x.to(first)
        shards = [(fn, dev, part.to(dev)) for fn, dev, part in
                  zip(predicts, mesh.devices,
                      torch.tensor_split(x, mesh.size)) if len(part)]
        if not shards:
            return predicts[0](x)
        outs = []
        for fn, dev, part in shards:
            with _on(dev):
                outs.append(fn(part))
        return torch.cat([o.to(first) for o in outs])

    return predict


def spatial_engine(predicts: Sequence[Callable], mesh: Mesh) -> Callable:
    """``predict(images)`` over one per-device ``predict`` a device of a
    spatial mesh, the H axis sharded: the batch splits over ``data``
    (``torch.tensor_split``) and each row's images into ``spatial`` slabs
    (:func:`slab_of`), one thread a slab runs its device's ``predict``
    under a ``parallel/spatial.py::ThreadComm`` of its row (the halo rows
    and the pools' sums pass between the row's threads), and the NHWC
    outputs (logits, or the (B, H, W) class map) are joined along H, then
    along B, on the first device. A thread that raises breaks its row's
    barrier, and the first error is raised here."""
    if len(predicts) != mesh.size:
        raise ValueError(f"{len(predicts)} predicts for a mesh of "
                         f"{mesh.size} devices")
    from insarseg_torch.parallel import spatial

    first, n_s = mesh.devices[0], mesh.spatial

    def predict(images):
        x = torch.as_tensor(images)
        if x.device.type == "cpu" and first.type == "cuda":
            x = x.to(first)
        h = x.shape[1]
        rows = [(d, r) for d, r in enumerate(torch.tensor_split(x, mesh.data))
                if len(r)]
        outs: Dict[Tuple[int, int], torch.Tensor] = {}
        errors: List[BaseException] = []

        def work(i, dev, part, shared, s):
            try:
                with _on(dev), spatial.active(
                        spatial.ThreadComm(shared, s, dev)):
                    outs[i, s] = predicts[i](part.to(dev))
            except Exception as e:  # raised in the caller below
                errors.append(e)
                shared.barrier.abort()

        threads = []
        for d, r in rows:
            shared = spatial.ThreadExchange(n_s)
            for s in range(n_s):
                i = d * n_s + s
                threads.append(threading.Thread(target=work, args=(
                    i, mesh.devices[i], r[:, slab_of(h, s, n_s)], shared,
                    s)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return torch.cat([torch.cat([outs[d * n_s + s, s].to(first)
                                     for s in range(n_s)], dim=1)
                          for d, _ in rows])

    return predict


def _on(dev: torch.device):
    """The current-device context of ``dev`` (none off the card)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# training: one process per device
# ---------------------------------------------------------------------------

def grouped() -> bool:
    """Whether this process is a rank of a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if grouped() else 0


def world() -> int:
    return dist.get_world_size() if grouped() else 1


def coords(spatial: int = 1, r: Optional[int] = None) -> Tuple[int, int]:
    """(data, spatial) coordinates of rank ``r`` (default: this process)
    on a mesh of ``spatial`` slabs a row: ``divmod(r, spatial)``, so a
    row's ranks are consecutive, as the JAX mesh's devices are."""
    return divmod(rank() if r is None else r, spatial)


_SPATIAL_COMMS: Dict[Tuple[int, Any], Any] = {}


def spatial_comm(spatial: int):
    """This rank's spatial group on a mesh of ``world() // spatial`` rows
    of ``spatial`` ranks (``parallel/spatial.py::GroupComm``). The first
    call under a process group makes every row's group, on every rank in
    the same order (``dist.new_group`` is collective), so every rank must
    make the call; later calls return the same group."""
    if not grouped():
        raise ValueError(NEEDS_LAUNCH)
    w = world()
    if w % spatial:
        raise ValueError(f"a process group of {w} ranks does not split into "
                         f"groups of spatial={spatial}")
    key = (spatial, dist.group.WORLD)
    if key not in _SPATIAL_COMMS:
        from insarseg_torch.parallel.spatial import GroupComm

        d, s = coords(spatial)
        groups = [dist.new_group(list(range(i * spatial, (i + 1) * spatial)))
                  for i in range(w // spatial)]
        _SPATIAL_COMMS[key] = GroupComm(groups[d], spatial, s)
    return _SPATIAL_COMMS[key]


def barrier() -> None:
    if grouped():
        dist.barrier()


def all_reduce_grads(params) -> None:
    """Sum the gradients over the ranks in place: one flattened all-reduce
    per (device, dtype). Parameters without a gradient (a BN-fed conv's
    bias in train mode) are left out on every rank alike. Without a
    group, nothing to do."""
    if not grouped():
        return
    groups: Dict[Tuple[torch.device, torch.dtype], List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.device, p.grad.dtype), []).append(
                p.grad)
    for grads in groups.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def broadcast_state(model: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``model`` from rank ``src``, in
    place."""
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, src)


def sync_batchnorm(model: nn.Module) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` of ``model`` take the global batch's
    moments under a process group: a ``MomentBatchNorm2d`` is marked
    ``synced``, any other is swapped for a synced ``MomentBatchNorm2d``
    that holds the same parameter and buffer objects (an optimizer built
    over the model keeps them; the state_dict names do not change). In
    place; returns ``model``."""
    for name, child in list(model.named_children()):
        if isinstance(child, MomentBatchNorm2d):
            child.synced = True
        elif isinstance(child, nn.BatchNorm2d):
            setattr(model, name, MomentBatchNorm2d.taking_over(child))
        else:
            sync_batchnorm(child)
    return model


# the variables ``torchrun`` (and any ``env://`` launcher) gives a rank
ENV_RANK = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def env_rank() -> bool:
    """Whether ``torchrun`` started this process as a rank
    (:data:`ENV_RANK` all set)."""
    return all(k in os.environ for k in ENV_RANK)


@contextlib.contextmanager
def joined(dev: torch.device):
    """This process as a rank of its group for the body of the ``with``:
    the group its caller made, or else the one ``torchrun`` describes in
    the environment (joined here through ``env://``, NCCL on the card
    ``LOCAL_RANK`` names or gloo on the CPU, and left on exit). Yields the
    rank's device: ``dev`` on the CPU, else the caller's current card or
    ``LOCAL_RANK``'s."""
    if grouped():
        yield torch.device("cuda", torch.cuda.current_device()) \
            if dev.type == "cuda" else dev
        return
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if kw else "gloo", init_method="env://",
                            timeout=COLLECTIVE_TIMEOUT, **kw)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def default_backend(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, gloo on the CPU or when
    ranks share a card (NCCL refuses two ranks on one card)."""
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def _rank_main(r: int, fn: Callable, args: tuple, world_size: int,
               devices: List[torch.device], backend: str, tmp: str,
               threads: int) -> None:
    torch.set_num_threads(threads)
    # the ranks of a launch share this host: their sockets stay on it
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = devices[r]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=r,
                            world_size=world_size,
                            timeout=COLLECTIVE_TIMEOUT, **kw)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int,
           devices: Optional[Sequence[DeviceLike]] = None,
           args: tuple = ()) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` ranks, one process each
    (``torch.multiprocessing``, ``spawn``), rank r on ``devices[r]``
    (default: the first ``world_size`` cards), in one process group
    (:func:`default_backend`'s). The ranks meet through a
    ``FileStore`` in a temporary directory (no TCP port). On a card the
    kernels' library is built here first, so the ranks find it built.
    ``fn`` must be importable (a module-level function); each rank gets
    this process's torch threads divided by the ranks. Returns each
    rank's return value, in rank order; a rank that raises fails the
    launch (the other ranks are stopped)."""
    import torch.multiprocessing as mp

    if devices is None:
        devs = list(make_mesh(world_size).devices)
    else:
        devs = [_device(d) for d in devices]
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices for {world_size} ranks")
    backend = default_backend(devs)
    if any(d.type == "cuda" for d in devs):
        from insarseg_torch.kernels import load_library

        load_library()
    threads = max(1, torch.get_num_threads() // world_size)
    with tempfile.TemporaryDirectory(prefix="insarseg-launch-") as tmp:
        mp.start_processes(
            _rank_main, args=(fn, tuple(args), world_size, devs, backend,
                              tmp, threads),
            nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
