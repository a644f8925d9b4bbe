"""The ``data`` mesh: serving over a list of devices in one process, and
training one process per device (``parallel/mesh.py``); batched inference
of the ``nn.Module`` graph (``parallel/inference.py``)."""

from insarseg_torch.parallel.inference import make_predict_fn
from insarseg_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    launch,
    make_mesh,
    mesh_engine,
    rank,
    replicate,
    replicate_arrays,
    rows_of,
    shard_batch,
    sync_batchnorm,
    world,
)

__all__ = ["make_predict_fn", "Mesh", "all_reduce_grads", "launch",
           "make_mesh", "mesh_engine", "rank", "replicate",
           "replicate_arrays", "rows_of", "shard_batch", "sync_batchnorm",
           "world"]
