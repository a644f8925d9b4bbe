"""The ('data', 'spatial') mesh: serving over a list of devices in one
process, and training one process per device (``parallel/mesh.py``); the
H axis sharded over the ``spatial`` ranks (``parallel/spatial.py``);
batched inference of the ``nn.Module`` graph (``parallel/inference.py``)."""

from insarseg_torch.parallel.inference import make_predict_fn
from insarseg_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    coords,
    launch,
    make_mesh,
    mesh_engine,
    rank,
    replicate,
    replicate_arrays,
    rows_of,
    shard_batch,
    slab_of,
    spatial_comm,
    spatial_engine,
    sync_batchnorm,
    world,
)

__all__ = ["make_predict_fn", "Mesh", "all_reduce_grads", "coords",
           "launch", "make_mesh", "mesh_engine", "rank", "replicate",
           "replicate_arrays", "rows_of", "shard_batch", "slab_of",
           "spatial_comm", "spatial_engine", "sync_batchnorm", "world"]
