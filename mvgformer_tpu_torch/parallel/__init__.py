"""Data and view parallelism: one process per rank of a (data x view)
grid, the global batch split by rows and, under a view split, each frame's
views split over the ranks of its data row; the cross-view collectives
written out (`parallel/collectives.py`) and the gradients averaged by an
explicit all-reduce (`parallel/mesh.py`)."""

from mvgformer_tpu_torch.parallel.mesh import (
    DataParallel,
    all_reduce_grads,
    choose_backend,
    data_world,
    init_data_parallel,
    launch,
    replicated,
    shard_batch,
    shard_views,
    spawn,
)

__all__ = ["DataParallel", "all_reduce_grads", "choose_backend",
           "data_world", "init_data_parallel", "launch", "replicated",
           "shard_batch", "shard_views", "spawn"]
