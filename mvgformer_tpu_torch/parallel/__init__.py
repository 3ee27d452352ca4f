"""Data parallelism: one process per card, the global batch split by rows,
the gradients averaged by an explicit all-reduce (`parallel/mesh.py`)."""

from mvgformer_tpu_torch.parallel.mesh import (
    DataParallel,
    all_reduce_grads,
    choose_backend,
    data_world,
    init_data_parallel,
    launch,
    replicated,
    shard_batch,
    spawn,
)

__all__ = ["DataParallel", "all_reduce_grads", "choose_backend",
           "data_world", "init_data_parallel", "launch", "replicated",
           "shard_batch", "spawn"]
