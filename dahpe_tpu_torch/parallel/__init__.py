"""Data parallelism over ``torch.distributed`` ranks (port of
``dahpe_tpu/parallel/``): process-group bring-up, the launcher of a
job's ranks from one process, and the data-parallel train and eval
steps."""

from dahpe_tpu_torch.parallel.distributed import (
    barrier,
    fold_in,
    rank,
    robust_distributed_initialize,
    shutdown,
    world_size,
)
from dahpe_tpu_torch.parallel.launch import run_ranks
from dahpe_tpu_torch.parallel.mesh import (
    Collectives,
    assert_replicated,
    create_mesh,
    data_parallel,
    make_parallel_da_step,
    make_parallel_eval_step,
    make_parallel_pretrain_step,
    replicate,
    shard_batch,
)

__all__ = [
    "barrier",
    "fold_in",
    "rank",
    "robust_distributed_initialize",
    "shutdown",
    "world_size",
    "Collectives",
    "assert_replicated",
    "create_mesh",
    "data_parallel",
    "make_parallel_da_step",
    "make_parallel_eval_step",
    "make_parallel_pretrain_step",
    "replicate",
    "run_ranks",
    "shard_batch",
]
