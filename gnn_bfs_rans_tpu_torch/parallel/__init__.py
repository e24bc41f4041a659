"""Scale-out on torch.distributed: data parallelism, multi-case training,
node-partitioned graphs with a halo exchange (one rank a device)."""

from .data_parallel import (
    gather_predictions,
    make_dp_forward,
    make_dp_train_step,
    replicate,
    shard_targets,
)
from .distributed import init_distributed, launch
from .generalization import (
    analytic_targets,
    run_geometry_generalization,
    train_multicase_streamed,
)
from .multicase import (
    CaseBatch,
    gather_case_predictions,
    make_multicase_forward,
    make_multicase_train_step,
    make_perturbed_cases,
    shard_cases,
)
from .partition import (
    PartitionedGraph,
    build_partition,
    gather_partitioned,
    make_partitioned_forward,
    make_partitioned_train_step,
    shard_partition,
    shard_partitioned_targets,
)

# the JAX package's names, with init_distributed and launch in place of
# make_data_mesh (a group of ranks is the port's mesh)
__all__ = [
    "init_distributed",
    "launch",
    "make_dp_train_step",
    "make_dp_forward",
    "shard_targets",
    "replicate",
    "gather_predictions",
    "CaseBatch",
    "make_perturbed_cases",
    "shard_cases",
    "make_multicase_train_step",
    "make_multicase_forward",
    "gather_case_predictions",
    "PartitionedGraph",
    "build_partition",
    "shard_partition",
    "make_partitioned_forward",
    "make_partitioned_train_step",
    "shard_partitioned_targets",
    "gather_partitioned",
    "analytic_targets",
    "train_multicase_streamed",
    "run_geometry_generalization",
]
