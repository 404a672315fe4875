"""Multi-rank training and rollout on ``torch.distributed``
(``molecular_dynamics_neural_operator_tpu/parallel/``): the device mesh,
the data-parallel train steps, the stream-sharded and edge-sharded
rollouts."""

from molecular_dynamics_neural_operator_tpu_torch.parallel.mesh import (
    batch_sharding,
    data_parallel_put,
    init_distributed,
    make_data_parallel_step,
    make_mesh,
    make_sharded_curriculum_train_step,
    make_sharded_train_step,
    replicas_equal,
    replicated_sharding,
    shard_batch,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel.rollout_sharded import (  # noqa: E501
    gather_streams,
    make_sharded_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel.edge_sharded import (  # noqa: E501
    make_edge_sharded_forward,
    make_edge_sharded_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel.rollout_edge_sharded import (  # noqa: E501
    make_edge_sharded_rollout_fn,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "make_sharded_train_step",
    "make_sharded_curriculum_train_step",
    "make_sharded_rollout_fn",
    "make_edge_sharded_rollout_fn",
    # the port's own: process group, placement, generic step, checks
    "init_distributed",
    "data_parallel_put",
    "make_data_parallel_step",
    "make_edge_sharded_forward",
    "make_edge_sharded_train_step",
    "gather_streams",
    "replicas_equal",
]
