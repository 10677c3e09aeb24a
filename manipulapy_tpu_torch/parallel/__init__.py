"""Execution over a mesh of devices (scenario-axis sharding).

Counterpart of ``manipulapy_tpu/parallel``. A mesh is a tuple of torch
devices driven by this one process, as JAX's single-controller mesh is;
there is no process group.
"""

from .mesh import (
    Mesh,
    make_mesh,
    scenario_sharding,
    replicate_model,
    shard_batch,
    sharded_vmap,
    distributed_rollout,
    distributed_ik,
    scaling_efficiency,
)
from .fleet import (
    Fleet,
    stack_models,
    masked_forward_dynamics,
    make_masked_step_fn,
    fleet_rollout,
    fleet_ilqr_solve,
    fleet_mpc_round,
)
from .fused_fleet import (
    ShardedBatchMPC,
    build_sharded_batch_mpc,
    FleetFusedMPC,
    build_fleet_fused_mpc,
    unpad_robot,
)

__all__ = [
    "make_mesh",
    "scenario_sharding",
    "replicate_model",
    "shard_batch",
    "sharded_vmap",
    "distributed_rollout",
    "distributed_ik",
    "scaling_efficiency",
    "Fleet",
    "stack_models",
    "masked_forward_dynamics",
    "make_masked_step_fn",
    "fleet_rollout",
    "fleet_ilqr_solve",
    "fleet_mpc_round",
    "ShardedBatchMPC",
    "build_sharded_batch_mpc",
    "FleetFusedMPC",
    "build_fleet_fused_mpc",
    "unpad_robot",
]
