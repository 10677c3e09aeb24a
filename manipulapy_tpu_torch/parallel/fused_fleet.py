"""The batched fused MPC solver, sharded over the mesh's scenario axis.

Counterpart of ``manipulapy_tpu/parallel/fused_fleet.py``. Each device owns
``B / mesh.size`` scenarios and runs its own
:func:`~manipulapy_tpu_torch.mpc.fused_batch.build_batch_tracking_mpc`
solver on them, so a CUDA device runs the kernels K2-K5 on its chunk;
goals are a run-time argument, so a fleet re-targets every round without a
rebuild. The fleet cost is the mean of the per-device mean costs, gathered
on the first device (one device: that device's mean).

Heterogeneous fleets compose per robot: :func:`build_fleet_fused_mpc`
strips each robot's padding (the fused kernels need a non-singular mass
matrix) and builds one sharded solver, one kernel set, a distinct robot.
The unpadded robot keeps the f64 source arrays of the robot before
padding, so its kernels are the same code, built once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.robot import HOST_ARRAY_KEYS, RobotModel, from_host_arrays
from ..mpc.fused_batch import BatchTrackingMPC, build_batch_tracking_mpc
from .fleet import Fleet, _f64_arrays
from .mesh import SCENARIO_AXIS, Mesh, scenario_sharding, shard_batch

__all__ = [
    "ShardedBatchMPC",
    "build_sharded_batch_mpc",
    "FleetFusedMPC",
    "build_fleet_fused_mpc",
    "unpad_robot",
]


class ShardedBatchMPC(NamedTuple):
    """Mesh-sharded batched fused solver.

    ``solve(x0 (B, 2n), us_warm (B, H, n), q_goal=None) -> (us (B, H, n),
    xs (B, H+1, 2n), cost (B,), fleet_cost scalar)`` with B the global
    batch; the outputs lie on the mesh's first device. ``local`` holds one
    solver a device."""

    solve: Callable
    local: Tuple[BatchTrackingMPC, ...]
    mesh: Mesh
    batch: int
    axis_name: str

    def shard_inputs(self, *arrays):
        """Split (B, ...) tensors over the mesh, one shard a device."""
        out = tuple(shard_batch(torch.as_tensor(a), self.mesh) for a in arrays)
        return out if len(out) > 1 else out[0]


def build_sharded_batch_mpc(
    model: RobotModel,
    mesh: Mesh,
    q_goal,
    batch: int,
    horizon: int,
    dt: float,
    *,
    axis_name: str = SCENARIO_AXIS,
    **solver_kw,
) -> ShardedBatchMPC:
    """Build the batched fused solver sharded over ``mesh``: ``batch``
    (the global scenario count) must divide by the mesh size. ``q_goal``:
    (n,) shared or (batch, n) per scenario, the default of every solve.
    The remaining keywords go to ``build_batch_tracking_mpc``."""
    n = model.num_joints
    B = int(batch)
    if B % mesh.size != 0:
        raise ValueError(f"global batch {B} must divide by the mesh size {mesh.size}")
    B_local = B // mesh.size
    # Each device's solver is built with placeholder goals: goals always
    # ride the run-time argument, one chunk a device.
    local = tuple(
        build_batch_tracking_mpc(model.to(d), np.zeros((B_local, n), dtype=np.float32), B_local, horizon, dt,
                                 **solver_kw)
        for d in mesh.devices
    )
    first = mesh.devices[0]

    def goals_of(q):
        goals = torch.as_tensor(q.detach() if isinstance(q, torch.Tensor) else np.asarray(q, np.float32),
                                dtype=torch.float32, device=first)
        if goals.dim() == 1:
            goals = goals.expand(B, n)
        if tuple(goals.shape) != (B, n):
            raise ValueError(f"q_goal must be ({n},) or ({B}, {n}), got {tuple(goals.shape)}")
        return goals

    goal_default = goals_of(q_goal)

    def solve(x0: torch.Tensor, us_init: torch.Tensor, q_goal_new=None):
        if x0.shape[0] != B:
            raise ValueError(f"x0 global batch {x0.shape[0]} != declared batch {B}")
        if us_init.shape[0] != B:
            raise ValueError(f"us_init global batch {us_init.shape[0]} != {B}")
        goals = goal_default if q_goal_new is None else goals_of(q_goal_new)
        outs = [
            solver.solve(x0[rows].to(d), us_init[rows].to(d), goals[rows].to(d))
            for solver, (d, rows) in zip(local, scenario_sharding(mesh, B))
        ]
        us, xs, cost = (torch.cat([o[i].to(first) for o in outs]) if len(outs) > 1 else outs[0][i]
                        for i in range(3))
        fleet = torch.stack([o[2].mean().to(first) for o in outs]).mean()
        return us, xs, cost, fleet

    return ShardedBatchMPC(solve=solve, local=local, mesh=mesh, batch=B, axis_name=axis_name)


def unpad_robot(padded: RobotModel, n_real: int) -> RobotModel:
    """Undo ``stack_models``' padding of one robot: the first ``n_real``
    rows of every per-joint field (padding is appended, so this is the
    robot before padding, f64 source arrays included)."""
    a = _f64_arrays(padded)
    sliced = {k: (a[k] if k == "home" else a[k][:n_real]) for k in HOST_ARRAY_KEYS}
    return from_host_arrays(sliced, dtype=padded.dtype, device=padded.device)


class FleetFusedMPC(NamedTuple):
    """Heterogeneous fleet on the sharded fused solver: one
    :class:`ShardedBatchMPC` a robot, fleet-shaped (R, S, ...) inputs and
    outputs.

    ``round(x0 (R, S, 2 n_max), us0 (R, S, H, n_max), q_goals (R, S,
    n_max)) -> (us (R, S, H, n_max), costs (R, S), fleet_cost scalar)``,
    the padded controls exactly 0."""

    solvers: Tuple[ShardedBatchMPC, ...]
    dofs: Tuple[int, ...]
    n_max: int
    horizon: int
    scenarios: int
    mesh: Mesh

    def round(self, x0, us0, q_goals):
        R, S, n_max = len(self.solvers), self.scenarios, self.n_max
        if tuple(x0.shape) != (R, S, 2 * n_max):
            raise ValueError(f"x0 must be ({R}, {S}, {2 * n_max}), got {tuple(x0.shape)}")
        us_out, costs, fleet_means = [], [], []
        for r, (solver, n_r) in enumerate(zip(self.solvers, self.dofs)):
            x0_r = torch.cat([x0[r, :, :n_r], x0[r, :, n_max : n_max + n_r]], dim=-1)
            us_r, _, cost_r, fleet_r = solver.solve(x0_r, us0[r, :, :, :n_r], q_goals[r, :, :n_r])
            us_out.append(torch.nn.functional.pad(us_r, (0, n_max - n_r)))
            costs.append(cost_r)
            fleet_means.append(fleet_r)
        return torch.stack(us_out), torch.stack(costs), torch.stack(fleet_means).mean()


def build_fleet_fused_mpc(
    fleet: Fleet,
    mesh: Mesh,
    scenarios: int,
    horizon: int,
    dt: float,
    *,
    axis_name: str = SCENARIO_AXIS,
    dofs: Optional[Tuple[int, ...]] = None,
    **solver_kw,
) -> FleetFusedMPC:
    """One sharded fused solver a fleet robot (reuse the handle across
    rounds; goals are run-time arguments). ``dofs`` overrides each robot's
    true DoF (default: from the fleet mask)."""
    R = fleet.num_robots
    if dofs is None:
        dofs = tuple(int(m) for m in fleet.mask.sum(dim=1).round().tolist())
    solvers = []
    for r in range(R):
        model_r = unpad_robot(fleet.robot(r)[0], dofs[r])
        solvers.append(build_sharded_batch_mpc(
            model_r, mesh, np.zeros((scenarios, dofs[r]), dtype=np.float32), scenarios, horizon, dt,
            axis_name=axis_name, **solver_kw,
        ))
    return FleetFusedMPC(solvers=tuple(solvers), dofs=tuple(dofs), n_max=fleet.num_joints,
                         horizon=int(horizon), scenarios=int(scenarios), mesh=mesh)
