"""Fleet MPC: heterogeneous robots x scenarios over the device mesh.

Counterpart of ``manipulapy_tpu/parallel/fleet.py``. A fleet pads every
robot to the fleet's largest joint count with exact no-op joints: a zero
screw axis exponentiates to the identity, a zero spatial inertia adds
nothing to RNEA or the mass matrix, and repeating the last CoM home frame
makes the padded link-to-link transforms the identity. Only the mass-matrix
solve needs care (its padded block is zero): :func:`masked_forward_dynamics`
puts ``diag(1 - mask)`` there, which is exact because the padded block is
decoupled from the real one.

JAX nests ``vmap`` over robots and scenarios around the generic ``ilqr``.
Here the robots are a Python loop (R is small, and each robot keeps its own
model) and the scenarios a ``torch.func.vmap`` of the port's ``ilqr``, whose
iterations are branchless. Rollouts batch over scenarios natively. The
mesh splits the scenario axis; the fleet cost is the mean of the
per-device means, gathered on the first device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from ..dynamics import mass_matrix, rnea
from ..models.robot import HOST_ARRAY_KEYS, RobotModel, from_host_arrays, host_arrays
from ..mpc.costs import make_tracking_costs
from ..mpc.ilqr import ILQRParams, ILQRResult, ilqr
from ..ops.smallinalg import solve_spd_small
from .mesh import SCENARIO_AXIS, Mesh, scenario_sharding

__all__ = [
    "Fleet",
    "stack_models",
    "masked_forward_dynamics",
    "make_masked_step_fn",
    "fleet_rollout",
    "fleet_ilqr_solve",
    "fleet_mpc_round",
]


class Fleet(NamedTuple):
    """A stack of robots as one batched model.

    Attributes:
        model: :class:`RobotModel` whose fields have a leading (R,) robot
            axis; each robot is padded to the fleet DoF ``n_max``.
        mask: (R, n_max) float mask, 1.0 for real joints, 0.0 for padding.
        robots: the R padded robots as models of their own, each with its
            f64 source arrays (so code generated from a robot is the same
            code as from the robot before padding).
    """

    model: RobotModel
    mask: torch.Tensor
    robots: Tuple[RobotModel, ...] = ()

    @property
    def num_robots(self) -> int:
        return self.mask.shape[0]

    @property
    def num_joints(self) -> int:
        return self.mask.shape[1]

    def robot(self, r: int) -> Tuple[RobotModel, torch.Tensor]:
        """The r-th padded robot and its joint mask."""
        if self.robots:
            return self.robots[r], self.mask[r]
        fields = {f.name: getattr(self.model, f.name)[r] for f in dataclasses.fields(RobotModel)}
        return RobotModel(**fields), self.mask[r]

    def to(self, device) -> "Fleet":
        return Fleet(self.model.to(device), self.mask.to(device), tuple(m.to(device) for m in self.robots))


def _f64_arrays(model: RobotModel) -> dict:
    """The model's f64 source arrays, or its tensors read back."""
    host = host_arrays(model)
    if host is not None:
        return {k: host[k] for k in HOST_ARRAY_KEYS}
    return {k: getattr(model, k).detach().cpu().double().numpy() for k in HOST_ARRAY_KEYS}


def _pad_model(model: RobotModel, n_max: int) -> RobotModel:
    """Zero-pad a robot to ``n_max`` joints with exact no-op joints."""
    n = model.num_joints
    pad = n_max - n
    if pad == 0:
        return model
    a = _f64_arrays(model)

    def pad_rows(x, fill=0.0):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill)])

    # Repeating the last CoM home frame makes the padded RNEA link-to-link
    # transforms Mc_{k-1}^-1 Mc_k = I, so velocities and wrenches pass through.
    last_com = a["com_home"][-1:] if n > 0 else np.eye(4)[None]
    padded = {k: pad_rows(a[k]) for k in ("screws_space", "screws_body", "inertias", "joint_lower",
                                          "joint_upper", "velocity_limit", "torque_limit")}
    padded.update(home=a["home"], com_home=np.concatenate([a["com_home"], np.repeat(last_com, pad, axis=0)]))
    return from_host_arrays(padded, dtype=model.dtype, device=model.device)


def stack_models(models: Sequence[RobotModel], pad_to: Optional[int] = None) -> Fleet:
    """Stack heterogeneous robots (one dtype, one device) into one batched,
    padded model; ``pad_to`` defaults to the largest DoF."""
    if not models:
        raise ValueError("need at least one robot")
    n_max = pad_to if pad_to is not None else max(m.num_joints for m in models)
    if any(m.num_joints > n_max for m in models):
        raise ValueError(f"a robot exceeds pad_to={n_max} joints")
    padded = tuple(_pad_model(m, n_max) for m in models)
    stacked = RobotModel(**{
        f.name: torch.stack([getattr(m, f.name) for m in padded]) for f in dataclasses.fields(RobotModel)
    })
    mask = torch.stack([
        torch.cat([torch.ones(m.num_joints, dtype=stacked.dtype, device=stacked.device),
                   torch.zeros(n_max - m.num_joints, dtype=stacked.dtype, device=stacked.device)])
        for m in models
    ])
    return Fleet(model=stacked, mask=mask, robots=padded)


def masked_forward_dynamics(model: RobotModel, mask, q, dq, tau, g=None) -> torch.Tensor:
    """Forward dynamics of one padded robot over (..., n_max) states.

    The padded block of M(q) is zero (zero screws and inertias decouple
    it), so adding ``diag(1 - mask)`` makes M SPD again without touching the
    real block; the padded accelerations come out exactly zero because
    their right-hand side is zero."""
    rhs = (tau - rnea(model, q, dq, torch.zeros_like(q), g=g)) * mask
    M = mass_matrix(model, q)
    M = M * (mask[:, None] * mask[None, :]) + torch.diag(1.0 - mask)
    return solve_spd_small(M, rhs) * mask


def make_masked_step_fn(dt: float, g=None) -> Callable:
    """Discrete dynamics ``x' = f(model, mask, x, u)`` of a padded robot
    over (..., 2 n_max) states: semi-implicit Euler, the positions clamped
    to the joint limits (the fleet twin of ``mpc.ilqr.make_step_fn``)."""

    def step(model: RobotModel, mask, x, u):
        n = mask.shape[-1]
        q, dq = x[..., :n], x[..., n:]
        ddq = masked_forward_dynamics(model, mask, q, dq, u, g)
        dq_new = dq + ddq * dt
        q_new = torch.minimum(torch.maximum(q + dq_new * dt, model.joint_lower), model.joint_upper)
        return torch.cat([q_new, dq_new], dim=-1)

    return step


def fleet_rollout(fleet: Fleet, q0, dq0, taus, *, dt: float = 0.01, g=None):
    """Batched rollouts for every robot x scenario: q0, dq0 (R, S, n_max),
    taus (R, S, N, n_max) -> (q_traj, dq_traj), each (R, S, N, n_max); row t
    is the state after step t."""
    step = make_masked_step_fn(dt, g)
    n = fleet.num_joints
    qs, dqs = [], []
    for r in range(fleet.num_robots):
        model, mask = fleet.robot(r)
        x = torch.cat([q0[r], dq0[r]], dim=-1)
        xs = []
        for t in range(taus.shape[2]):
            x = step(model, mask, x, taus[r, :, t])
            xs.append(x)
        xs = torch.stack(xs, dim=1)
        qs.append(xs[..., :n])
        dqs.append(xs[..., n:])
    return torch.stack(qs), torch.stack(dqs)


def _solve_one(model, mask, x0_i, us_i, qg_i, params: ILQRParams, g=None) -> ILQRResult:
    step_fn = make_masked_step_fn(params.dt, g)

    def step(x, u):
        return step_fn(model, mask, x, u)

    running, terminal = make_tracking_costs(model, qg_i)
    return ilqr(step, running, terminal, x0_i, us_i, params,
                u_min=-model.torque_limit, u_max=model.torque_limit)


def fleet_ilqr_solve(fleet: Fleet, x0, us0, q_goals, params: ILQRParams, g=None) -> ILQRResult:
    """Solve every (robot, scenario) MPC problem: a loop over the robots,
    ``torch.func.vmap`` of the generic iLQR over the scenarios.

    Args:
        x0: (R, S, 2 n_max) initial states.
        us0: (R, S, H, n_max) warm-start controls.
        q_goals: (R, S, n_max) joint-space goals (padded entries 0).

    Returns:
        :class:`ILQRResult` with leading (R, S) axes. Padded controls come
        out exactly zero (their torque limits are 0).
    """
    results = []
    for r in range(fleet.num_robots):
        model, mask = fleet.robot(r)
        solve = vmap(lambda x0_i, us_i, qg_i: _solve_one(model, mask, x0_i, us_i, qg_i, params, g))
        results.append(solve(x0[r], us0[r], q_goals[r]))
    return ILQRResult(*(torch.stack(f) for f in zip(*results)))


def fleet_mpc_round(
    fleet: Fleet,
    mesh: Mesh,
    x0,
    us0,
    q_goals,
    params: ILQRParams,
    g=None,
    axis_name: str = SCENARIO_AXIS,
    solver: str = "ilqr",
    fused_mpc=None,
):
    """One distributed fleet-MPC round: the scenario axis split over the
    mesh, the robots replicated, the fleet cost the mean of the per-device
    mean costs. S must be a multiple of the mesh size.

    ``solver``: ``"ilqr"`` (the generic iLQR, any robot mix) or
    ``"fused_batch"`` (the batched fused solver, kernels K2-K5, one solver
    a robot; pass a prebuilt ``fused_mpc`` from
    :func:`~manipulapy_tpu_torch.parallel.fused_fleet.build_fleet_fused_mpc`
    to reuse its builds across rounds).

    Returns:
        (us (R, S, H, n_max), costs (R, S), fleet_cost scalar).
    """
    S = x0.shape[1]
    if S % mesh.size != 0:
        # Checked before the solver branch, so the fused path fails here too.
        raise ValueError(f"scenario count {S} must be divisible by the mesh size {mesh.size}")
    if solver == "fused_batch":
        from .fused_fleet import build_fleet_fused_mpc

        if fused_mpc is not None:
            if fused_mpc.horizon != params.horizon or fused_mpc.scenarios != S:
                raise ValueError(
                    f"prebuilt fused_mpc (H={fused_mpc.horizon}, S={fused_mpc.scenarios}) does not match "
                    f"params/call (H={params.horizon}, S={S})"
                )
        else:
            fused_mpc = build_fleet_fused_mpc(
                fleet, mesh, S, params.horizon, params.dt, axis_name=axis_name,
                iterations=params.iterations, line_search_steps=params.line_search_steps,
                reg=params.reg_init, g=g if g is not None else (0.0, 0.0, -9.81),
            )
        return fused_mpc.round(x0, us0, q_goals)
    if solver != "ilqr":
        raise ValueError(f"unknown solver {solver!r} (use 'ilqr' or 'fused_batch')")

    us, costs, means = [], [], []
    for d, rows in scenario_sharding(mesh, S):
        res = fleet_ilqr_solve(fleet.to(d), x0[:, rows].to(d), us0[:, rows].to(d), q_goals[:, rows].to(d),
                               params, g)
        us.append(res.us)
        costs.append(res.cost)
        means.append(res.cost.mean())
    first = mesh.devices[0]
    fleet_cost = torch.stack([m.to(first) for m in means]).mean()
    return (torch.cat([u.to(first) for u in us], dim=1), torch.cat([c.to(first) for c in costs], dim=1),
            fleet_cost)
