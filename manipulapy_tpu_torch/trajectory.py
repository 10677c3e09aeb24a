"""Trajectory generation and trajectory-level dynamics on tensors.

Counterpart of ``manipulapy_tpu/trajectory.py``:

* :func:`joint_trajectory` and :func:`batch_joint_trajectory`: polynomial
  point-to-point joint trajectories, positions clipped to the joint limits.
  A float32 call on a CUDA device (``Tf > 0``, ``N > 1``, no input
  requiring grad) goes to the hand-written kernel K9
  (``ops/elementwise.py``), then clamps the positions in place; every other
  call (CPU, float64, autograd, degenerate ``Tf`` or ``N``) takes the
  tensor formulation over ``core.time_scaling.scaling_profile``;
* :func:`cartesian_trajectory`: straight-line Cartesian trajectories with
  the orientation on the SO(3) geodesic;
* :func:`inverse_dynamics_trajectory`: exact inverse dynamics at every
  waypoint in one batched call, torques clamped to the limits;
* :func:`forward_dynamics_trajectory`: the rollout. Calls with the default
  tip wrench go to a cached engine, the CUDA kernel for float32 (B, n)
  states on a CUDA device and the plain PyTorch step program otherwise
  (``ops/dispatch.py``); calls with ``Ftipmat``, or with inputs that
  require grad, take the generic path, which runs any dtype and leading
  batch dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .core import lie
from .core.time_scaling import scaling_profile
from .dynamics import forward_dynamics_fast, inverse_dynamics, rnea
from .models.robot import RobotModel, host_arrays
from .ops import dispatch
from .ops.fd_step import DEFAULT_G

__all__ = [
    "Trajectory",
    "joint_trajectory",
    "batch_joint_trajectory",
    "cartesian_trajectory",
    "inverse_dynamics_trajectory",
    "forward_dynamics_trajectory",
]


class Trajectory(NamedTuple):
    """(..., N, J) positions, velocities and accelerations."""

    position: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor


def joint_trajectory(
    model: RobotModel,
    theta_start: torch.Tensor,
    theta_end: torch.Tensor,
    Tf,
    N: int,
    method: int = 5,
    clip_to_limits: bool = True,
) -> Trajectory:
    """``pos = start + s (end - start)``, ``vel = s_dot delta``, ``acc =
    s_ddot delta`` over N waypoints; positions clipped to the joint limits.
    (..., J) endpoints give (..., N, J) trajectories. ``Tf`` is a number or
    a 0-dim tensor (read once, at the call, when the kernel serves it)."""
    tensors = [theta_start, theta_end] + ([Tf] if isinstance(Tf, torch.Tensor) else [])
    if clip_to_limits:
        tensors += [model.joint_lower, model.joint_upper]
    needs_grad = any(x.requires_grad for x in tensors)
    kind = dispatch.elementwise_kind(theta_start.device, theta_start.dtype, needs_grad)
    Tf_read = float(Tf) if kind == "cuda" and N > 1 else 0.0
    if Tf_read > 0.0:
        from .ops.elementwise import trajectory_kernel

        start, end = torch.broadcast_tensors(theta_start, theta_end)
        batch, J = start.shape[:-1], start.shape[-1]
        pos, vel, acc = trajectory_kernel(
            start.reshape(-1, J).contiguous(), end.reshape(-1, J).contiguous(), Tf_read, N, method
        )
        if clip_to_limits:
            torch.clamp(pos, model.joint_lower, model.joint_upper, out=pos)  # in place: pos is ours
        return Trajectory(*(x.reshape(batch + (N, J)) for x in (pos, vel, acc)))
    return _joint_trajectory_generic(model, theta_start, theta_end, Tf, N, method, clip_to_limits)


def _joint_trajectory_generic(model, theta_start, theta_end, Tf, N, method, clip_to_limits) -> Trajectory:
    """The tensor formulation: any dtype and device, autograd, degenerate
    ``Tf <= 0`` or ``N <= 1`` (zero profiles)."""
    s, s_dot, s_ddot = scaling_profile(
        Tf, N, method, dtype=theta_start.dtype, device=theta_start.device
    )
    delta = theta_end - theta_start
    pos = theta_start[..., None, :] + s[:, None] * delta[..., None, :]
    vel = s_dot[:, None] * delta[..., None, :]
    acc = s_ddot[:, None] * delta[..., None, :]
    if clip_to_limits:
        # maximum, then minimum, as jnp.clip: a tie splits the derivative
        # evenly (torch.clamp's is 1 at a bound).
        pos = torch.minimum(torch.maximum(pos, model.joint_lower), model.joint_upper)
    return Trajectory(pos, vel, acc)


def batch_joint_trajectory(
    model: RobotModel,
    theta_start: torch.Tensor,
    theta_end: torch.Tensor,
    Tf,
    N: int,
    method: int = 5,
    clip_to_limits: bool = True,
) -> Trajectory:
    """(B, J) start/end pairs -> a (B, N, J) batch; :func:`joint_trajectory`
    under the reference's name for the batched call."""
    return joint_trajectory(model, theta_start, theta_end, Tf, N, method, clip_to_limits)


def cartesian_trajectory(X_start: torch.Tensor, X_end: torch.Tensor, Tf, N: int, method: int = 5):
    """Straight-line Cartesian trajectory with SO(3) orientation blending:
    positions interpolate linearly under the time scaling, orientations
    follow the geodesic ``R(s) = R_s exp(log(R_s^T R_e) s)``.

    (..., 4, 4) poses give ``(poses (..., N, 4, 4), velocity (..., N, 3),
    acceleration (..., N, 3))``, the last two the linear profiles."""
    s, s_dot, s_ddot = scaling_profile(Tf, N, method, dtype=X_start.dtype, device=X_start.device)
    R_s, p_s = lie.trans_to_rp(X_start)
    R_e, p_e = lie.trans_to_rp(X_end)
    dp = (p_e - p_s)[..., None, :]
    pos = p_s[..., None, :] + s[:, None] * dp
    vel = s_dot[:, None] * dp
    acc = s_ddot[:, None] * dp
    log_rel = lie.so3_log(R_s.mT @ R_e)  # (..., 3) rotation vector
    R_steps = R_s[..., None, :, :] @ lie.so3_exp(s[:, None] * log_rel[..., None, :])
    return lie.rp_to_trans(R_steps, pos), vel, acc


def inverse_dynamics_trajectory(
    model: RobotModel,
    thetamat: torch.Tensor,
    dthetamat: torch.Tensor,
    ddthetamat: torch.Tensor,
    g=None,
    Ftip=None,
    use_rnea: bool = True,
) -> torch.Tensor:
    """Exact inverse dynamics at every waypoint: (..., N, J) -> (..., N, J)
    torques, clamped to the torque limits. ``use_rnea`` selects the O(n)
    Newton-Euler sweep (default) or the Lagrangian composition."""
    fn = rnea if use_rnea else inverse_dynamics
    f = None
    if Ftip is not None:
        f = torch.as_tensor(Ftip, dtype=thetamat.dtype, device=thetamat.device)
        f = torch.broadcast_to(f, thetamat.shape[:-1] + (6,))
    tau = fn(model, thetamat, dthetamat, ddthetamat, g, f)
    return torch.minimum(torch.maximum(tau, -model.torque_limit), model.torque_limit)


_ENGINE_CACHE: dict = {}
_ENGINE_CACHE_MAX = 16


def _rollout_engine_for(model, dt, intRes, g, device, dtype, batched_2d):
    """The cached rollout engine for a concrete call. Keyed by the model's
    host-array digest (``id(model)`` for unregistered models), so a rebuilt
    but identical model reuses the compiled kernel."""
    kind = dispatch.rollout_kind(device, dtype, batched_2d)
    host = host_arrays(model)
    model_key = host["digest"] if host is not None else id(model)
    key = (model_key, float(dt), int(intRes), tuple(g), kind)
    hit = _ENGINE_CACHE.get(key)
    if hit is not None:
        return hit[1]
    engine = dispatch.rollout_engine(model, dt=float(dt), intRes=int(intRes), g=tuple(g), kind=kind)
    if len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
        _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
    # Keep the model alive with its engine: its id() may be the key.
    _ENGINE_CACHE[key] = (model, engine)
    return engine


def forward_dynamics_trajectory(
    model: RobotModel,
    thetalist: torch.Tensor,
    dthetalist: torch.Tensor,
    taumat: torch.Tensor,
    g=None,
    Ftipmat=None,
    dt=0.01,
    intRes: int = 1,
):
    """Integrate forward dynamics along a torque trajectory.

    Per waypoint, ``intRes`` semi-implicit Euler substeps of ``dt /
    intRes``; positions clamped to the joint limits and velocities to the
    velocity limit after each substep. (B, J) states with (B, N, J) torques
    give (B, N, J) outputs; row t is the state at waypoint t (row 0 = the
    initial state) and the accelerations are the last substep's.

    Returns:
        (thetamat, dthetamat, ddthetamat).
    """
    if int(intRes) < 1:
        raise ValueError("intRes must be >= 1")
    tensors = [thetalist, dthetalist, taumat] + [
        getattr(model, f.name) for f in dataclasses.fields(model)
    ]
    if isinstance(g, torch.Tensor):
        tensors.append(g)
    needs_grad = any(x.requires_grad for x in tensors)
    if Ftipmat is None and not needs_grad:
        g_t = DEFAULT_G if g is None else tuple(float(x) for x in torch.as_tensor(g).flatten())
        engine = _rollout_engine_for(
            model, dt, intRes, g_t,
            device=thetalist.device,
            dtype=thetalist.dtype,
            batched_2d=thetalist.dim() == 2,
        )
        return engine(thetalist, dthetalist, taumat)
    return _forward_dynamics_trajectory_generic(
        model, thetalist, dthetalist, taumat, g, Ftipmat, dt, intRes
    )


def _forward_dynamics_trajectory_generic(
    model: RobotModel,
    thetalist: torch.Tensor,
    dthetalist: torch.Tensor,
    taumat: torch.Tensor,
    g=None,
    Ftipmat=None,
    dt=0.01,
    intRes: int = 1,
):
    """The generic path: tip wrenches, autograd, any leading batch
    dimensions and any dtype; the same step semantics as the engines."""
    sub_dt = torch.as_tensor(dt, dtype=thetalist.dtype, device=thetalist.device) / intRes
    N = taumat.shape[-2]
    F = None
    if Ftipmat is not None:
        F = torch.as_tensor(Ftipmat, dtype=thetalist.dtype, device=thetalist.device)
        F = torch.broadcast_to(F, taumat.shape[:-1] + (6,))
    q, dq = thetalist, dthetalist
    qs, dqs, ddqs = [], [], []
    for t in range(N):
        tau = taumat[..., t, :]
        f = None if F is None else F[..., t, :]
        qs.append(q)
        dqs.append(dq)
        for _ in range(intRes):
            ddq = forward_dynamics_fast(model, q, dq, tau, g, f)
            dq = dq + ddq * sub_dt
            q = q + dq * sub_dt
            q = torch.minimum(torch.maximum(q, model.joint_lower), model.joint_upper)
            dq = torch.minimum(torch.maximum(dq, -model.velocity_limit), model.velocity_limit)
        ddqs.append(ddq)
    return torch.stack(qs, dim=-2), torch.stack(dqs, dim=-2), torch.stack(ddqs, dim=-2)
