"""Controllers as pure step functions with explicit state, on tensors.

Counterpart of ``manipulapy_tpu/control.py``. Every controller is a
function ``(inputs, state) -> (tau, state)`` with the integral or estimator
state passed explicitly, and takes joint vectors of shape (..., n): leading
dimensions are a batch of robots or scenarios (where the JAX functions are
batched with ``vmap``). Gains are scalars or (n,) tensors. The clamps are
``maximum`` then ``minimum``, so the derivative on a limit is 0.5, as
``jnp.clip``'s.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import torch

from .core.lie import _matvec
from .dynamics import bias_forces, forward_dynamics_fast, mass_matrix, rnea
from .kinematics import forward_kinematics, jacobian
from .models.robot import RobotModel

logger = logging.getLogger(__name__)

__all__ = [
    "ControlState",
    "KalmanState",
    "computed_torque_control",
    "pd_control",
    "pid_control",
    "robust_control",
    "adaptive_control",
    "feedforward_control",
    "pd_feedforward_control",
    "joint_space_control",
    "cartesian_space_control",
    "kalman_filter_predict",
    "kalman_filter_update",
    "kalman_filter_control",
    "enforce_limits",
    "ziegler_nichols_tuning",
    "tune_controller",
    "find_ultimate_gain_and_period",
    "step_response_metrics",
]


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    as_t = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, as_t(lo)), as_t(hi))


class ControlState(NamedTuple):
    """Integrator state threaded through control steps."""

    eint: torch.Tensor  # integral of the position error, (..., n)

    @classmethod
    def zero(cls, n: int, dtype=torch.float32, device="cuda") -> "ControlState":
        return cls(eint=torch.zeros(n, dtype=dtype, device=device))


class KalmanState(NamedTuple):
    """Kalman filter state: the estimate [q; dq] (..., 2n) and its
    covariance (..., 2n, 2n)."""

    x_hat: torch.Tensor
    P: torch.Tensor

    @classmethod
    def initial(cls, q: torch.Tensor, dq: torch.Tensor, p0: float = 1.0) -> "KalmanState":
        x = torch.cat([q, dq], dim=-1)
        eye = torch.eye(x.shape[-1], dtype=q.dtype, device=q.device)
        return cls(x_hat=x, P=(eye * p0).expand(x.shape[:-1] + eye.shape))


def _integrate_error(state: ControlState, e: torch.Tensor, dt, i_clamp=None) -> ControlState:
    """``eint += e dt`` with an optional anti-windup clamp."""
    eint = state.eint + e * dt
    if i_clamp is not None:
        eint = _clip(eint, -i_clamp, i_clamp)
    return ControlState(eint=eint)


def computed_torque_control(
    model: RobotModel,
    thetalistd,
    dthetalistd,
    ddthetalistd,
    thetalist,
    dthetalist,
    g,
    dt,
    Kp,
    Ki,
    Kd,
    state: ControlState,
    i_clamp=None,
) -> Tuple[torch.Tensor, ControlState]:
    """``tau = M (Kp e + Ki int(e) + Kd de) + invdyn(q, dq, ddq_d)``."""
    e = thetalistd - thetalist
    edot = dthetalistd - dthetalist
    state = _integrate_error(state, e, dt, i_clamp)
    M = mass_matrix(model, thetalist)
    v = Kp * e + Ki * state.eint + Kd * edot
    tau_ff = rnea(model, thetalist, dthetalist, ddthetalistd, g=g)
    return _matvec(M, v) + tau_ff, state


def pd_control(desired_position, desired_velocity, current_position, current_velocity, Kp, Kd):
    """Elementwise PD law."""
    return Kp * (desired_position - current_position) + Kd * (desired_velocity - current_velocity)


def pid_control(
    thetalistd, dthetalistd, thetalist, dthetalist, dt, Kp, Ki, Kd, state: ControlState, i_clamp=None
) -> Tuple[torch.Tensor, ControlState]:
    """Elementwise PID with the integral state passed explicitly."""
    e = thetalistd - thetalist
    state = _integrate_error(state, e, dt, i_clamp)
    tau = Kp * e + Ki * state.eint + Kd * (dthetalistd - dthetalist)
    return tau, state


def robust_control(
    model: RobotModel, thetalist, dthetalist, ddthetalist, g, Ftip, disturbance_estimate, adaptation_gain
) -> torch.Tensor:
    """``tau = M ddq + h + J^T F + k_adapt * disturbance``."""
    tau = _matvec(mass_matrix(model, thetalist), ddthetalist)
    tau = tau + bias_forces(model, thetalist, dthetalist, g)
    tau = tau + _matvec(jacobian(model, thetalist).mT, Ftip)
    return tau + adaptation_gain * disturbance_estimate


def adaptive_control(
    model: RobotModel,
    thetalist,
    dthetalist,
    ddthetalist,
    g,
    Ftip,
    measurement_error,
    adaptation_gain,
    parameter_estimate,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient parameter adaptation added to the computed torque; returns
    (tau, new parameter estimate)."""
    parameter_estimate = parameter_estimate + adaptation_gain * measurement_error
    tau = rnea(model, thetalist, dthetalist, ddthetalist, g=g, f_tip=Ftip)
    return tau + parameter_estimate, parameter_estimate


def feedforward_control(model: RobotModel, thetalistd, dthetalistd, ddthetalistd, g, Ftip) -> torch.Tensor:
    """Inverse-dynamics feedforward along the desired trajectory."""
    return rnea(model, thetalistd, dthetalistd, ddthetalistd, g=g, f_tip=Ftip)


def pd_feedforward_control(
    model: RobotModel, thetalistd, dthetalistd, ddthetalistd, thetalist, dthetalist, g, Ftip, Kp, Kd
) -> torch.Tensor:
    """Feedforward plus PD feedback."""
    tau_ff = feedforward_control(model, thetalistd, dthetalistd, ddthetalistd, g, Ftip)
    return tau_ff + pd_control(thetalistd, dthetalistd, thetalist, dthetalist, Kp, Kd)


def joint_space_control(model: RobotModel, thetalistd, thetalist, dthetalist, Kp, Kd) -> torch.Tensor:
    """Joint-space PD toward a setpoint."""
    return Kp * (thetalistd - thetalist) - Kd * dthetalist


def cartesian_space_control(model: RobotModel, p_desired, thetalist, dthetalist, Kp, Kd) -> torch.Tensor:
    """Task-space PD through the linear Jacobian:
    ``tau = J_v^T (Kp (p_d - p) - Kd J_v dq)``."""
    T = forward_kinematics(model, thetalist)
    J_v = jacobian(model, thetalist)[..., 3:, :]  # linear rows of [omega; v]
    p_err = p_desired - T[..., :3, 3]
    return _matvec(J_v.mT, Kp * p_err - Kd * _matvec(J_v, dthetalist))


# -- Kalman filtering ----------------------------------------------------------


def kalman_filter_predict(model: RobotModel, state: KalmanState, taulist, g, Ftip, dt, Q) -> KalmanState:
    """Predict: one explicit Euler step of the forward dynamics on the
    estimate; ``P += Q`` (the state transition is taken as the identity)."""
    n = model.num_joints
    q, dq = state.x_hat[..., :n], state.x_hat[..., n:]
    ddq = forward_dynamics_fast(model, q, dq, taulist, g, Ftip)
    x_pred = torch.cat([q + dq * dt, dq + ddq * dt], dim=-1)
    return KalmanState(x_hat=x_pred, P=state.P + Q)


def kalman_filter_update(state: KalmanState, z, R) -> KalmanState:
    """Update with H = I. The innovation covariance S = P + R is symmetric
    positive definite, so the gain comes from a Cholesky solve:
    ``K = P S^-1``, that is ``S K^T = P^T``."""
    P = state.P
    L = torch.linalg.cholesky(P + R)
    K = torch.cholesky_solve(P.mT, L).mT
    x_new = state.x_hat + _matvec(K, z - state.x_hat)
    P_new = (torch.eye(P.shape[-1], dtype=P.dtype, device=P.device) - K) @ P
    return KalmanState(x_hat=x_new, P=P_new)


def kalman_filter_control(model: RobotModel, state: KalmanState, taulist, z, g, Ftip, dt, Q, R) -> KalmanState:
    """Predict and update in one step."""
    return kalman_filter_update(kalman_filter_predict(model, state, taulist, g, Ftip, dt, Q), z, R)


# -- Limits, tuning, metrics -------------------------------------------------


def enforce_limits(model: RobotModel, thetalist, dthetalist, tau):
    """Clip position, velocity and torque to the model's limits."""
    q = _clip(thetalist, model.joint_lower, model.joint_upper)
    dq = _clip(dthetalist, -model.velocity_limit, model.velocity_limit)
    t = _clip(tau, -model.torque_limit, model.torque_limit)
    return q, dq, t


def ziegler_nichols_tuning(Ku, Tu, kind: str = "PID", device=None):
    """Ziegler-Nichols gains from the ultimate gain and period: P -> 0.5 Ku;
    PI -> (0.45 Ku, 1.2 Ku / Tu); PID -> (0.6 Ku, 2 Kp / Tu, 0.125 Kp Tu).
    Returns (Kp, Ki, Kd) on ``device``; by default that of ``Ku`` or ``Tu``
    when one is a tensor, else the card. ``Tu`` must be positive and finite
    for PI and PID: ``Tu == 0`` is :func:`find_ultimate_gain_and_period`'s
    signal that it found no sustained oscillation. A tensor ``Tu`` is
    checked where it lies and read back once, as one flag."""
    if device is None:
        device = next((v.device for v in (Ku, Tu) if isinstance(v, torch.Tensor)), "cuda")
    Ku = torch.as_tensor(Ku, device=device)
    kind = kind.upper()
    if kind == "P":
        return 0.5 * Ku, torch.zeros_like(Ku), torch.zeros_like(Ku)
    if isinstance(Tu, torch.Tensor):
        bad = bool((~torch.isfinite(Tu) | (Tu <= 0)).any())
    else:
        bad = not (0.0 < float(Tu) < float("inf"))  # also rejects NaN
    if bad:
        raise ValueError(
            f"Tu (ultimate period) must be positive and finite, got Tu={Tu!r}. "
            "Tu == 0 typically indicates find_ultimate_gain_and_period found "
            "no sustained oscillation; check your gain sweep."
        )
    Tu = torch.as_tensor(Tu, device=device)
    if kind == "PI":
        return 0.45 * Ku, 1.2 * Ku / Tu, torch.zeros_like(Ku)
    if kind == "PID":
        Kp = 0.6 * Ku
        return Kp, 2.0 * Kp / Tu, 0.125 * Kp * Tu
    raise ValueError(f"Unknown controller kind {kind!r}; must be 'P', 'PI' or 'PID'")


def tune_controller(Ku, Tu, kind: str = "PID", n: Optional[int] = None, device=None):
    """:func:`ziegler_nichols_tuning`, logged, and broadcast to (n,) gains
    when ``n`` is given."""
    Kp, Ki, Kd = ziegler_nichols_tuning(Ku, Tu, kind, device)
    if n is not None:
        Kp, Ki, Kd = (torch.broadcast_to(k, (n,)) for k in (Kp, Ki, Kd))
    logger.info("Tuned Z-N (%s) gains\n  Kp=%s\n  Ki=%s\n  Kd=%s", kind, Kp, Ki, Kd)
    return Kp, Ki, Kd


def find_ultimate_gain_and_period(
    model: RobotModel,
    thetalist: torch.Tensor,
    desired_joint_angles: torch.Tensor,
    g,
    *,
    dt: float = 0.01,
    steps: int = 400,
    Kp_start: float = 0.5,
    Kp_growth: float = 1.1,
    num_gains: int = 30,
):
    """Gain-sweep oscillation probe: a P-controlled rollout of ``steps``
    steps (velocity damping 0.1) for all ``num_gains`` candidate gains at
    once. The ultimate gain is the smallest whose joint-0 error changes
    sign at least 4 times *and* keeps its amplitude (the peak of the
    trace's second half within an order of magnitude of the first half's);
    the period is twice the mean spacing of its zero crossings.

    Returns 0-dim (Ku, Tu); ``Tu = 0`` when no gain oscillates sustainedly
    (then Ku is the largest gain tried)."""
    dtype, device = thetalist.dtype, thetalist.device
    gains = Kp_start * (Kp_growth ** torch.arange(num_gains, dtype=dtype, device=device))
    q = thetalist.expand(num_gains, -1)
    dq = torch.zeros_like(q)
    errs = []
    for _ in range(steps):
        tau = gains[:, None] * (desired_joint_angles - q) - 0.1 * dq
        ddq = forward_dynamics_fast(model, q, dq, tau, g)
        dq = dq + ddq * dt
        q = q + dq * dt
        errs.append((desired_joint_angles - q)[:, 0])
    errs = torch.stack(errs, dim=1)  # (num_gains, steps)
    crossed = torch.diff(torch.sign(errs), dim=1).abs() > 1
    crossings = crossed.sum(dim=1)
    half = steps // 2
    amp_first = errs[:, :half].abs().amax(dim=1)
    amp_second = errs[:, half:].abs().amax(dim=1)
    sustained = amp_second >= 0.1 * torch.clamp(amp_first, min=1e-12)
    oscillates = (crossings >= 4) & sustained
    idx = torch.argmax(oscillates.to(torch.int32))  # the first True
    found = oscillates.any()
    Ku = torch.where(found, gains[idx], gains[-1])
    cross_t = crossed[idx].to(torch.int32)
    num_cross = cross_t.sum()
    # Last crossing (the first maximum of the running count) minus the first.
    span = (torch.argmax(torch.cumsum(cross_t, dim=0)) - torch.argmax(cross_t)).to(dtype) * dt
    Tu = torch.where(num_cross > 1, 2.0 * span / torch.clamp(num_cross - 1, min=1), dt * steps)
    Tu = torch.where(found, Tu, torch.zeros_like(Tu))
    return Ku, Tu


def step_response_metrics(t: torch.Tensor, y: torch.Tensor, setpoint, tol: float = 0.02) -> dict:
    """Rise time (10% to 90%), percent overshoot, settling time (the first
    entry into the ``tol`` band that is never left) and steady-state error
    of a step response ``y`` (T,) or (T, B) over times ``t`` (T,). A level
    never reached gives a NaN rise time; a trace still outside the band at
    its last sample never settled and gives a NaN settling time."""
    sp = torch.as_tensor(setpoint, dtype=y.dtype, device=y.device)
    nan = torch.full((), float("nan"), dtype=t.dtype, device=t.device)
    y0 = y[0]
    span = sp - y0
    span = torch.where(span.abs() < 1e-12, torch.ones_like(span), span)
    frac = (y - y0) / span

    def first_time(mask):
        idx = torch.argmax(mask.to(torch.int32), dim=0)
        return torch.where(mask.any(dim=0), t[idx], nan)

    rise_time = first_time(frac >= 0.9) - first_time(frac >= 0.1)
    overshoot = torch.clamp(frac.amax(dim=0) - 1.0, min=0.0) * 100.0

    err = (y - sp).abs() / span.abs()
    outside = err > tol
    last = y.shape[0] - 1
    last_outside = last - torch.argmax(torch.flip(outside, dims=(0,)).to(torch.int32), dim=0)
    settle_idx = torch.where(
        outside.any(dim=0), torch.clamp(last_outside + 1, max=last), torch.zeros_like(last_outside)
    )
    settling_time = torch.where(outside[-1], nan, t[settle_idx])
    return {
        "rise_time": rise_time,
        "percent_overshoot": overshoot,
        "settling_time": settling_time,
        "steady_state_error": (y[-1] - sp).abs(),
    }
