"""iLQR receding-horizon trajectory optimisation (the generic solver).

Counterpart of ``manipulapy_tpu/mpc/ilqr.py``: linearise the exact
dynamics along a rollout, solve the LQR subproblem with a Riccati backward
pass, line-search, repeat. Derivatives come from ``torch.func``
(``jacfwd``, ``grad``, ``hessian`` under ``vmap``), ``lax.scan`` becomes a
Python loop, and the line search rolls every alpha at once as a batch.
Controls are box-clamped in the forward pass; the first improving alpha is
taken; the Levenberg term is divided by ``reg_scale`` on an accepted step
and multiplied on a rejected one; the feedback gains of the last step whose
factorisation succeeded are carried (``Ks_prev``).

This is the parity bar of the fused batched solver
(``mpc/fused_batch.py``), not a kernel path. The position clamps are
``torch.maximum`` then ``torch.minimum``, as ``jnp.clip`` is, so the
derivative at a state exactly on a joint limit is JAX's (0.5).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..dynamics import forward_dynamics_fast
from ..models.robot import RobotModel
from ..ops.smallinalg import chol_factor_small, chol_solve_small, chol_solve_small_mat

__all__ = ["ILQRParams", "ILQRResult", "make_step_fn", "riccati_sweep", "ilqr", "mpc_step"]


class ILQRParams(NamedTuple):
    """Solver configuration. ``unroll`` is kept for the JAX signature and
    has no effect here (there is no scan to unroll). ``parallel_riccati``
    runs the associative-scan backward pass (``mpc/pscan.py``) in place of
    the sequential sweep; it bakes ``reg`` into the whole value recursion,
    so the two agree at ``reg_init`` and part once ``reg`` grows after a
    rejected step."""

    horizon: int
    dt: float
    iterations: int = 10
    line_search_steps: int = 8
    reg_init: float = 1e-6
    reg_scale: float = 10.0
    reg_max: float = 1e6
    unroll: int = 1
    parallel_riccati: bool = False


class ILQRResult(NamedTuple):
    xs: torch.Tensor  # (H+1, 2n) optimal state trajectory
    us: torch.Tensor  # (H, n) optimal controls (torques)
    cost: torch.Tensor  # scalar final cost
    gains_K: torch.Tensor  # (H, n, 2n) feedback gains for the MPC policy
    converged: torch.Tensor  # bool


def make_step_fn(model: RobotModel, dt: float, g=None, fused: bool = True) -> Callable:
    """Discrete dynamics ``x' = f(x, u)`` with state ``x = [q; dq]`` over
    (..., 2n) states: semi-implicit Euler over the exact forward dynamics,
    positions clamped to the joint limits, velocities not clamped.

    ``fused=True`` runs the emitted step program (``ops/fd_step.py``);
    ``fused=False`` the array formulation (``dynamics.forward_dynamics_fast``)."""
    n = model.num_joints
    if fused:
        from ..ops.fd_step import build_fd_step

        g_tuple = (0.0, 0.0, -9.81) if g is None else tuple(float(x) for x in g)
        fstep = build_fd_step(model, dt=dt, g=g_tuple, clip_velocity=False)

        def step(x, u):
            q_new, dq_new, _ = fstep(x[..., :n], x[..., n:], u)
            return torch.cat([q_new, dq_new], dim=-1)

        return step

    def step(x, u):
        q, dq = x[..., :n], x[..., n:]
        ddq = forward_dynamics_fast(model, q, dq, u, g)
        dq_new = dq + ddq * dt
        q_new = torch.minimum(torch.maximum(q + dq_new * dt, model.joint_lower), model.joint_upper)
        return torch.cat([q_new, dq_new], dim=-1)

    return step


def _rollout(step_fn, x0, us):
    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(step_fn(xs[-1], us[t]))
    return torch.stack(xs)


def riccati_sweep(A, B, lx, lu, lxx, luu, lux, Vx, Vxx, reg):
    """The sequential Riccati backward sweep over (H, ...) derivatives, the
    Levenberg term ``reg`` on the factorised Quu only. Returns ``(ks, Ks,
    expected improvement, every factorisation finite?)``."""
    H, n_u = B.shape[0], B.shape[-1]
    eye_u = torch.eye(n_u, dtype=B.dtype, device=B.device)
    dV = torch.zeros((), dtype=B.dtype, device=B.device)
    ok = torch.ones((), dtype=torch.bool, device=B.device)
    ks, Ks = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        A_t, B_t = A[t], B[t]
        Qx = lx[t] + A_t.T @ Vx
        Qu = lu[t] + B_t.T @ Vx
        Qxx = lxx[t] + A_t.T @ Vxx @ A_t
        Quu = luu[t] + B_t.T @ Vxx @ B_t
        Qux = lux[t] + B_t.T @ Vxx @ A_t
        # A failed factorisation (sqrt of a negative) flags divergence.
        L = chol_factor_small(Quu + reg * eye_u)
        ok = ok & torch.isfinite(torch.stack([L[i][i] for i in range(n_u)])).all()
        k_t = -chol_solve_small(L, Qu)
        K_t = -chol_solve_small_mat(L, Qux)
        Vx = Qx + K_t.T @ Quu @ k_t + K_t.T @ Qu + Qux.T @ k_t
        Vxx = Qxx + K_t.T @ Quu @ K_t + K_t.T @ Qux + Qux.T @ K_t
        Vxx = 0.5 * (Vxx + Vxx.T)
        dV = dV + k_t @ Qu + 0.5 * k_t @ (Quu @ k_t)
        ks[t], Ks[t] = k_t, K_t
    return torch.stack(ks), torch.stack(Ks), dV, ok


def ilqr(
    step_fn: Callable,
    cost_fn: Callable,
    final_cost_fn: Callable,
    x0: torch.Tensor,
    us_init: torch.Tensor,
    params: ILQRParams,
    u_min: Optional[torch.Tensor] = None,
    u_max: Optional[torch.Tensor] = None,
    linearize_step_fn: Optional[Callable] = None,
) -> ILQRResult:
    """Iterative LQR with box control limits and Levenberg regularisation.

    Args:
        step_fn: discrete dynamics ``x' = f(x, u)`` over (..., 2n) states.
        cost_fn: running cost ``l(x, u, t)`` (scalar).
        final_cost_fn: terminal cost ``lf(x)`` (scalar).
        x0: (2n,) initial state.
        us_init: (H, n) initial controls (warm start).
        params: solver configuration.
        u_min/u_max: optional (n,) control bounds, clamped in the forward
            pass.
        linearize_step_fn: a step to differentiate in place of ``step_fn``.
    """
    H = params.horizon
    dtype, device = us_init.dtype, us_init.device
    ts = torch.arange(H, device=device)
    n_u = us_init.shape[-1]
    eye_u = torch.eye(n_u, dtype=dtype, device=device)

    def clamp(u):
        if u_min is not None:
            u = torch.maximum(u, torch.as_tensor(u_min, dtype=dtype, device=device))
        if u_max is not None:
            u = torch.minimum(u, torch.as_tensor(u_max, dtype=dtype, device=device))
        return u

    lin_step = linearize_step_fn if linearize_step_fn is not None else step_fn
    fx_fn = vmap(jacfwd(lin_step, argnums=0))
    fu_fn = vmap(jacfwd(lin_step, argnums=1))
    lx_fn = vmap(grad(cost_fn, argnums=0))
    lu_fn = vmap(grad(cost_fn, argnums=1))
    lxx_fn = vmap(hessian(cost_fn, argnums=0))
    luu_fn = vmap(hessian(cost_fn, argnums=1))
    lux_fn = vmap(jacfwd(grad(cost_fn, argnums=1), argnums=0))
    run_cost_fn = vmap(cost_fn)
    alpha_cost_fn = vmap(cost_fn, in_dims=(0, 0, None))
    alpha_final_fn = vmap(final_cost_fn)

    def total_cost(xs, us):
        return torch.sum(run_cost_fn(xs[:-1], us, ts)) + final_cost_fn(xs[-1])

    def backward(xs, us, reg):
        """Riccati sweep -> (k, K, expected improvement, all factorisations
        finite?)."""
        x, u = xs[:-1], us
        # torch.func's forward mode can widen a float32 tangent to float64
        # (a 0-dim tensor times a Python float under vmap); cast back.
        A, B = fx_fn(x, u).to(dtype), fu_fn(x, u).to(dtype)
        lx, lu = lx_fn(x, u, ts), lu_fn(x, u, ts)
        lxx, luu, lux = (f(x, u, ts).to(dtype) for f in (lxx_fn, luu_fn, lux_fn))
        Vx = grad(final_cost_fn)(xs[-1])
        Vxx = hessian(final_cost_fn)(xs[-1]).to(dtype)
        if params.parallel_riccati:
            from .pscan import parallel_riccati

            return parallel_riccati(A, B, lx, lu, lxx, luu + reg * eye_u, lux, Vx, Vxx)
        return riccati_sweep(A, B, lx, lu, lxx, luu, lux, Vx, Vxx, reg)

    def forward(xs, us, ks, Ks, alphas):
        """Closed-loop rollouts of every alpha at once, with the control
        clamp; the running cost is summed inside the same loop."""
        x = xs[0].expand(alphas.shape[0], -1)
        acc = torch.zeros(alphas.shape, dtype=dtype, device=device)
        xs_new, us_new = [x], []
        for t in range(H):
            u = clamp(us[t] + alphas[:, None] * ks[t] + (x - xs[t]) @ Ks[t].T)
            x_next = step_fn(x, u)
            acc = acc + alpha_cost_fn(x, u, t).to(dtype)
            x = x_next
            xs_new.append(x)
            us_new.append(u)
        return torch.stack(xs_new, dim=1), torch.stack(us_new, dim=1), acc + alpha_final_fn(x)

    alphas = 0.5 ** torch.arange(params.line_search_steps, dtype=dtype, device=device)
    us = clamp(us_init)
    xs = _rollout(step_fn, x0, us)
    cost = total_cost(xs, us)
    reg = torch.as_tensor(params.reg_init, dtype=dtype, device=device)
    Ks_prev = torch.zeros((H, n_u, x0.shape[0]), dtype=dtype, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    for _ in range(params.iterations):
        ks, Ks, _, ok = backward(xs, us, reg)
        xs_all, us_all, costs_all = forward(xs, us, ks, Ks, alphas)
        improving = torch.isfinite(costs_all) & (costs_all < cost)
        idx = torch.argmax(improving.to(torch.int32))  # first True: alphas descend
        new_cost = costs_all[idx]
        accepted = ok & improving.any()
        reg = torch.where(
            accepted,
            torch.clamp(reg / params.reg_scale, min=1e-9),
            torch.clamp(reg * params.reg_scale, max=params.reg_max),
        )
        converged = accepted & ((cost - new_cost) < 1e-9 * (1.0 + cost))
        xs = torch.where(accepted, xs_all[idx], xs)
        us = torch.where(accepted, us_all[idx], us)
        cost = torch.where(accepted, new_cost, cost)
        Ks_prev = torch.where(ok, Ks, Ks_prev)
        done = done | converged
    return ILQRResult(xs=xs, us=us, cost=cost, gains_K=Ks_prev, converged=done)


def mpc_step(
    step_fn: Callable,
    cost_fn: Callable,
    final_cost_fn: Callable,
    x_current: torch.Tensor,
    us_warm: torch.Tensor,
    params: ILQRParams,
    **limits,
):
    """One receding-horizon MPC step: solve from the current state with a
    warm-started control sequence; return (first control, shifted warm
    start, solver result)."""
    result = ilqr(step_fn, cost_fn, final_cost_fn, x_current, us_warm, params, **limits)
    us_next = torch.cat([result.us[1:], result.us[-1:]], dim=0)
    return result.us[0], us_next, result
