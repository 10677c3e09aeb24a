"""TRAC-IK-style dual-algorithm inverse kinematics.

Counterpart of ``manipulapy_tpu/trac_ik.py``: two algorithm families raced
over a diverse set of initial guesses, damped least squares with LM
adaptation (``ik.solve_ik_batch``) and a projected Gauss-Newton / LM solver
of the squared pose error with a batched Armijo-style line search
(:func:`sqp_ik`). Each family runs over every guess as one batched call a
round; rounds repeat with fresh random guesses until one converges or the
wall-clock ``timeout`` runs out, with one host read a round.

``sqp_ik`` is a masked loop like ``solve_ik``, and ends as it does once
every lane is done; its restarts draw a uniform
vector from a table drawn up front, ``torch.rand`` from
``torch.Generator(seed)``, or a given table (``draws``).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .ik import (
    IKResult,
    _all_done,
    _commit,
    _final_result,
    _limit_box,
    geometric_error,
    midpoint_guess,
    random_guesses,
    select_best,
    solve_ik_batch,
    workspace_heuristic_guess,
)
from .core.lie import _matvec
from .kinematics import clip_to_limits, forward_kinematics, jacobian
from .models.robot import RobotModel
from .ops.smallinalg import solve_spd_small

__all__ = ["sqp_ik", "sqp_draws", "TracIKSolver", "trac_ik_solve"]


def sqp_draws(model: RobotModel, max_iterations: int, seed: int = 0) -> torch.Tensor:
    """The ``(max_iterations, n)`` table of uniforms in [0, 1) that
    :func:`sqp_ik`'s restarts draw from, on the model's device."""
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    return torch.rand((int(max_iterations), model.num_joints), generator=gen, dtype=model.dtype,
                      device=model.device)


def _sqp_batch(
    model: RobotModel,
    T_desired: torch.Tensor,
    theta0: torch.Tensor,
    *,
    eomg: float = 1e-6,
    ev: float = 1e-6,
    max_iterations: int = 100,
    reg: float = 1e-6,
    max_stall: int = 10,
    seed: int = 0,
    draws: Optional[torch.Tensor] = None,
) -> IKResult:
    """:func:`sqp_ik` over B lanes: (B, 4, 4) or one (4, 4) target, (B, n)
    guesses."""
    dtype, device = theta0.dtype, theta0.device
    B, n = theta0.shape
    T_desired = torch.as_tensor(T_desired, dtype=dtype, device=device).expand(B, 4, 4)
    uniforms = sqp_draws(model, max_iterations, seed) if draws is None else torch.as_tensor(
        draws, dtype=dtype, device=device)
    scales = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.03], dtype=dtype, device=device)
    eye = torch.eye(n, dtype=dtype, device=device)
    lo, hi = _limit_box(model)

    def err(theta):
        return geometric_error(forward_kinematics(model, theta), T_desired)

    s = dict(theta=clip_to_limits(model, theta0), best_theta=theta0,
             best_cost=torch.full((B,), math.inf, dtype=dtype, device=device),
             reg=torch.full((B,), reg, dtype=dtype, device=device),
             stall=torch.zeros((B,), dtype=torch.int32, device=device),
             k=torch.zeros((B,), dtype=torch.int32, device=device),
             done=torch.zeros((B,), dtype=torch.bool, device=device))
    for t in range(int(max_iterations)):
        active = (s["k"] < max_iterations) & ~s["done"]
        theta = s["theta"]
        V, rot, trans = err(theta)
        cost = 0.5 * torch.sum(V * V, dim=-1)
        converged = (rot < eomg) & (trans < ev)
        improved = cost < s["best_cost"] * (1.0 - 1e-9)
        best_theta = torch.where(improved[:, None], theta, s["best_theta"])
        best_cost = torch.where(improved, cost, s["best_cost"])
        stall = torch.where(improved, 0, s["stall"] + 1)

        # LM step: (J^T J + reg I) dq = J^T V by the unrolled SPD solve.
        J = jacobian(model, theta)
        dq = solve_spd_small(J.mT @ J + s["reg"][:, None, None] * eye, _matvec(J.mT, V))
        cands = clip_to_limits(model, theta + scales[:, None, None] * dq)  # (5, B, n)
        Vs, _, _ = err(cands)
        costs = 0.5 * torch.sum(Vs * Vs, dim=-1)
        i = torch.argmin(costs, dim=0)
        step_ok = torch.gather(costs, 0, i[None])[0] < cost
        cand = torch.gather(cands, 0, i.view(1, B, 1).expand(1, B, n))[0]
        theta_next = torch.where(step_ok[:, None], cand, theta)
        reg_next = torch.where(step_ok, torch.clamp(s["reg"] * 0.5, min=1e-10),
                               torch.clamp(s["reg"] * 10.0, max=1e2))

        # Local-minimum escape: a random restart within the limits after
        # max_stall rounds without improvement.
        do_restart = stall > max_stall
        theta_next = torch.where(do_restart[:, None], lo + uniforms[t] * (hi - lo), theta_next)
        reg_next = torch.where(do_restart, reg, reg_next)
        stall = torch.where(do_restart, 0, stall)
        theta_next = torch.where(converged[:, None], theta, theta_next)
        s = _commit(active, dict(theta=theta_next, best_theta=best_theta, best_cost=best_cost, reg=reg_next,
                                 stall=stall, k=s["k"] + 1, done=converged), s)
        if _all_done(t, s["done"]):
            break

    return _final_result(model, T_desired, s["theta"], s["best_theta"], s["k"], eomg, ev)


def sqp_ik(model: RobotModel, T_desired: torch.Tensor, theta0: torch.Tensor, **kw) -> IKResult:
    """Projected Levenberg-Marquardt / Gauss-Newton on ``f(q) = 1/2
    ||V_err(q)||^2`` for one target and one (n,) guess: the analytic
    gradient ``J^T V``, joint limits by projection, five line-search scales
    in one batched FK, LM regularisation adaptation, and a random restart
    after ``max_stall`` rounds without improvement. Keywords: ``eomg``,
    ``ev``, ``max_iterations``, ``reg``, ``max_stall``, ``seed``,
    ``draws``."""
    res = _sqp_batch(model, T_desired, theta0[None], **kw)
    return IKResult(*(x[0] for x in res))


class TracIKSolver:
    """Dual-algorithm, multi-guess racing solver.

    Each ``solve`` round runs both families over the whole guess set, one
    batched call each; rounds repeat with fresh random guesses until success
    or the wall-clock ``timeout`` (checked between rounds, never inside
    one)."""

    def __init__(
        self,
        model: RobotModel,
        *,
        timeout: float = 0.1,
        eomg: float = 1e-6,
        ev: float = 1e-6,
        num_guesses: int = 8,
        dls_iterations: int = 100,
        sqp_iterations: int = 60,
        seed: int = 0,
    ):
        self.model = model
        self.timeout = float(timeout)
        self.eomg = float(eomg)
        self.ev = float(ev)
        self.num_guesses = int(num_guesses)
        self.dls_iterations = int(dls_iterations)
        self.sqp_iterations = int(sqp_iterations)
        self._host_rng = np.random.default_rng(seed)

    def solve_round(self, T_desired, theta0=None, seed: int = 0) -> IKResult:
        """One DLS + SQP round over the guess set: the user's guess (or the
        workspace heuristic), the midpoint, zeros, the negated midpoint and
        random guesses from ``torch.Generator(seed)``; the best result."""
        model = self.model
        f = dict(dtype=model.dtype, device=model.device)
        T_desired = torch.as_tensor(T_desired, **f)
        mid = midpoint_guess(model)
        base = torch.stack([
            torch.as_tensor(theta0, **f) if theta0 is not None else workspace_heuristic_guess(model, T_desired),
            mid, torch.zeros(model.num_joints, **f), -mid,
        ])
        num_random = max(self.num_guesses - base.shape[0], 0)
        if num_random:
            gen = torch.Generator(device=model.device).manual_seed(int(seed))
            base = torch.cat([base, random_guesses(model, gen, num_random)])
        stack = base[: self.num_guesses]
        r_dls = solve_ik_batch(model, T_desired, stack, eomg=self.eomg, ev=self.ev,
                               max_iterations=self.dls_iterations)
        r_sqp = _sqp_batch(model, T_desired, stack, eomg=self.eomg, ev=self.ev,
                           max_iterations=self.sqp_iterations)
        return select_best(IKResult(*(torch.cat([a, b]) for a, b in zip(r_dls, r_sqp))))

    def solve(self, T_desired, theta0=None) -> IKResult:
        deadline = time.monotonic() + self.timeout
        best, best_err = None, float("inf")
        while True:
            round_seed = int(self._host_rng.integers(2**31 - 1))
            res = self.solve_round(T_desired, theta0, seed=round_seed)
            # One host read a round: success and the two errors together.
            ok, rot_e, trans_e = torch.stack(
                [res.success.to(res.rot_err.dtype), res.rot_err, res.trans_err]).tolist()
            err = rot_e + trans_e
            if ok:
                # This round's converged result, never a lower-error failure
                # of an earlier round.
                return res
            if best is None or err < best_err:
                best, best_err = res, err
            if time.monotonic() >= deadline:
                return best
            theta0 = None  # later rounds re-randomize fully


def trac_ik_solve(model: RobotModel, T_desired, theta0=None, **kwargs) -> IKResult:
    """One-shot convenience wrapper."""
    return TracIKSolver(model, **kwargs).solve(T_desired, theta0)
