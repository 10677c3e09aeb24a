"""Batched inverse kinematics: damped least squares as a masked loop.

Counterpart of ``manipulapy_tpu/ik.py``. JAX's ``lax.while_loop`` (under
``vmap`` for a batch) becomes one Python loop of at most ``max_iterations``
rounds of tensor operations over every lane at once:

* a lane is active while ``k < max_iterations`` and it has not converged;
  an active lane commits the round's new state, an inactive one keeps its
  state bit for bit, as ``vmap`` of ``while_loop`` does;
* ``done`` is the convergence seen at the start of a round, and that round
  leaves θ as it is, so ``iterations`` counts it, as in JAX;
* the host reads ``done.all()`` once every :data:`DONE_CHECK_EVERY` rounds
  and leaves the loop when every lane is done, as ``vmap`` of
  ``while_loop`` stops; the rounds it skips would change no lane, so every
  lane's result is the same bit for bit;
* the reference's adaptations (best-solution tracking, stall restarts, LM
  damping and step-cap updates, multi-scale backtracking) are branchless
  ``where`` updates; backtracking evaluates its five scales in one batched
  FK and takes the first minimum.

The random draws: JAX's ``solve_ik`` splits a key chain that depends only
on ``seed`` and the round, so every lane of a batch draws the same normal
and uniform vectors in round k. The port draws that whole
``(max_iterations, n)`` table up front from a ``torch.Generator`` seeded
with ``seed`` (:func:`ik_draws`), or takes a given table (``draws``). Its
default stream is not JAX's threefry stream, so restarts perturb by other
vectors than JAX's; fed JAX's table, the port follows JAX's lanes.
Everything runs on the device of the model and the inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .core import lie
from .core.lie import _matvec
from .kinematics import clip_to_limits, forward_kinematics, jacobian
from .models.robot import RobotModel
from .ops.smallinalg import solve_spd_small

__all__ = [
    "IKResult",
    "geometric_error",
    "dls_solve",
    "dls_solve_svd",
    "ik_draws",
    "solve_ik",
    "solve_ik_batch",
    "multi_start_ik",
    "freeze_solve_kw",
    "select_best",
    "workspace_heuristic_guess",
    "extrapolate_guess",
    "random_guesses",
    "midpoint_guess",
]


class IKResult(NamedTuple):
    """Solution bundle; each field has the lanes' leading shape."""

    theta: torch.Tensor
    success: torch.Tensor
    iterations: torch.Tensor
    rot_err: torch.Tensor
    trans_err: torch.Tensor


def geometric_error(T_current: torch.Tensor, T_target: torch.Tensor):
    """6D geometric error ``[omega_space; dp]`` and its (rot, trans) norms:
    the axis-angle of ``R_c^T R_t`` rotated into the space frame, and the
    position error in the space frame."""
    pos_err = T_target[..., :3, 3] - T_current[..., :3, 3]
    R_c = T_current[..., :3, :3]
    omega_space = _matvec(R_c, lie.so3_log(R_c.mT @ T_target[..., :3, :3]))
    V_err = torch.cat([omega_space, pos_err], dim=-1)
    return V_err, torch.linalg.norm(omega_space, dim=-1), torch.linalg.norm(pos_err, dim=-1)


def dls_solve(J: torch.Tensor, V_err: torch.Tensor, damping) -> torch.Tensor:
    """Damped least-squares step ``J^T (J J^T + l^2 I)^{-1} V`` over (..., 6,
    n) Jacobians, the SVD form's operator computed by the unrolled SPD
    solve; ``damping`` is a number or a (...,) tensor."""
    m = J.shape[-2]
    d = torch.as_tensor(damping, dtype=J.dtype, device=J.device)
    eye = torch.eye(m, dtype=J.dtype, device=J.device)
    JJt = J @ J.mT + (d * d + 1e-12)[..., None, None] * eye
    return _matvec(J.mT, solve_spd_small(JJt, V_err))


def dls_solve_svd(J: torch.Tensor, V_err: torch.Tensor, damping) -> torch.Tensor:
    """The same step through an explicit SVD."""
    U, s, Vh = torch.linalg.svd(J, full_matrices=False)
    d = torch.as_tensor(damping, dtype=J.dtype, device=J.device)
    s_damped = s / (s * s + (d * d)[..., None] + 1e-12)
    return _matvec(Vh.mT, s_damped * _matvec(U.mT, V_err))


def ik_draws(model: RobotModel, max_iterations: int, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(max_iterations, n)`` tables of standard normals and of
    uniforms in [0, 1) that :func:`solve_ik` draws from, round k taking row
    k, on the model's device from ``torch.Generator(seed)``."""
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    shape = (int(max_iterations), model.num_joints)
    kw = dict(generator=gen, dtype=model.dtype, device=model.device)
    return torch.randn(shape, **kw), torch.rand(shape, **kw)


def _limit_box(model: RobotModel):
    """The joint limits, unbounded joints taken as [-pi, pi]."""
    lo = torch.where(torch.isfinite(model.joint_lower), model.joint_lower, -math.pi)
    hi = torch.where(torch.isfinite(model.joint_upper), model.joint_upper, math.pi)
    return lo, hi


def _final_result(model, T_desired, theta, best_theta, iterations, eomg, ev) -> IKResult:
    """The last evaluation: fall back to the tracked best where it is
    better."""
    _, rot, trans = geometric_error(forward_kinematics(model, torch.stack([theta, best_theta])), T_desired)
    use_best = (rot[1] + trans[1]) < (rot[0] + trans[0])
    theta_out = torch.where(use_best[..., None], best_theta, theta)
    rot_out = torch.where(use_best, rot[1], rot[0])
    trans_out = torch.where(use_best, trans[1], trans[0])
    return IKResult(theta_out, (rot_out < eomg) & (trans_out < ev), iterations, rot_out, trans_out)


DONE_CHECK_EVERY = 8  # rounds between the host's reads of "every lane is done"


def _all_done(t: int, done: torch.Tensor) -> bool:
    """After round ``t``: every lane is done (read on the host, once every
    :data:`DONE_CHECK_EVERY` rounds)."""
    return (t + 1) % DONE_CHECK_EVERY == 0 and bool(done.all())


def _commit(active: torch.Tensor, new: dict, old: dict) -> dict:
    """A lane that is not active keeps its state."""
    return {k: torch.where(active.view(active.shape + (1,) * (v.dim() - active.dim())), v, old[k])
            for k, v in new.items()}


def _solve_lanes(
    model: RobotModel,
    T_desired: torch.Tensor,  # (B, 4, 4)
    theta0: torch.Tensor,  # (B, n)
    *,
    eomg: float,
    ev: float,
    max_iterations: int,
    damping: torch.Tensor,  # (B,)
    step_cap: torch.Tensor,  # (B,)
    min_damping: float,
    max_damping: float,
    max_stall: int,
    perturb_scale: float,
    weight_position: float,
    weight_orientation: float,
    backtracking: bool,
    adaptive: bool,
    draws: Tuple[torch.Tensor, torch.Tensor],
) -> IKResult:
    """The DLS loop over B independent lanes (the body of JAX's
    ``solve_ik``, vmapped)."""
    dtype, device = theta0.dtype, theta0.device
    B, n = theta0.shape
    normals, uniforms = draws
    scales = torch.tensor([1.0, 0.5, 0.25, 0.125, 0.75], dtype=dtype, device=device)
    weights = torch.tensor([weight_orientation] * 3 + [weight_position] * 3, dtype=dtype, device=device)
    lo, hi = _limit_box(model)
    inf = torch.full((B,), math.inf, dtype=dtype, device=device)
    zeros_i = torch.zeros((B,), dtype=torch.int32, device=device)
    s = dict(theta=theta0, best_theta=theta0, best_error=inf, attempt_best=inf, prev_error=inf,
             damping=damping, step_cap=step_cap, nu=torch.full((B,), 2.0, dtype=dtype, device=device),
             stall=zeros_i, restarts=zeros_i, k=zeros_i, done=torch.zeros((B,), dtype=torch.bool, device=device))

    def error_of(theta):
        return geometric_error(forward_kinematics(model, theta), T_desired)

    for t in range(max_iterations):
        active = (s["k"] < max_iterations) & ~s["done"]
        theta = s["theta"]
        V_err, rot_err, trans_err = error_of(theta)
        current = rot_err + trans_err
        converged = (rot_err < eomg) & (trans_err < ev)

        improved = current < s["best_error"]
        best_theta = torch.where(improved[:, None], theta, s["best_theta"])
        best_error = torch.where(improved, current, s["best_error"])
        # Stall counts against this attempt's best, not the global best.
        improved_attempt = current < s["attempt_best"]
        attempt_best = torch.where(improved_attempt, current, s["attempt_best"])
        stall = torch.where(improved_attempt, 0, s["stall"] + 1)

        # Restarts alternate between a nudge around the best solution and a
        # full random re-seed within the limits.
        nudged = clip_to_limits(model, best_theta + perturb_scale * normals[t])
        reseeded = lo + uniforms[t] * (hi - lo)
        perturbed = torch.where((s["restarts"] % 2 == 0)[:, None], nudged, reseeded)
        do_perturb = stall > max_stall
        stall = torch.where(do_perturb, 0, stall)
        attempt_best = torch.where(do_perturb, math.inf, attempt_best)
        restarts = torch.where(do_perturb, s["restarts"] + 1, s["restarts"])

        # LM damping / step-cap adaptation.
        prev, damp, cap, nu = s["prev_error"], s["damping"], s["step_cap"], s["nu"]
        if adaptive:
            good = current < prev * 0.75
            modest = ~good & (current < prev * 0.95)
            worse = current > prev
            damping_new = torch.where(
                good, torch.clamp(damp / 3.0, min=min_damping),
                torch.where(modest, torch.clamp(damp / 1.5, min=min_damping),
                            torch.where(worse, torch.clamp(damp * nu, max=max_damping), damp)))
            step_cap_new = torch.where(
                good, torch.minimum(step_cap * 1.5, cap * 1.2),
                torch.where(worse, torch.clamp(cap * 0.7, min=0.05), cap))
            nu_new = torch.where(good, 2.0, torch.where(worse, torch.clamp(nu * 1.5, max=8.0), nu))
        else:
            damping_new, step_cap_new, nu_new = damp, cap, nu
        damping_new = torch.where(do_perturb, damping, damping_new)
        nu_new = torch.where(do_perturb, 2.0, nu_new)

        # DLS step on the weighted error, capped in norm.
        delta = dls_solve(jacobian(model, theta), V_err * weights, damping_new)
        norm_delta = torch.linalg.norm(delta, dim=-1, keepdim=True)
        cap_col = step_cap_new[:, None]
        delta = torch.where(norm_delta > cap_col, delta * (cap_col / (norm_delta + 1e-12)), delta)

        if backtracking:
            candidates = clip_to_limits(model, theta + scales[:, None, None] * delta)  # (5, B, n)
            _, rots, transs = error_of(candidates)
            errs = rots + transs
            i_best = torch.argmin(errs, dim=0)  # the first minimum, NaN winning as in NumPy
            cand_best = torch.gather(candidates, 0, i_best.view(1, B, 1).expand(1, B, n))[0]
            err_best = torch.gather(errs, 0, i_best[None])[0]
            accept = err_best < current * 1.1
            theta_next = torch.where(accept[:, None], cand_best, clip_to_limits(model, theta + 0.1 * delta))
        else:
            theta_next = clip_to_limits(model, theta + delta)
        theta_next = torch.where(do_perturb[:, None], perturbed, theta_next)
        theta_next = torch.where(converged[:, None], theta, theta_next)

        s = _commit(active, dict(
            theta=theta_next, best_theta=best_theta, best_error=best_error, attempt_best=attempt_best,
            prev_error=current, damping=damping_new, step_cap=step_cap_new, nu=nu_new, stall=stall,
            restarts=restarts, k=s["k"] + 1, done=converged), s)
        if _all_done(t, s["done"]):
            break

    return _final_result(model, T_desired, s["theta"], s["best_theta"], s["k"], eomg, ev)


def _lane_tensor(value, B: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=device).expand(B).clone()


def solve_ik_batch(
    model: RobotModel,
    T_desired: torch.Tensor,
    theta0: torch.Tensor,
    *,
    eomg: float = 1e-6,
    ev: float = 1e-6,
    max_iterations: int = 200,
    damping=5e-2,
    step_cap=0.5,
    min_damping: float = 1e-4,
    max_damping: float = 1.0,
    max_stall: int = 12,
    perturb_scale: float = 0.3,
    weight_position: float = 1.0,
    weight_orientation: float = 1.0,
    backtracking: bool = True,
    adaptive: bool = True,
    seed: int = 0,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> IKResult:
    """Damped-least-squares IK over B lanes: (B, 4, 4) targets (or one (4,
    4) target for every lane) and (B, n) guesses. ``damping`` and
    ``step_cap`` may be (B,) tensors, one value a lane. ``draws`` replaces
    the (normals, uniforms) table of :func:`ik_draws`."""
    B = theta0.shape[0]
    dtype, device = theta0.dtype, theta0.device
    T_desired = torch.as_tensor(T_desired, dtype=dtype, device=device).expand(B, 4, 4)
    if draws is None:
        draws = ik_draws(model, max_iterations, seed)
    return _solve_lanes(
        model, T_desired, theta0, eomg=eomg, ev=ev, max_iterations=int(max_iterations),
        damping=_lane_tensor(damping, B, dtype, device), step_cap=_lane_tensor(step_cap, B, dtype, device),
        min_damping=min_damping, max_damping=max_damping, max_stall=max_stall, perturb_scale=perturb_scale,
        weight_position=weight_position, weight_orientation=weight_orientation, backtracking=backtracking,
        adaptive=adaptive, draws=tuple(torch.as_tensor(d, dtype=dtype, device=device) for d in draws),
    )


def solve_ik(model: RobotModel, T_desired: torch.Tensor, theta0: torch.Tensor, **kw) -> IKResult:
    """Damped-least-squares IK with LM adaptation for one (4, 4) target from
    one (n,) guess; the keywords are :func:`solve_ik_batch`'s."""
    res = solve_ik_batch(model, T_desired, theta0[None], **kw)
    return IKResult(*(x[0] for x in res))


def freeze_solve_kw(kw: dict) -> tuple:
    """A ``solve_ik`` keyword dict as a sorted tuple of items."""
    return tuple(sorted(kw.items()))


def select_best(results: IKResult) -> IKResult:
    """Selection over a leading race axis: converged solutions first, then
    the smallest combined error. A diverged lane's NaN error must not win
    (``argmin`` lets a NaN win), so NaN scores are demoted to +inf."""
    combined = results.rot_err + results.trans_err
    combined = torch.where(torch.isnan(combined), math.inf, combined)
    penalty = torch.where(results.success, 0.0, 1e6)
    i = torch.argmin(combined + penalty)
    return IKResult(*(x[i] for x in results))


def multi_start_ik(
    model: RobotModel,
    T_desired: torch.Tensor,
    *,
    num_starts: int = 16,
    theta0: Optional[torch.Tensor] = None,
    seed: int = 0,
    **kw,
) -> IKResult:
    """The best of ``num_starts`` solves raced as one batch: the user's
    guess (or the workspace heuristic), the limits' midpoint, zeros, and
    random draws within the limits from ``torch.Generator(seed)``."""
    T_desired = torch.as_tensor(T_desired, dtype=model.dtype, device=model.device)
    n = model.num_joints
    guesses = [
        torch.as_tensor(theta0, dtype=model.dtype, device=model.device)[None] if theta0 is not None
        else workspace_heuristic_guess(model, T_desired)[None],
        midpoint_guess(model)[None],
        torch.zeros((1, n), dtype=model.dtype, device=model.device),
    ]
    num_random = max(num_starts - len(guesses), 0)
    if num_random:
        gen = torch.Generator(device=model.device).manual_seed(int(seed))
        guesses.append(random_guesses(model, gen, num_random))
    stack = torch.cat(guesses)[:num_starts]
    return select_best(solve_ik_batch(model, T_desired, stack, **kw))


# -- Initial-guess strategies ------------------------------------------------


def workspace_heuristic_guess(model: RobotModel, T_desired: torch.Tensor) -> torch.Tensor:
    """Point the base yaw joint at the target, the other joints at their
    limits' midpoint."""
    p = T_desired[..., :3, 3]
    guess = midpoint_guess(model).expand(p.shape[:-1] + (model.num_joints,)).clone()
    guess[..., 0] = torch.atan2(p[..., 1], p[..., 0])
    return clip_to_limits(model, guess)


def extrapolate_guess(
    model: RobotModel, q_current: torch.Tensor, T_desired: torch.Tensor, alpha: float = 1.0
) -> torch.Tensor:
    """One ``J^+`` log-error step from the current configuration."""
    V_err, _, _ = geometric_error(forward_kinematics(model, q_current), T_desired)
    dq = _matvec(torch.linalg.pinv(jacobian(model, q_current)), V_err)
    return clip_to_limits(model, q_current + alpha * dq)


def random_guesses(model: RobotModel, generator: torch.Generator, num: int) -> torch.Tensor:
    """(num, n) uniform random configurations within the limits, unbounded
    joints in [-pi, pi]; ``generator`` lives on the model's device."""
    lo, hi = _limit_box(model)
    u = torch.rand((num, model.num_joints), generator=generator, dtype=model.dtype, device=model.device)
    return lo + u * (hi - lo)


def midpoint_guess(model: RobotModel) -> torch.Tensor:
    """Midpoint of the joint limits; zero for unbounded joints."""
    lo = torch.where(torch.isfinite(model.joint_lower), model.joint_lower, 0.0)
    hi = torch.where(torch.isfinite(model.joint_upper), model.joint_upper, 0.0)
    return 0.5 * (lo + hi)
