"""Batched fused tracking MPC: one iLQR problem per scenario, B at once.

Counterpart of ``manipulapy_tpu/mpc/fused_batch.py``. Each iteration runs
three kernels (``ops/cuda_mpc_batch.py``) over every scenario:

* ``linearize`` (K2): the exact ``A_t, B_t`` of the step program along the
  nominal trajectory, all 3n tangent seeds;
* ``backward`` (K3): the Riccati sweep with a per-scenario Levenberg term;
* ``linesearch`` (K4): the closed-loop rollout of every alpha, its cost
  and its trajectory.

The solver then selects each scenario's first improving alpha from K4's
trajectories, as the JAX single-problem solver selects from its forward
kernel's; the JAX batched solver instead replays that alpha (its
``replay``, K5 here), which gives the same bits. K5 runs once a solve, for
the initial open-loop rollout. The glue between the kernels is plain tensor
ops on the device, as it is XLA in the JAX package: the alphas ``0.5 **
arange(A)``, the first improving alpha per scenario and the selection
along the alpha axis, the guard that keeps a rejected scenario's state (NaN
gains from a Quu that lost definiteness must not reach it), and the
regularisation update ``reg <- clamp(reg / 10 or reg * 10, 1e-9, 1e6)``.

The solver runs where its inputs lie: CUDA float32 inputs go through the
kernels, CPU inputs through their plain PyTorch versions. Internally the
tensors are scenario-minor (``(H, nx, B)`` and so on, see
``ops/cuda_mpc_batch.py``); ``solve``'s inputs and outputs keep the JAX
contract, ``x0 (B, 2n)``, ``us (B, H, n)``, ``xs (B, H+1, 2n)``, ``cost
(B,)``. Unlike the JAX package, B is not padded: the kernels guard
``b < B``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.robot import RobotModel, host_arrays
from ..ops.cuda_mpc_batch import BatchMPCKernels

__all__ = ["BatchTrackingMPC", "build_batch_tracking_mpc", "batch_mpc_step"]


class BatchTrackingMPC(NamedTuple):
    """Batched solver handle: ``solve(x0 (B, 2n), us_warm (B, H, n),
    q_goal_new=None) -> (us (B, H, n), xs (B, H+1, 2n), cost (B,))``.
    ``q_goal_new`` is (n,) or (B, n) and re-targets every scenario; the
    goals given at build time serve when it is None.

    ``linearize``/``backward``/``linesearch_costs``/``linesearch``/``replay``
    are the stages in the scenario-minor layout; ``kernels`` is their
    :class:`~manipulapy_tpu_torch.ops.cuda_mpc_batch.BatchMPCKernels`;
    ``solve_plain`` is ``solve`` through the plain versions on any device,
    the reference the kernels are held against. ``build_args`` are the
    arguments it was built from, host-side (the model as its f64 host
    arrays and its device type, the goals as float32 NumPy), which
    ``utils/aot.py`` stores to rebuild it in another process.
    ``solve_impl(x0, us_warm, goal)`` is the solve with its goals already in
    the kernels' layout, ``goal`` (n, B) on the inputs' device (the JAX
    package's AOT entry); ``goal_default`` is the build-time goals so laid
    out, on the model's device."""

    solve: Callable
    horizon: int
    n: int
    batch: int
    linearize: Callable
    backward: Callable
    linesearch_costs: Callable
    linesearch: Callable
    replay: Callable
    kernels: BatchMPCKernels
    solve_plain: Callable
    build_args: dict
    solve_impl: Callable = None
    goal_default: torch.Tensor = None


def _host_vector(v, n: int, name: str) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().double().numpy()
    out = np.asarray(v, dtype=np.float64)
    try:
        return np.broadcast_to(out, (n,)).copy()
    except ValueError:
        raise ValueError(f"{name} must broadcast to ({n},), got {out.shape}") from None


def build_batch_tracking_mpc(
    model: RobotModel,
    q_goal,
    batch: int,
    horizon: int,
    dt: float,
    iterations: int = 4,
    line_search_steps: int = 6,
    w_q: float = 10.0,
    w_dq: float = 0.5,
    w_u: float = 1e-4,
    w_terminal: float = 100.0,
    reg: float = 1e-6,
    u_limit=None,
    g=(0.0, 0.0, -9.81),
    _form=None,
    _fwd_form=None,
) -> BatchTrackingMPC:
    """Build the batched fused solver for one (robot, goals, B, H).

    ``q_goal``: (n,) shared or (batch, n) per scenario; it is kept on the
    model's device. ``u_limit`` defaults to the model's torque limits (its
    f64 host arrays where it has them). The kernels build with nvcc at
    their first CUDA call (or :meth:`BatchMPCKernels.build`). ``_form`` and
    ``_fwd_form``, not public options, name K2's form and K4's and K5's
    (``BatchMPCKernels``)."""
    n = model.num_joints
    nx = 2 * n
    H, B, A = int(horizon), int(batch), int(line_search_steps)
    if min(H, B, A) < 1 or iterations < 0:
        raise ValueError("horizon, batch and line_search_steps must be >= 1, iterations >= 0")
    if u_limit is None:
        host = host_arrays(model)
        u_limit = host["torque_limit"] if host is not None else model.torque_limit
    u_lim = _host_vector(u_limit, n, "u_limit")
    kernels = BatchMPCKernels(
        model, dt, g=g, w_q=w_q, w_dq=w_dq, w_u=w_u, w_terminal=w_terminal, u_lim=u_lim, _form=_form,
        _fwd_form=_fwd_form,
    )
    device = model.device

    def goal_tensor(q_goal_arg, device) -> torch.Tensor:
        goal = torch.as_tensor(q_goal_arg, dtype=torch.float32, device=device)
        if tuple(goal.shape) == (n,):  # shared goal
            goal = goal.expand(B, n)
        elif goal.dim() == 2 and goal.shape[0] != B:
            raise ValueError(f"q_goal batch {goal.shape[0]} != declared batch {B}")
        if tuple(goal.shape) != (B, n):
            raise ValueError(f"q_goal must be ({n},) or ({B}, {n}), got {tuple(goal.shape)}")
        return goal.T.contiguous()  # (n, B)

    goal_default = goal_tensor(
        q_goal.detach() if isinstance(q_goal, torch.Tensor) else np.asarray(q_goal, np.float32),
        device,
    )
    alphas_np = 0.5 ** np.arange(A, dtype=np.float32)

    def solve_with(stages, x0, us_init, goal_t):
        if x0.dim() != 2 or x0.shape[0] != B:
            raise ValueError(f"x0 batch {x0.shape[0] if x0.dim() else '?'} != declared batch {B}")
        if tuple(x0.shape) != (B, nx) or tuple(us_init.shape) != (B, H, n):
            raise ValueError(
                f"x0 must be ({B}, {nx}) and us_warm ({B}, {H}, {n}), got "
                f"{tuple(x0.shape)} and {tuple(us_init.shape)}"
            )
        dev = x0.device
        f32 = dict(dtype=torch.float32, device=dev)
        u_lim_t = torch.as_tensor(u_lim, **f32)
        us0 = torch.clamp(us_init.to(**f32), -u_lim_t, u_lim_t)
        x0_t = x0.to(**f32).T.contiguous()  # (nx, B)
        alphas = torch.as_tensor(alphas_np, device=dev)
        us_cur = us0.permute(1, 2, 0).contiguous()  # (H, n, B)

        # Initial rollout: alpha = 0 with zero gains is the open loop us0.
        zeros_kK = torch.zeros((H, n, 1 + nx, B), **f32)
        xs_post, us_cur, cost = stages.replay(
            x0_t, torch.zeros((H, nx, B), **f32), us_cur, zeros_kK, goal_t,
            torch.zeros((B,), **f32),
        )
        reg_t = torch.full((B,), float(reg), **f32)
        # Every alpha's trajectory: allocated by the first line search and
        # written again by each later one.
        xs_all = us_all = None
        for _ in range(iterations):
            # Pre-step nominal states: x0, then xs_post[:-1].
            sd_x = torch.cat([x0_t[None], xs_post[:-1]], dim=0)
            AB = stages.linearize(sd_x, us_cur)
            kK = stages.backward(AB, sd_x, us_cur, xs_post[-1].contiguous(), goal_t, reg_t)
            costs_all, xs_all, us_all = stages.linesearch(x0_t, sd_x, us_cur, kK, goal_t, alphas, xs_all, us_all)
            # Per scenario, the first improving alpha (alphas descend from 1),
            # and its trajectory and cost.
            improving = torch.isfinite(costs_all) & (costs_all < cost[None])
            idx = torch.argmax(improving.to(torch.int32), dim=0)
            accepted = improving.any(dim=0)
            xs_new = torch.gather(xs_all, 2, idx.view(1, 1, 1, B).expand(H, nx, 1, B))[:, :, 0]
            us_new = torch.gather(us_all, 2, idx.view(1, 1, 1, B).expand(H, n, 1, B))[:, :, 0]
            cost_new = torch.gather(costs_all, 0, idx[None])[0]
            # A rejected scenario keeps its whole state: its idx points at
            # alpha 1, whose rollout NaN gains would have poisoned.
            xs_post = torch.where(accepted, xs_new, xs_post)
            us_cur = torch.where(accepted, us_new, us_cur)
            cost = torch.where(accepted, cost_new, cost)
            reg_t = torch.where(
                accepted, torch.clamp(reg_t / 10.0, min=1e-9), torch.clamp(reg_t * 10.0, max=1e6)
            )
        xs_full = torch.cat([x0_t.T[:, None], xs_post.permute(2, 0, 1)], dim=1)
        return us_cur.permute(2, 0, 1).contiguous(), xs_full.contiguous(), cost

    plain = kernels.plain()

    def goal_on(q_goal_new, dev) -> torch.Tensor:
        return goal_default.to(dev) if q_goal_new is None else goal_tensor(q_goal_new, dev)

    def solve(x0: torch.Tensor, us_init: torch.Tensor, q_goal_new=None):
        """Solve the batch; ``q_goal_new`` (n,) or (B, n) re-targets every
        scenario."""
        return solve_with(kernels, x0, us_init, goal_on(q_goal_new, x0.device))

    def solve_plain(x0: torch.Tensor, us_init: torch.Tensor, q_goal_new=None):
        return solve_with(plain, x0, us_init, goal_on(q_goal_new, x0.device))

    def solve_impl(x0: torch.Tensor, us_init: torch.Tensor, goal: torch.Tensor):
        return solve_with(kernels, x0, us_init, goal)

    build_args = dict(
        host_arrays=host_arrays(model), q_goal=goal_default.T.cpu().numpy().copy(), batch=B, horizon=H, dt=float(dt),
        iterations=int(iterations), line_search_steps=A, w_q=w_q, w_dq=w_dq, w_u=w_u, w_terminal=w_terminal,
        reg=float(reg), u_limit=u_lim, g=tuple(float(v) for v in g), device=model.device.type,
        **({"_form": _form} if _form else {}), **({"_fwd_form": _fwd_form} if _fwd_form else {}),
    )
    return BatchTrackingMPC(
        solve=solve, horizon=H, n=n, batch=B,
        linearize=kernels.linearize, backward=kernels.backward,
        linesearch_costs=kernels.linesearch_costs, linesearch=kernels.linesearch, replay=kernels.replay,
        kernels=kernels, solve_plain=solve_plain, build_args=build_args, solve_impl=solve_impl,
        goal_default=goal_default,
    )


def batch_mpc_step(
    mpc: BatchTrackingMPC,
    x: torch.Tensor,
    us_warm: torch.Tensor,
    q_goal: Optional[torch.Tensor] = None,
):
    """One receding-horizon round for a whole fleet: solve all B scenarios,
    return the first controls, and shift the warm starts.

    Returns ``(u_first (B, n), us_warm_next (B, H, n), (us, xs, cost))``.
    ``q_goal`` re-targets every scenario.
    """
    us, xs, cost = mpc.solve(x, us_warm, q_goal)
    u_first = us[:, 0]
    us_next = torch.cat([us[:, 1:], us[:, -1:]], dim=1)
    return u_first, us_next, (us, xs, cost)
