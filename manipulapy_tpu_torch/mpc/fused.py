"""Single-problem fused tracking MPC: one robot, the lowest-latency solve.

Counterpart of ``manipulapy_tpu/mpc/fused.py``. Each iteration runs three
kernels (``ops/cuda_mpc_single.py``) on one problem:

* ``linearize`` (K6): the exact ``A_t, B_t`` of the step program along the
  nominal trajectory, all 3n tangent seeds;
* ``backward`` (K7): the Riccati sweep from the terminal value function,
  Quu solved by pivot-free Gauss-Jordan;
* ``forward`` (K8): the closed-loop rollout and cost of every line-search
  alpha at once.

The initial rollout is K8 with one alpha of 0, zero gains and a zero
nominal, the open loop of the clipped warm start, so a solve of I
iterations launches K6 and K7 I times and K8 I+1 times. The glue between
the kernels is plain tensor ops on the device, as it is XLA in the JAX
package: the terminal value function, the first improving alpha, the
guard that keeps the current trajectory when no alpha improves (NaN gains
from a Quu that lost definiteness must not reach it), and the
regularisation update ``reg <- clamp(reg / 10 or reg * 10, 1e-9, 1e6)``.
Nothing in ``solve`` waits for the device: the accepted alpha and the
Levenberg term stay on it.

The solver runs where its inputs lie: CUDA float32 inputs go through the
kernels, CPU inputs through their plain PyTorch versions. Its contract is
the JAX one, ``solve(x0 (2n,), us_warm (H, n), q_goal_new=None) -> (us (H,
n), xs (H+1, 2n), cost ())``, with the JAX package's limits: H <= 128 and n
<= 8.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..models.robot import RobotModel, host_arrays
from ..ops.cuda_mpc_single import SingleMPCKernels
from .fused_batch import _host_vector

__all__ = ["TrackingMPC", "build_tracking_mpc"]

_LANES = 128  # the JAX kernels' lane width, which bounds H
_AB_COLS = 32  # the JAX package's packed AB tile, which bounds n


class TrackingMPC(NamedTuple):
    """Solver handle: ``solve(x0 (2n,), us_warm (H, n), q_goal_new=None)
    -> (us (H, n), xs (H+1, 2n), cost ())``. ``q_goal_new`` (n,) re-targets
    the solve (the dq goal is 0); the goal given at build time serves when
    it is None.

    ``linearize``/``backward``/``forward`` are the three stages in the
    time-major layout of ``ops/cuda_mpc_single.py``; ``kernels`` is their
    :class:`~manipulapy_tpu_torch.ops.cuda_mpc_single.SingleMPCKernels`;
    ``solve_plain`` is ``solve`` through the plain versions on any device,
    the reference the kernels are held against. ``build_args`` are the
    arguments it was built from, host-side (the model as its f64 host
    arrays and its device type, the goal as float32 NumPy), which
    ``utils/aot.py`` stores to rebuild it in another process.
    ``solve_impl(x0, us_warm, goal)`` is the solve with its goal a float32
    (n,) tensor on the inputs' device (the JAX package's AOT entry);
    ``goal_default`` is the build-time goal, float32 NumPy."""

    solve: Callable
    horizon: int
    n: int
    linearize: Callable
    backward: Callable
    forward: Callable
    kernels: SingleMPCKernels
    solve_plain: Callable
    build_args: dict
    solve_impl: Callable = None
    goal_default: np.ndarray = None


def build_tracking_mpc(
    model: RobotModel,
    q_goal,
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
) -> TrackingMPC:
    """Build the fused solver for one (robot, goal, horizon).

    ``u_limit`` defaults to the model's torque limits (its f64 host arrays
    where it has them). The kernels build with nvcc at their first CUDA
    call (or :meth:`SingleMPCKernels.build`)."""
    n = model.num_joints
    nx = 2 * n
    H, A = int(horizon), int(line_search_steps)
    if H > _LANES:
        raise ValueError(f"horizon {H} > {_LANES} lanes (tile the kernel to lift)")
    b_col = ((nx + 7) // 8) * 8
    if b_col + n > _AB_COLS:
        raise ValueError(
            f"robot too large for the fused packed layout (nx={nx}, n={n}); "
            "use the generic mpc.ilqr solver"
        )
    if min(H, A) < 1 or iterations < 0:
        raise ValueError("horizon and line_search_steps must be >= 1, iterations >= 0")
    if u_limit is None:
        host = host_arrays(model)
        u_limit = host["torque_limit"] if host is not None else model.torque_limit
    u_lim = _host_vector(u_limit, n, "u_limit")
    kernels = SingleMPCKernels(
        model, dt, g=g, w_q=w_q, w_dq=w_dq, w_u=w_u, w_terminal=w_terminal, u_lim=u_lim
    )
    P = kernels.P
    q_goal_host = q_goal.detach().cpu() if isinstance(q_goal, torch.Tensor) else q_goal
    goal_default = np.asarray(q_goal_host, dtype=np.float32)
    if goal_default.shape != (n,):
        raise ValueError(f"q_goal must be ({n},), got {goal_default.shape}")
    consts: Dict[torch.device, SimpleNamespace] = {}

    def on(dev: torch.device) -> SimpleNamespace:
        """The solver's constants on a device, made once: after the first
        call a solve copies nothing from the host."""
        if dev not in consts:
            f32 = dict(dtype=torch.float32, device=dev)
            two_wT = torch.tensor([2.0 * w for w in P.wT], **f32)
            consts[dev] = SimpleNamespace(
                u_lim=torch.tensor(u_lim, **f32),
                goal=torch.tensor(goal_default, **f32),
                alphas=torch.tensor(0.5 ** np.arange(A, dtype=np.float32), device=dev),
                zero_alpha=torch.zeros((1,), **f32),
                zero_x=torch.zeros((H, nx), **f32),
                zero_kK=torch.zeros((H, n, 1 + nx), **f32),
                zero_dq=torch.zeros((n,), **f32),
                two_wT=two_wT,
                Vxx_T=torch.diag(two_wT),
                reg=torch.tensor(float(reg), **f32),
            )
        return consts[dev]

    on(model.device)

    def goal_on(q_goal_new, dev) -> torch.Tensor:
        if q_goal_new is None:
            return on(dev).goal
        goal = torch.as_tensor(q_goal_new, dtype=torch.float32, device=dev)
        if tuple(goal.shape) != (n,):
            raise ValueError(f"q_goal_new must be ({n},), got {tuple(goal.shape)}")
        return goal.contiguous()

    def solve_with(stages, x0, us_init, goal):
        if tuple(x0.shape) != (nx,) or tuple(us_init.shape) != (H, n):
            raise ValueError(
                f"x0 must be ({nx},) and us_warm ({H}, {n}), got {tuple(x0.shape)} and {tuple(us_init.shape)}"
            )
        dev = x0.device
        c = on(dev)
        x_goal = torch.cat([goal, c.zero_dq])
        x0_t = x0.to(dtype=torch.float32).contiguous()
        us_cur = torch.clamp(us_init.to(dtype=torch.float32), -c.u_lim, c.u_lim).contiguous()

        # Initial rollout: alpha = 0 with zero gains is the open loop us0.
        xs_a, us_a, costs = stages.forward(x0_t, c.zero_x, us_cur, c.zero_kK, goal, c.zero_alpha)
        xs_post, us_cur, cost = xs_a[0], us_a[0], costs[0]
        reg_t = c.reg
        for _ in range(iterations):
            # Pre-step nominal states: x0, then xs_post[:-1].
            sd_x = torch.cat([x0_t[None], xs_post[:-1]])
            AB = stages.linearize(sd_x, us_cur)
            Vterm = torch.cat([c.Vxx_T, (c.two_wT * (xs_post[-1] - x_goal))[None]])
            kK = stages.backward(AB, sd_x, us_cur, goal, Vterm, reg_t)
            xs_a, us_a, costs = stages.forward(x0_t, sd_x, us_cur, kK, goal, c.alphas)
            # The first improving alpha (alphas descend from 1), on the device.
            improving = torch.isfinite(costs) & (costs < cost)
            idx = torch.argmax(improving.to(torch.int32)).reshape(1)
            accepted = improving.any()
            xs_post = torch.where(accepted, xs_a.index_select(0, idx)[0], xs_post)
            us_cur = torch.where(accepted, us_a.index_select(0, idx)[0], us_cur)
            cost = torch.where(accepted, costs.index_select(0, idx)[0], cost)
            reg_t = torch.where(
                accepted, torch.clamp(reg_t / 10.0, min=1e-9), torch.clamp(reg_t * 10.0, max=1e6)
            )
        return us_cur, torch.cat([x0_t[None], xs_post]), cost

    plain = kernels.plain()

    def solve(x0: torch.Tensor, us_init: torch.Tensor, q_goal_new=None):
        """Solve; ``q_goal_new`` (n,) re-targets without a rebuild (pass a
        tensor on the inputs' device to keep the call free of copies)."""
        return solve_with(kernels, x0, us_init, goal_on(q_goal_new, x0.device))

    def solve_plain(x0: torch.Tensor, us_init: torch.Tensor, q_goal_new=None):
        return solve_with(plain, x0, us_init, goal_on(q_goal_new, x0.device))

    def solve_impl(x0: torch.Tensor, us_init: torch.Tensor, goal: torch.Tensor):
        return solve_with(kernels, x0, us_init, goal)

    build_args = dict(
        host_arrays=host_arrays(model), q_goal=goal_default, horizon=H, dt=float(dt), iterations=int(iterations),
        line_search_steps=A, w_q=w_q, w_dq=w_dq, w_u=w_u, w_terminal=w_terminal, reg=float(reg), u_limit=u_lim,
        g=tuple(float(v) for v in g), device=model.device.type,
    )
    return TrackingMPC(
        solve=solve, horizon=H, n=n,
        linearize=kernels.linearize, backward=kernels.backward, forward=kernels.forward,
        kernels=kernels, solve_plain=solve_plain, build_args=build_args, solve_impl=solve_impl,
        goal_default=goal_default,
    )
