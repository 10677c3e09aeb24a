"""Exact forward-dynamics step program, generated per robot.

Counterpart of ``manipulapy_tpu/ops/fd_step.py``. One step computes, for
every scenario,

    ddq = M(q)^{-1} (tau - h(q, dq))          [exact, coupled]
    dq' = clip(dq + ddq dt);  q' = clip(q + dq' dt)

as one flat program over scalar values (``ops/cgen.py``), with the robot
geometry, dt, g and the clip flags folded in as constants:

* ``M(q)`` as ``sum_k JB_k^T G_k JB_k`` over per-link CoM Jacobians, the
  formulation of :func:`manipulapy_tpu_torch.dynamics.mass_matrix`;
* gravity in the Jacobian form and the velocity bias from a zero-gravity
  RNEA sweep;
* an unrolled Cholesky solve, semi-implicit Euler and the limit clamps.

The same emitter runs on tensors (:func:`build_fd_step`,
:func:`build_rollout`: the plain PyTorch versions) and on symbolic CVars
(:func:`build_fd_step_source`: the C source of the CUDA kernel's device
function, ``ops/cuda_rollout.py``), so the kernel and its plain version
compute the same thing by construction.

The looped form (:func:`link_table`, :func:`fd_step_loop_planes`,
:class:`LoopRollout`) is the same step written once as a loop over links,
the robot's geometry read from a table: the plain version of
``csrc/fd_step_loop.cuh``, whose code does not grow with the robot.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from . import cgen as cg
from ..models.robot import RobotModel, _adjoint_np, host_arrays

__all__ = [
    "build_fd_step",
    "build_fd_step_planes",
    "build_fd_step_source",
    "build_fd_step_jvp_planes",
    "build_fd_step_jvp_source",
    "build_fd_step_jvp_group_source",
    "build_bias_mass_fn",
    "build_rollout",
    "Rollout",
    "LINK_FIELDS",
    "TABLE_HEAD",
    "LINK_STRIDE",
    "COST_FIELDS",
    "loop_supported",
    "link_table",
    "fwd_table",
    "table_defines",
    "fd_step_loop_planes",
    "build_fd_step_loop",
    "loop_step_ops",
    "fd_step_loop_jvp_planes",
    "loop_jvp_ops",
    "fd_fwd_loop_planes",
    "loop_terminal_cost",
    "loop_terminal_cost_fused",
    "loop_fwd_ops",
    "loop_rollout_plain",
    "LoopRollout",
    "build_loop_rollout",
]

DEFAULT_G = (0.0, 0.0, -9.81)


def _np_model(model: RobotModel):
    """f64 host copies of the arrays the emitter folds: the registry's when
    the model has them, else one read-back of the tensors."""
    names = ("screws_space", "com_home", "inertias", "joint_lower", "joint_upper", "velocity_limit")
    host = host_arrays(model)
    if host is not None:
        return tuple(host[k] for k in names)
    return tuple(getattr(model, k).detach().cpu().double().numpy() for k in names)


def _joint_exp(S_row, q_val, s, c):
    """exp([S] q) as a cgen transform; revolute or prismatic is decided at
    build time (S is constant)."""
    w = S_row[:3]
    v = S_row[3:]
    if np.linalg.norm(w) > 0.5:
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        W2 = W @ W
        eye = np.eye(3)
        # R = I + s W + (1 - c) W2.
        R = [
            [
                cg.add(
                    float(eye[i, j]),
                    cg.add(cg.mul(s, float(W[i, j])), cg.mul(cg.sub(1.0, c), float(W2[i, j]))),
                )
                for j in range(3)
            ]
            for i in range(3)
        ]
        # p = (I q + (1 - c) W + (q - s) W2) v.
        Wv = W @ v
        W2v = W2 @ v
        p = [
            cg.add(
                cg.mul(q_val, float(v[i])),
                cg.add(
                    cg.mul(cg.sub(1.0, c), float(Wv[i])),
                    cg.mul(cg.sub(q_val, s), float(W2v[i])),
                ),
            )
            for i in range(3)
        ]
        return R, p
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    return eye, [cg.mul(q_val, float(v[i])) for i in range(3)]


def _transform_inv_val(T):
    """Run-time inverse of a value transform: (R^T, -R^T p)."""
    R, p = T
    Rt = cg.mat_T(R)
    return Rt, [cg.neg(x) for x in cg.mat_vec(Rt, p)]


def _chol_solve_values(M, rhs):
    """Unrolled Cholesky solve on an n x n list of lists of values."""
    n = len(rhs)
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = cg.sub(s, cg.mul(L[j][k], L[j][k]))
        d = cg.sqrt(s)
        L[j][j] = d
        inv_d = cg.recip(d)
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = cg.sub(s, cg.mul(L[i][k], L[j][k]))
            L[i][j] = cg.mul(s, inv_d)
    inv_diag = [cg.recip(L[i][i]) for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = cg.sub(s, cg.mul(L[i][k], y[k]))
        y[i] = cg.mul(s, inv_diag[i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = cg.sub(s, cg.mul(L[k][i], x[k]))
        x[i] = cg.mul(s, inv_diag[i])
    return x


def _emit_dynamics(model: RobotModel, g=DEFAULT_G, lean: bool = False):
    """The (q, dq) -> (M, bias) emitter shared by every ``build_*``
    function, over per-joint value lists.

    ``lean`` emits the same operations on the same operands, so the same
    values bit for bit, in an order that holds fewer values at once (K2's
    group body, where each value is held once per seed as well): the
    velocity bias before the mass matrix; each link's prefix, Jacobian
    column and CoM frame in one pass, its gravity term first and its mass
    matrix terms column by column; and each downward transform of the RNEA
    recomputed in the backward pass from its joint's q, sin and cos (behind
    :func:`~.cgen.keep`, so the compiler does not merge the two and hold
    the transform across the sweep)."""
    S_np, Mc_np, G_np, *_ = _np_model(model)
    n = S_np.shape[0]
    g_np = np.asarray(g, dtype=np.float64)

    # Constant RNEA frames: A_k = Ad(Mc_k^-1) S_k; M_prev_k = Mc_{k-1}^-1 Mc_k.
    A_np = np.zeros((n, 6))
    Mprev_inv_np = np.zeros((n, 4, 4))
    for k in range(n):
        Mc_inv = np.linalg.inv(Mc_np[k])
        A_np[k] = _adjoint_np(Mc_inv) @ S_np[k]
        prev = np.eye(4) if k == 0 else Mc_np[k - 1]
        Mprev_inv_np[k] = np.linalg.inv(np.linalg.inv(prev) @ Mc_np[k])

    G_c = [cg.from_numpy(G_np[k]) for k in range(n)]
    A_c = [cg.from_numpy(A_np[k]) for k in range(n)]
    S_c = [cg.from_numpy(S_np[k]) for k in range(n)]
    Mc_c = [(cg.from_numpy(Mc_np[k][:3, :3]), cg.from_numpy(Mc_np[k][:3, 3])) for k in range(n)]
    Mprev_inv_c = [
        (cg.from_numpy(Mprev_inv_np[k][:3, :3]), cg.from_numpy(Mprev_inv_np[k][:3, 3]))
        for k in range(n)
    ]

    def mass_and_gravity(q_vals, sines, cosines):
        """M(q) through per-link CoM Jacobians, and the gravity bias."""
        prefixes = [([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], [0.0, 0.0, 0.0])]
        exp_of = lambda k: _joint_exp(S_np[k], q_vals[k], sines[k], cosines[k])
        J_cols = []
        if not lean:
            for k in range(n):
                prefixes.append(cg.compose(prefixes[-1], exp_of(k)))
            J_cols = [cg.adjoint_apply(prefixes[i], S_c[i]) for i in range(n)]

        M = [[0.0] * n for _ in range(n)]
        bias_grav = [0.0] * n
        for k in range(n):
            if lean:
                J_cols.append(cg.adjoint_apply(prefixes[k], S_c[k]))
                prefixes.append(cg.compose(prefixes[k], exp_of(k)))
            T_com = cg.compose(prefixes[k + 1], Mc_c[k])
            T_inv = _transform_inv_val(T_com)
            JB = [cg.adjoint_apply(T_inv, J_cols[i]) for i in range(k + 1)]

            def gravity():  # the wrench [0; m R^T (-g)] in the CoM frame
                f_lin = cg.mat_vec(cg.mat_T(T_com[0]), [float(-g_np[0]), float(-g_np[1]), float(-g_np[2])])
                F = [0.0, 0.0, 0.0] + [cg.mul(float(G_np[k][3, 3]), x) for x in f_lin]
                for i in range(k + 1):
                    bias_grav[i] = cg.add(bias_grav[i], cg.dot(JB[i], F))

            if lean:  # gravity first, then one G JB column at a time
                gravity()
                for j in range(k + 1):
                    GJB_j = cg.mat_vec(G_c[k], JB[j])
                    for i in range(j + 1):
                        M[i][j] = cg.add(M[i][j], cg.dot(JB[i], GJB_j))
            else:
                GJB = [cg.mat_vec(G_c[k], col) for col in JB]
                for i in range(k + 1):
                    for j in range(i, k + 1):
                        M[i][j] = cg.add(M[i][j], cg.dot(JB[i], GJB[j]))
                gravity()
        for i in range(n):
            for j in range(i):
                M[i][j] = M[j][i]
        return M, bias_grav

    # exp(-[A_k] q_k): sin(-q) = -s, cos(-q) = c.
    def down(k, q_val, s, c):
        return cg.compose(_joint_exp(A_np[k], cg.neg(q_val), cg.neg(s), c), Mprev_inv_c[k])

    def velocity_bias(q_vals, dq_vals, sines, cosines):
        """The velocity-product bias: RNEA with ddq = 0 and g = 0."""
        V = [0.0] * 6
        Vd = [0.0] * 6
        V_list, Vd_list, Tdown_list = [], [], []
        for k in range(n):
            Td = down(k, q_vals[k], sines[k], cosines[k])
            Tdown_list.append(Td)
            AdV = cg.adjoint_apply(Td, V)
            V = [cg.add(AdV[i], cg.mul(A_c[k][i], dq_vals[k])) for i in range(6)]
            Adq = [cg.mul(A_c[k][i], dq_vals[k]) for i in range(6)]
            adVA = cg.ad_apply(V, Adq)
            AdVd = cg.adjoint_apply(Td, Vd)
            Vd = [cg.add(AdVd[i], adVA[i]) for i in range(6)]
            V_list.append(V)
            Vd_list.append(Vd)

        F = [0.0] * 6
        bias_vel = [None] * n
        for k in range(n - 1, -1, -1):
            GVd = cg.mat_vec(G_c[k], Vd_list[k])
            GV = cg.mat_vec(G_c[k], V_list[k])
            adTF = cg.ad_T_apply(V_list[k], GV)
            F = [cg.sub(cg.add(F[i], GVd[i]), adTF[i]) for i in range(6)]
            bias_vel[k] = cg.dot(A_c[k], F)
            Td = Tdown_list[k]
            if lean and k < n - 1:
                Td = down(k, cg.keep(q_vals[k]), cg.keep(sines[k]), cg.keep(cosines[k]))
            F = cg.adjoint_T_apply(Td, F)
        return bias_vel

    def dynamics_of(q_vals, dq_vals):
        sines = [cg.sin(q) for q in q_vals]
        cosines = [cg.cos(q) for q in q_vals]
        if lean:
            bias_vel = velocity_bias(q_vals, dq_vals, sines, cosines)
            M, bias_grav = mass_and_gravity(q_vals, sines, cosines)
        else:
            M, bias_grav = mass_and_gravity(q_vals, sines, cosines)
            bias_vel = velocity_bias(q_vals, dq_vals, sines, cosines)
        bias = [cg.add(bias_vel[i], bias_grav[i]) for i in range(n)]
        return M, bias

    return n, dynamics_of


def _full(v, like: torch.Tensor) -> torch.Tensor:
    """A value as a tensor shaped like ``like`` (constants broadcast)."""
    if cg.is_const(v):
        return like.new_full(like.shape, v)
    return torch.broadcast_to(v, like.shape)


def build_bias_mass_fn(model: RobotModel, g=DEFAULT_G):
    """(q, dq) -> (M, bias) on (..., n) tensors."""
    n, dynamics_of = _emit_dynamics(model, g)

    def fn(q: torch.Tensor, dq: torch.Tensor):
        q_vals = [q[..., i] for i in range(n)]
        M, bias = dynamics_of(q_vals, [dq[..., i] for i in range(n)])
        like = q_vals[0]
        M_arr = torch.stack(
            [torch.stack([_full(M[i][j], like) for j in range(n)], dim=-1) for i in range(n)],
            dim=-2,
        )
        return M_arr, torch.stack([_full(b, like) for b in bias], dim=-1)

    return fn


def build_fd_step_planes(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    clip_limits: bool = True,
    clip_velocity: bool = True,
    lean: bool = False,
):
    """``step(q_list, dq_list, tau_list) -> (q', dq', ddq)`` over per-joint
    value lists (tensors of one shape, or CVars). Limits are per-joint
    Python-float constants; ``clip_velocity`` is independent of
    ``clip_limits``, and only finite limits are applied. ``lean``: see
    ``_emit_dynamics``."""
    *_, lower, upper, vel_lim = _np_model(model)
    n, dynamics_of = _emit_dynamics(model, g, lean=lean)

    def step(q_vals, dq_vals, tau_vals):
        M, bias = dynamics_of(q_vals, dq_vals)
        rhs = [cg.sub(tau_vals[i], bias[i]) for i in range(n)]
        ddq_vals = _chol_solve_values(M, rhs)
        dq_new = [dq_vals[i] + ddq_vals[i] * dt for i in range(n)]
        q_new = [q_vals[i] + dq_new[i] * dt for i in range(n)]
        for i in range(n):
            if clip_limits and (np.isfinite(lower[i]) or np.isfinite(upper[i])):
                q_new[i] = cg.clip(q_new[i], float(lower[i]), float(upper[i]))
            if clip_velocity and np.isfinite(vel_lim[i]):
                dq_new[i] = cg.clip(dq_new[i], -float(vel_lim[i]), float(vel_lim[i]))
        return q_new, dq_new, ddq_vals

    return n, step


def build_fd_step(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    clip_limits: bool = True,
    clip_velocity: bool = True,
):
    """The semi-implicit Euler step ``step(q, dq, tau) -> (q', dq', ddq)``
    over (..., n) tensors (unbatched (n,) too). ``clip_velocity`` can be
    turned off on its own (the MPC setting)."""
    n, step_planes = build_fd_step_planes(
        model, dt, g=g, clip_limits=clip_limits, clip_velocity=clip_velocity
    )

    def step(q: torch.Tensor, dq: torch.Tensor, tau: torch.Tensor):
        q_new, dq_new, ddq = step_planes(
            [q[..., i] for i in range(n)],
            [dq[..., i] for i in range(n)],
            [tau[..., i] for i in range(n)],
        )
        like = q[..., 0]
        stack = lambda vals: torch.stack([_full(v, like) for v in vals], dim=-1)
        return stack(q_new), stack(dq_new), stack(ddq)

    return step


def build_fd_step_source(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    clip_limits: bool = True,
    clip_velocity: bool = True,
    emitter=None,
):
    """C source of ``__device__ void fd_step(float q[n], float dq[n], const
    float tau[n], float ddq[n])``: one step in f32, updating q and dq in
    place and writing ddq. The same emitter as :func:`build_fd_step`, run
    on CVars. Returns ``(n, source, op_count)``; ``emitter``, a list,
    receives the emitter."""
    n, step_planes = build_fd_step_planes(
        model, dt, g=g, clip_limits=clip_limits, clip_velocity=clip_velocity
    )
    em = cg.Emitter()
    ins = {
        arr: [cg.CVar(em, f"{arr}_{i}") for i in range(n)] for arr in ("q", "dq", "tau")
    }
    q_new, dq_new, ddq = step_planes(ins["q"], ins["dq"], ins["tau"])
    loads = [f"const float {arr}_{i} = {arr}[{i}];" for arr in ins for i in range(n)]
    stores = [
        f"{arr}[{i}] = {em.ref(v)};"
        for arr, vals in (("q", q_new), ("dq", dq_new), ("ddq", ddq))
        for i, v in enumerate(vals)
    ]
    body = "\n".join("  " + line for line in loads + em.lines + stores)
    source = (
        f"static __device__ __forceinline__ void fd_step(\n"
        f"    float q[{n}], float dq[{n}], const float tau[{n}], float ddq[{n}]) {{\n"
        f"{body}\n}}\n"
    )
    if emitter is not None:
        emitter.append(em)
    return n, source, len(em.lines)


def build_fd_step_jvp_planes(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    clip_limits: bool = True,
    clip_velocity: bool = False,
    lean: bool = False,
):
    """Forward mode over the step program (the MPC linearization):
    ``step_jvp(x_vals, u_vals, x_tans, u_tans) -> (x_next, x_next_tans)``
    over value lists, ``x = [q; dq]`` (2n values) and ``u = tau`` (n). Each
    input is paired with its tangent as a :class:`~.cgen.Dual`, so the
    step's arithmetic is the one of :func:`build_fd_step_planes` and the
    tangent rules are those of ``jax.linearize`` (``ops/cgen.py``). An
    output whose tangent folded away has tangent 0.0."""
    n, step_planes = build_fd_step_planes(
        model, dt, g=g, clip_limits=clip_limits, clip_velocity=clip_velocity, lean=lean
    )

    def step_jvp(x_vals, u_vals, x_tans, u_tans):
        x = [cg.dual(p, t) for p, t in zip(x_vals, x_tans)]
        u = [cg.dual(p, t) for p, t in zip(u_vals, u_tans)]
        q_new, dq_new, _ = step_planes(x[:n], x[n:], u)
        out = list(q_new) + list(dq_new)
        return [cg.primal(v) for v in out], [cg.tangent(v) for v in out]

    return n, step_jvp


def build_fd_step_jvp_source(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    clip_limits: bool = True,
    clip_velocity: bool = False,
    emitter=None,
):
    """C source of ``__device__ void fd_step_jvp(const float x[2n], const
    float u[n], int k, float x_next[2n], float col[2n])``: one step and
    column k of its Jacobian, ``col[i] = d x_next_i / d [x; u]_k``. The
    seed index is a run-time argument (the input tangents are ``k == i ?
    1 : 0``), so one function serves all 3n seeds: m specialised copies
    would multiply a body of ~10^4 statements by 3n. The same emitter as
    the plain linearization (``ops/cuda_mpc_batch.py``), run on CVars. Returns ``(n, source,
    statement count)``; ``emitter``, a list, receives the emitter."""
    n, step_jvp = build_fd_step_jvp_planes(
        model, dt, g=g, clip_limits=clip_limits, clip_velocity=clip_velocity
    )
    nx, m = 2 * n, 3 * n

    def seeds(em):
        lines = [
            f"const float s_{i} = (k == {i}) ? {cg.c_literal(1.0)} : {cg.c_literal(0.0)};"
            for i in range(m)
        ]
        return lines, {"s": [cg.CVar(em, f"s_{i}") for i in range(m)]}

    def body(x, u, s):
        return step_jvp(x, u, s[:nx], s[nx:])

    source, ops = cg.c_function(
        "fd_step_jvp", [("x", nx), ("u", n)], [], [("x_next", nx), ("col", nx)], body,
        preamble=[("int k", seeds)], emitter=emitter,
    )
    return n, source, ops


def build_fd_step_jvp_group_source(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    seeds: int = 3,
    clip_limits: bool = True,
    clip_velocity: bool = False,
    emitter=None,
):
    """C source of ``__device__ void fd_step_jvp_group(const float x[2n],
    const float u[n], int k0, float x_next[2n], float col[G * 2n])``: one
    step and columns k0 .. k0+G-1 of its Jacobian, ``col[j * 2n + i] = d
    x_next_i / d [x; u]_{k0+j}``, G = ``seeds``, which must divide 3n. The
    primal step is emitted once and each tangent statement once per seed
    (:class:`~.cgen.Seeds`), so seed j does exactly what
    :func:`build_fd_step_jvp_source` does for k = k0 + j: the seeds are
    run-time values, ``(k0 + j == i) ? 1 : 0``, as there. The step is
    emitted ``lean`` (``_emit_dynamics``): the same values in an order that
    holds fewer at once, since each is held once per seed. Returns ``(n,
    source, statement count)``; ``emitter``, a list, receives the emitter."""
    n, step_jvp = build_fd_step_jvp_planes(
        model, dt, g=g, clip_limits=clip_limits, clip_velocity=clip_velocity, lean=True
    )
    nx, m = 2 * n, 3 * n
    if not (1 <= seeds <= m and m % seeds == 0):
        raise ValueError(f"seeds must divide m = {m}, got {seeds}")
    one, zero = cg.c_literal(1.0), cg.c_literal(0.0)

    def seed_vars(em):
        lines = [
            f"const float s_{i}_{j} = (k0 + {j} == {i}) ? {one} : {zero};"
            for i in range(m) for j in range(seeds)
        ]
        return lines, {"s": [cg.Seeds(cg.CVar(em, f"s_{i}_{j}") for j in range(seeds)) for i in range(m)]}

    def body(x, u, s):
        x_next, tans = step_jvp(x, u, s[:nx], s[nx:])
        return x_next, [cg.seed(t, j) for j in range(seeds) for t in tans]

    source, ops = cg.c_function(
        "fd_step_jvp_group", [("x", nx), ("u", n)], [], [("x_next", nx), ("col", seeds * nx)], body,
        preamble=[("int k0", seed_vars)], emitter=emitter,
    )
    return n, cg.KEEP_SOURCE + source, ops


class Rollout(nn.Module):
    """The plain PyTorch rollout over the step program: a Python loop over
    the N waypoints and ``intRes`` substeps, on any device and dtype.

    ``forward(q0, dq0, taumat) -> (qs, dqs, ddqs)`` with (..., n) initial
    states and (..., N, n) torques; outputs are (..., N, n), row t is the
    state at waypoint t (row 0 = initial state) and ``ddqs[t]`` is the
    last-substep acceleration.
    """

    kind = "torch"

    def __init__(self, model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G):
        super().__init__()
        if intRes < 1:
            raise ValueError("intRes must be >= 1")
        self.intRes = int(intRes)
        self.n, self._step = build_fd_step_planes(
            model, float(dt) / intRes, g=g, clip_limits=True
        )

    def forward(self, q0: torch.Tensor, dq0: torch.Tensor, taumat: torch.Tensor):
        n, N = self.n, taumat.shape[-2]
        q = [q0[..., i] for i in range(n)]
        dq = [dq0[..., i] for i in range(n)]
        qs, dqs, ddqs = [], [], []
        for t in range(N):
            tau = [taumat[..., t, i] for i in range(n)]
            qs.append(q)
            dqs.append(dq)
            for _ in range(self.intRes):
                q, dq, ddq = self._step(q, dq, tau)
            ddqs.append(ddq)
        like = q0[..., 0]

        def stack(rows):
            return torch.stack(
                [torch.stack([_full(v, like) for v in row], dim=-1) for row in rows], dim=-2
            )

        return stack(qs), stack(dqs), stack(ddqs)


def build_rollout(model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G) -> Rollout:
    """The plain PyTorch version of the rollout kernel (``ops/cuda_rollout``)."""
    return Rollout(model, dt=dt, intRes=intRes, g=g)


# ---------------------------------------------------------------------------
# The looped step: the robot's geometry as data
# ---------------------------------------------------------------------------
#
# The table is one flat float array: TABLE_HEAD floats once, then
# LINK_STRIDE floats for each link k in LINK_FIELDS' order. Everything is
# computed in f64 as _emit_dynamics computes it and rounded once to the
# table's dtype. A_k = Ad(Mc_k^-1) S_k is joint k's screw in link k's CoM
# frame; exp(-[A_k] q) M_prev_k^-1, M_prev_k = Mc_{k-1}^-1 Mc_k, takes link
# k-1's CoM frame to link k's (the RNEA's transform, _emit_dynamics'
# `down`). W = [w] for A_k's rotation part w, so the transform's rotation
# is I - sin(q) W + (1 - cos q) W^2 (_joint_exp at -q). G_k = [[I, 0], [0, m
# 1]] in the CoM frame. A clamp not applied is an infinite bound: the
# kernel's clamp then leaves the value as it is, NaN too. u_lim is the
# torque bound the closed-loop step clamps its control to (K4 and K5); the
# rollout's and K2's tables carry +inf there and do not read it. The
# closed-loop step's table (:func:`fwd_table`) is followed by its cost
# weights, COST_FIELDS, in the same launch parameter. The space-frame
# screws S_k and CoM homes Mc_k, which _emit_dynamics also folds, are not
# in the table: the loop carries each CoM Jacobian column from link to link
# with the RNEA's transform, so the space frame never appears.
TABLE_HEAD = (("dt", 1), ("g", 3))
LINK_FIELDS = (
    ("A", 6),        # A_k = [w; v]
    ("W2", 9),       # [w]^2, row-major
    ("Wv", 3),       # [w] v
    ("W2v", 3),      # [w]^2 v
    ("Mprev_R", 9),  # M_prev_k^-1: rotation, row-major
    ("Mprev_p", 3),  #   and translation
    ("I", 9),        # G_k's rotational block, row-major
    ("m", 1),        # G_k's mass
    ("lower", 1),    # position limits (-inf, +inf: not clamped)
    ("upper", 1),
    ("vel", 1),      # velocity limit (+inf: not clamped)
    ("u_lim", 1),    # torque bound of the closed-loop step (+inf: not clamped)
)
# The closed-loop step's cost weights, after the table: the running cost's
# state and control weights and the terminal cost's (``Costs``' wT).
COST_FIELDS = (("w_q", 1), ("w_dq", 1), ("w_u", 1), ("wT_q", 1), ("wT_dq", 1))


def _offsets(fields):
    out, at = {}, 0
    for name, size in fields:
        out[name] = at
        at += size
    return out, at


HEAD_AT, HEAD_FLOATS = _offsets(TABLE_HEAD)
LINK_AT, LINK_STRIDE = _offsets(LINK_FIELDS)
COST_AT, COST_FLOATS = _offsets(COST_FIELDS)


def table_defines() -> str:
    """The table's layout as C macros (``MPT_TAB_*``, and ``MPT_COST_*``
    for the cost weights after it) for ``csrc/fd_step_loop.cuh`` and the
    looped K4/K5: the one place the layout is written is here."""
    lines = [f"#define MPT_TAB_HEAD {HEAD_FLOATS}", f"#define MPT_TAB_STRIDE {LINK_STRIDE}"]
    lines += [f"#define MPT_TAB_{name.upper()} {at}" for name, at in HEAD_AT.items()]
    lines += [f"#define MPT_TAB_{name.upper()} {at}" for name, at in LINK_AT.items()]
    lines += [f"#define MPT_COST_FLOATS {COST_FLOATS}"]
    lines += [f"#define MPT_COST_{name.upper()} {at}" for name, at in COST_AT.items()]
    return "\n".join(lines) + "\n"


def loop_supported(model: RobotModel) -> bool:
    """Whether the looped step takes this robot: every spatial inertia of
    the form ``[[I, 0], [0, m 1]]`` (a CoM-frame inertia; every URDF and
    catalog robot has it)."""
    G = _np_model(model)[2]
    m = G[:, 3, 3]
    return bool(
        not np.any(G[:, :3, 3:]) and not np.any(G[:, 3:, :3])
        and np.array_equal(G[:, 3:, 3:], m[:, None, None] * np.eye(3))
    )


def link_table(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    clip_limits: bool = True,
    clip_velocity: bool = True,
    dtype=torch.float32,
    u_lim=None,
) -> torch.Tensor:
    """The robot's geometry, dt and g as one flat tensor on the CPU (layout:
    ``TABLE_HEAD``, then ``LINK_FIELDS`` for each link), the data of the
    looped step (:func:`fd_step_loop_planes`, ``csrc/fd_step_loop.cuh``).
    The values are those ``_emit_dynamics`` folds into the emitted code,
    computed in f64 the same way and rounded once to ``dtype``. ``u_lim``
    (n torque bounds, or None for +inf) is read by the closed-loop step
    alone."""
    if not loop_supported(model):
        raise ValueError("the looped step takes spatial inertias of the form [[I, 0], [0, m 1]] only")
    S_np, Mc_np, G_np, lower, upper, vel = _np_model(model)
    n = S_np.shape[0]
    u_lim = np.full(n, np.inf) if u_lim is None else np.broadcast_to(np.asarray(u_lim, dtype=np.float64), (n,))
    out = np.zeros(HEAD_FLOATS + n * LINK_STRIDE)
    out[HEAD_AT["dt"]] = float(dt)
    out[HEAD_AT["g"]:HEAD_AT["g"] + 3] = np.asarray(g, dtype=np.float64)
    for k in range(n):
        Mc_inv = np.linalg.inv(Mc_np[k])
        A = _adjoint_np(Mc_inv) @ S_np[k]
        prev = np.eye(4) if k == 0 else Mc_np[k - 1]
        Mprev_inv = np.linalg.inv(np.linalg.inv(prev) @ Mc_np[k])
        w, v = A[:3], A[3:]
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        W2 = W @ W
        row = {
            "A": A, "W2": W2, "Wv": W @ v, "W2v": W2 @ v,
            "Mprev_R": Mprev_inv[:3, :3], "Mprev_p": Mprev_inv[:3, 3],
            "I": G_np[k][:3, :3], "m": G_np[k][3, 3],
            "lower": lower[k] if clip_limits else -np.inf,
            "upper": upper[k] if clip_limits else np.inf,
            "vel": vel[k] if clip_velocity else np.inf,
            "u_lim": u_lim[k],
        }
        base = HEAD_FLOATS + k * LINK_STRIDE
        for name, size in LINK_FIELDS:
            at = base + LINK_AT[name]
            out[at:at + size] = np.ravel(row[name])
    return torch.from_numpy(out).to(dtype)


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _dot6(a, b):
    return ((((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3]) + a[4] * b[4]) + a[5] * b[5]


def _ad_transform(R, p, x):
    """``Ad(T) x`` for T = (R, p) (9 and 3 values) and a twist x = [w; v]:
    [R w; p x (R w) + R v]."""
    w = [_dot3(R[3 * i:3 * i + 3], x[:3]) for i in range(3)]
    Rv = [_dot3(R[3 * i:3 * i + 3], x[3:]) for i in range(3)]
    return w + [c + r for c, r in zip(_cross(p, w), Rv)]


def _inertia_apply(I, m, x):
    """G x for G = [[I, 0], [0, m 1]]."""
    return [_dot3(I[3 * i:3 * i + 3], x[:3]) for i in range(3)] + [m * x[3 + i] for i in range(3)]


def _clamp(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``fd_step_loop.cuh``'s clamp: ``x < lo ? lo : (x > hi ? hi : x)``, and
    for a clamp of zero width ``x != x ? x : hi + 0`` (+0.0 for a zero
    bound), as ``cgen.clip``; an infinite bound leaves x, NaN too."""
    inside = torch.where(x < lo, lo, torch.where(x > hi, hi, x))
    return torch.where(lo == hi, torch.where(torch.isnan(x), x, hi + 0.0), inside)


def _link_fields(tab: torch.Tensor, k: int) -> dict:
    """Link k's row of the table, field by field."""
    base = HEAD_FLOATS + k * LINK_STRIDE
    return {name: tab[base + LINK_AT[name]:base + LINK_AT[name] + size] for name, size in LINK_FIELDS}


def _link_transform(f: dict, qk):
    """``Td = exp(-[A] qk) M_prev^-1``, link k-1's CoM frame to link k's, as
    (R, p) (9 and 3 values): ``fd_step_loop.cuh``'s ``mpt_link_transform``."""
    A, W2, Wv, W2v = f["A"], f["W2"], f["Wv"], f["W2v"]
    s, c = torch.sin(qk), torch.cos(qk)
    th, sn, omc = -qk, -s, 1.0 - c
    tms = th - sn
    w0, w1, w2 = A[0], A[1], A[2]
    W = (None, -w2, w1, w2, None, -w0, -w1, w0, None)
    Re = [1.0 + omc * W2[i] if i in (0, 4, 8) else sn * W[i] + omc * W2[i] for i in range(9)]
    pe = [th * A[3 + i] + (omc * Wv[i] + tms * W2v[i]) for i in range(3)]
    Rc, pc = f["Mprev_R"], f["Mprev_p"]
    R = [_dot3(Re[3 * i:3 * i + 3], Rc[j::3]) for i in range(3) for j in range(3)]
    p = [_dot3(Re[3 * i:3 * i + 3], pc) + pe[i] for i in range(3)]
    return R, p


def _ad_twist(x, y):
    """``ad_x y`` for twists x = [w; v], y: [w x y_w; v x y_w + w x y_v]."""
    return _cross(x[:3], y[:3]) + [a + b for a, b in zip(_cross(x[3:], y[:3]), _cross(x[:3], y[3:]))]


def _wrench(I, m, V, Vd):
    """``G Vd - ad_V^T G V = G Vd + [w x Gw + v x Gv; w x Gv]``, and G V."""
    GV = _inertia_apply(I, m, V)
    GVd = _inertia_apply(I, m, Vd)
    adT_top = [x + y for x, y in zip(_cross(V[:3], GV[:3]), _cross(V[3:], GV[3:]))]
    return [x + y for x, y in zip(GVd, adT_top + _cross(V[:3], GV[3:]))], GV


def _loop_dynamics(tab: torch.Tensor, n: int, q_vals, dq_vals):
    """The looped step's pass over the links: (M, bias), M's upper triangle
    (``M[i][j]``, i <= j; the rest None) and the bias h(q, dq) with gravity."""
    g = tab[HEAD_AT["g"]:HEAD_AT["g"] + 3]
    like = q_vals[0]
    full = lambda v: torch.broadcast_to(v, like.shape)
    zero = torch.zeros_like(like)
    V = [zero] * 6
    Vd = [zero] * 3 + [full(-g[i]) for i in range(3)]
    JB = [None] * n
    M = [[None] * n for _ in range(n)]
    bias = [None] * n
    for k in range(n):
        f = _link_fields(tab, k)
        A, I, m = f["A"], f["I"], f["m"][0]
        dqk = dq_vals[k]
        R, p = _link_transform(f, q_vals[k])
        for i in range(k):
            JB[i] = _ad_transform(R, p, JB[i])
        JB[k] = [full(A[e]) for e in range(6)]
        # The RNEA's forward sweep (ddq = 0).
        Adq = [A[e] * dqk for e in range(6)]
        AdV = _ad_transform(R, p, V)
        V = [x + y for x, y in zip(AdV, Adq)]
        AdVd = _ad_transform(R, p, Vd)
        Vd = [x + y for x, y in zip(AdVd, _ad_twist(V, Adq))]
        F, _ = _wrench(I, m, V, Vd)
        for j in range(k + 1):
            GJ = _inertia_apply(I, m, JB[j])
            for i in range(j + 1):
                d = _dot6(JB[i], GJ)
                M[i][j] = d if k == j else M[i][j] + d
            d = _dot6(JB[j], F)
            bias[j] = d if k == j else bias[j] + d
    return M, bias


def fd_step_loop_planes(tab: torch.Tensor, n: int, q_vals, dq_vals, tau_vals):
    """One step of the looped program over per-joint tensor lists: ``(q',
    dq', ddq)``. ``tab`` is a :func:`link_table` in the values' dtype, on
    their device: (T,) for one robot, or (T, ...) with trailing dimensions
    that broadcast against the values, so that robots of n joints run side
    by side, a column of the table a row. The operations, their operands
    and their order are ``fd_step_loop`` 's in ``csrc/fd_step_loop.cuh``,
    so on the card this is the kernel's value bit for bit.

    One pass over the links, k = 0..n-1, carries the CoM-frame twist V and
    its rate Vd (the RNEA's forward sweep, Vd starting at [0; -g] so that
    gravity enters as the base's acceleration) and the columns JB_i, i <= k,
    of link k's CoM Jacobian, moved from link k-1's frame by the same
    transform. Link k adds JB_i . G_k JB_j to M[i][j] (i <= j <= k) and
    JB_i . F_k to bias[i], F_k = G_k Vd - ad_V^T G_k V its wrench: the
    RNEA's backward sweep written as the sum of J^T F over the links, so
    nothing is kept for a second pass. Then the Cholesky solve
    (``_chol_factor``, ``_chol_apply``), semi-implicit Euler and the
    clamps."""
    M, bias = _loop_dynamics(tab, n, q_vals, dq_vals)
    ddq = _chol_apply(*_chol_factor(M), [tau_vals[i] - bias[i] for i in range(n)])
    dt = tab[HEAD_AT["dt"]]
    dq_new, q_new = [], []
    for i in range(n):
        lo, hi, vel = _limits(tab, i)
        dq_i = dq_vals[i] + ddq[i] * dt
        q_new.append(_clamp(q_vals[i] + dq_i * dt, lo, hi))
        dq_new.append(_clamp(dq_i, -vel, vel))
    return q_new, dq_new, ddq


def _limits(tab: torch.Tensor, i: int):
    """Joint i's position bounds and velocity limit from the table."""
    base = HEAD_FLOATS + i * LINK_STRIDE
    return tuple(tab[base + LINK_AT[k]] for k in ("lower", "upper", "vel"))


# ---------------------------------------------------------------------------
# The looped step's forward mode (K2's looped form)
# ---------------------------------------------------------------------------
#
# The Jacobian columns d x'_i / d [q; dq; tau]_s of one step, seed by seed,
# the plain version of csrc/fd_step_loop_jvp.cuh. With ddq the primal's,
# M(q) ddq + h(q, dq) = tau, so
#
#     d ddq = M^-1 (d tau - r),   r = d(M ddq + h) at fixed ddq,
#
# solved with the primal's Cholesky factor. r is the tangent of the sum of
# J^T W over the links, W_k = G_k Vd_k - ad_V^T G_k V_k the link's wrench
# with Vd_k carrying the acceleration ddq too (the RNEA's full forward
# sweep): a second pass over the links, which needs ddq, carries the
# tangents of V and Vd from the seed's own joint j on. A q_j seed turns
# link j's transform, so there dV = ad_{Ad V}(A_j) and dVd = ad_{Ad
# Vd}(A_j) + ad_dV(A_j dq_j), and each earlier Jacobian column moves by
# dJB_i = ad_{JB_i}(JB_j), i < j (in link k's frame, k >= j, never
# stored); a dq_j seed starts at dV = A_j, dVd = ad_V(A_j); a tau seed has
# r = 0 and needs the solve alone. Past link j both tangents move with the
# link's transform and dVd gains ad_dV(A_k dq_k).


def _chol_factor(M):
    """The Cholesky factor of M (upper triangle read) and the reciprocals
    of its diagonal: ``_chol_solve_values``' factor, operation for
    operation, and ``fd_step_loop.cuh``'s ``mpt_chol_factor``."""
    n = len(M)
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[j][i]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L, [1.0 / L[i][i] for i in range(n)]


def _chol_apply(L, inv_diag, rhs):
    """Both triangular solves with the factor: ``mpt_chol_apply``."""
    n = len(rhs)
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv_diag[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv_diag[i]
    return x


def _clamp_tangent(p: torch.Tensor, t: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The tangent of ``_clamp(p)``, ``cgen._clip_tangent``'s rule with the
    bounds as run-time values: t strictly inside, 0.5 t on a bound, 0
    outside and for a NaN primal; an infinite bound is no bound, so with
    both infinite the tangent is t whatever p (JAX does not clip there)."""
    no_lo, no_hi = lo == -torch.inf, hi == torch.inf
    inside = ((p > lo) | no_lo) & ((p < hi) | no_hi)
    at = ((p == lo) & ~no_lo) | ((p == hi) & ~no_hi)
    return torch.where(inside, t, torch.where(at, t * 0.5, torch.zeros_like(t)))


def _loop_residual_tangents(tab: torch.Tensor, n: int, q_vals, dq_vals, ddq, seeds):
    """Per q or dq seed s of ``seeds`` (0 <= s < 2n), r_s = d(M ddq + h) /
    d s at fixed ddq (n values): the second pass, ``mpt_jvp_tangents``."""
    g = tab[HEAD_AT["g"]:HEAD_AT["g"] + 3]
    like = q_vals[0]
    full = lambda v: torch.broadcast_to(v, like.shape)
    zero = torch.zeros_like(like)
    V = [zero] * 6
    Vd = [zero] * 3 + [full(-g[i]) for i in range(3)]
    JB = [None] * n
    tan = {}  # seed: (dV, dVd), from its joint on
    r = {s: [zero] * n for s in seeds}
    for k in range(n):
        f = _link_fields(tab, k)
        A, I, m = f["A"], f["I"], f["m"][0]
        Af = [full(A[e]) for e in range(6)]
        R, p = _link_transform(f, q_vals[k])
        for i in range(k):
            JB[i] = _ad_transform(R, p, JB[i])
        JB[k] = Af
        Adq = [A[e] * dq_vals[k] for e in range(6)]
        AdV = _ad_transform(R, p, V)
        V = [x + y for x, y in zip(AdV, Adq)]
        AdVd = _ad_transform(R, p, Vd)
        Vd = [(x + y) + A[e] * ddq[k] for e, (x, y) in enumerate(zip(AdVd, _ad_twist(V, Adq)))]
        W, GV = _wrench(I, m, V, Vd)
        for s in seeds:
            j, is_q = s % n, s < n
            if k < j:
                continue
            if k == j and is_q:
                dV = _ad_twist(AdV, Af)
                dVd = [x + y for x, y in zip(_ad_twist(AdVd, Af), _ad_twist(dV, Adq))]
            elif k == j:
                dV, dVd = Af, _ad_twist(V, Af)
            else:
                dV = _ad_transform(R, p, tan[s][0])
                dVd = [x + y for x, y in zip(_ad_transform(R, p, tan[s][1]), _ad_twist(dV, Adq))]
            tan[s] = (dV, dVd)
            # dW = G dVd + [dw x Gw + w x Gdw + dv x Gv + v x Gdv; dw x Gv + w x Gdv].
            GdV, GdVd = _inertia_apply(I, m, dV), _inertia_apply(I, m, dVd)
            top = [(a + b) + (c + d) for a, b, c, d in zip(
                _cross(dV[:3], GV[:3]), _cross(V[:3], GdV[:3]), _cross(dV[3:], GV[3:]), _cross(V[3:], GdV[3:]))]
            bottom = [a + b for a, b in zip(_cross(dV[:3], GV[3:]), _cross(V[:3], GdV[3:]))]
            dW = [x + y for x, y in zip(GdVd, top + bottom)]
            rs = r[s]
            for i in range(k + 1):
                c = _dot6(JB[i], dW)
                if is_q and i < j:
                    c = c + _dot6(_ad_twist(JB[i], JB[j]), W)
                rs[i] = rs[i] + c
    return r


def fd_step_loop_jvp_planes(tab: torch.Tensor, n: int, x_vals, u_vals, seeds):
    """The looped step and its Jacobian columns over per-value tensor lists:
    ``(x', cols)``, x' = [q'; dq'] (2n values) and ``cols[c][i] = d x'_i /
    d [x; u]_s`` for s = ``seeds[c]`` (0 <= s < 3n: q, then dq, then tau).
    ``tab`` as :func:`fd_step_loop_planes` takes it. The operations, their
    operands and their order are ``csrc/fd_step_loop_jvp.cuh``'s for each
    seed, so on the card this is the kernel's value bit for bit; a seed's
    zeros are run-time values there and here alike."""
    q_vals, dq_vals = x_vals[:n], x_vals[n:]
    M, bias = _loop_dynamics(tab, n, q_vals, dq_vals)
    L, inv_diag = _chol_factor(M)
    ddq = _chol_apply(L, inv_diag, [u_vals[i] - bias[i] for i in range(n)])
    dt = tab[HEAD_AT["dt"]]
    limits = [_limits(tab, i) for i in range(n)]
    dq_pre = [dq_vals[i] + ddq[i] * dt for i in range(n)]
    q_pre = [q_vals[i] + dq_pre[i] * dt for i in range(n)]
    x_next = [_clamp(q_pre[i], lo, hi) for i, (lo, hi, _) in enumerate(limits)]
    x_next += [_clamp(dq_pre[i], -vel, vel) for i, (_, _, vel) in enumerate(limits)]
    r = _loop_residual_tangents(tab, n, q_vals, dq_vals, ddq, [s for s in seeds if s < 2 * n])
    zero, one = torch.zeros_like(q_vals[0]), torch.ones_like(q_vals[0])
    cols = []
    for s in seeds:
        j = s % n
        rhs = [-x for x in r[s]] if s < 2 * n else [one if i == j else zero for i in range(n)]
        dx = _chol_apply(L, inv_diag, rhs)
        d_dq = [dx[i] * dt for i in range(n)]
        if n <= s < 2 * n:
            d_dq[j] = 1.0 + d_dq[j]
        d_q = [d_dq[i] * dt for i in range(n)]
        if s < n:
            d_q[j] = 1.0 + d_q[j]
        cols.append([_clamp_tangent(q_pre[i], d_q[i], lo, hi) for i, (lo, hi, _) in enumerate(limits)]
                    + [_clamp_tangent(dq_pre[i], d_dq[i], -vel, vel) for i, (_, _, vel) in enumerate(limits)])
    return x_next, cols


def build_fd_step_loop(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    clip_limits: bool = True,
    clip_velocity: bool = True,
    dtype=torch.float32,
):
    """The looped step ``step(q, dq, tau) -> (q', dq', ddq)`` over (..., n)
    tensors of ``dtype`` (the table is rounded to it), the counterpart of
    :func:`build_fd_step`."""
    n = model.num_joints
    table = link_table(model, dt, g, clip_limits, clip_velocity, dtype=dtype)

    def step(q: torch.Tensor, dq: torch.Tensor, tau: torch.Tensor):
        if q.dtype != dtype:
            raise TypeError(f"this step's table is {dtype}; got {q.dtype}")
        tab = table.to(q.device)
        outs = fd_step_loop_planes(tab, n, *([x[..., i] for i in range(n)] for x in (q, dq, tau)))
        return tuple(torch.stack(vals, dim=-1) for vals in outs)

    return step


_ARITHMETIC = {"add", "sub", "rsub", "mul", "neg", "reciprocal", "div", "sqrt", "sin", "cos",
               "lt", "gt", "eq", "isnan", "where", "bitwise_and", "bitwise_or", "bitwise_not"}


def _count_ops(fn) -> int:
    """The elementwise arithmetic ``fn()`` issues (``_ARITHMETIC``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += func.overloadpacket.__name__ in _ARITHMETIC
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.ops


@functools.lru_cache(maxsize=None)
def loop_step_ops(n: int) -> int:
    """The floating-point operations of one looped step for n joints: the
    elementwise operations the plain version issues on one scenario
    (``fd_step_loop.cuh`` does the same arithmetic, and one branch of each
    clamp where the plain version evaluates both; its selects of the link's
    registers and its branches on the link index are not counted)."""
    tab = torch.full((HEAD_FLOATS + n * LINK_STRIDE,), 0.5)
    x = [torch.zeros(1) for _ in range(n)]
    return _count_ops(lambda: fd_step_loop_planes(tab, n, x, x, x))


@functools.lru_cache(maxsize=None)
def loop_jvp_ops(n: int, seeds: int) -> dict:
    """The operations of the looped K2 (``fd_step_loop_jvp.cuh``) per
    (scenario, step) for n joints and ``seeds`` q or dq seeds a thread,
    counted as :func:`loop_step_ops` counts on the plain version run one
    thread's group at a time: per seed kind (``"q"``, ``"dq"``, ``"tau"``:
    the sum over that kind's threads, each with its primal step) and
    ``"total"``. The x' the plain version also returns is not counted."""
    tab = torch.full((HEAD_FLOATS + n * LINK_STRIDE,), 0.5)
    x = [torch.zeros(1) for _ in range(2 * n)]
    groups = {"q": [list(range(j, j + seeds)) for j in range(0, n, seeds)],
              "dq": [list(range(n + j, n + j + seeds)) for j in range(0, n, seeds)],
              "tau": [list(range(2 * n, 3 * n))]}
    b = tab[0]
    xn = _count_ops(lambda: [_clamp(x[0], b, b) for _ in range(n)] + [_clamp(x[0], -b, b) for _ in range(n)])
    out = {kind: sum(_count_ops(lambda: fd_step_loop_jvp_planes(tab, n, x, x[:n], g)) - xn for g in gs)
           for kind, gs in groups.items()}
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# The looped closed-loop step (K4's and K5's looped form)
# ---------------------------------------------------------------------------
#
# The batched solver's line search and replay roll each scenario under the
# controller u = clip(u_nom + alpha k + K dx, +-u_lim), the running cost
# at the pre-step state, then the step (``clip_limits=True,
# clip_velocity=False``): ``cuda_mpc_batch.fwd_step`` on the emitted step,
# here on the looped one, with the torque bounds (``u_lim``) and the cost
# weights (COST_FIELDS) read from the table. Every sum keeps the emitted
# order: ((u_nom + alpha k_j) + K_j0 dx_0) + K_j1 dx_1 ..., and the cost
# joint by joint, its first term set, not added to 0.


def fwd_table(
    model: RobotModel,
    dt: float,
    g=DEFAULT_G,
    u_lim=None,
    w_q: float = 10.0,
    w_dq: float = 0.5,
    w_u: float = 1e-4,
    w_terminal: float = 100.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """The looped closed-loop step's table: :func:`link_table` of its step
    (``clip_velocity=False``) with the torque bounds ``u_lim``, then the
    cost weights (``COST_FIELDS``: w_q, w_dq, w_u and the terminal weights
    w_terminal and 0.1 w_terminal, as ``cuda_mpc_batch.Costs`` forms them),
    computed in f64 and rounded once to ``dtype``: 4 + 50 n + 5 floats."""
    weights = {"w_q": w_q, "w_dq": w_dq, "w_u": w_u, "wT_q": float(w_terminal), "wT_dq": 0.1 * float(w_terminal)}
    tail = torch.from_numpy(np.array([float(weights[name]) for name, _ in COST_FIELDS])).to(dtype)
    return torch.cat([link_table(model, dt, g, clip_velocity=False, dtype=dtype, u_lim=u_lim), tail])


def _cost_weights(tab: torch.Tensor, n: int) -> dict:
    """The cost weights after the table of an n-joint robot."""
    base = HEAD_FLOATS + n * LINK_STRIDE
    return {name: tab[base + at] for name, at in COST_AT.items()}


def fd_fwd_loop_planes(tab: torch.Tensor, n: int, x_vals, sdx_vals, sdu_vals, kk_vals, goal_vals, alpha):
    """One closed-loop step on the looped program over per-value tensor
    lists: ``(u, c, x')``. ``tab`` is a :func:`fwd_table` in the values'
    dtype on their device, (T,) or (T, ...) as :func:`fd_step_loop_planes`
    takes it; ``kk_vals`` the step's gains, flat ``n * (1 + 2n)`` (k_j, then
    row j of K); ``alpha`` a tensor that broadcasts against the values. The
    operations, their operands and their order are the looped K4's and
    K5's (``mpt_fwd_loop_step``, ``csrc/mpc_batch.cuh``), so on the card
    this is the kernel's value bit for bit."""
    nx = 2 * n
    w = _cost_weights(tab, n)
    dx = [x_vals[i] - sdx_vals[i] for i in range(nx)]
    u = []
    for j in range(n):
        row = kk_vals[j * (1 + nx):(j + 1) * (1 + nx)]
        uj = sdu_vals[j] + alpha * row[0]
        for i in range(nx):
            uj = uj + row[1 + i] * dx[i]
        lim = tab[HEAD_FLOATS + j * LINK_STRIDE + LINK_AT["u_lim"]]
        u.append(_clamp(uj, -lim, lim))
    c = None
    for i in range(n):
        e = x_vals[i] - goal_vals[i]
        t = (w["w_q"] * e) * e
        c = t if c is None else c + t
        c = c + (w["w_dq"] * x_vals[n + i]) * x_vals[n + i]
    for j in range(n):
        c = c + (w["w_u"] * u[j]) * u[j]
    q2, dq2, _ = fd_step_loop_planes(tab, n, list(x_vals[:n]), list(x_vals[n:]), u)
    return u, c, list(q2) + list(dq2)


def loop_terminal_cost(tab: torch.Tensor, n: int, x_vals, goal_vals):
    """The terminal cost with the table's weights: ``sum wT_q (q - goal)^2 +
    wT_dq dq^2`` in ``cuda_mpc_batch.terminal_cost``'s order (the looped
    K4's and K5's ``mpt_fwd_loop_terminal``)."""
    w = _cost_weights(tab, n)
    c = None
    for i in range(n):
        e = x_vals[i] - goal_vals[i]
        t = (w["wT_q"] * e) * e
        c = t if c is None else c + t
        c = c + (w["wT_dq"] * x_vals[n + i]) * x_vals[n + i]
    return c


def loop_terminal_cost_fused(tab: torch.Tensor, n: int, x_vals, goal_vals):
    """K8's terminal cost with the table's weights: every q term ``wT_q (q -
    goal)^2``, then every dq term ``wT_dq dq^2``, the order of
    ``cuda_mpc_single.terminal_cost_fused`` (the looped K8's
    ``fwdl_terminal_cost``, ``csrc/fwd_loop_lanes.cuh``)."""
    w = _cost_weights(tab, n)
    c = None
    for i in range(n):
        e = x_vals[i] - goal_vals[i]
        t = (w["wT_q"] * e) * e
        c = t if c is None else c + t
    for i in range(n):
        c = c + (w["wT_dq"] * x_vals[n + i]) * x_vals[n + i]
    return c


@functools.lru_cache(maxsize=None)
def loop_fwd_ops(n: int) -> int:
    """The floating-point operations of one looped closed-loop step for n
    joints (the controller, the running cost and the looped step), counted
    as :func:`loop_step_ops` counts, on :func:`fd_fwd_loop_planes`: the
    looped K4's and K5's own operations a (scenario, alpha) and step."""
    tab = torch.full((HEAD_FLOATS + n * LINK_STRIDE + COST_FLOATS,), 0.5)
    x = [torch.zeros(1) for _ in range(2 * n * (2 + n))]
    return _count_ops(lambda: fd_fwd_loop_planes(tab, n, x[:2 * n], x[:2 * n], x[:n], x, x[:n], x[0]))


def loop_rollout_plain(tab: torch.Tensor, n: int, intRes: int, q0: torch.Tensor, dq0: torch.Tensor,
                       taumat: torch.Tensor):
    """The looped rollout's plain loop over the N waypoints and ``intRes``
    substeps of :func:`fd_step_loop_planes` with the table ``tab`` (see
    there: one robot's, or a column a row of the (B, n) states); outputs
    as :class:`Rollout`'s."""
    N = taumat.shape[-2]
    q = [q0[..., i] for i in range(n)]
    dq = [dq0[..., i] for i in range(n)]
    qs, dqs, ddqs = [], [], []
    for t in range(N):
        tau = [taumat[..., t, i] for i in range(n)]
        qs.append(q)
        dqs.append(dq)
        for _ in range(intRes):
            q, dq, ddq = fd_step_loop_planes(tab, n, q, dq, tau)
        ddqs.append(ddq)
    stack = lambda rows: torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)
    return stack(qs), stack(dqs), stack(ddqs)


class LoopRollout(nn.Module):
    """The plain PyTorch version of the looped rollout kernel:
    :func:`loop_rollout_plain` over the robot's link table (``table``,
    float32 on the host: what the kernel gets; a float64 call uses the table
    unrounded). Same contract as :class:`Rollout`."""

    kind = "torch"

    def __init__(self, model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G):
        super().__init__()
        if intRes < 1:
            raise ValueError("intRes must be >= 1")
        self.n, self.intRes = model.num_joints, int(intRes)
        self.table = link_table(model, float(dt) / intRes, g)
        self._tables = {torch.float32: self.table,
                        torch.float64: link_table(model, float(dt) / intRes, g, dtype=torch.float64)}

    def forward(self, q0: torch.Tensor, dq0: torch.Tensor, taumat: torch.Tensor):
        tab = self._tables.get(q0.dtype)
        if tab is None:
            raise TypeError(f"the looped rollout takes float32 or float64, got {q0.dtype}")
        return loop_rollout_plain(tab.to(q0.device), self.n, self.intRes, q0, dq0, taumat)


def build_loop_rollout(model: RobotModel, dt: float = 0.01, intRes: int = 1, g=DEFAULT_G) -> LoopRollout:
    """The plain PyTorch version of the looped rollout kernel
    (``ops/cuda_rollout.py``, the looped form)."""
    return LoopRollout(model, dt=dt, intRes=intRes, g=g)
