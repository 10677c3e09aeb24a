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
"""

from __future__ import annotations

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
