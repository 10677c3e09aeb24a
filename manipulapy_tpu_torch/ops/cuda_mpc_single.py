"""Hand-written CUDA kernels of the single-problem fused tracking MPC
(K6-K8), with their plain PyTorch versions.

Counterpart of the three ``pallas_call``s of ``manipulapy_tpu/mpc/fused.py``:

* K6 ``linearize`` (``lin_kernel``): ``A_t, B_t = d x' / d [x; u]`` of the
  step program with ``clip_velocity=False`` at every step of one horizon,
  over the m = 3n seeds: the function K2 computes, at one problem; each
  (step, seed) lane runs the lean one-seed body (K2's for Panda), one
  thread a lane, or, with ``LIN_WARPS`` > 0, split over a team of warps
  (:func:`lin_team_step`);
* K7 ``backward`` (``bwd_kernel``): the time-reversed Riccati sweep of one
  problem from a given terminal value function, Quu solved by the
  pivot-free Gauss-Jordan of ``_gj_solve``; one block of ``BWD_THREADS``
  threads runs the sweep;
* K8 ``forward`` (``fwd_kernel``): the closed-loop rollout of every
  line-search alpha, streaming out xs and us, with the running and
  terminal cost.

Each kernel's arithmetic is one Python function over cgen values
(``ops/fd_step.py::build_fd_step_jvp_planes`` for K6, emitted ``lean``,
:func:`riccati_step_gj` for K7, ``ops/cuda_mpc_batch.py::fwd_step`` and
:func:`terminal_cost_fused` for K8). Run on tensors it is the plain PyTorch
version; run on CVars it is the kernel's device function (template
``csrc/mpc_single.cuh``), built with ``--fmad=false``, so the two agree
bitwise. The order of every sum is the JAX kernels'. K7 is the exception:
one block of threads runs :func:`riccati_step_gj`'s sums as phases, written
by hand in the template in the same order; the emitted step
(``riccati_step_source``) is the host tests' reference for them.

Layout: time-major, one problem. ``xs (H, nx)``, ``us (H, n)``, ``AB (H,
nx, m)`` (row i: ``A[i, :]`` then ``B[i, :]``), ``kK (H, n, 1+nx)`` (``[t,
j, 0]`` = k_j, ``[t, j, 1+i]`` = K_ji, K3's row format), ``goal (n,)``,
``Vterm (nx+1, nx)`` (Vxx rows, then Vx), ``reg ()``, ``x0 (nx,)``,
``alphas (A,)``; K8 returns ``xs (A, H, nx)`` post-step states, ``us (A,
H, n)`` and ``costs (A,)``.

On CPU tensors every stage runs its plain version, and only because the
tensors lie on the CPU. On CUDA tensors it launches its kernel or raises:
float32, contiguous, one device, the shapes above. Each launch adds one to
``SingleMPCKernels.launch_count[stage]`` (all instances).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List

import torch

from . import cgen as cg
from .cuda_mpc_batch import (
    LIN_FLAGS,
    Costs,
    MPCKernelSet,
    _stack,
    _sum,
    bwd_weights,
    fwd_signature,
    fwd_step,
    team_layout,
)
from .fd_step import _full, build_fd_step_jvp_group_source, build_fd_step_jvp_planes

__all__ = [
    "SingleMPCKernels",
    "STAGES",
    "BWD_THREADS",
    "FWD_WARPS",
    "LIN_WARPS",
    "lin_team_step",
    "riccati_step_gj",
    "terminal_cost_fused",
]

TEMPLATE = Path(__file__).resolve().parents[1] / "csrc" / "mpc_single.cuh"
BWD_THREADS = 256  # K7's block; chip_compare.py times 128 and 512 beside it (PERF.md)
# K8: warps of its team (the partition of the emitted step, ``cg.team_function``),
# chosen by timing Panda's K8 on an H100 (``chip_compare.py``, PERF.md section 6).
FWD_WARPS = 32
# K6: warps of a team per 32 (step, seed) lanes (``lin_team_step``), or 0 for
# one thread a lane; chosen by timing Panda's K6 on an H100
# (``chip_compare.py --variants``, PERF.md section 6): 8 warps 18% faster
# than one thread a lane in one call, 2, 4 and 16 warps slower than 8.
LIN_WARPS = 8
STAGES = ("linearize", "backward", "forward")
UNITS = {"lin": ("linearize",), "bwd": ("backward",), "fwd": ("forward",)}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "linearize": [_P] * 3 + [_I, _P],
    "backward": [_P] * 7 + [_I, _P],
    "forward": [_P] * 9 + [_I, _I, _P],
}


def _gj_solve_rows(aug: List[List], n: int) -> List[List]:
    """``_gj_solve`` over values: the augmented rows ``[M | rhs]`` (n rows,
    ``M`` n x n) reduced by pivot-free Gauss-Jordan; returns the rows of
    ``M^{-1} rhs``. Per pivot p: one reciprocal, the pivot row scaled by
    it, and ``row_r - aug[r][p] * row_p`` for every other row. Columns
    left of p+1 are never read again and are not computed."""
    width = len(aug[0])
    aug = [list(row) for row in aug]
    for p in range(n):
        inv_p = cg.recip(aug[p][p])
        row_p = {c: cg.mul(aug[p][c], inv_p) for c in range(p + 1, width)}
        for r in range(n):
            if r == p:
                continue
            col = aug[r][p]
            for c in range(p + 1, width):
                aug[r][c] = cg.sub(aug[r][c], cg.mul(col, row_p[c]))
        for c in range(p + 1, width):
            aug[p][c] = row_p[c]
    return [row[n:] for row in aug]


def lin_team_step(model, dt, g, warps: int) -> cg.TeamStep:
    """K6's body split over a team of ``warps`` warps (``cg.team_function``):
    the lean one-seed body, the statements of ``fd_step_jvp_group`` at one
    seed in its order, with the seed's one-hot row ``s`` (m values, ``s_i
    = k == i ? 1 : 0``) an input column beside x and u, and column k of the
    Jacobian its output; every value a column of ``MPT_TS`` lanes
    (``xin``: x, u, s; ``cout``: the column)."""
    n, step_jvp = build_fd_step_jvp_planes(model, dt, g=g, lean=True)
    nx, m = 2 * n, 3 * n

    def body(x, u, s):
        return [step_jvp(x, u, s[:nx], s[nx:])[1]]

    layout = {"x": ("xin", 0, "MPT_TS"), "u": ("xin", nx, "MPT_TS"), "s": ("xin", nx + n, "MPT_TS"),
              "col": ("cout", 0)}
    return cg.team_function("mpt_lin_team", [("x", nx), ("u", n), ("s", m)], [], [("col", nx)], body, layout, warps)


def riccati_step_gj(P: Costs, ab, x, u, goal, V, reg):
    """One step of the single-problem backward sweep (``bwd_kernel`` of
    ``fused.py``) over values, sum for sum.

    ``ab``: the step's Jacobian flat ``nx * m`` (row i: ``A[i, :]`` then
    ``B[i, :]``); ``x``, ``u``: the nominal pre-step state and control;
    ``goal``: the n joint goals; ``V``: the value function flat ``(nx+1) *
    nx``; ``reg``: the Levenberg term. Returns ``(kk, V_next)``, ``kk`` flat
    ``n * (1+nx)`` (``k_j``, then row j of K).

    It differs from ``riccati_step`` of the batched kernels: the diagonal
    cost terms come first in Qxx and Quu, Quu is solved by Gauss-Jordan, and
    Vxx' is taken in full and then symmetrised, ``0.5 (V + V^T)``."""
    n, nx = P.n, 2 * P.n
    m = nx + n
    x_goal = list(goal) + [0.0] * n
    Am = [[ab[i * m + k] for k in range(nx)] for i in range(nx)]
    Bm = [[ab[i * m + nx + j] for j in range(n)] for i in range(nx)]
    Vxx = [[V[i * nx + k] for k in range(nx)] for i in range(nx)]
    Vx = [V[nx * nx + i] for i in range(nx)]

    lx = [cg.mul(2.0 * P.w_x[i], cg.sub(x[i], x_goal[i])) for i in range(nx)]
    lu = [cg.mul(2.0 * P.w_u, u[j]) for j in range(n)]
    Qx = [cg.add(lx[i], _sum(cg.mul(Vx[k], Am[k][i]) for k in range(nx))) for i in range(nx)]
    Qu = [cg.add(lu[j], _sum(cg.mul(Vx[k], Bm[k][j]) for k in range(nx))) for j in range(n)]
    VA = [[_sum(cg.mul(Vxx[k][l], Am[l][i]) for l in range(nx)) for i in range(nx)] for k in range(nx)]
    VB = [[_sum(cg.mul(Vxx[k][l], Bm[l][j]) for l in range(nx)) for j in range(n)] for k in range(nx)]
    # Qxx = diag(2 w_x) + A^T V A; Quu = (diag(2 w_u) + reg I) + B^T V B.
    Qxx = [
        [
            cg.add((2.0 * P.w_x[i]) if i == k else 0.0, _sum(cg.mul(Am[l][i], VA[l][k]) for l in range(nx)))
            for k in range(nx)
        ]
        for i in range(nx)
    ]
    Quu = [
        [
            cg.add(
                cg.add(2.0 * P.w_u, reg) if j == j2 else 0.0,
                _sum(cg.mul(Bm[l][j], VB[l][j2]) for l in range(nx)),
            )
            for j2 in range(n)
        ]
        for j in range(n)
    ]
    Qux = [[_sum(cg.mul(Bm[l][j], VA[l][i]) for l in range(nx)) for i in range(nx)] for j in range(n)]

    # Quu^{-1} [Qu | Qux], then negate: k = -sol[:, 0], K = -sol[:, 1:].
    sol = _gj_solve_rows([Quu[j] + [Qu[j]] + Qux[j] for j in range(n)], n)
    k_t = [cg.neg(sol[j][0]) for j in range(n)]
    K = [[cg.neg(sol[j][1 + i]) for i in range(nx)] for j in range(n)]

    # Vx' = Qx + K^T (Quu k + Qu) + Qux^T k
    Quu_k = [_sum(cg.mul(Quu[j][j2], k_t[j2]) for j2 in range(n)) for j in range(n)]
    Vx_new = [
        cg.add(
            cg.add(Qx[i], _sum(cg.mul(cg.add(Quu_k[j], Qu[j]), K[j][i]) for j in range(n))),
            _sum(cg.mul(k_t[j], Qux[j][i]) for j in range(n)),
        )
        for i in range(nx)
    ]
    # Vxx' = Qxx + (K^T Quu) K + K^T Qux + Qux^T K, then 0.5 (Vxx' + Vxx'^T).
    KtQuu = [[_sum(cg.mul(K[j][i], Quu[j][j2]) for j in range(n)) for j2 in range(n)] for i in range(nx)]
    full = [
        [
            cg.add(
                cg.add(
                    cg.add(Qxx[i][k], _sum(cg.mul(KtQuu[i][j2], K[j2][k]) for j2 in range(n))),
                    _sum(cg.mul(K[j][i], Qux[j][k]) for j in range(n)),
                ),
                _sum(cg.mul(Qux[j][i], K[j][k]) for j in range(n)),
            )
            for k in range(nx)
        ]
        for i in range(nx)
    ]
    Vxx_new = [[None] * nx for _ in range(nx)]
    for i in range(nx):
        for k in range(i, nx):
            # a + b == b + a in IEEE arithmetic: one value serves both halves.
            Vxx_new[i][k] = Vxx_new[k][i] = cg.mul(0.5, cg.add(full[i][k], full[k][i]))
    kk = [v for j in range(n) for v in [k_t[j]] + K[j]]
    return kk, [v for row in Vxx_new for v in row] + Vx_new


def terminal_cost_fused(P: Costs, x, goal):
    """The terminal cost of ``fwd_kernel``: ``sum_i wT_i (x_i - xg_i)^2``
    over the nx state entries in order, every q term before the dq terms
    (the dq goal is 0). ``terminal_cost`` of the batched kernels
    interleaves q_i and dq_i."""
    n = P.n
    x_goal = list(goal) + [0.0] * n
    c = 0.0
    for i in range(2 * n):
        e = cg.sub(x[i], x_goal[i])
        c = cg.add(c, cg.mul(cg.mul(P.wT[i], e), e))
    return c


class SingleMPCKernels(MPCKernelSet):
    """K6-K8 for one (robot, dt, g, cost weights, torque limits). K6's unit
    runs the lean one-seed body one thread a lane (``LIN_WARPS`` = 0) or
    split over a team of ``LIN_WARPS`` warps (``self.lin_team``); the
    one-seed ``fd_step_jvp`` stays out of it, as ``linearize_seed_source``,
    and so does the body for a team, as ``linearize_group_source``: the
    host tests' references. Only the units of ``UNITS`` are built."""

    STAGES, UNITS, ARGTYPES, LIB_PREFIX = STAGES, UNITS, _ARGTYPES, "mpc_single"
    TEMPLATE, DEFINES = TEMPLATE, {"MPT_BWD_THREADS": BWD_THREADS}
    FWD_WARPS, TEAM_STAGE = FWD_WARPS, "forward"
    LIN_WARPS, UNIT_FLAGS = LIN_WARPS, {"lin": LIN_FLAGS}
    LAYOUTS = {"lin": ("linearize_team", "mpt_layout_linearize_team")}
    launch_count: Dict[str, int] = dict.fromkeys(STAGES, 0)  # all instances
    lin_team = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.lin_team is not None:  # the team body goes where the template marks it, after MPT_TS
            lin = self.sources["lin"]
            at = lin.rindex("// MPT_LIN_TEAM_STEP:")
            self.sources["lin"] = lin[:at] + self.lin_team.source + lin[at:]

    def _bodies(self, model, dt, g) -> Dict[str, str]:
        """The units' generated parts; also ``riccati_step_source``, K8's
        ``team`` and K6's ``lin_team`` (``cg.TeamStep``) and, per emitted
        body, ``chains``: its longest chain of dependent statements
        (``cg.chain_length``)."""
        P, n, nx = self.P, self.n, self.nx
        kkn, vn = n * (1 + nx), (nx + 1) * nx
        self.linearize_seed_source = self._linearize_body(model, dt, g)
        ems = []
        _, self.linearize_group_source, self.statements["linearize_group"] = build_fd_step_jvp_group_source(
            model, dt, g=g, seeds=1, emitter=ems
        )
        lin_chain = cg.chain_length(ems[0])
        if self.LIN_WARPS:
            self.lin_team = lin_team_step(model, dt, g, self.LIN_WARPS)
            lin_src = f"{cg.KEEP_SOURCE}{cg.TEAM_SOURCE}#define MPT_LIN_TEAM 1\n"
        else:
            lin_src = f"#define MPT_LIN_SEEDS 1\n{self.linearize_group_source}"
        # K7's phases (csrc/mpc_single.cuh) do riccati_step_gj's operations,
        # so its emitted body stays out of the unit: it is the host harness's
        # reference and its statements K7's operation count.
        ems = []
        self.riccati_step_source, self.statements["backward"] = cg.c_function(
            "riccati_step_gj", [("ab", nx * self.m), ("x", nx), ("u", n), ("goal", n), ("V", vn)],
            ["reg"], [("kk", kkn), ("V_next", vn)],
            lambda ab, x, u, goal, V, reg: riccati_step_gj(P, ab, x, u, goal, V, reg), emitter=ems,
        )
        self._bwd_emitter = ems[0]

        def fwd_body(x, sdx, sdu, kk, goal, alpha):
            u, c, x_next = fwd_step(P, x, sdx, sdu, kk, goal, alpha)
            return u, [c], x_next

        ems = []
        fwd_src, self.statements["forward"] = cg.c_function("mpc_fwd_step", *fwd_signature(P), fwd_body, emitter=ems)
        cost_src, self.statements["cost_terminal"] = cg.c_function(
            "mpc_terminal_fused", [("x", nx), ("goal", n)], [], [("c", 1)],
            lambda x, goal: [[terminal_cost_fused(P, x, goal)]], emitter=ems,
        )
        # K8: the same step split over a team of warps, the alphas on its
        # lanes (columns of 32), the rows and the goal shared by every lane.
        self.team = cg.team_function("mpt_fwd_team", *fwd_signature(P), fwd_body, team_layout(P, "1"), self.FWD_WARPS)
        self.chains = {
            "linearize": lin_chain,
            "backward": cg.chain_length(self._bwd_emitter),
            "forward": cg.chain_length(ems[0]),
            "cost_terminal": cg.chain_length(ems[1]),
        }
        team_src = f"#define MPT_TS 32\n{cg.TEAM_SOURCE}{self.team.source}"
        return {"lin": lin_src, "bwd": bwd_weights(P), "fwd": fwd_src + cost_src + team_src}

    # -- checks ------------------------------------------------------------
    @staticmethod
    def _horizon(xs: torch.Tensor) -> int:
        if xs.dim() != 2:
            raise ValueError(f"xs must be (H, nx), got {tuple(xs.shape)}")
        H = xs.shape[0]
        if not 1 <= H <= 65535:
            raise ValueError(f"H must be in [1, 65535], got {H}")
        return H

    # -- K6 ----------------------------------------------------------------
    def linearize(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """xs (H, nx) pre-step states, us (H, n) -> AB (H, nx, m)."""
        H = self._horizon(xs)
        n, nx, m = self.n, self.nx, self.m
        if not self._route("linearize", {"xs": xs, "us": us}, {"xs": (H, nx), "us": (H, n)}):
            return self.linearize_plain(xs, us)
        AB = torch.empty((H, nx, m), dtype=xs.dtype, device=xs.device)
        self._launch("linearize", xs.device, xs, us, AB, H)
        return AB

    # -- K7 ----------------------------------------------------------------
    def backward(self, AB, xs, us, goal, Vterm, reg) -> torch.Tensor:
        """-> gains kK (H, n, 1+nx)."""
        H = self._horizon(xs)
        n, nx, m = self.n, self.nx, self.m
        tensors = {"AB": AB, "xs": xs, "us": us, "goal": goal, "Vterm": Vterm, "reg": reg}
        shapes = {"AB": (H, nx, m), "xs": (H, nx), "us": (H, n), "goal": (n,),
                  "Vterm": (nx + 1, nx), "reg": ()}
        if not self._route("backward", tensors, shapes):
            return self.backward_plain(AB, xs, us, goal, Vterm, reg)
        kK = torch.empty((H, n, 1 + nx), dtype=xs.dtype, device=xs.device)
        self._launch("backward", xs.device, AB, xs, us, goal, Vterm, reg, kK, H)
        return kK

    def backward_plain(self, AB, xs, us, goal, Vterm, reg) -> torch.Tensor:
        n, nx, m = self.n, self.nx, self.m
        H = xs.shape[0]
        g = [goal[j] for j in range(n)]
        V = [Vterm[i, k] for i in range(nx + 1) for k in range(nx)]
        rows = [None] * H
        for t in range(H - 1, -1, -1):
            ab = [AB[t, i, k] for i in range(nx) for k in range(m)]
            kk, V = riccati_step_gj(
                self.P, ab, [xs[t, i] for i in range(nx)], [us[t, j] for j in range(n)], g, V, reg
            )
            rows[t] = _stack(kk, reg).reshape(n, 1 + nx)
        return torch.stack(rows)

    # -- K8 ----------------------------------------------------------------
    def forward(self, x0, sd_x, sd_u, kK, goal, alphas):
        """Roll every alpha (A,) closed loop: -> (xs (A, H, nx) post-step
        states, us (A, H, n), costs (A,))."""
        H = self._horizon(sd_x)
        n, nx = self.n, self.nx
        A = alphas.shape[0] if alphas.dim() == 1 else -1
        if not 1 <= A <= 65535:
            raise ValueError(f"forward takes 1 to 65535 alphas, got {A}")
        tensors = {"x0": x0, "sd_x": sd_x, "sd_u": sd_u, "kK": kK, "goal": goal, "alphas": alphas}
        shapes = {"x0": (nx,), "sd_x": (H, nx), "sd_u": (H, n), "kK": (H, n, 1 + nx),
                  "goal": (n,), "alphas": (A,)}
        if not self._route("forward", tensors, shapes):
            return self.forward_plain(x0, sd_x, sd_u, kK, goal, alphas)
        xs = torch.empty((A, H, nx), dtype=x0.dtype, device=x0.device)
        us = torch.empty((A, H, n), dtype=x0.dtype, device=x0.device)
        costs = torch.empty((A,), dtype=x0.dtype, device=x0.device)
        self._launch("forward", x0.device, x0, sd_x, sd_u, kK, goal, alphas, xs, us, costs, H, A)
        return xs, us, costs

    def forward_plain(self, x0, sd_x, sd_u, kK, goal, alphas):
        n, nx = self.n, self.nx
        H = sd_x.shape[0]
        like = torch.zeros_like(alphas)
        g = [goal[j] for j in range(n)]
        x = [x0[i] for i in range(nx)]
        acc = like
        xs_rows, us_rows = [], []
        for t in range(H):
            kk = [kK[t, j, c] for j in range(n) for c in range(1 + nx)]
            u, c, x = fwd_step(
                self.P, x, [sd_x[t, i] for i in range(nx)], [sd_u[t, j] for j in range(n)], kk, g, alphas
            )
            acc = cg.add(acc, c)
            xs_rows.append(_stack(x, like, dim=-1))
            us_rows.append(_stack(u, like, dim=-1))
        cost = cg.add(acc, terminal_cost_fused(self.P, x, g))
        return torch.stack(xs_rows, dim=1), torch.stack(us_rows, dim=1), _full(cost, like)
