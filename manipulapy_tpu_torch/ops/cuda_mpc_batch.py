"""Hand-written CUDA kernels of the batched fused tracking MPC (K2-K5),
with their plain PyTorch versions.

Counterpart of the four ``pallas_call``s of
``manipulapy_tpu/mpc/fused_batch.py``:

* K2 ``linearize`` (``lin_kernel``): ``A_t, B_t = d x' / d [x; u]`` of the
  step program with ``clip_velocity=False``, over the m = 3n seeds, a
  group of them a thread (``fd_step_jvp_group``: the primal step once,
  each tangent once per seed, as ``jax.linearize`` and its vmapped linear
  program do), as many as :func:`lin_seeds` gives for the robot;
* K3 ``backward`` (``bwd_kernel``): the time-reversed Riccati sweep with a
  per-scenario Levenberg term and the unrolled Cholesky solve of
  ``_chol_solve_tiles``;
* K4 ``linesearch_costs`` (``cost_kernel``): the closed-loop cost of every
  alpha for every scenario; ``linesearch`` is the same kernel keeping every
  alpha's trajectory too, so the solver selects the chosen one, as the JAX
  single-problem solver's forward kernel does (``mpc/fused.py``);
* K5 ``replay`` (``replay_kernel``): the rollout of each scenario's own
  alpha, streaming out xs, us and the cost, one thread a scenario; a
  variant unit (``TEAM_WARPS`` > 0) runs each step on a team of warps.

Each kernel's arithmetic is one Python function over cgen values
(:func:`riccati_terminal`, :func:`riccati_step`, :func:`fwd_step`,
:func:`terminal_cost`, and ``ops/fd_step.py::build_fd_step_jvp_planes``
for K2). Run on tensors it is the plain PyTorch version; run on CVars it
is the kernel's device function (template ``csrc/mpc_batch.cuh``), built
with ``--fmad=false``, so the two agree bitwise. The order of every sum
is the JAX kernels'. K3 is the exception: one warp per scenario runs
:func:`riccati_step`'s sums as phases over its lanes, written by hand in
the template in the same order; the emitted step
(``riccati_step_source``) is the host tests' reference for them.

Layout: scenario-minor, ``xs (H, nx, B)``, ``us (H, n, B)``, ``AB (H, nx,
m, B)``, ``kK (H, n, 1+nx, B)`` (``[..., j, 0, :]`` = k_j, ``[..., j, 1+i,
:]`` = K_ji), ``x0 (nx, B)``, ``goal (n, B)``, ``reg``/``alpha``/``cost
(B,)``, ``costs (A, B)``, and ``linesearch``'s ``xs_all (H, nx, A, B)``,
``us_all (H, n, A, B)``.

On CPU tensors every stage runs its plain version, and only because the
tensors lie on the CPU. On CUDA tensors it launches its kernel or raises:
float32, contiguous, one device, the shapes above. Each launch adds one to
``BatchMPCKernels.launch_count[stage]`` (all instances).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Sequence

import torch

from . import cgen as cg
from ._build import KernelSet
from .fd_step import (
    DEFAULT_G,
    _full,
    build_fd_step_jvp_group_source,
    build_fd_step_jvp_planes,
    build_fd_step_jvp_source,
    build_fd_step_planes,
)
from ..models.robot import RobotModel, host_arrays

__all__ = [
    "MPCKernelSet",
    "BatchMPCKernels",
    "STAGES",
    "BLOCK",
    "lin_seeds",
    "LIN_BLOCK",
    "TEAM_WARPS",
    "TEAM_S",
    "TEAM_PER_BLOCK",
    "riccati_terminal",
    "riccati_step",
    "bwd_weights",
    "fwd_step",
    "terminal_cost",
]

TEMPLATE = Path(__file__).resolve().parents[1] / "csrc" / "mpc_batch.cuh"
BLOCK = 128  # threads per block (K4, K5)
# K2: threads a block (``MPT_LIN_BLOCK``; 64 leave each thread more shared
# memory to spill into than 128) and ptxas's -O1, whose schedule spills less
# than its default -O3 and builds ~3x faster (``chip_k2_variants.py``).
LIN_BLOCK = 64
LIN_FLAGS = ("-Xptxas", "-O1")


def lin_seeds(n: int) -> int:
    """K2's tangent seeds a thread (``MPT_LIN_SEEDS``) for a robot of n
    joints: 3 where the primal step and three tangents fit a thread's 255
    registers, up to 6 joints (UR5: 40 local bytes, 19-24% faster than one
    seed), else 1 (Panda: three seeds spill 1560 local bytes and take 1.7x
    as long; one seed spills nothing and is 1-3% faster than a unit of the
    one-seed ``fd_step_jvp`` in blocks of 128 at ptxas -O3). Both measured
    in one ``chip_compare.py`` call on an H100 (PERF.md section 6)."""
    return 3 if n <= 6 else 1


# K5: one thread a scenario (``TEAM_WARPS`` = 0). A variant unit runs a team
# of ``TEAM_WARPS`` warps per ``TEAM_S`` scenarios at most (``MPT_TEAM_S_MAX``,
# halved until a team fits a block), ``TEAM_PER_BLOCK`` teams a block: 1.3x
# to 3.2x slower for Panda on an H100 (``chip_compare.py``, PERF.md
# section 6).
TEAM_WARPS, TEAM_S, TEAM_PER_BLOCK = 0, 32, 2
STAGES = ("linearize", "backward", "linesearch_costs", "linesearch", "replay")
# Translation units: K4 and K5 share one emitted body.
UNITS = {"lin": ("linearize",), "bwd": ("backward",), "fwd": ("linesearch_costs", "linesearch", "replay")}
# Per unit, the entry (``mpt_layout_*``) that gives a block's dynamic shared
# bytes where the unit's kernel takes them: K3, K5's team variant.
LAYOUTS = {"bwd": ("backward", "mpt_layout_backward"), "fwd": ("replay_team", "mpt_layout_replay_team")}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "linearize": [_P] * 3 + [_I, _I, _P],
    "backward": [_P] * 7 + [_I, _I, _P],
    "linesearch_costs": [_P] * 7 + [_I, _I, _I, _P],
    "linesearch": [_P] * 9 + [_I, _I, _I, _P],
    "replay": [_P] * 9 + [_I, _I, _P],
}


class Costs:
    """The tracking problem's folded constants: state weights ``w_x``
    (2n), control weight ``w_u``, terminal weights ``wT`` (2n), torque
    limits ``u_lim`` (n) and the step program (``clip_velocity=False``)."""

    def __init__(self, model, dt, g, w_q, w_dq, w_u, w_terminal, u_lim):
        self.n, self.step = build_fd_step_planes(
            model, float(dt), g=g, clip_limits=True, clip_velocity=False
        )
        n = self.n
        self.w_q, self.w_dq, self.w_u = float(w_q), float(w_dq), float(w_u)
        self.w_x = [self.w_q] * n + [self.w_dq] * n
        self.wT = [float(w_terminal)] * n + [0.1 * float(w_terminal)] * n
        self.u_lim = [float(v) for v in u_lim]


def _sum(terms: Sequence) -> cg.Value:
    """``sum(terms)`` in Python's order (0 + t0 + t1 + ...), folded."""
    s = 0.0
    for t in terms:
        s = cg.add(s, t)
    return s


def _chol_solve_cols(M, cols):
    """``_chol_solve_tiles`` of the JAX kernel over values: the unrolled
    Cholesky of the symmetric ``M`` (lower half read) and both triangular
    solves for each right-hand column."""
    n = len(M)
    L = [[None] * (i + 1) for i in range(n)]
    inv_d = [None] * n
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = cg.sub(s, cg.mul(L[j][k], L[j][k]))
        d = cg.sqrt(s)
        L[j][j] = d
        inv_d[j] = cg.recip(d)
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = cg.sub(s, cg.mul(L[i][k], L[j][k]))
            L[i][j] = cg.mul(s, inv_d[j])
    out = []
    for rhs in cols:
        y = [None] * n
        for i in range(n):
            s = rhs[i]
            for k in range(i):
                s = cg.sub(s, cg.mul(L[i][k], y[k]))
            y[i] = cg.mul(s, inv_d[i])
        x = [None] * n
        for i in range(n - 1, -1, -1):
            s = y[i]
            for k in range(i + 1, n):
                s = cg.sub(s, cg.mul(L[k][i], x[k]))
            x[i] = cg.mul(s, inv_d[i])
        out.append(x)
    return out


def riccati_terminal(P: Costs, x_last, goal) -> List:
    """The terminal value function, flat ``(nx+1) * nx``: ``Vxx =
    diag(2 wT)`` (rows 0..nx-1), then ``Vx = 2 wT (x_T - goal)``."""
    n, nx = P.n, 2 * P.n
    x_goal = list(goal) + [0.0] * n
    V = [(2.0 * P.wT[i]) if i == k else 0.0 for i in range(nx) for k in range(nx)]
    return V + [cg.mul(2.0 * P.wT[i], cg.sub(x_last[i], x_goal[i])) for i in range(nx)]


def riccati_step(P: Costs, ab, x, u, goal, V, reg):
    """One step of the backward sweep (``bwd_kernel``) over values.

    ``ab``: the step's Jacobian flat ``nx * m`` (row i: ``A[i, :]`` then
    ``B[i, :]``); ``x``, ``u``: the nominal pre-step state and control;
    ``V``: the value function flat ``(nx+1) * nx``; ``reg``: the
    scenario's Levenberg term. Returns ``(kk, V_next)``, ``kk`` flat
    ``n * (1+nx)`` (``k_j``, then row j of K)."""
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
    Qxx = [
        [
            cg.add(
                _sum(cg.mul(Am[l][i], VA[l][k]) for l in range(nx)),
                (2.0 * P.w_x[i]) if i == k else 0.0,
            )
            for k in range(nx)
        ]
        for i in range(nx)
    ]
    Quu = [
        [
            cg.add(
                _sum(cg.mul(Bm[l][j], VB[l][j2]) for l in range(nx)),
                cg.add(2.0 * P.w_u, reg) if j == j2 else 0.0,
            )
            for j2 in range(n)
        ]
        for j in range(n)
    ]
    Qux = [[_sum(cg.mul(Bm[l][j], VA[l][i]) for l in range(nx)) for i in range(nx)] for j in range(n)]

    # Solve Quu [k | K] = [Qu | Qux], then negate.
    cols = [[Qu[j] for j in range(n)]] + [[Qux[j][i] for j in range(n)] for i in range(nx)]
    sols = _chol_solve_cols(Quu, cols)
    k_t = [cg.neg(sols[0][j]) for j in range(n)]
    K = [[cg.neg(sols[1 + i][j]) for i in range(nx)] for j in range(n)]

    # Vx' = Qx + K^T (Quu k + Qu) + Qux^T k
    Quu_k = [_sum(cg.mul(Quu[j][j2], k_t[j2]) for j2 in range(n)) for j in range(n)]
    Vx_new = [
        cg.add(
            cg.add(Qx[i], _sum(cg.mul(K[j][i], cg.add(Quu_k[j], Qu[j])) for j in range(n))),
            _sum(cg.mul(Qux[j][i], k_t[j]) for j in range(n)),
        )
        for i in range(nx)
    ]
    # Vxx' = Qxx + K^T Quu K + K^T Qux + Qux^T K, symmetrised.
    KtQuu = [[_sum(cg.mul(K[j][i], Quu[j][j2]) for j in range(n)) for j2 in range(n)] for i in range(nx)]
    Vxx_new = [[None] * nx for _ in range(nx)]
    for i in range(nx):
        for k in range(i, nx):
            v = cg.add(
                cg.add(
                    cg.add(Qxx[i][k], _sum(cg.mul(KtQuu[i][j2], K[j2][k]) for j2 in range(n))),
                    _sum(cg.mul(K[j][i], Qux[j][k]) for j in range(n)),
                ),
                _sum(cg.mul(Qux[j][i], K[j][k]) for j in range(n)),
            )
            Vxx_new[i][k] = v
            Vxx_new[k][i] = v
    kk = [v for j in range(n) for v in [k_t[j]] + K[j]]
    return kk, [v for row in Vxx_new for v in row] + Vx_new


def fwd_step(P: Costs, x, sd_x, sd_u, kk, goal, alpha):
    """One closed-loop step (``_fwd_step``): ``u = clip(u_nom + alpha k +
    K (x - x_nom), +-u_lim)``, the running cost at the pre-step state and
    the dynamics step. Returns ``(u, cost, x_next)``."""
    n, nx = P.n, 2 * P.n
    dx = [cg.sub(x[i], sd_x[i]) for i in range(nx)]
    u = []
    for j in range(n):
        row = kk[j * (1 + nx):(j + 1) * (1 + nx)]
        uj = cg.add(sd_u[j], cg.mul(alpha, row[0]))
        for i in range(nx):
            uj = cg.add(uj, cg.mul(row[1 + i], dx[i]))
        u.append(cg.clip(uj, -P.u_lim[j], P.u_lim[j]))
    c = 0.0
    for i in range(n):
        e = cg.sub(x[i], goal[i])
        c = cg.add(
            cg.add(c, cg.mul(cg.mul(P.w_q, e), e)),
            cg.mul(cg.mul(P.w_dq, x[n + i]), x[n + i]),
        )
    for j in range(n):
        c = cg.add(c, cg.mul(cg.mul(P.w_u, u[j]), u[j]))
    q2, dq2, _ = P.step(list(x[:n]), list(x[n:]), u)
    return u, c, list(q2) + list(dq2)


def fwd_signature(P: Costs):
    """The arguments of the emitted closed-loop step (``mpc_fwd_step`` and
    its team form): array inputs, scalar inputs, array outputs."""
    n, nx = P.n, 2 * P.n
    return (
        [("x", nx), ("sdx", nx), ("sdu", n), ("kk", n * (1 + nx)), ("goal", n)],
        ["alpha"],
        [("u", n), ("c", 1), ("x_next", nx)],
    )


def team_layout(P: Costs, row_stride: str):
    """Where a team step (``cg.team_function``) finds the closed-loop step's
    inputs and puts its outputs in shared memory, every value a column of
    ``MPT_TS`` lanes: ``xin`` the state, ``rows`` sd_x, sd_u and the gains
    (``row_stride`` apart, ``MPT_TS`` when each lane has its own, 1 when the
    lanes share them), ``goal`` (the same stride), ``ob`` u then the running
    cost, ``xout`` the next state."""
    n, nx = P.n, 2 * P.n
    return {
        "x": ("xin", 0, "MPT_TS"), "sdx": ("rows", 0, row_stride), "sdu": ("rows", nx, row_stride),
        "kk": ("rows", nx + n, row_stride), "goal": ("goal", 0, row_stride),
        "u": ("ob", 0), "c": ("ob", n), "x_next": ("xout", 0),
    }


def terminal_cost(P: Costs, x, goal):
    """``_terminal``: ``sum wT_q (q - goal)^2 + wT_dq dq^2``."""
    n = P.n
    c = 0.0
    for i in range(n):
        e = cg.sub(x[i], goal[i])
        c = cg.add(
            cg.add(c, cg.mul(cg.mul(P.wT[i], e), e)),
            cg.mul(cg.mul(P.wT[n + i], x[n + i]), x[n + i]),
        )
    return c


def bwd_weights(P: Costs) -> str:
    """The folded weights of a Riccati step whose phases are written by
    hand (K3, K7): ``MPT_BWD_2WX`` (2 w_x, nx) and ``MPT_BWD_2WU`` (2 w_u),
    the f32 literals the emitter writes for them."""
    return (
        f"static __device__ const float MPT_BWD_2WX[{2 * P.n}] = "
        f"{{{', '.join(cg.c_literal(2.0 * w) for w in P.w_x)}}};\n"
        f"#define MPT_BWD_2WU {cg.c_literal(2.0 * P.w_u)}\n"
    )


def _stack(vals, like: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.stack([_full(v, like) for v in vals], dim=dim)


class MPCKernelSet(KernelSet):
    """What the batched (K2-K5) and single-problem (K6-K8) kernel sets
    share, for one (robot, dt, g, cost weights, torque limits): the folded
    costs ``P``, the sources (per unit a header, the unit's emitted device
    functions and the template), the statement counts, the plain
    linearization (K2's and K6's) and :meth:`plain`.

    A subclass sets ``STAGES``, ``TEMPLATE``, ``DEFINES`` (extra
    ``#define``s of its units), ``TEAM_STAGE`` (the stage whose kernel
    runs the closed-loop step as a team, ``self.team``) and ``LAYOUTS``
    (unit: the kernel and the ``mpt_layout_*`` entry of :meth:`layout_bytes`) besides
    :class:`KernelSet`'s attributes, and gives ``_bodies(model, dt, g) ->
    {unit: emitted source}``."""

    STAGES: tuple = ()
    TEMPLATE: Path
    DEFINES: Dict[str, int] = {}
    TEAM_STAGE: str
    LAYOUTS: Dict[str, tuple] = {}

    def __init__(
        self,
        model: RobotModel,
        dt: float,
        g=DEFAULT_G,
        w_q: float = 10.0,
        w_dq: float = 0.5,
        w_u: float = 1e-4,
        w_terminal: float = 100.0,
        u_lim: Sequence[float] = (),
    ):
        g = tuple(float(v) for v in g)
        self.P = P = Costs(model, dt, g, w_q, w_dq, w_u, w_terminal, u_lim)
        self.n = n = P.n
        self.nx, self.m = 2 * n, 3 * n
        if len(P.u_lim) != n:
            raise ValueError(f"u_lim must have {n} entries, got {len(P.u_lim)}")
        _, self._step_jvp = build_fd_step_jvp_planes(model, float(dt), g=g)
        self.statements: Dict[str, int] = {}
        host = host_arrays(model)
        digest = host["digest"] if host is not None else "unregistered model"
        weights = tuple(float(w) for w in (w_q, w_dq, w_u, w_terminal))
        template = self.TEMPLATE.read_text()
        defines = "".join(f"#define {k} {v}\n" for k, v in {"MPT_NJ": n, **self.DEFINES}.items())
        self.sources = {
            unit: (
                f"// Generated: robot {digest}, dt {float(dt)!r}, g {g!r}, weights (w_q, w_dq, "
                f"w_u, w_terminal) {weights!r}, u_lim {tuple(P.u_lim)!r}, unit {unit}.\n"
                f"{defines}#define MPT_UNIT_{unit.upper()} 1\n#include <math.h>\n{body}\n{template}"
            )
            for unit, body in self._bodies(model, float(dt), g).items()
        }

    def _linearize_body(self, model, dt, g) -> str:
        """The one-seed linearization's device function (``fd_step_jvp``),
        counting its statements and, as ``"step"``, those of the primal step
        alone: the part that all m seeds share. The host tests hold K2 and
        K6 against it; their bounds count with both."""
        n, P = self.n, self.P
        _, src, self.statements["linearize"] = build_fd_step_jvp_source(model, dt, g=g)
        _, self.statements["step"] = cg.c_function(
            "fd_step", [("q", n), ("dq", n), ("tau", n)], [], [("q_next", n), ("dq_next", n)],
            lambda q, dq, tau: P.step(q, dq, tau)[:2],
        )
        return src

    def linearize_plain(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """The plain linearization: xs (H, nx, ...), us (H, n, ...) -> AB
        (H, nx, m, ...), all m tangent seeds in one pass."""
        n, nx, m = self.n, self.nx, self.m
        rest = tuple(xs.shape[2:])
        eye = torch.eye(m, dtype=xs.dtype, device=xs.device).reshape((m, m) + (1,) * (1 + len(rest)))
        _, tans = self._step_jvp(
            [xs[:, i] for i in range(nx)], [us[:, j] for j in range(n)],
            [eye[i] for i in range(nx)], [eye[nx + j] for j in range(n)],
        )
        AB = _stack(tans, xs[:, 0].expand((m, xs.shape[0]) + rest), dim=1)  # (m, nx, H, ...)
        return AB.permute(2, 1, 0, *range(3, AB.dim())).contiguous()

    def team_attributes(self, stage: str = None) -> Dict[str, int]:
        """A team kernel (``stage``, by default ``TEAM_STAGE``) as built:
        warps, scenarios (alphas, or lanes) a team, teams a block, phases a
        step, slots a lane and the dynamic shared bytes of a block (its
        unit's ``team_<stage>``)."""
        stage = stage or self.TEAM_STAGE
        keys = ("warps", "scenarios", "teams_per_block", "phases", "slots", "dynamic_smem_bytes")
        out = (ctypes.c_int * len(keys))()
        getattr(self._lib(stage), f"team_{stage}")(out)
        return dict(zip(keys, out))

    def layout_bytes(self) -> Dict[str, int]:
        """The dynamic shared bytes a block takes, per kernel of ``LAYOUTS``
        whose built unit has its ``mpt_layout_*`` entry (the kernel's own
        macros): K3 (``backward``) and K5's team (``replay_team``, a team
        variant only); K6's team (``linearize_team``, a team unit only)."""
        out = {}
        for unit, lib in self.build().items():
            key, entry = self.LAYOUTS.get(unit, (None, None))
            fn = getattr(lib.lib, entry, None) if entry else None
            if fn is not None:
                fn.restype = ctypes.c_longlong
                out[key] = int(fn())
        return out

    def plain(self) -> SimpleNamespace:
        """The stages through their plain versions on any device (the
        reference the kernels are held against)."""
        return SimpleNamespace(**{stage: getattr(self, f"{stage}_plain") for stage in self.STAGES})


class BatchMPCKernels(MPCKernelSet):
    """K2-K5 for one (robot, dt, g, cost weights, torque limits). K2's unit
    carries ``fd_step_jvp_group`` for ``LIN_SEEDS`` seeds a thread
    (``MPT_LIN_SEEDS``; None: :func:`lin_seeds` of the robot, set on the
    instance); the one-seed ``fd_step_jvp`` stays out of it, as
    ``linearize_seed_source``, the host tests' reference. K5's unit runs
    one thread a scenario, or with ``TEAM_WARPS`` > 0 a team of warps
    (``self.team``). Only the units of ``UNITS`` are emitted and built."""

    kind = "cuda"
    STAGES, UNITS, ARGTYPES, LIB_PREFIX = STAGES, UNITS, _ARGTYPES, "mpc_batch"
    TEMPLATE, DEFINES, LAYOUTS = TEMPLATE, {"MPT_BLOCK": BLOCK}, LAYOUTS
    LIN_SEEDS, UNIT_FLAGS = None, {"lin": LIN_FLAGS}
    TEAM_WARPS, TEAM_S, TEAM_PER_BLOCK, TEAM_STAGE = TEAM_WARPS, TEAM_S, TEAM_PER_BLOCK, "replay"
    launch_count: Dict[str, int] = dict.fromkeys(STAGES, 0)  # all instances
    team = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.team is not None:  # the team step goes where the template marks it, after the macros it reads
            fwd = self.sources["fwd"]
            at = fwd.rindex("// MPT_TEAM_STEP:")
            self.sources["fwd"] = fwd[:at] + self.team.source + fwd[at:]

    def _bodies(self, model, dt, g) -> Dict[str, str]:
        P, n, nx = self.P, self.n, self.nx
        kkn, vn = n * (1 + nx), (nx + 1) * nx
        out = {}
        if self.LIN_SEEDS is None:
            self.LIN_SEEDS = lin_seeds(n)
        if "lin" in self.UNITS:
            self.linearize_seed_source = self._linearize_body(model, dt, g)
            _, group_src, self.statements["linearize_group"] = build_fd_step_jvp_group_source(
                model, dt, g=g, seeds=self.LIN_SEEDS
            )
            out["lin"] = f"#define MPT_LIN_SEEDS {self.LIN_SEEDS}\n#define MPT_LIN_BLOCK {LIN_BLOCK}\n{group_src}"
        if "bwd" in self.UNITS:
            term_src, term_ops = cg.c_function(
                "riccati_terminal", [("x_last", nx), ("goal", n)], [], [("V", vn)],
                lambda x_last, goal: [riccati_terminal(P, x_last, goal)],
            )
            step_src, step_ops = cg.c_function(
                "riccati_step", [("ab", nx * self.m), ("x", nx), ("u", n), ("goal", n), ("V", vn)],
                ["reg"], [("kk", kkn), ("V_next", vn)],
                lambda ab, x, u, goal, V, reg: riccati_step(P, ab, x, u, goal, V, reg),
            )
            # K3's phases (csrc/mpc_batch.cuh) do riccati_step's operations, so
            # its emitted body stays out of the unit: it is the host harness's
            # reference and its statements K3's operation count.
            self.riccati_step_source = step_src
            self.statements["backward"] = step_ops
            self.statements["value_terminal"] = term_ops
            out["bwd"] = bwd_weights(P) + term_src
        if "fwd" in self.UNITS:
            out["fwd"] = self._fwd_body()
        return out

    def _fwd_body(self) -> str:
        """K4's and K5's unit: the emitted closed-loop step and terminal cost
        (``fwd_rollout``), and for a team the step split over its warps."""
        P, n, nx = self.P, self.n, self.nx

        def fwd_body(x, sdx, sdu, kk, goal, alpha):
            u, c, x_next = fwd_step(P, x, sdx, sdu, kk, goal, alpha)
            return u, [c], x_next

        ems = []
        fwd_src, fwd_ops = cg.c_function("mpc_fwd_step", *fwd_signature(P), fwd_body, emitter=ems)
        cost_src, cost_ops = cg.c_function(
            "mpc_terminal", [("x", nx), ("goal", n)], [], [("c", 1)],
            lambda x, goal: [[terminal_cost(P, x, goal)]], emitter=ems,
        )
        for stage in ("linesearch_costs", "linesearch", "replay"):
            self.statements[stage] = fwd_ops
        self.statements["cost_terminal"] = cost_ops
        self.chains = {"replay": cg.chain_length(ems[0]), "cost_terminal": cg.chain_length(ems[1])}
        if not self.TEAM_WARPS:
            return fwd_src + cost_src
        # K5's variant: the same step split over a team of warps, the
        # scenarios on its lanes: every input and output a column of
        # MPT_TEAM_S lanes.
        self.team = cg.team_function(
            "mpt_fwd_team", *fwd_signature(P), fwd_body, team_layout(P, "MPT_TS"), self.TEAM_WARPS
        )
        return (
            f"{fwd_src}{cost_src}#define MPT_REPLAY_TEAM 1\n#define MPT_TEAM_S_MAX {self.TEAM_S}\n"
            f"#define MPT_TEAM_PER_BLOCK {self.TEAM_PER_BLOCK}\n#define MPT_TS MPT_TEAM_S\n{cg.TEAM_SOURCE}"
        )

    def team_attributes(self, stage: str = None) -> Dict[str, int]:
        if self.team is None:
            raise ValueError("K5 runs one thread a scenario here; a team is a variant unit (TEAM_WARPS > 0)")
        return super().team_attributes(stage)

    # -- checks -----------------------------------------------------------
    @staticmethod
    def _dims(xs: torch.Tensor):
        if xs.dim() != 3:
            raise ValueError(f"xs must be (H, nx, B), got {tuple(xs.shape)}")
        H, B = xs.shape[0], xs.shape[2]
        if not (1 <= B < 2**31 and 1 <= H <= 65535):
            raise ValueError(f"B must be in [1, 2**31) and H in [1, 65535], got B={B}, H={H}")
        return H, B

    # -- K2 ----------------------------------------------------------------
    def linearize(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """xs (H, nx, B) pre-step states, us (H, n, B) -> AB (H, nx, m, B)."""
        H, B = self._dims(xs)
        n, nx, m = self.n, self.nx, self.m
        if not self._route("linearize", {"xs": xs, "us": us}, {"xs": (H, nx, B), "us": (H, n, B)}):
            return self.linearize_plain(xs, us)
        AB = torch.empty((H, nx, m, B), dtype=xs.dtype, device=xs.device)
        self._launch("linearize", xs.device, xs, us, AB, B, H)
        return AB

    # -- K3 ----------------------------------------------------------------
    def backward(self, AB, xs, us, x_last, goal, reg) -> torch.Tensor:
        """-> gains kK (H, n, 1+nx, B)."""
        H, B = self._dims(xs)
        n, nx, m = self.n, self.nx, self.m
        tensors = {"AB": AB, "xs": xs, "us": us, "x_last": x_last, "goal": goal, "reg": reg}
        shapes = {"AB": (H, nx, m, B), "xs": (H, nx, B), "us": (H, n, B),
                  "x_last": (nx, B), "goal": (n, B), "reg": (B,)}
        if not self._route("backward", tensors, shapes):
            return self.backward_plain(AB, xs, us, x_last, goal, reg)
        kK = torch.empty((H, n, 1 + nx, B), dtype=xs.dtype, device=xs.device)
        self._launch("backward", xs.device, AB, xs, us, x_last, goal, reg, kK, B, H)
        return kK

    def backward_plain(self, AB, xs, us, x_last, goal, reg) -> torch.Tensor:
        n, nx, m = self.n, self.nx, self.m
        H = xs.shape[0]
        like = reg
        g = [goal[j] for j in range(n)]
        V = [_full(v, like) for v in riccati_terminal(self.P, [x_last[i] for i in range(nx)], g)]
        rows = [None] * H
        for t in range(H - 1, -1, -1):
            ab = [AB[t, i, k] for i in range(nx) for k in range(m)]
            kk, V = riccati_step(
                self.P, ab, [xs[t, i] for i in range(nx)], [us[t, j] for j in range(n)], g, V, reg
            )
            rows[t] = _stack(kk, like).reshape(n, 1 + nx, -1)
        return torch.stack(rows)

    # -- K4 ----------------------------------------------------------------
    def _linesearch_inputs(self, stage, x0, sd_x, sd_u, kK, goal, alphas):
        """(H, B, A, whether the stage runs its kernel)."""
        H, B = self._dims(sd_x)
        n, nx = self.n, self.nx
        A = alphas.shape[0] if alphas.dim() == 1 else -1
        if A == 0 or A > 65535:
            raise ValueError(f"{stage} takes 1 to 65535 alphas, got {A}")
        tensors = {"x0": x0, "sd_x": sd_x, "sd_u": sd_u, "kK": kK, "goal": goal, "alphas": alphas}
        shapes = {"x0": (nx, B), "sd_x": (H, nx, B), "sd_u": (H, n, B),
                  "kK": (H, n, 1 + nx, B), "goal": (n, B), "alphas": (A,)}
        return H, B, A, self._route(stage, tensors, shapes)

    def linesearch_costs(self, x0, sd_x, sd_u, kK, goal, alphas) -> torch.Tensor:
        """Score every alpha (A,) for every scenario: -> (A, B)."""
        H, B, A, kernel = self._linesearch_inputs("linesearch_costs", x0, sd_x, sd_u, kK, goal, alphas)
        if not kernel:
            return self.linesearch_costs_plain(x0, sd_x, sd_u, kK, goal, alphas)
        costs = torch.empty((A, B), dtype=x0.dtype, device=x0.device)
        self._launch("linesearch_costs", x0.device, x0, sd_x, sd_u, kK, goal, alphas, costs, B, H, A)
        return costs

    def linesearch_costs_plain(self, x0, sd_x, sd_u, kK, goal, alphas) -> torch.Tensor:
        return self.replay_plain(x0, sd_x, sd_u, kK, goal, alphas[:, None])[2]

    def linesearch(self, x0, sd_x, sd_u, kK, goal, alphas, xs_all=None, us_all=None):
        """Roll every alpha (A,) for every scenario and keep its trajectory:
        -> (costs (A, B), xs_all (H, nx, A, B), us_all (H, n, A, B)), xs_all
        the post-step states. ``xs_all`` and ``us_all``, where given, are
        written in place and returned (a solve reuses them)."""
        H, B, A, kernel = self._linesearch_inputs("linesearch", x0, sd_x, sd_u, kK, goal, alphas)
        shapes = {"xs_all": (H, self.nx, A, B), "us_all": (H, self.n, A, B)}
        outs = {"xs_all": xs_all, "us_all": us_all}
        for name, out in outs.items():
            if out is None:
                outs[name] = torch.empty(shapes[name], dtype=x0.dtype, device=x0.device)
            elif tuple(out.shape) != shapes[name] or out.device != x0.device or out.dtype != x0.dtype \
                    or not out.is_contiguous():
                raise ValueError(f"linesearch: {name} must be a contiguous {x0.dtype} {shapes[name]} "
                                 f"on {x0.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
        if not kernel:
            costs, xs, us = self.linesearch_plain(x0, sd_x, sd_u, kK, goal, alphas)
            return costs, outs["xs_all"].copy_(xs), outs["us_all"].copy_(us)
        costs = torch.empty((A, B), dtype=x0.dtype, device=x0.device)
        self._launch("linesearch", x0.device, x0, sd_x, sd_u, kK, goal, alphas, costs,
                     outs["xs_all"], outs["us_all"], B, H, A)
        return costs, outs["xs_all"], outs["us_all"]

    def linesearch_plain(self, x0, sd_x, sd_u, kK, goal, alphas, xs_all=None, us_all=None):
        """The plain version of ``linesearch``: the plain replay of every
        alpha, ``alphas (A, 1)``. ``xs_all`` and ``us_all`` are ignored."""
        xs, us, costs = self.replay_plain(x0, sd_x, sd_u, kK, goal, alphas[:, None])
        return costs, xs, us

    # -- K5 ----------------------------------------------------------------
    def replay(self, x0, sd_x, sd_u, kK, goal, alpha):
        """Roll each scenario's own alpha (B,): -> (xs (H, nx, B), us (H, n,
        B), cost (B,)), xs being the post-step states."""
        H, B = self._dims(sd_x)
        n, nx = self.n, self.nx
        tensors = {"x0": x0, "sd_x": sd_x, "sd_u": sd_u, "kK": kK, "goal": goal, "alpha": alpha}
        shapes = {"x0": (nx, B), "sd_x": (H, nx, B), "sd_u": (H, n, B),
                  "kK": (H, n, 1 + nx, B), "goal": (n, B), "alpha": (B,)}
        if not self._route("replay", tensors, shapes):
            return self.replay_plain(x0, sd_x, sd_u, kK, goal, alpha)
        xs = torch.empty((H, nx, B), dtype=x0.dtype, device=x0.device)
        us = torch.empty((H, n, B), dtype=x0.dtype, device=x0.device)
        cost = torch.empty((B,), dtype=x0.dtype, device=x0.device)
        self._launch("replay", x0.device, x0, sd_x, sd_u, kK, goal, alpha, xs, us, cost, B, H)
        return xs, us, cost

    def replay_plain(self, x0, sd_x, sd_u, kK, goal, alpha):
        """The plain version of K5 (alpha (B,)), and of K4 with alpha (A, 1),
        every alpha for every scenario: (xs, us, cost), with a leading alpha
        axis for K4."""
        n, nx = self.n, self.nx
        H = sd_x.shape[0]
        lead = torch.broadcast_shapes(alpha.shape, x0.shape[1:])
        like = torch.zeros(lead, dtype=x0.dtype, device=x0.device)
        g = [goal[j] for j in range(n)]
        x = [x0[i] for i in range(nx)]
        acc = like
        xs_rows, us_rows = [], []
        for t in range(H):
            kk = [kK[t, j, c] for j in range(n) for c in range(1 + nx)]
            u, c, x = fwd_step(
                self.P, x, [sd_x[t, i] for i in range(nx)], [sd_u[t, j] for j in range(n)], kk, g, alpha
            )
            acc = cg.add(acc, c)
            xs_rows.append(_stack(x, like))
            us_rows.append(_stack(u, like))
        cost = cg.add(acc, terminal_cost(self.P, x, g))
        return torch.stack(xs_rows), torch.stack(us_rows), _full(cost, like)
