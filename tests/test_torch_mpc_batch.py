"""The port's batched fused tracking MPC (K2-K5) against the JAX package's.

* K2's plain version (forward mode over the step program) against
  ``jax.vmap(jax.jacfwd(step))`` of JAX ``build_fd_step(...,
  clip_velocity=False)`` on UR5 and Panda: f64 within 1e-9 with a state
  past a joint limit, and f32 (1e-4 on the rows of q', 1e-3 on those of
  dq') with a state exactly on a limit, where JAX halves the tangent; and
  against ``torch.func.jacfwd`` of the port's tensor step (f64, 1e-9).
* The four stages (plain versions) against JAX ``build_batch_tracking_mpc
  (..., interpret=True)`` on the same inputs, two-link arm, B=3, H=20: each
  output within 2e-4 of its own largest magnitude (f32; XLA fuses and
  reorders the sums of the interpret-mode kernels).
* The whole solve against JAX's, and against the port's generic ``ilqr``
  per scenario with the JAX test's bars (cost rtol 1e-5, final state atol
  5e-4, controls atol 5e-3, ``tests/test_mpc.py``).
* The emitted kernel bodies (``csrc/mpc_batch.cuh`` with the generated
  device functions), compiled with the host g++ behind a ``__device__``
  shim, against the plain versions; K3's warp phases run lane by lane
  (``MPT_HOST_TEAM``) bitwise against the emitted one-thread
  ``riccati_step`` sweep on the two-link arm, UR5 and Panda, and a NaN
  scenario kept to itself.
* The solver's behaviour: run-time goals, torque limits, the NaN guard,
  ``batch_mpc_step`` and the checks on its inputs.
"""

import ctypes
import shutil
import subprocess
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.fused_batch import build_batch_tracking_mpc as jax_build_batch
from manipulapy_tpu.ops import fd_step as jfd
from manipulapy_tpu_torch.models import catalog as port_catalog
from manipulapy_tpu_torch.models import from_host_arrays
from manipulapy_tpu_torch.mpc import ILQRParams, ilqr, make_step_fn, make_tracking_costs
from manipulapy_tpu_torch.mpc.fused_batch import batch_mpc_step, build_batch_tracking_mpc
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops.cuda_mpc_batch import STAGES, BatchMPCKernels

CPU = torch.device("cpu")
STAGE_RTOL = 2e-4  # of each output's largest magnitude


def _port_model(jax_model, dtype=torch.float32):
    return from_host_arrays(jax_host_arrays(jax_model), dtype=dtype, device=CPU)


# ---------------------------------------------------------------------------
# K2: the linearization
# ---------------------------------------------------------------------------

_ARMS = {"ur5": jax_catalog.ur5, "panda": jax_catalog.panda}


LIN_CASES = {
    # gravity on, one state past a joint limit (tangent 0); f64, so the
    # tangent rules are checked to rounding
    "random_f64": (np.float64, jnp.float64, torch.float64),
    # gravity off, scenario 0 at rest on joint 0's lower limit with zero
    # torque, so the clamped position equals the limit exactly (JAX halves
    # the tangent there); f32, the kernel's type
    "at_bound_f32": (np.float32, jnp.float32, torch.float32),
}


def _lin_inputs(tm, case, B=5, H=2, seed=0):
    """(H, B, 2n) states, (H, B, n) torques and g for a case."""
    n = tm.num_joints
    np_dtype = LIN_CASES[case][0]
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (H, B, n))
    dq = rng.uniform(-0.5, 0.5, (H, B, n))
    tau = rng.uniform(-10.0, 10.0, (H, B, n))
    lower = tm.joint_lower.double().numpy()
    upper = tm.joint_upper.double().numpy()
    q = np.clip(q, lower + 0.05, upper - 0.05)
    if case.startswith("random"):
        q[0, 1, 0] = upper[0] + 0.5
        g = (0.0, 0.0, -9.81)
    else:
        q[:, 0, 0] = np_dtype(lower[0])
        dq[:, 0], tau[:, 0] = 0.0, 0.0
        g = (0.0, 0.0, 0.0)
    return np.concatenate([q, dq], axis=-1).astype(np_dtype), tau.astype(np_dtype), g


@pytest.fixture(scope="module")
def arms():
    """Per arm and dtype: the JAX model and the port's, from one set of
    f64 host arrays."""
    out = {}
    for name, make in _ARMS.items():
        host = jax_host_arrays(make(dtype=jnp.float64))
        for _, jdt, tdt in LIN_CASES.values():
            out[name, tdt] = (make(dtype=jdt), from_host_arrays(host, dtype=tdt, device=CPU))
    return out


def _jax_jacobians(jm, x, u, dt, g):
    n = u.shape[-1]
    step = jfd.build_fd_step(jm, dt, g=g, clip_velocity=False)

    def f(xx, uu):
        q2, dq2, _ = step(xx[:n], xx[n:], uu)
        return jnp.concatenate([q2, dq2])

    A = jax.vmap(jax.jacfwd(f, 0))(jnp.asarray(x), jnp.asarray(u))
    Bm = jax.vmap(jax.jacfwd(f, 1))(jnp.asarray(x), jnp.asarray(u))
    return np.concatenate([np.asarray(A), np.asarray(Bm)], axis=-1)  # (N, nx, m)


@pytest.mark.parametrize("robot", sorted(_ARMS))
@pytest.mark.parametrize("case", sorted(LIN_CASES))
def test_linearize_plain_matches_jax_jacfwd(arms, robot, case):
    """Tolerances: f64 1e-9; f32 1e-4 on the rows of q' and 1e-3 on those
    of dq' (the JAX package's f32 rollout tolerances: dq' carries dt times
    the inverse mass matrix, whose wrist entries are large)."""
    tdt = LIN_CASES[case][2]
    jm, tm = arms[robot, tdt]
    n = tm.num_joints
    dt = 0.01
    x, u, g = _lin_inputs(tm, case)
    H, B = x.shape[0], x.shape[1]
    kernels = BatchMPCKernels(tm, dt, g=g, u_lim=[1.0] * n)
    xs = torch.from_numpy(x).permute(0, 2, 1).contiguous()  # (H, nx, B)
    us = torch.from_numpy(u).permute(0, 2, 1).contiguous()
    AB = kernels.linearize(xs, us)  # (H, nx, m, B), the plain version on the CPU
    assert AB.shape == (H, 2 * n, 3 * n, B) and AB.dtype == tdt
    got = AB.permute(0, 3, 1, 2).reshape(H * B, 2 * n, 3 * n).numpy()
    ref = _jax_jacobians(jm, x.reshape(H * B, 2 * n), u.reshape(H * B, n), dt, g)
    tol_q, tol_dq = (1e-9, 1e-9) if tdt == torch.float64 else (1e-4, 1e-3)
    np.testing.assert_allclose(got[:, :n], ref[:, :n], rtol=0, atol=tol_q)
    np.testing.assert_allclose(got[:, n:], ref[:, n:], rtol=0, atol=tol_dq)
    if case.startswith("random"):
        assert np.all(got[1, 0] == 0.0)  # past the limit: q'_0 is clamped, tangent 0
    else:
        # Joint 0's position row: halved against the one-sided derivative
        # of the same step without the limit clamp.
        _, free = tfd.build_fd_step_jvp_planes(tm, dt, g=g, clip_limits=False)
        eye = torch.eye(3 * n).reshape(3 * n, 3 * n, 1)
        x0, u0 = torch.from_numpy(x[0, :1]), torch.from_numpy(u[0, :1])
        _, tans = free(
            [x0[:, i] for i in range(2 * n)], [u0[:, j] for j in range(n)],
            [eye[i] for i in range(2 * n)], [eye[2 * n + j] for j in range(n)],
        )
        np.testing.assert_array_equal(got[0, 0], 0.5 * tans[0][:, 0].numpy())
        assert np.abs(got[0, 0]).max() > 0.1


@pytest.mark.parametrize("robot", sorted(_ARMS))
def test_linearize_plain_matches_torch_jacfwd(arms, robot):
    """The tensor step clamps with torch.maximum/minimum, whose derivatives
    follow JAX's rule, so autograd of it is a second reference, the state
    past a limit included (f64, 1e-9)."""
    _, tm = arms[robot, torch.float64]
    n = tm.num_joints
    x, u, g = _lin_inputs(tm, "random_f64", seed=3)
    step = tfd.build_fd_step(tm, 0.01, g=g, clip_velocity=False)

    def f(xx, uu):
        q2, dq2, _ = step(xx[:n], xx[n:], uu)
        return torch.cat([q2, dq2])

    xf, uf = torch.from_numpy(x.reshape(-1, 2 * n)), torch.from_numpy(u.reshape(-1, n))
    jac = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1)))(xf, uf)
    ref = torch.cat(jac, dim=-1)
    AB = BatchMPCKernels(tm, 0.01, g=g, u_lim=[1.0] * n).linearize(
        torch.from_numpy(x).permute(0, 2, 1).contiguous(), torch.from_numpy(u).permute(0, 2, 1).contiguous()
    )
    got = AB.permute(0, 3, 1, 2).reshape(-1, 2 * n, 3 * n)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# K3-K5 and the whole solve against JAX, on the two-link arm
# ---------------------------------------------------------------------------

PB, PH, PITERS, PDT = 3, 20, 4, 0.02


def _to_jax(x):
    """Scenario-minor (..., B) -> the JAX tiles (1, ..., 8, 128)."""
    x = np.asarray(x)
    pad = np.zeros(x.shape[:-1] + (1024 - x.shape[-1],), np.float32)
    return jnp.asarray(np.concatenate([x, pad], -1).reshape(x.shape[:-1] + (8, 128))[None])


def _from_jax(x, B=PB):
    x = np.asarray(x)[0]
    return x.reshape(x.shape[:-2] + (1024,))[..., :B]


def _close_to_scale(got, ref, rtol=STAGE_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def planar():
    """Both solvers on the two-link arm, the JAX one in interpret mode, the
    same goals, initial states and torques, and each stage's inputs and
    outputs (the port's intermediates feed both)."""
    jm = jax_catalog.two_link_planar(dtype=jnp.float32)
    tm = _port_model(jm)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, (PB, 4)).astype(np.float32)
    goals = rng.uniform(-0.8, 0.8, (PB, 2)).astype(np.float32)
    us_rand = rng.uniform(-5.0, 5.0, (PH, 2, PB)).astype(np.float32)
    jmpc = jax_build_batch(jm, jnp.asarray(goals), PB, PH, PDT, iterations=PITERS, interpret=True)
    tmpc = build_batch_tracking_mpc(tm, goals, PB, PH, PDT, iterations=PITERS)
    out = dict(jm=jm, tm=tm, x0=x0, goals=goals, jmpc=jmpc, tmpc=tmpc)
    out["jax_solve"] = [np.asarray(v) for v in jmpc.solve(jnp.asarray(x0), jnp.zeros((PB, PH, 2), jnp.float32))]
    out["port_solve"] = [v.numpy() for v in tmpc.solve(torch.from_numpy(x0), torch.zeros(PB, PH, 2))]

    x0_t = torch.from_numpy(x0).T.contiguous()
    goal_t = torch.from_numpy(goals).T.contiguous()
    us0 = torch.from_numpy(us_rand)
    zeros_kK = torch.zeros(PH, 2, 5, PB)
    xs0, _, _ = tmpc.replay(x0_t, torch.zeros(PH, 4, PB), us0, zeros_kK, goal_t, torch.zeros(PB))
    sd_x = torch.cat([x0_t[None], xs0[:-1]])
    AB = tmpc.linearize(sd_x, us0)
    reg = torch.full((PB,), 1e-6)
    kK = tmpc.backward(AB, sd_x, us0, xs0[-1].contiguous(), goal_t, reg)
    alphas = torch.tensor(0.5 ** np.arange(6), dtype=torch.float32)
    alpha = torch.tensor([1.0, 0.5, 0.25])
    costs = tmpc.linesearch_costs(x0_t, sd_x, us0, kK, goal_t, alphas)
    replay = tmpc.replay(x0_t, sd_x, us0, kK, goal_t, alpha)
    J = _to_jax
    out["stages"] = {
        "linearize": ([AB], [_from_jax(jmpc.linearize(J(sd_x), J(us0)))]),
        "backward": (
            [kK],
            [_from_jax(jmpc.backward(J(AB), J(sd_x), J(us0), J(xs0[-1]), J(goal_t), J(reg)))],
        ),
        "linesearch_costs": (
            [costs],
            [_from_jax(jmpc.linesearch_costs(J(x0_t), J(sd_x), J(us0), J(kK), J(goal_t), jnp.asarray(alphas.numpy())))],
        ),
        "replay": (
            list(replay),
            [
                _from_jax(v).reshape(tuple(p.shape))
                for v, p in zip(jmpc.replay(J(x0_t), J(sd_x), J(us0), J(kK), J(goal_t), J(alpha)[:, None]), replay)
            ],
        ),
    }
    return out


@pytest.mark.parametrize("stage", ["linearize", "backward", "linesearch_costs", "replay"])
def test_stage_plain_matches_jax_interpret(planar, stage):
    got, ref = planar["stages"][stage]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        _close_to_scale(g.numpy(), r)


def test_solve_matches_jax_interpret(planar):
    (tu, tx, tc), (ju, jx, jc) = planar["port_solve"], planar["jax_solve"]
    assert tu.shape == (PB, PH, 2) and tx.shape == (PB, PH + 1, 4) and tc.shape == (PB,)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    np.testing.assert_allclose(tx[:, -1], jx[:, -1], atol=5e-4)
    np.testing.assert_allclose(tu, ju, atol=5e-3)
    np.testing.assert_array_equal(tx[:, 0], planar["x0"])


def test_solve_matches_generic_ilqr_per_scenario(planar):
    """The parity bar of the JAX tests: each scenario against an
    independent solve of the port's generic iLQR."""
    tm, x0, goals = planar["tm"], planar["x0"], planar["goals"]
    us_b, xs_b, cost_b = planar["port_solve"]
    step = make_step_fn(tm, PDT)
    for s in range(PB):
        running, terminal = make_tracking_costs(tm, torch.from_numpy(goals[s]))
        res = ilqr(
            step, running, terminal, torch.from_numpy(x0[s]), torch.zeros(PH, 2),
            ILQRParams(horizon=PH, dt=PDT, iterations=PITERS),
        )
        np.testing.assert_allclose(cost_b[s], float(res.cost), rtol=1e-5)
        np.testing.assert_allclose(xs_b[s, -1], res.xs[-1].numpy(), atol=5e-4)
        np.testing.assert_allclose(us_b[s], res.us.numpy(), atol=5e-3)


# ---------------------------------------------------------------------------
# The emitted kernel bodies on the host
# ---------------------------------------------------------------------------

_HARNESS = """\
#define __device__
#define __forceinline__ inline
#define MPT_HOST_TEAM 1
{src}
extern "C" void run(const float** in, float** out, int B, int H, int A) {{
#if defined(MPT_UNIT_LIN)
  for (int t = 0; t < H; ++t) for (int k = 0; k < MPT_M; ++k) for (int b = 0; b < B; ++b)
    lin_thread(in[0], in[1], out[0], B, b, k, t);
#elif defined(MPT_UNIT_BWD)
  // K3: one warp's storage, a host array; under MPT_HOST_TEAM each phase of
  // the sweep runs lanes 0..31 in turn before the next phase begins.
  mpt_bwd_team team;
  for (int b = 0; b < B; ++b) bwd_sweep(0, &team, in[0], in[1], in[2], in[3], in[4], in[5], out[0], B, H, b);
#else
  for (int a = 0; a < A; ++a) for (int b = 0; b < B; ++b)
    cost_thread(in[0], in[1], in[2], in[3], in[4], in[5], out[0], B, H, b, a);
  for (int b = 0; b < B; ++b)
    replay_thread(in[0], in[1], in[2], in[3], in[4], in[6], out[1], out[2], out[3], B, H, b);
#endif
}}
"""


def _host_units(kernels, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    libs = {}
    for unit, src in kernels.sources.items():
        cpp, so = tmp_path / f"{unit}.cpp", tmp_path / f"{unit}.so"
        cpp.write_text(_HARNESS.format(src=src))
        subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", str(so), str(cpp)], check=True, timeout=300)
        lib = ctypes.CDLL(str(so))
        lib.run.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 3
        libs[unit] = lib
    return libs


def _call(lib, ins, outs, B, H, A=0):
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    lib.run(ptrs(ins), ptrs(outs), B, H, A)
    return outs


def test_emitted_kernel_bodies_match_plain_versions(planar, tmp_path):
    """K2-K5's thread bodies, run on the host, against the plain versions
    on the same inputs (B=3, with a torque limit that engages), within
    1e-5 of each output's scale: the host's libm ``sinf``/``cosf`` against
    PyTorch's."""
    tm = planar["tm"]
    mpc = build_batch_tracking_mpc(tm, planar["goals"], PB, PH, PDT, u_limit=[4.0, 3.0])
    k = mpc.kernels
    libs = _host_units(k, tmp_path)
    x0_t = torch.from_numpy(planar["x0"]).T.contiguous()
    goal_t = torch.from_numpy(planar["goals"]).T.contiguous()
    us0 = torch.from_numpy(np.random.default_rng(1).uniform(-5, 5, (PH, 2, PB)).astype(np.float32))
    xs0, _, _ = k.replay(x0_t, torch.zeros(PH, 4, PB), us0, torch.zeros(PH, 2, 5, PB), goal_t, torch.zeros(PB))
    sd_x = torch.cat([x0_t[None], xs0[:-1]])
    reg = torch.tensor([1e-6, 1e-3, 10.0])
    AB = k.linearize(sd_x, us0)
    kK = k.backward(AB, sd_x, us0, xs0[-1].contiguous(), goal_t, reg)
    alphas = torch.tensor(0.5 ** np.arange(6), dtype=torch.float32)
    alpha = torch.tensor([1.0, 0.0, 0.125])
    refs = {
        "lin": [AB],
        "bwd": [kK],
        "fwd": [k.linesearch_costs(x0_t, sd_x, us0, kK, goal_t, alphas), *k.replay(x0_t, sd_x, us0, kK, goal_t, alpha)],
    }
    got = {
        "lin": _call(libs["lin"], [sd_x, us0], [torch.empty_like(AB)], PB, PH),
        "bwd": _call(libs["bwd"], [AB, sd_x, us0, xs0[-1].contiguous(), goal_t, reg], [torch.empty_like(kK)], PB, PH),
        "fwd": _call(
            libs["fwd"], [x0_t, sd_x, us0, kK, goal_t, alphas, alpha],
            [torch.empty(6, PB), torch.empty(PH, 4, PB), torch.empty(PH, 2, PB), torch.empty(PB)], PB, PH, 6,
        ),
    }
    for unit in refs:
        for g, r in zip(got[unit], refs[unit]):
            _close_to_scale(g.numpy(), r.numpy(), 1e-5)
    assert float(got["fwd"][2].abs()[:, 0].max()) <= 4.0 and float(got["fwd"][2].abs()[:, 1].max()) <= 3.0


# K3's phases, lane by lane, against the emitted one-thread sweep. Both are
# compiled by g++ with the same flags and both take sqrtf and the IEEE
# division, so they must agree bit for bit.

_BWD_REFERENCE = """
{step}
extern "C" void run_ref(const float** in, float** out, int B, int H, int A) {{
  const float *AB = in[0], *xs = in[1], *us = in[2], *x_last = in[3], *goal = in[4], *reg = in[5];
  for (int b = 0; b < B; ++b) {{
    float g[MPT_NJ], xl[MPT_NX], V[MPT_VN], V_next[MPT_VN], ab[MPT_AB], x[MPT_NX], u[MPT_NJ], kk[MPT_KKN];
    for (int j = 0; j < MPT_NJ; ++j) g[j] = MPT_AT(goal, j, b, B);
    for (int i = 0; i < MPT_NX; ++i) xl[i] = MPT_AT(x_last, i, b, B);
    riccati_terminal(xl, g, V);
    for (int t = H - 1; t >= 0; --t) {{
      for (int e = 0; e < MPT_AB; ++e) ab[e] = MPT_AT(AB, (size_t)t * MPT_AB + e, b, B);
      for (int i = 0; i < MPT_NX; ++i) x[i] = MPT_AT(xs, t * MPT_NX + i, b, B);
      for (int j = 0; j < MPT_NJ; ++j) u[j] = MPT_AT(us, t * MPT_NJ + j, b, B);
      riccati_step(ab, x, u, g, V, reg[b], kk, V_next);
      for (int e = 0; e < MPT_KKN; ++e) MPT_AT(out[0], (size_t)t * MPT_KKN + e, b, B) = kk[e];
      for (int e = 0; e < MPT_VN; ++e) V[e] = V_next[e];
    }}
  }}
}}
"""
TEAM_ROBOTS = ("two_link_planar", "ur5", "panda")  # n = 2 leaves most lanes idle
TEAM_B, TEAM_H = 5, 8
TEAM_SHAPES = [(3, 1), (3, 8), (5, 1), (5, 8)]  # (B, H): never a whole block of 4 warps
TEAM_REGS = [1e-6, 1e-3, 10.0]


@pytest.fixture(scope="module")
def team_units(tmp_path_factory):
    """Per robot, on first use: the K3 unit with the emitted one-thread
    sweep beside it, compiled by g++ at -O0 (the emitted step is 26k
    statements for Panda: 2 s at -O0, 12 s at -O1), and a nominal of
    TEAM_H steps under random torques from rest inside the joint limits,
    with its Jacobians (the plain K5 and K2)."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    units = {}

    def get(robot):
        if robot not in units:
            model = port_catalog.get_robot(robot, device="cpu")
            n = model.num_joints
            k = BatchMPCKernels(model, 0.01, u_lim=[10.0] * n)
            tmp = tmp_path_factory.mktemp(robot)
            cpp, so = tmp / "bwd.cpp", tmp / "bwd.so"
            cpp.write_text(_HARNESS.format(src=k.sources["bwd"]) + _BWD_REFERENCE.format(step=k.riccati_step_source))
            subprocess.run(["g++", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                           check=True, timeout=300)
            lib = ctypes.CDLL(str(so))
            for fn in (lib.run, lib.run_ref):
                fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 3
            rng = np.random.default_rng(7)
            lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
            lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
            q0 = (lo + hi) / 2 + rng.uniform(-0.5, 0.5, (TEAM_B, n)) * (hi - lo) / 2
            x0 = torch.from_numpy(np.concatenate([q0, np.zeros_like(q0)], 1).T.astype(np.float32)).contiguous()
            us = torch.from_numpy(rng.uniform(-3.0, 3.0, (TEAM_H, n, TEAM_B)).astype(np.float32))
            goal = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, TEAM_B)).astype(np.float32))
            xs, _, _ = k.replay(x0, torch.zeros(TEAM_H, 2 * n, TEAM_B), us, torch.zeros(TEAM_H, n, 1 + 2 * n, TEAM_B),
                                goal, torch.zeros(TEAM_B))
            sd_x = torch.cat([x0[None], xs[:-1]])
            units[robot] = SimpleNamespace(k=k, lib=lib, AB=k.linearize(sd_x, us), sd_x=sd_x, us=us, xs=xs, goal=goal)
        return units[robot]

    return get


def _team_inputs(u, B, H, reg):
    """The first B scenarios and H steps of a unit's nominal, with x_last the
    state after step H."""
    c = lambda x: x[..., :B].contiguous()
    return [c(u.AB[:H]), c(u.sd_x[:H]), c(u.us[:H]), c(u.xs[H - 1]), c(u.goal), torch.full((B,), reg)]


def _team_and_reference(u, ins, B, H):
    n = u.k.n
    outs = [torch.full((H, n, 1 + 2 * n, B), 7.0) for _ in range(2)]
    _call(u.lib, ins, outs[:1], B, H)
    u.lib.run_ref((ctypes.c_void_p * 6)(*[t.data_ptr() for t in ins]), (ctypes.c_void_p * 1)(outs[1].data_ptr()), B, H, 0)
    return outs


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("reg", TEAM_REGS)
@pytest.mark.parametrize("B, H", TEAM_SHAPES)
@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_bwd_team_phases_match_emitted_step_bitwise(team_units, robot, B, H, reg):
    u = team_units(robot)
    team, ref = _team_and_reference(u, _team_inputs(u, B, H, reg), B, H)
    assert bool(torch.isfinite(ref).all())
    assert torch.equal(_bits(team), _bits(ref))


@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_bwd_team_keeps_a_nan_scenario_to_itself(team_units, robot):
    """Scenario 1's Jacobians all NaN: its gains go NaN, every other
    scenario's stay bit for bit those of the clean run (one warp's storage is
    reused from scenario to scenario here); the clean run also holds the
    plain version to 1e-5 of scale."""
    u = team_units(robot)
    B, H = TEAM_B, TEAM_H
    clean = _team_inputs(u, B, H, 1e-3)
    dirty = [x.clone() for x in clean]
    dirty[0][..., 1] = float("nan")
    team_clean, _ = _team_and_reference(u, clean, B, H)
    team, ref = _team_and_reference(u, dirty, B, H)
    assert torch.equal(_bits(team), _bits(ref))
    assert bool(torch.isnan(team[..., 1]).all())
    others = [0, 2, 3, 4]
    assert torch.equal(_bits(team[..., others]), _bits(team_clean[..., others]))
    _close_to_scale(team_clean.numpy(), u.k.backward_plain(*clean).numpy(), 1e-5)


# ---------------------------------------------------------------------------
# Solver behaviour (tests/test_mpc.py::TestBatchFusedMPC at the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planar32():
    return _port_model(jax_catalog.two_link_planar(dtype=jnp.float64))


def test_goal_argument_matches_baked(planar32):
    B, H = 2, 10
    g1 = np.array([[0.5, -0.2], [0.2, 0.4]], np.float32)
    g2 = np.array([[-0.3, 0.6], [0.7, 0.1]], np.float32)
    x0, us0 = torch.zeros(B, 4), torch.zeros(B, H, 2)
    a = build_batch_tracking_mpc(planar32, g1, B, H, 0.02, iterations=3).solve(x0, us0, torch.from_numpy(g2))
    b = build_batch_tracking_mpc(planar32, g2, B, H, 0.02, iterations=3).solve(x0, us0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_shared_goal_broadcasts(planar32):
    B, H = 2, 8
    mpc = build_batch_tracking_mpc(planar32, [0.5, -0.2], B, H, 0.02, iterations=2)
    x0, us0 = torch.zeros(B, 4), torch.zeros(B, H, 2)
    shared = torch.tensor([-0.3, 0.6])
    a = mpc.solve(x0, us0, shared)
    b = mpc.solve(x0, us0, shared.expand(B, 2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_torque_limits_hold_and_scenarios_progress(planar32):
    B, H = 2, 12
    mpc = build_batch_tracking_mpc(planar32, [1.0, 0.3], B, H, 0.02, iterations=3, u_limit=[3.0, 2.0])
    assert mpc.kernels.P.u_lim == [3.0, 2.0]
    x0 = torch.zeros(B, 4)
    x0[1, 0] = 0.2
    us, xs, cost = mpc.solve(x0, torch.zeros(B, H, 2))
    assert float(us[:, :, 0].abs().max()) <= 3.0 and float(us[:, :, 1].abs().max()) <= 2.0
    assert float((us[0] - us[1]).abs().max()) > 1e-4
    assert float((xs[0, -1, 0] - 1.0).abs()) < float((xs[0, 0, 0] - 1.0).abs())
    assert bool(torch.isfinite(cost).all())
    # A warm start past the limits is clamped before the first rollout.
    us0, _, _ = build_batch_tracking_mpc(
        planar32, [1.0, 0.3], B, H, 0.02, iterations=0, u_limit=[3.0, 2.0]
    ).solve(x0, torch.full((B, H, 2), -50.0))
    assert torch.equal(us0, torch.tensor([-3.0, -2.0]).expand(B, H, 2))


def test_default_torque_limits_come_from_host_arrays():
    jm = jax_catalog.panda(dtype=jnp.float64)
    tm = _port_model(jm)
    mpc = build_batch_tracking_mpc(tm, np.zeros(7), 1, 2, 0.01, iterations=0)
    assert mpc.kernels.P.u_lim == [float(v) for v in jax_host_arrays(jm)["torque_limit"]]


def test_rejected_scenarios_keep_their_state(planar32):
    """A negative Levenberg term makes every Quu indefinite, so every gain
    is NaN and every step is rejected: the NaN guard must return the
    initial rollout untouched."""
    B, H = 3, 6
    goals = np.array([[0.4, 0.1], [-0.2, 0.3], [0.6, -0.5]], np.float32)
    x0 = torch.from_numpy(np.random.default_rng(2).uniform(-0.3, 0.3, (B, 4)).astype(np.float32))
    us_warm = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (B, H, 2)).astype(np.float32))
    bad = build_batch_tracking_mpc(planar32, goals, B, H, 0.02, iterations=2, reg=-1e3)
    us, xs, cost = bad.solve(x0, us_warm)
    k = bad.kernels
    xs0, us0, cost0 = k.replay(
        x0.T.contiguous(), torch.zeros(H, 4, B), us_warm.permute(1, 2, 0).contiguous(),
        torch.zeros(H, 2, 5, B), torch.from_numpy(goals).T.contiguous(), torch.zeros(B),
    )
    assert torch.equal(us, us0.permute(2, 0, 1)) and torch.equal(cost, cost0)
    assert torch.equal(xs[:, 1:], xs0.permute(2, 0, 1))
    assert bool(torch.isfinite(xs).all())


def test_batch_mpc_step_progresses(planar32):
    B, H = 2, 10
    goals = torch.tensor([[0.6, -0.3], [-0.4, 0.5]])
    mpc = build_batch_tracking_mpc(planar32, goals, B, H, 0.02, iterations=3)
    step = make_step_fn(planar32, 0.02)
    x, us_warm = torch.zeros(B, 4), torch.zeros(B, H, 2)
    err0 = float((x[:, :2] - goals).abs().max())
    for _ in range(6):
        u, us_next, (us, _, _) = batch_mpc_step(mpc, x, us_warm)
        assert torch.equal(u, us[:, 0]) and torch.equal(us_next[:, :-1], us[:, 1:])
        us_warm = us_next
        x = step(x, u)
    assert float((x[:, :2] - goals).abs().max()) < err0


def test_solver_checks_its_inputs(planar32):
    B, H = 2, 4
    mpc = build_batch_tracking_mpc(planar32, [0.1, 0.2], B, H, 0.02, iterations=1)
    x0, us0 = torch.zeros(B, 4), torch.zeros(B, H, 2)
    for bad_goal in (torch.zeros(3, 2), torch.zeros(B, 3), torch.zeros(3)):
        with pytest.raises(ValueError):
            mpc.solve(x0, us0, bad_goal)
    with pytest.raises(ValueError):
        mpc.solve(torch.zeros(B + 1, 4), torch.zeros(B + 1, H, 2))
    with pytest.raises(ValueError):
        mpc.solve(x0, torch.zeros(B, H + 1, 2))
    with pytest.raises(ValueError):
        build_batch_tracking_mpc(planar32, np.zeros((B + 1, 2)), B, H, 0.02)
    with pytest.raises(ValueError):
        build_batch_tracking_mpc(planar32, [0.1, 0.2], B, H, 0.02, u_limit=[1.0, 2.0, 3.0])
    k = mpc.kernels
    with pytest.raises(ValueError):  # a wrong shape
        k.linearize(torch.zeros(H, 4, B), torch.zeros(H, 3, B))
    meta = [torch.empty(s, device="meta") for s in ((H, 4, B), (H, 2, B))]
    with pytest.raises(ValueError):  # neither the CPU nor one CUDA device
        k.linearize(*meta)


def _stage_inputs(B, H, A):
    """Zero inputs of every stage for the two-link arm (n=2, nx=4, m=6)."""
    z = torch.zeros
    return {
        "linearize": (z(H, 4, B), z(H, 2, B)),
        "backward": (z(H, 4, 6, B), z(H, 4, B), z(H, 2, B), z(4, B), z(2, B), z(B)),
        "linesearch_costs": (z(4, B), z(H, 4, B), z(H, 2, B), z(H, 2, 5, B), z(2, B), z(A)),
        "replay": (z(4, B), z(H, 4, B), z(H, 2, B), z(H, 2, 5, B), z(2, B), z(B)),
    }


_EMPTY = [(s, 0, 3, 2) for s in STAGES] + [(s, 2, 0, 2) for s in STAGES] + [("linesearch_costs", 2, 3, 0)]


@pytest.mark.parametrize("stage, B, H, A", _EMPTY)
def test_stages_reject_empty_work(planar32, stage, B, H, A):
    """No stage takes an empty batch, horizon or alpha set, so a launch
    count only moves when a kernel runs."""
    k = BatchMPCKernels(planar32, 0.02, u_lim=[5.0, 5.0])
    with pytest.raises(ValueError):
        getattr(k, stage)(*_stage_inputs(B, H, A)[stage])


def test_plain_stages_are_the_cpu_stages(planar32):
    k = BatchMPCKernels(planar32, 0.02, u_lim=[5.0, 5.0])
    plain = k.plain()
    rng = np.random.default_rng(4)
    for stage, args in _stage_inputs(3, 2, 2).items():
        args = [torch.from_numpy(rng.uniform(0.1, 0.5, a.shape).astype(np.float32)) for a in args]
        assert getattr(plain, stage) == getattr(k, f"{stage}_plain")
        got, ref = getattr(k, stage)(*args), getattr(plain, stage)(*args)
        for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("robot", sorted(_ARMS))
def test_step_statements_are_the_shared_primal(arms, robot):
    """K2's bound counts the primal step once per (scenario, step):
    ``statements["step"]`` is the emitted step without its tangent."""
    tm = arms[robot, torch.float32][1]
    k = BatchMPCKernels(tm, 0.01, u_lim=[10.0] * tm.num_joints)
    _, _, primal = tfd.build_fd_step_source(tm, 0.01, clip_limits=True, clip_velocity=False)
    assert k.statements["step"] == primal
    assert primal < k.statements["linearize"] < 4 * primal
