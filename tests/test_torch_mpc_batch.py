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
  scenario kept to itself; K2's thread body, a group of G seeds a thread,
  for every (scenario, group, step), bitwise against the plain
  linearization and the emitted one-seed ``fd_step_jvp``, with G = 3 and
  G = n, on a joint limit and with a NaN scenario.
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
from manipulapy_tpu.models import robot_data as jax_robot_data
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.fused_batch import build_batch_tracking_mpc as jax_build_batch
from manipulapy_tpu.ops import fd_step as jfd
from manipulapy_tpu_torch.models import catalog as port_catalog
from manipulapy_tpu_torch.models import from_host_arrays, robot_data
from manipulapy_tpu_torch.mpc import ILQRParams, ilqr, make_step_fn, make_tracking_costs
from manipulapy_tpu_torch.mpc.fused_batch import batch_mpc_step, build_batch_tracking_mpc
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops.cuda_mpc_batch import STAGES, BatchMPCKernels
from manipulapy_tpu_torch.ops.cuda_mpc_single import SingleMPCKernels

CPU = torch.device("cpu")
STAGE_RTOL = 2e-4  # of each output's largest magnitude


def _port_model(jax_model, dtype=torch.float32):
    return from_host_arrays(jax_host_arrays(jax_model), dtype=dtype, device=CPU)


# The calibrated fleet's extremes, each robot's root-to-tip chain: one
# revolute finger joint (3 tangent seeds, most of K3's lanes idle) and the
# Kinova Jaco's 8-joint chain (the widest calibrated chain of the fleet).
CALIBRATED = {"robotiq_2f_85": "robotiq_2f_85", "jaco_7dof_chain": "jaco_7dof"}


def _model(robot, dtype=torch.float32):
    """The port's model of a test robot on the CPU: a calibrated chain of
    ``CALIBRATED``, else the programmatic catalog arm."""
    if robot in CALIBRATED:
        return robot_data.load_robot(CALIBRATED[robot], dtype=dtype, chain_joints_only=True, device="cpu")
    return port_catalog.get_robot(robot, source="programmatic", dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# K2: the linearization
# ---------------------------------------------------------------------------

_ARMS = {"ur5": jax_catalog.ur5, "panda": jax_catalog.panda}
# The calibrated chains' JAX models (``tests/test_torch_mpc_calibrated.py``
# runs the tests below on them).
CALIBRATED_ARMS = {name: (lambda key: lambda dtype: jax_robot_data.load_robot(key, dtype=dtype, chain_joints_only=True))(key)
                   for name, key in CALIBRATED.items()}


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


def arm_pairs(makers: dict) -> dict:
    """Per arm and dtype: the JAX model and the port's, from one set of
    f64 host arrays."""
    out = {}
    for name, make in makers.items():
        host = jax_host_arrays(make(dtype=jnp.float64))
        for _, jdt, tdt in LIN_CASES.values():
            out[name, tdt] = (make(dtype=jdt), from_host_arrays(host, dtype=tdt, device=CPU))
    return out


@pytest.fixture(scope="module")
def arms():
    return arm_pairs(_ARMS)


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
    if robot in CALIBRATED and tdt == torch.float32:
        # The Jaco's finger weighs grams: its dq' row reaches dt M^-1 ~ 43,
        # and f32 rounding, amplified there, is held to each row's scale.
        scale = np.maximum(1.0, np.abs(ref[:, n:]).max(axis=-1, keepdims=True))
        assert float((np.abs(got[:, n:] - ref[:, n:]) / scale).max()) <= tol_dq
    else:
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

# Runs the threads of one team as coroutines: between two barriers
# (``mpt_team_sync``, which yields here) threads 0..T-1 run one after the
# other, so each phase runs warp by warp, then lane by lane, each thread with
# its own registers. Returns nonzero when the threads met different numbers
# of barriers.
TEAM_RUNNER = """\
#include <math.h>
#include <stdlib.h>
#include <ucontext.h>
static ucontext_t mpt_main_ctx;
static ucontext_t* mpt_ctx;
static int *mpt_meets, mpt_cur;
static char* mpt_done;
typedef void (*mpt_thread_fn)(int tid, void* arg);
static mpt_thread_fn mpt_fn;
static void* mpt_arg;
extern "C" void mpt_host_yield(void) {
  ++mpt_meets[mpt_cur];
  swapcontext(&mpt_ctx[mpt_cur], &mpt_main_ctx);
}
static void mpt_entry(int tid) {
  mpt_fn(tid, mpt_arg);
  mpt_done[tid] = 1;
}
static int mpt_run_team(int T, mpt_thread_fn fn, void* arg) {
  const size_t stack = 1 << 18;
  mpt_ctx = (ucontext_t*)calloc(T, sizeof(ucontext_t));
  mpt_meets = (int*)calloc(T, sizeof(int));
  mpt_done = (char*)calloc(T, 1);
  char* stacks = (char*)malloc(stack * T);
  mpt_fn = fn;
  mpt_arg = arg;
  for (int t = 0; t < T; ++t) {
    getcontext(&mpt_ctx[t]);
    mpt_ctx[t].uc_stack.ss_sp = stacks + stack * t;
    mpt_ctx[t].uc_stack.ss_size = stack;
    mpt_ctx[t].uc_link = &mpt_main_ctx;
    makecontext(&mpt_ctx[t], (void (*)())mpt_entry, 1, t);
  }
  for (int live = T; live > 0;) {
    live = 0;
    for (int t = 0; t < T; ++t)
      if (!mpt_done[t]) {
        mpt_cur = t;
        swapcontext(&mpt_main_ctx, &mpt_ctx[t]);
        live += !mpt_done[t];
      }
  }
  int bad = 0;
  for (int t = 1; t < T; ++t) bad |= mpt_meets[t] != mpt_meets[0];
  free(mpt_ctx);
  free(mpt_meets);
  free(mpt_done);
  free(stacks);
  return bad;
}
"""

# K5 on the host: every team of the batch in turn, its storage NaN-filled
# first; inputs x0, sd_x, sd_u, kK, goal, alpha; outputs xs, us, cost.
REPLAY_TEAMS = """
#if defined(MPT_UNIT_FWD) && defined(MPT_REPLAY_TEAM)
struct mpt_replay_args {{ const float** in; float** out; int B, H, b0; float* tm; }};
static void mpt_replay_thread(int tid, void* p) {{
  const mpt_replay_args* a = (const mpt_replay_args*)p;
  replay_team(tid, 1, a->tm, a->in[0], a->in[1], a->in[2], a->in[3], a->in[4], a->in[5],
              a->out[0], a->out[1], a->out[2], a->B, a->H, a->b0);
}}
extern "C" int run_replay(const float** in, float** out, int B, int H) {{
  float* tm = (float*)malloc(MPT_T_BYTES);
  int bad = 0;
  for (int b0 = 0; b0 < B; b0 += MPT_TEAM_S) {{
    for (int i = 0; i < MPT_T_FLOATS; ++i) tm[i] = NAN;
    mpt_replay_args a = {{in, out, B, H, b0, tm}};
    bad |= mpt_run_team(MPT_TEAM_THREADS, mpt_replay_thread, &a);
  }}
  free(tm);
  return bad;
}}
#endif
"""

def _braced(c_source: str) -> str:
    """C source, escaped for ``str.format``."""
    return c_source.replace("{", "{{").replace("}", "}}")


_HARNESS = _braced(TEAM_RUNNER) + """\
#define __device__
#define __forceinline__ inline
#define MPT_HOST_TEAM 1
{src}
""" + REPLAY_TEAMS + """
extern "C" void run(const float** in, float** out, int B, int H, int A) {{
#if defined(MPT_UNIT_LIN)
  for (int t = 0; t < H; ++t) for (int g = 0; g < MPT_LIN_GROUPS; ++g) for (int b = 0; b < B; ++b)
    lin_thread(in[0], in[1], out[0], B, b, g, t);
#elif defined(MPT_UNIT_BWD)
  // K3: one warp's storage, a host array; under MPT_HOST_TEAM each phase of
  // the sweep runs lanes 0..31 in turn before the next phase begins.
  mpt_bwd_team team;
  for (int b = 0; b < B; ++b) bwd_sweep(0, &team, in[0], in[1], in[2], in[3], in[4], in[5], out[0], B, H, b);
#else
  for (int a = 0; a < A; ++a) for (int b = 0; b < B; ++b)
    cost_thread(in[0], in[1], in[2], in[3], in[4], in[5], out[0], B, H, b, a);
#if defined(MPT_REPLAY_TEAM)
  // K5's team variant: its teams, each thread a coroutine (TEAM_RUNNER).
  const float* rin[6] = {{in[0], in[1], in[2], in[3], in[4], in[6]}};
  if (run_replay(rin, out + 1, B, H)) abort();
#else
  for (int b = 0; b < B; ++b)
    replay_thread(in[0], in[1], in[2], in[3], in[4], in[6], out[1], out[2], out[3], B, H, b);
#endif
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
_TORCH_SQRT = 'extern "C" { float (*mpt_host_fn[3])(float); }\n#define sqrtf(v) mpt_host_fn[2](v)\n'
TEAM_ROBOTS = ("two_link_planar", "ur5", "panda")  # n = 2 leaves most lanes idle; n = 1 in test_torch_mpc_calibrated
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
            model = _model(robot)
            n = model.num_joints
            k = BatchMPCKernels(model, 0.01, u_lim=[10.0] * n)
            tmp = tmp_path_factory.mktemp(robot)
            cpp, so = tmp / "bwd.cpp", tmp / "bwd.so"
            # The calibrated chains' Riccati steps amplify the last bit of a
            # sqrt past 1e-5 of scale, so there the unit's sqrtf is PyTorch's,
            # as the plain version's is (the host's libm and PyTorch's CPU
            # sqrt differ in the last bit for some inputs; on the card they
            # are one function).
            src = (_TORCH_SQRT if robot in CALIBRATED else "") + k.sources["bwd"]
            cpp.write_text(_HARNESS.format(src=src) + _BWD_REFERENCE.format(step=k.riccati_step_source))
            subprocess.run(["g++", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                           check=True, timeout=300)
            lib = ctypes.CDLL(str(so))
            if robot in CALIBRATED:
                (ctypes.c_void_p * 3).in_dll(lib, "mpt_host_fn")[2] = ctypes.cast(_TORCH_FNS[2], ctypes.c_void_p)
            for fn in (lib.run, lib.run_ref):
                fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 3
            rng = np.random.default_rng(7)
            lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
            lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
            q0 = (lo + hi) / 2 + rng.uniform(-0.5, 0.5, (TEAM_B, n)) * (hi - lo) / 2
            x0 = torch.from_numpy(np.concatenate([q0, np.zeros_like(q0)], 1).T.astype(np.float32)).contiguous()
            us = torch.from_numpy(rng.uniform(-3.0, 3.0, (TEAM_H, n, TEAM_B)).astype(np.float32))
            if robot in CALIBRATED:  # under +-3 N m the Jaco's finger (grams) leaves f32 within 8 steps
                us = us * 0.1
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


# K2's thread body (a group of G seeds: the primal step once, each tangent
# once per seed) for every (scenario, group, step), against the plain
# linearization and the emitted one-seed fd_step_jvp, bit for bit. The host's
# libm sinf/cosf/sqrtf and PyTorch's CPU sin/cos/sqrt (MKL's vector maths)
# differ in the last bit for some 5% of inputs, so the harness routes the
# three through PyTorch's own: what is held bitwise is the emitted arithmetic.
# On the card the kernel's sinf is torch.sin's and nothing is substituted.

_LIN_HARNESS = """\
#include <math.h>
extern "C" {{ float (*mpt_host_fn[3])(float); }}
#define sinf(v) mpt_host_fn[0](v)
#define cosf(v) mpt_host_fn[1](v)
#define sqrtf(v) mpt_host_fn[2](v)
#define __device__
#define __forceinline__ inline
{src}
{seed_src}
extern "C" void run(const float** in, float** out, int B, int H, int A) {{
  for (int t = 0; t < H; ++t) for (int g = 0; g < MPT_LIN_GROUPS; ++g) for (int b = 0; b < B; ++b)
    lin_thread(in[0], in[1], out[0], B, b, g, t);
}}
extern "C" void run_ref(const float** in, float** out, int B, int H, int A) {{
  for (int t = 0; t < H; ++t) for (int k = 0; k < MPT_M; ++k) for (int b = 0; b < B; ++b) {{
    float x[MPT_NX], u[MPT_NJ], x_next[MPT_NX], col[MPT_NX];
    for (int i = 0; i < MPT_NX; ++i) x[i] = MPT_AT(in[0], t * MPT_NX + i, b, B);
    for (int j = 0; j < MPT_NJ; ++j) u[j] = MPT_AT(in[1], t * MPT_NJ + j, b, B);
    fd_step_jvp(x, u, k, x_next, col);
    for (int i = 0; i < MPT_NX; ++i) MPT_AT(out[0], ((size_t)t * MPT_NX + i) * MPT_M + k, b, B) = col[i];
  }}
}}
"""
_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)
# PyTorch's float32 sin, cos and sqrt of one value, for the harness.
_TORCH_FNS = [_FN(lambda v, f=f: float(f(torch.tensor([v], dtype=torch.float32))[0]))
              for f in (torch.sin, torch.cos, torch.sqrt)]
LIN_ROBOTS = ("two_link_planar", "ur5", "panda")
LIN_SHAPES = [(1, 1), (1, 8), (3, 1), (3, 8)]  # (B, H)


@pytest.fixture(scope="module")
def lin_units(tmp_path_factory):
    """Per (robot, G, g) on first use: the K2 unit for G seeds a thread with
    the one-seed ``fd_step_jvp`` beside it, compiled by g++ at -O0 (Panda's
    G = 7 body is 63k statements)."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    units = {}

    def get(robot, seeds, g=tfd.DEFAULT_G):
        key = (robot, seeds, g)
        if key not in units:
            model = _model(robot)
            n = model.num_joints
            cls = type("Seeds", (BatchMPCKernels,), {"LIN_SEEDS": seeds})
            k = cls(model, 0.01, g=g, u_lim=[10.0] * n, _form="emitted")
            tmp = tmp_path_factory.mktemp(f"{robot}_G{seeds}")
            cpp, so = tmp / "lin.cpp", tmp / "lin.so"
            cpp.write_text(_LIN_HARNESS.format(src=k.sources["lin"], seed_src=k.linearize_seed_source))
            subprocess.run(["g++", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                           check=True, timeout=300)
            lib = ctypes.CDLL(str(so))
            fns = (ctypes.c_void_p * 3).in_dll(lib, "mpt_host_fn")
            for i, fn in enumerate(_TORCH_FNS):
                fns[i] = ctypes.cast(fn, ctypes.c_void_p)
            for fn in (lib.run, lib.run_ref):
                fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 3
            units[key] = SimpleNamespace(k=k, lib=lib, model=model)
        return units[key]

    return get


def _lin_seeds(robot, which):
    return int(which) if which in ("1", "3") else _model(robot).num_joints


def _lin_problem(model, B, H, seed=0):
    """xs (H, 2n, B) inside the joint limits, us (H, n, B) within 30% of the
    torque limits, from numpy."""
    n = model.num_joints
    rng = np.random.default_rng(seed)
    lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
    lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
    q = (lo + hi)[None, :, None] / 2 + rng.uniform(-0.8, 0.8, (H, n, B)) * (hi - lo)[None, :, None] / 2
    dq = rng.uniform(-0.5, 0.5, (H, n, B))
    u_lim = model.torque_limit.double().numpy()
    u_lim = np.where(np.isfinite(u_lim), u_lim, 10.0)  # the two-link arm has none
    us = rng.uniform(-0.3, 0.3, (H, n, B)) * u_lim[None, :, None]
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).contiguous()
    return f32(np.concatenate([q, dq], axis=1)), f32(us)


def _lin_host(u, xs, us):
    """(the group kernel's AB, the one-seed body's AB), NaN-filled first."""
    H, B = xs.shape[0], xs.shape[2]
    outs = [torch.full((H, u.k.nx, u.k.m, B), float("nan")) for _ in range(2)]
    _call(u.lib, [xs, us], outs[:1], B, H)
    u.lib.run_ref((ctypes.c_void_p * 2)(xs.data_ptr(), us.data_ptr()), (ctypes.c_void_p * 1)(outs[1].data_ptr()), B, H, 0)
    return outs


def _assert_same_bits(got, ref):
    """Equal bits wherever ``ref`` is a number, NaN where it is NaN."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(ref)[~nan])


@pytest.mark.parametrize("B, H", LIN_SHAPES)
@pytest.mark.parametrize("which", ["1", "3", "n"])
@pytest.mark.parametrize("robot", LIN_ROBOTS)
def test_lin_group_body_matches_plain_bitwise(lin_units, robot, which, B, H):
    u = lin_units(robot, _lin_seeds(robot, which))
    xs, us = _lin_problem(u.model, B, H, seed=B + 10 * H)
    got, one_seed = _lin_host(u, xs, us)
    ref = u.k.linearize_plain(xs, us)
    assert bool(torch.isfinite(ref).all())
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(one_seed), _bits(ref))


@pytest.mark.parametrize("which", ["1", "3", "n"])
@pytest.mark.parametrize("robot", ["two_link_planar", "ur5"])
def test_lin_group_body_halves_the_tangent_on_a_limit(lin_units, robot, which):
    """Gravity off, scenario 0 at rest on joint 0's lower limit with zero
    torque: q'_0 is the limit exactly, and JAX's clamp halves its tangent
    there (the plain version's rule); bit for bit, at every step."""
    u = lin_units(robot, _lin_seeds(robot, which), (0.0, 0.0, 0.0))
    B, H = 3, 8
    xs, us = _lin_problem(u.model, B, H, seed=1)
    xs[:, 0, 0] = float(u.model.joint_lower[0])
    xs[:, u.k.n:, 0], us[..., 0] = 0.0, 0.0
    got, one_seed = _lin_host(u, xs, us)
    ref = u.k.linearize_plain(xs, us)
    assert torch.equal(_bits(got), _bits(ref)) and torch.equal(_bits(one_seed), _bits(ref))
    assert bool((got[:, 0, 0, 0] == 0.5).all())  # d q'_0 / d q_0 on the limit
    if robot in CALIBRATED:
        # Inside: the whole tangent of the step without the limit clamp (a
        # calibrated base joint's symmetry does not cancel to the last bit,
        # so d q'_0 / d q_0 is 1 + O(dt^2 eps) there, not 1).
        _, free = tfd.build_fd_step_jvp_planes(u.model, 0.01, g=(0.0, 0.0, 0.0), clip_limits=False)
        eye = torch.eye(u.k.m).reshape(u.k.m, u.k.m, 1)
        for t in range(H):
            _, tans = free([xs[t, i, 1:] for i in range(u.k.nx)], [us[t, j, 1:] for j in range(u.k.n)],
                           [eye[i] for i in range(u.k.nx)], [eye[u.k.nx + j] for j in range(u.k.n)])
            assert torch.equal(_bits(got[t, 0, :, 1:]), _bits(torch.stack([tans[0][k] for k in range(u.k.m)])))
    else:
        assert bool((got[:, 0, 0, 1:] == 1.0).all())  # inside: the whole tangent


@pytest.mark.parametrize("which", ["1", "3", "n"])
@pytest.mark.parametrize("robot", LIN_ROBOTS)
def test_lin_group_body_keeps_a_nan_scenario_to_itself(lin_units, robot, which):
    """Scenario 1's velocity of joint 0 is NaN at every step: its Jacobians
    go NaN where the plain version's do, and every other scenario keeps the
    clean run's bits."""
    u = lin_units(robot, _lin_seeds(robot, which))
    B, H = 3, 8
    xs, us = _lin_problem(u.model, B, H, seed=2)
    clean, _ = _lin_host(u, xs, us)
    # A one-joint arm has no Coriolis term, so its Jacobian never reads the
    # velocity: its NaN goes on the position.
    xs[:, u.k.n if u.k.n > 1 else 0, 1] = float("nan")
    got, one_seed = _lin_host(u, xs, us)
    ref = u.k.linearize_plain(xs, us)
    _assert_same_bits(got, ref)
    _assert_same_bits(one_seed, ref)
    assert bool(torch.isnan(got[..., 1]).any())
    assert torch.equal(_bits(got[..., [0, 2]]), _bits(clean[..., [0, 2]]))


def test_single_lin_unit_keeps_the_one_seed_body():
    """K6 keeps one seed a lane: its one-thread unit holds the lean group
    body at one seed (K2's for the Panda), and its team unit the same
    statements split over the warps; the emitted one-seed ``fd_step_jvp``
    is in neither K6's nor K2's unit, but the host tests' reference of
    both. K2's emitted form runs the group body, three seeds a thread for
    the UR5 and one for the Panda."""
    model = port_catalog.get_robot("ur5", source="programmatic", device="cpu")
    _, one_seed, _ = tfd.build_fd_step_jvp_source(model, 0.01, g=tfd.DEFAULT_G)
    _, group1, group_ops = tfd.build_fd_step_jvp_group_source(model, 0.01, g=tfd.DEFAULT_G, seeds=1)
    single = type("OneThread", (SingleMPCKernels,), {"LIN_WARPS": 0})(model, 0.01, u_lim=[10.0] * 6)
    team = type("Team", (SingleMPCKernels,), {"LIN_WARPS": 4})(model, 0.01, u_lim=[10.0] * 6)
    batch = BatchMPCKernels(model, 0.01, u_lim=[10.0] * 6, _form="emitted")
    assert group1 in single.sources["lin"] and "#define MPT_LIN_SEEDS 1\n" in single.sources["lin"]
    assert single.lin_team is None and team.lin_team.statements == group_ops
    assert group1 == single.linearize_group_source == team.linearize_group_source
    assert one_seed == single.linearize_seed_source == batch.linearize_seed_source
    assert all(one_seed not in k.sources["lin"] for k in (single, team, batch))
    assert batch.LIN_SEEDS == 3 and f"#define MPT_LIN_SEEDS 3\n" in batch.sources["lin"]
    panda = BatchMPCKernels(port_catalog.get_robot("panda", source="programmatic", device="cpu"), 0.01, u_lim=[10.0] * 7,
                            _form="emitted")
    assert panda.LIN_SEEDS == 1 and f"#define MPT_LIN_SEEDS 1\n" in panda.sources["lin"]


# K5, a team of W warps per MPT_TEAM_S scenarios, each closed-loop step the
# emitted step partitioned over the warps (``cg.team_function``). The
# partition's invariants, then the team's threads run on the host as
# coroutines (TEAM_RUNNER): every team of the batch, phase by phase, warp by
# warp, lane by lane, bit for bit against the emitted one-thread step (the
# unit's ``fwd_rollout``, which K4 runs) and against ``replay_plain``, with
# sin, cos and sqrt routed through PyTorch's own as for K2.


def check_team_partition(team, statements: int, prefix: str = "mpt_fwd_team") -> None:
    """The invariants of a team step (``cg.TeamStep``, its warp programs
    ``{prefix}_w<w>``): every statement runs once; each read follows its
    write (the same warp, earlier in the phase, or an earlier phase); a
    value crosses warps through its slot (or its output), which no other
    value overwrites before its last first read; P - 1 barriers a warp."""
    part = team.partition
    W, P = part.warps, part.phases
    assert team.statements == statements == len(part.place) == len(team.reads)
    assert all(0 <= p < P and 0 <= w < W for p, w in part.place)
    first = {}
    for i, reads in enumerate(team.reads):
        p, w = part.place[i]
        for u in reads:
            pu, wu = part.place[u]
            assert u < i and (pu < p or (pu == p and wu == w))
            if wu != w:
                first[(u, w)] = min(first.get((u, w), P), p)
    crossing = {u: (k, written, dict(readers)) for u, k, written, readers in team.crossings}
    for (u, w), p in first.items():
        k, written, readers = crossing[u]
        assert written == part.place[u][0] and readers[w] == p > written
    assert len(crossing) == len({u for u, _ in first})
    by_slot = {}
    for u, (k, written, readers) in crossing.items():
        if k >= 0:
            assert k < team.slots
            by_slot.setdefault(k, []).append((written, max(readers.values())))
    for spans in by_slot.values():
        spans.sort()
        assert all(b[0] > a[1] for a, b in zip(spans, spans[1:]))
    assert team.source.count("mpt_team_sync(bar, ") == W * (P - 1)
    for w in range(W):
        assert f"void {prefix}_w{w}(" in team.source


TEAM_WARPS = [1, 4, 8]
REPLAY_ROBOTS = ("two_link_planar", "ur5", "panda")  # K5's team is a variant unit, off the solve's path


@pytest.mark.parametrize("warps", TEAM_WARPS)
@pytest.mark.parametrize("robot", REPLAY_ROBOTS)
def test_replay_team_partition_invariants(robot, warps):
    model = _model(robot)
    cls = type("Team", (BatchMPCKernels,), {"TEAM_WARPS": warps})
    k = cls(model, 0.01, u_lim=[10.0] * model.num_joints)
    check_team_partition(k.team, k.statements["replay"])
    assert k.team.partition.critical <= k.statements["replay"]
    assert (warps == 1) == (k.team.partition.phases == 1)


_REPLAY_REFERENCE = """
extern "C" void run_ref(const float** in, float** out, int B, int H) {
  for (int b = 0; b < B; ++b)
    out[2][b] = fwd_rollout(in[0], in[1], in[2], in[3], in[4], in[5][b], out[0], out[1], 1, B, H, b);
}
"""
HOST_FNS = """\
#include <math.h>
extern "C" { float (*mpt_host_fn[3])(float); }
#define sinf(v) mpt_host_fn[0](v)
#define cosf(v) mpt_host_fn[1](v)
#define sqrtf(v) mpt_host_fn[2](v)
"""


def compile_team_unit(source: str, tmp, name: str, entries) -> ctypes.CDLL:
    """A unit under the host shim, g++ -O0 without contraction, sin, cos and
    sqrt PyTorch's own (``_TORCH_FNS``); ``entries`` get (in, out, int, int)."""
    cpp, so = tmp / f"{name}.cpp", tmp / f"{name}.so"
    cpp.write_text(HOST_FNS + TEAM_RUNNER + "#define __device__\n#define __forceinline__ inline\n"
                   "#define MPT_HOST_TEAM 1\n" + source)
    subprocess.run(["g++", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fns = (ctypes.c_void_p * 3).in_dll(lib, "mpt_host_fn")
    for i, fn in enumerate(_TORCH_FNS):
        fns[i] = ctypes.cast(fn, ctypes.c_void_p)
    for entry in entries:
        getattr(lib, entry).argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 2
    return lib


@pytest.fixture(scope="module")
def replay_units(tmp_path_factory):
    """Per (robot, W, S) on first use: the K4/K5 unit with its team of W
    warps over S scenarios, on the host, and the emitted one-thread replay
    beside it."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    units = {}

    def get(robot, warps, scenarios=32):
        key = (robot, warps, scenarios)
        if key not in units:
            model = _model(robot)
            cls = type("Team", (BatchMPCKernels,), {"TEAM_WARPS": warps, "TEAM_S": scenarios})
            k = cls(model, 0.01, u_lim=[10.0] * model.num_joints)
            src = k.sources["fwd"] + REPLAY_TEAMS.format() + _REPLAY_REFERENCE
            lib = compile_team_unit(src, tmp_path_factory.mktemp(f"{robot}_W{warps}_S{scenarios}"), "fwd",
                                    ("run_replay", "run_ref"))
            units[key] = SimpleNamespace(k=k, lib=lib, model=model)
        return units[key]

    return get


def _replay_problem(u, B, H, seed=0):
    """x0 inside the joint limits at rest, an open-loop nominal of H steps
    under torques within 30% of 10, gains of 0.1 scale, alphas in [0, 1]."""
    model, k = u.model, u.k
    n = model.num_joints
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).contiguous()
    lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
    lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
    q0 = (lo + hi)[:, None] / 2 + rng.uniform(-0.4, 0.4, (n, B)) * (hi - lo)[:, None] / 2
    x0 = f32(np.concatenate([q0, rng.uniform(-0.2, 0.2, (n, B))]))
    us = f32(rng.uniform(-3.0, 3.0, (H, n, B)))
    goal = f32(rng.uniform(-1.0, 1.0, (n, B)))
    xs = k.replay_plain(x0, torch.zeros(H, 2 * n, B), us, torch.zeros(H, n, 1 + 2 * n, B), goal, torch.zeros(B))[0]
    sd_x = torch.cat([x0[None], xs[:-1]]).contiguous()
    kK = f32(rng.uniform(-0.1, 0.1, (H, n, 1 + 2 * n, B)))
    return [x0, sd_x, us, kK, goal, f32(rng.uniform(0.0, 1.0, B))]


def _replay_host(u, ins):
    """(the team's outputs, the one-thread replay's), NaN-filled first."""
    H, n2, B = ins[1].shape
    runs = []
    for entry in ("run_replay", "run_ref"):
        outs = [torch.full((H, n2, B), float("nan")), torch.full((H, n2 // 2, B), float("nan")),
                torch.full((B,), float("nan"))]
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
        met = getattr(u.lib, entry)(ptrs(ins), ptrs(outs), B, H)
        assert entry == "run_ref" or met == 0  # the team's threads met equally often
        runs.append(outs)
    return runs


@pytest.mark.parametrize("B", [1, 31, 33, 64])
@pytest.mark.parametrize("warps", TEAM_WARPS)
@pytest.mark.parametrize("robot", REPLAY_ROBOTS)
def test_replay_team_matches_emitted_step_bitwise(replay_units, robot, warps, B):
    """B = 64 takes the rows four scenarios a copy (B % 4 == 0), the others
    one at a time."""
    u = replay_units(robot, warps)
    ins = _replay_problem(u, B, 4, seed=B)
    team, one = _replay_host(u, ins)
    plain = u.k.replay_plain(*ins)
    for got, ref, pl in zip(team, one, plain):
        assert bool(torch.isfinite(pl).all())
        assert torch.equal(_bits(got), _bits(ref)) and torch.equal(_bits(got), _bits(pl))


@pytest.mark.parametrize("robot, warps, scenarios, B, H", [
    ("two_link_planar", 8, 32, 1025, 2), ("ur5", 8, 32, 1025, 2), ("panda", 8, 32, 1025, 2),
    ("ur5", 4, 8, 33, 3), ("ur5", 4, 16, 31, 3), ("panda", 4, 8, 9, 2), ("panda", 4, 8, 36, 2),
])
def test_replay_team_with_idle_lanes_matches_plain_bitwise(replay_units, robot, warps, scenarios, B, H):
    """Teams whose last one runs past B, and teams of 8 or 16 scenarios whose
    other lanes repeat their work: bit for bit as the plain version."""
    u = replay_units(robot, warps, scenarios)
    ins = _replay_problem(u, B, H, seed=3)
    team, one = _replay_host(u, ins)
    for got, ref, pl in zip(team, one, u.k.replay_plain(*ins)):
        assert torch.equal(_bits(got), _bits(pl)) and torch.equal(_bits(ref), _bits(pl))


@pytest.mark.parametrize("robot", REPLAY_ROBOTS)
def test_replay_team_keeps_a_nan_scenario_to_itself(replay_units, robot):
    """Scenario 1's gains all NaN: its rollout goes NaN where the plain
    version's does, and every other scenario of its team keeps the clean
    run's bits."""
    u = replay_units(robot, 8)
    B, H = 5, 4
    ins = _replay_problem(u, B, H, seed=4)
    clean, _ = _replay_host(u, ins)
    ins[3][..., 1] = float("nan")
    team, one = _replay_host(u, ins)
    for got, ref, pl, cl in zip(team, one, u.k.replay_plain(*ins), clean):
        _assert_same_bits(got, pl)
        _assert_same_bits(ref, pl)
        assert bool(torch.isnan(got[..., 1]).all())
        assert torch.equal(_bits(got[..., [0, 2, 3, 4]]), _bits(cl[..., [0, 2, 3, 4]]))


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
        "linesearch": (z(4, B), z(H, 4, B), z(H, 2, B), z(H, 2, 5, B), z(2, B), z(A)),
        "replay": (z(4, B), z(H, 4, B), z(H, 2, B), z(H, 2, 5, B), z(2, B), z(B)),
    }


_EMPTY = [(s, 0, 3, 2) for s in STAGES] + [(s, 2, 0, 2) for s in STAGES] + [
    ("linesearch_costs", 2, 3, 0), ("linesearch", 2, 3, 0)]


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


@pytest.mark.parametrize("seeds", [1, 3, 7, 21])
def test_group_statements_count_the_primal_once(arms, seeds):
    """The group body's statements grow by one seed's tangent a seed: the
    primal step (and each rule's shared factor) is emitted once. With one
    seed it is the one-seed body and the few statements that recompute the
    RNEA's downward transforms (its lean order)."""
    tm = arms["panda", torch.float32][1]
    k = BatchMPCKernels(tm, 0.01, u_lim=[10.0] * 7)
    one, step = k.statements["linearize"], k.statements["step"]
    count = {g: tfd.build_fd_step_jvp_group_source(tm, 0.01, seeds=g)[2] for g in (1, 3, seeds)}
    _, src, _ = tfd.build_fd_step_jvp_group_source(tm, 0.01, seeds=seeds)
    assert src.count("\n  col[") == 14 * seeds
    assert one < count[1] < 1.05 * one
    tangent = (count[3] - count[1]) // 2
    assert count[seeds] == count[1] + (seeds - 1) * tangent
    assert 0.9 * (one - step) < tangent < 1.05 * (one - step)
    assert k.LIN_SEEDS == 1 and k.statements["linearize_group"] == count[1]
    with pytest.raises(ValueError):
        tfd.build_fd_step_jvp_group_source(tm, 0.01, seeds=4)  # does not divide m = 21


# ---------------------------------------------------------------------------
# K4 keeps every alpha's trajectory; the solver selects the chosen one
# ---------------------------------------------------------------------------

SELECT_ROBOTS = {"two_link_planar": (5, 6, 3), "ur5": (4, 5, 2), "panda": (3, 4, 2)}  # B, H, iterations


def _select_problem(robot):
    """A robot from the port's catalog on the CPU, states at rest inside its
    limits, goals near them and a random warm start, from numpy."""
    model = port_catalog.get_robot(robot, source="programmatic", device="cpu")
    B, H, iters = SELECT_ROBOTS[robot]
    n = model.num_joints
    rng = np.random.default_rng(len(robot))
    lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
    lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
    q0 = (lo + hi) / 2 + rng.uniform(-0.4, 0.4, (B, n)) * (hi - lo) / 2
    goals = np.clip(q0 + rng.uniform(-0.3, 0.3, (B, n)), lo, hi).astype(np.float32)
    x0 = torch.from_numpy(np.concatenate([q0, np.zeros_like(q0)], 1).astype(np.float32))
    us_warm = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, H, n)).astype(np.float32))
    return model, goals, x0, us_warm, B, H, iters


def _replay_structured_solve(k, backward, x0, us_init, goals, H, iters, A=6, reg=1e-6):
    """The solver as it ran before its line search kept the trajectories:
    K4's costs, then K5 replays each scenario's first improving alpha
    (alpha 0 where none improves), the same guards."""
    B, nx, n = x0.shape[0], k.nx, k.n
    u_lim = torch.tensor(k.P.u_lim)
    us_cur = torch.clamp(us_init, -u_lim, u_lim).permute(1, 2, 0).contiguous()
    x0_t, goal_t = x0.T.contiguous(), torch.from_numpy(goals).T.contiguous()
    alphas = torch.as_tensor(0.5 ** np.arange(A, dtype=np.float32))
    xs_post, us_cur, cost = k.replay_plain(x0_t, torch.zeros(H, nx, B), us_cur, torch.zeros(H, n, 1 + nx, B),
                                           goal_t, torch.zeros(B))
    reg_t = torch.full((B,), reg)
    for _ in range(iters):
        sd_x = torch.cat([x0_t[None], xs_post[:-1]])
        kK = backward(k.linearize_plain(sd_x, us_cur), sd_x, us_cur, xs_post[-1].contiguous(), goal_t, reg_t)
        costs_all = k.linesearch_costs_plain(x0_t, sd_x, us_cur, kK, goal_t, alphas)
        improving = torch.isfinite(costs_all) & (costs_all < cost[None])
        idx = torch.argmax(improving.to(torch.int32), dim=0)
        accepted = improving.any(dim=0)
        alpha_sel = torch.where(accepted, alphas[idx], torch.zeros(()))
        xs_new, us_new, cost_new = k.replay_plain(x0_t, sd_x, us_cur, kK, goal_t, alpha_sel)
        xs_post = torch.where(accepted, xs_new, xs_post)
        us_cur = torch.where(accepted, us_new, us_cur)
        cost = torch.where(accepted, cost_new, cost)
        reg_t = torch.where(accepted, torch.clamp(reg_t / 10.0, min=1e-9), torch.clamp(reg_t * 10.0, max=1e6))
    xs_full = torch.cat([x0_t.T[:, None], xs_post.permute(2, 0, 1)], dim=1)
    return us_cur.permute(2, 0, 1).contiguous(), xs_full.contiguous(), cost


def _gains(case, backward):
    """K3's stage as the case has it: as built; scenario 1 with a NaN gain
    (one entry of one step's K); or every gain 0, so that every alpha
    retraces the nominal and none improves its cost."""
    if case == "as_built":
        return backward

    def changed(*args):
        kK = backward(*args).clone()
        if case == "nan_gain":
            kK[1, 0, 3, 1] = float("nan")
        else:
            kK.zero_()
        return kK

    return changed


@pytest.mark.parametrize("case", ["as_built", "nan_gain", "no_alpha_improves"])
@pytest.mark.parametrize("robot", sorted(SELECT_ROBOTS))
def test_solve_selecting_from_linesearch_equals_replay_structured_loop(robot, case):
    """The solve (K4's trajectories, the chosen alpha's taken along the alpha
    axis) gives us, xs and cost bit for bit as the loop that replays the
    chosen alpha (K5), through the plain versions on the CPU."""
    model, goals, x0, us_warm, B, H, iters = _select_problem(robot)
    mpc = build_batch_tracking_mpc(model, goals, B, H, 0.01, iterations=iters)
    k = mpc.kernels
    k.backward = _gains(case, k.backward)  # the solve looks its stages up on the kernel set
    got = mpc.solve(x0, us_warm)
    ref = _replay_structured_solve(k, k.backward, x0, us_warm, goals, H, iters)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(_bits(g), _bits(r))
    start = build_batch_tracking_mpc(model, goals, B, H, 0.01, iterations=0).solve(x0, us_warm)
    if case == "no_alpha_improves":  # every scenario keeps its initial rollout
        assert all(torch.equal(_bits(g), _bits(s)) for g, s in zip(got, start))
    elif case == "nan_gain":  # scenario 1 rejects every step and keeps its rollout; the others move
        assert all(torch.equal(_bits(g[1]), _bits(s[1])) for g, s in zip(got, start))
        assert bool((got[2][[0, 2]] < start[2][[0, 2]]).all())
    else:
        assert bool((got[2] < start[2]).all())


@pytest.mark.parametrize("robot", sorted(SELECT_ROBOTS))
def test_linesearch_plain_costs_equal_linesearch_costs_plain(robot):
    """``linesearch_plain``'s costs are ``linesearch_costs_plain``'s bit for
    bit, its trajectories are the replay of each alpha, and the stage on the
    CPU writes them into the buffers it is given."""
    model, goals, x0, us_warm, B, H, _ = _select_problem(robot)
    k = BatchMPCKernels(model, 0.01, u_lim=[float(v) for v in model.torque_limit])
    n, nx = k.n, k.nx
    rng = np.random.default_rng(7)
    x0_t, goal_t = x0.T.contiguous(), torch.from_numpy(goals).T.contiguous()
    us = us_warm.permute(1, 2, 0).contiguous()
    sd_x = torch.cat([x0_t[None], k.replay_plain(x0_t, torch.zeros(H, nx, B), us, torch.zeros(H, n, 1 + nx, B),
                                                 goal_t, torch.zeros(B))[0][:-1]])
    kK = torch.from_numpy(rng.uniform(-0.1, 0.1, (H, n, 1 + nx, B)).astype(np.float32))
    alphas = torch.as_tensor(0.5 ** np.arange(6, dtype=np.float32))
    costs, xs_all, us_all = k.linesearch_plain(x0_t, sd_x, us, kK, goal_t, alphas)
    assert costs.shape == (6, B) and xs_all.shape == (H, nx, 6, B) and us_all.shape == (H, n, 6, B)
    assert torch.equal(_bits(costs), _bits(k.linesearch_costs_plain(x0_t, sd_x, us, kK, goal_t, alphas)))
    for a in (0, 3, 5):
        xs, us_a, cost = k.replay_plain(x0_t, sd_x, us, kK, goal_t, alphas[a].expand(B).contiguous())
        assert torch.equal(_bits(xs_all[:, :, a]), _bits(xs)) and torch.equal(_bits(us_all[:, :, a]), _bits(us_a))
        assert torch.equal(_bits(costs[a]), _bits(cost))
    bufs = torch.full_like(xs_all, float("nan")), torch.full_like(us_all, float("nan"))
    staged = k.linesearch(x0_t, sd_x, us, kK, goal_t, alphas, *bufs)
    assert staged[1] is bufs[0] and staged[2] is bufs[1]
    for g, r in zip(staged, (costs, xs_all, us_all)):
        assert torch.equal(_bits(g), _bits(r))
    with pytest.raises(ValueError):
        k.linesearch(x0_t, sd_x, us, kK, goal_t, alphas, xs_all[:, :, :5].contiguous(), us_all)


# K4's thread body with its stores (the unit's ``linesearch_thread``), on
# the host: every (scenario, alpha), bit for bit against the plain version,
# and the chosen alpha's trajectory against K5's one-thread replay in the
# same unit.

_LINESEARCH_ENTRIES = """
extern "C" void run_linesearch(const float** in, float** out, int B, int H, int A) {
  for (int a = 0; a < A; ++a) for (int b = 0; b < B; ++b)
    linesearch_thread(in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2], B, H, A, b, a);
}
extern "C" void run_replay_one(const float** in, float** out, int B, int H, int A) {
  for (int b = 0; b < B; ++b)
    replay_thread(in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2], B, H, b);
}
"""


@pytest.fixture(scope="module")
def fwd_units(tmp_path_factory):
    """Per robot on first use: its emitted K4/K5 unit under the host shim
    (the route gives the long arms the looped one, held in
    ``test_torch_fwd_loop.py``)."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    units = {}

    def get(robot):
        if robot not in units:
            model = _model(robot)
            k = BatchMPCKernels(model, 0.01, u_lim=[10.0] * model.num_joints, _fwd_form="emitted")
            lib = compile_team_unit(k.sources["fwd"] + _LINESEARCH_ENTRIES, tmp_path_factory.mktemp(f"{robot}_fwd"),
                                    "fwd", ())
            for entry in ("run_linesearch", "run_replay_one"):
                getattr(lib, entry).argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 3
            units[robot] = SimpleNamespace(k=k, lib=lib, model=model)
        return units[robot]

    return get


@pytest.mark.parametrize("B, H, A", [(3, 4, 6), (33, 2, 1), (5, 3, 7)])
@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_linesearch_body_keeps_every_alphas_trajectory_bitwise(fwd_units, robot, B, H, A):
    u = fwd_units(robot)
    ins = _replay_problem(u, B, H, seed=B + A)
    alphas = torch.as_tensor(np.linspace(1.0, 0.0, A, dtype=np.float32))
    nan = lambda *s: torch.full(s, float("nan"))
    outs = [nan(A, B), nan(H, u.k.nx, A, B), nan(H, u.k.n, A, B)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    u.lib.run_linesearch(ptrs(ins[:5] + [alphas]), ptrs(outs), B, H, A)
    ref = u.k.linesearch_plain(*ins[:5], alphas)
    for g, r in zip(outs, ref):
        assert bool(torch.isfinite(r).all())
        assert torch.equal(_bits(g), _bits(r))
    # Alpha a = b % A for scenario b: the one-thread K5 gives that column.
    pick = torch.arange(B) % A
    one, rins = [nan(H, u.k.nx, B), nan(H, u.k.n, B), nan(B)], ins[:5] + [alphas[pick].contiguous()]
    u.lib.run_replay_one(ptrs(rins), ptrs(one), B, H, 0)
    cols = torch.arange(B)
    assert torch.equal(_bits(outs[1][:, :, pick, cols]), _bits(one[0]))
    assert torch.equal(_bits(outs[2][:, :, pick, cols]), _bits(one[1]))
    assert torch.equal(_bits(outs[0][pick, cols]), _bits(one[2]))


def test_bwd_team_solves_more_gain_columns_than_lanes(tmp_path):
    """Past 15 joints a step has more gain columns (1 + 2n) than a warp has
    lanes: columns c and c + 32 share a lane. K3's phases on the host for a
    16-joint chain, bit for bit against the plain sweep (sqrt PyTorch's)."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    n, B, H = 16, 2, 2
    model = port_catalog.serial_chain(n, device="cpu")
    k = type("Bwd", (BatchMPCKernels,), {"UNITS": {"bwd": ("backward",)}})(model, 0.01, u_lim=[10.0] * n)
    lib = compile_team_unit(k.sources["bwd"] + """
extern "C" void run_bwd(const float** in, float** out, int B, int H) {
  mpt_bwd_team team;
  for (int b = 0; b < B; ++b) bwd_sweep(0, &team, in[0], in[1], in[2], in[3], in[4], in[5], out[0], B, H, b);
}
""", tmp_path, "bwd", ("run_bwd",))
    rng = np.random.default_rng(16)
    f32 = lambda *s: torch.from_numpy(rng.uniform(-0.2, 0.2, s).astype(np.float32))
    AB = f32(H, 2 * n, 3 * n, B) * 0.1
    for t in range(H):
        AB[t, :, : 2 * n] += torch.eye(2 * n)[..., None]
    args = [AB.contiguous(), f32(H, 2 * n, B), f32(H, n, B), f32(2 * n, B), f32(n, B), torch.tensor([1e-3, 1.0])]
    out = torch.full((H, n, 1 + 2 * n, B), float("nan"))
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    lib.run_bwd(ptrs(args), ptrs([out]), B, H)
    ref = k.backward_plain(*args)
    assert bool(torch.isfinite(ref).all())
    assert torch.equal(_bits(out), _bits(ref))


# The dynamic shared bytes a block of each kernel whose storage grows with n
# takes (K1's tiles, K3's warps, K5's team variant, K6's team), computed by
# the kernels' own macros and types: the template compiled on the host with
# its generated bodies stubbed, for every n a chain may have up to 16. K6's
# team needs its partition's slots: the Python partition of the n = 16 body
# (66k statements) takes ~5 s.
_LAYOUT_SHIM = """\
#include <math.h>
#include <stddef.h>
#define __device__
#define __forceinline__ inline
#define MPT_HOST_TEAM 1
extern "C" void mpt_host_yield(void) {}
#define fd_step(...) ((void)0)
#define riccati_terminal(...) ((void)0)
#define mpc_fwd_step(...) ((void)0)
#define mpc_terminal(...) ((void)0)
#define mpt_fwd_team(...) ((void)0)
#define mpt_lin_team(...) ((void)0)
"""
SMEM_DYNAMIC_MAX = 232448  # a block's shared memory on an H100 (dynamic, after the attribute is raised)


def _layout(tmp, name, head, template, entry):
    cpp, so = tmp / f"{name}.cpp", tmp / f"{name}.so"
    cpp.write_text(head + _LAYOUT_SHIM + template)
    subprocess.run(["g++", "-O0", "-w", "-shared", "-fPIC", "-o", str(so), str(cpp)], check=True, timeout=120)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.restype = ctypes.c_longlong
    return int(fn())


@pytest.mark.parametrize("n", range(1, 17))
def test_shared_bytes_fit_a_block_for_every_joint_count(n, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the templates")
    from manipulapy_tpu_torch.ops import cuda_rollout
    from manipulapy_tpu_torch.ops.cgen import TEAM_SOURCE
    from manipulapy_tpu_torch.ops.cuda_mpc_batch import TEMPLATE, UNITS

    batch = TEMPLATE.read_text()
    k1 = _layout(tmp_path, "k1", f"#define MPT_NJ {n}\n#define MPT_INT_RES 1\n#define MPT_CHUNK {cuda_rollout.CHUNK}\n"
                 f"#define MPT_BLOCK {cuda_rollout.BLOCK}\n", cuda_rollout.TEMPLATE.read_text(), "mpt_layout_rollout")
    k3 = _layout(tmp_path, "k3", f"#define MPT_NJ {n}\n#define MPT_UNIT_BWD 1\n"
                 f"static const float MPT_BWD_2WX[{2 * n}] = {{0}};\n#define MPT_BWD_2WU 0.0f\n", batch,
                 "mpt_layout_backward")
    model = port_catalog.serial_chain(n, device="cpu")
    team = type("Team", (BatchMPCKernels,), {"TEAM_WARPS": 8, "UNITS": {"fwd": UNITS["fwd"]}})(
        model, 0.01, u_lim=[10.0] * n)
    defines = "".join(f"{line}\n" for line in team.team.source.splitlines() if line.startswith("#define MPT_FWD_TEAM_"))
    k5 = _layout(tmp_path, "k5", f"#define MPT_NJ {n}\n#define MPT_BLOCK 128\n#define MPT_UNIT_FWD 1\n"
                 f"#define MPT_REPLAY_TEAM 1\n#define MPT_TEAM_S_MAX {team.TEAM_S}\n"
                 f"#define MPT_TEAM_PER_BLOCK {team.TEAM_PER_BLOCK}\n#define MPT_TS MPT_TEAM_S\n{defines}",
                 TEAM_SOURCE + batch, "mpt_layout_replay_team")
    from manipulapy_tpu_torch.ops import cuda_mpc_single

    lin_team = cuda_mpc_single.lin_team_step(model, 0.01, tfd.DEFAULT_G, cuda_mpc_single.LIN_WARPS or 4)
    defines = "".join(f"{line}\n" for line in lin_team.source.splitlines() if line.startswith("#define MPT_LIN_TEAM_"))
    k6 = _layout(tmp_path, "k6", f"#define MPT_NJ {n}\n#define MPT_UNIT_LIN 1\n#define MPT_LIN_TEAM 1\n{defines}",
                 TEAM_SOURCE + cuda_mpc_single.TEMPLATE.read_text(), "mpt_layout_linearize_team")
    for name, got in (("K1", k1), ("K3", k3), ("K5 team", k5), ("K6 team", k6)):
        assert 0 < got <= SMEM_DYNAMIC_MAX, (name, n, got)
    lane_floats = 2 * 2 * n + n + 3 * n + max(lin_team.slots, 1)  # x, u, s, the column, the slots
    lanes = k6 // (4 * lane_floats)
    assert k6 == 4 * lanes * lane_floats and lanes in (1, 2, 4, 8, 16, 32)
    assert lanes == 32 or 2 * k6 > SMEM_DYNAMIC_MAX  # halved only as far as it must
    assert k1 == 5 * cuda_rollout.BLOCK * ((3 * n) | 1) * 4
    assert (k3 > 48 * 1024) == (n >= 12)  # past the 48 KB a block may declare statically
