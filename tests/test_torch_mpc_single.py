"""The port's single-problem fused tracking MPC (K6-K8) against the JAX
package's.

* The three stages (plain versions) against JAX ``build_tracking_mpc(...,
  interpret=True)`` on the same inputs, two-link arm, H=12, with a torque
  limit that engages: each output within 2e-4 of its own largest magnitude
  (f32; XLA fuses and reorders the sums of the interpret-mode kernels).
  The test packs the port's inputs into the JAX kernels' lane tiles.
* K6's plain version against K2's (``BatchMPCKernels.linearize_plain``) at
  B=1: bitwise, since K6 computes the function K2 computes.
* The whole solve against JAX's, and against the port's generic ``ilqr`` on
  the JAX test's problem (``tests/test_mpc.py::TestFusedTrackingMPC``), with
  its bars: cost rtol 1e-5, final state atol 5e-4, controls atol 5e-3.
* The emitted kernel bodies (``csrc/mpc_single.cuh`` with the generated
  device functions), compiled with the host g++ behind a ``__device__``
  shim, against the plain versions; K7's block phases run thread by thread
  (``MPT_HOST_TEAM``) bitwise against the emitted one-thread
  ``riccati_step_gj`` sweep on the two-link arm, UR5 and Panda, and a NaN
  step kept to the steps before it.
* The solver's behaviour: the run-time goal, torque limits, the NaN guard,
  a receding-horizon loop, and the JAX package's limits (H <= 128, n <= 8).

The JAX solver runs the two-link arm only (interpret mode); Panda is left to
the port-only checks.
"""

import ctypes
import shutil
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.fused import build_tracking_mpc as jax_build
from manipulapy_tpu_torch.models import catalog, from_host_arrays
from manipulapy_tpu_torch.mpc import ILQRParams, build_tracking_mpc, ilqr, make_step_fn, make_tracking_costs
from manipulapy_tpu_torch.ops import cgen as cg
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops.cuda_mpc_batch import BatchMPCKernels
from manipulapy_tpu_torch.ops.cuda_mpc_single import STAGES, SingleMPCKernels
from test_torch_mpc_batch import TEAM_RUNNER, _braced, _model, check_team_partition, compile_team_unit

CPU = torch.device("cpu")
STAGE_RTOL = 2e-4  # of each output's largest magnitude
H, DT, ITERS = 12, 0.02, 3
GOAL = [0.6, -0.4]
U_LIM = [4.0, 3.0]


def _close_to_scale(got, ref, rtol=STAGE_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def two_link():
    """The two-link arm in both packages, from one set of host arrays."""
    jm = jax_catalog.two_link_planar(dtype=jnp.float32)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float32, device=CPU)


@pytest.fixture(scope="module")
def planar(two_link):
    """Both solvers on the two-link arm with U_LIM, the JAX one in interpret
    mode; their solves from one x0, and each stage's outputs on the same
    inputs (the port's intermediates feed both)."""
    jm, tm = two_link
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, 4).astype(np.float32)
    us = rng.uniform(-5.0, 5.0, (H, 2)).astype(np.float32)
    jmpc = jax_build(jm, jnp.asarray(GOAL, jnp.float32), H, DT, iterations=ITERS,
                     u_limit=jnp.asarray(U_LIM), interpret=True)
    tmpc = build_tracking_mpc(tm, GOAL, H, DT, iterations=ITERS, u_limit=U_LIM)
    out = dict(x0=x0, tmpc=tmpc)
    out["jax_solve"] = [np.asarray(v) for v in jmpc.solve(jnp.asarray(x0), jnp.zeros((H, 2), jnp.float32))]
    out["port_solve"] = [v.numpy() for v in tmpc.solve(torch.from_numpy(x0), torch.zeros(H, 2))]

    x0_t, us_t = torch.from_numpy(x0), torch.from_numpy(us)
    goal = torch.tensor(GOAL)
    xs0 = tmpc.forward(x0_t, torch.zeros(H, 4), us_t, torch.zeros(H, 2, 5), goal, torch.zeros(1))[0][0]
    sd_x = torch.cat([x0_t[None], xs0[:-1]])
    AB = tmpc.linearize(sd_x, us_t)
    two_wT = torch.tensor([200.0, 200.0, 20.0, 20.0])
    Vterm = torch.cat([torch.diag(two_wT), (two_wT * (xs0[-1] - torch.cat([goal, torch.zeros(2)])))[None]])
    reg = torch.tensor(1e-6)
    kK = tmpc.backward(AB, sd_x, us_t, goal, Vterm, reg)
    alphas = torch.tensor(0.5 ** np.arange(6), dtype=torch.float32)
    fwd = tmpc.forward(x0_t, sd_x, us_t, kK, goal, alphas)

    # The JAX kernels' tiles: AB lanes-major (nx, 32, 128) with B at column
    # 8, sd (H, 8, 128), Vterm (8, 128), kK (H, 8, 128).
    AB_l = np.zeros((4, 32, 128), np.float32)
    AB_l[:, :4, :H] = AB[:, :, :4].permute(1, 2, 0).numpy()
    AB_l[:, 8:10, :H] = AB[:, :, 4:].permute(1, 2, 0).numpy()
    sd = np.zeros((H, 8, 128), np.float32)
    sd[:, 0, :4], sd[:, 1, :2] = sd_x.numpy(), us
    V_l = np.zeros((8, 128), np.float32)
    V_l[:5, :4] = Vterm.numpy()
    goal_row = jnp.asarray([GOAL + [0.0, 0.0]], jnp.float32)
    kK_l = np.asarray(jmpc.backward(jnp.asarray(AB_l), jnp.asarray(sd), jnp.asarray(V_l), jnp.float32(1e-6), goal_row))
    A_j, B_j = jmpc.linearize(jnp.asarray(sd_x.numpy()), jnp.asarray(us))
    fwd_j = jmpc.forward(
        jnp.asarray(x0), jnp.asarray(sd_x.numpy()), jnp.asarray(us),
        jnp.asarray(kK[:, :, 0].numpy()), jnp.asarray(kK[:, :, 1:].numpy()), jnp.asarray(alphas.numpy()),
    )
    out["stages"] = {
        "linearize": ([AB[:, :, :4], AB[:, :, 4:]], [A_j, B_j]),
        "backward": ([kK[:, :, 1:], kK[:, :, 0]], [kK_l[:, :2, :4], kK_l[:, 2, :2]]),
        "forward": (list(fwd), list(fwd_j)),
    }
    out["forward_us"] = fwd[1]
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_stage_plain_matches_jax_interpret(planar, stage):
    got, ref = planar["stages"][stage]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close_to_scale(g.numpy(), np.asarray(r))


def test_forward_torque_limit_engages(planar):
    """The forward stage's inputs drive some controls onto the limits."""
    us = planar["forward_us"]
    lim = torch.tensor(U_LIM)
    assert bool((us.abs() <= lim).all())
    assert bool((us.abs() == lim).any())


def test_solve_matches_jax_interpret(planar):
    (tu, tx, tc), (ju, jx, jc) = planar["port_solve"], planar["jax_solve"]
    assert tu.shape == (H, 2) and tx.shape == (H + 1, 4) and tc.shape == ()
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    np.testing.assert_allclose(tx[-1], jx[-1], atol=5e-4)
    np.testing.assert_allclose(tu, ju, atol=5e-3)
    np.testing.assert_array_equal(tx[0], planar["x0"])


@pytest.fixture(scope="module")
def arms(two_link):
    return {"two_link": two_link[1], "ur5": catalog.ur5(device=CPU), "panda": catalog.panda(device=CPU)}


@pytest.mark.parametrize("robot", ["two_link", "ur5", "panda"])
def test_linearize_plain_equals_k2_at_one_scenario(arms, robot):
    """K6 computes K2's function: bitwise the same at B=1."""
    tm = arms[robot]
    n = tm.num_joints
    rng = np.random.default_rng(5)
    lo, hi = tm.joint_lower.double().numpy(), tm.joint_upper.double().numpy()
    q = np.clip(rng.uniform(-1.0, 1.0, (7, n)), lo + 0.05, hi - 0.05)
    x = torch.from_numpy(np.concatenate([q, rng.uniform(-0.5, 0.5, (7, n))], 1).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-5.0, 5.0, (7, n)).astype(np.float32))
    single = SingleMPCKernels(tm, 0.01, u_lim=[10.0] * n).linearize(x, u)
    batch = BatchMPCKernels(tm, 0.01, u_lim=[10.0] * n).linearize(x[..., None], u[..., None])
    assert single.shape == (7, 2 * n, 3 * n)
    assert torch.equal(single, batch[..., 0])


def test_solve_matches_generic_ilqr(two_link):
    """The JAX test's problem (two-link arm, goal (0.6, -0.4), H=30, 6
    iterations, default limits) against the port's generic iLQR."""
    tm = two_link[1]
    q_goal = torch.tensor([0.6, -0.4])
    Hg, iters = 30, 6
    running, terminal = make_tracking_costs(tm, q_goal)
    res = ilqr(make_step_fn(tm, DT), running, terminal, torch.zeros(4), torch.zeros(Hg, 2),
               ILQRParams(horizon=Hg, dt=DT, iterations=iters))
    us, xs, cost = build_tracking_mpc(tm, q_goal, Hg, DT, iterations=iters).solve(torch.zeros(4), torch.zeros(Hg, 2))
    np.testing.assert_allclose(float(cost), float(res.cost), rtol=1e-5)
    np.testing.assert_allclose(xs[-1].numpy(), res.xs[-1].numpy(), atol=5e-4)
    np.testing.assert_allclose(us.numpy(), res.us.numpy(), atol=5e-3)


def test_goal_argument_matches_baked(two_link):
    tm = two_link[1]
    g1, g2 = [0.5, -0.2], [-0.3, 0.6]
    x0, us0 = torch.zeros(4), torch.zeros(H, 2)
    a = build_tracking_mpc(tm, g1, H, DT, iterations=3).solve(x0, us0, torch.tensor(g2))
    b = build_tracking_mpc(tm, g2, H, DT, iterations=3).solve(x0, us0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_torque_limits_hold(two_link):
    tm = two_link[1]
    mpc = build_tracking_mpc(tm, [1.5, 0.5], 20, DT, iterations=4, u_limit=[3.0, 2.0])
    assert mpc.kernels.P.u_lim == [3.0, 2.0]
    us, xs, cost = mpc.solve(torch.zeros(4), torch.zeros(20, 2))
    assert float(us[:, 0].abs().max()) <= 3.0 and float(us[:, 1].abs().max()) <= 2.0
    assert bool(torch.isfinite(xs).all()) and bool(torch.isfinite(cost))
    # A warm start past the limits is clamped before the first rollout.
    us0, _, _ = build_tracking_mpc(tm, [1.5, 0.5], 20, DT, iterations=0, u_limit=[3.0, 2.0]).solve(
        torch.zeros(4), torch.full((20, 2), -50.0)
    )
    assert torch.equal(us0, torch.tensor([-3.0, -2.0]).expand(20, 2))


def test_rejected_steps_keep_the_initial_rollout(two_link):
    """A negative Levenberg term makes Quu indefinite, so the gains are NaN
    and every step is rejected: the guard returns the initial rollout."""
    tm = two_link[1]
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.uniform(-0.3, 0.3, 4).astype(np.float32))
    us_warm = torch.from_numpy(rng.uniform(-1, 1, (6, 2)).astype(np.float32))
    bad = build_tracking_mpc(tm, [0.4, 0.1], 6, DT, iterations=2, reg=-1e3)
    us, xs, cost = bad.solve(x0, us_warm)
    xs0, us0, cost0 = bad.forward(x0, torch.zeros(6, 4), us_warm, torch.zeros(6, 2, 5), torch.tensor([0.4, 0.1]), torch.zeros(1))
    assert torch.equal(us, us0[0]) and torch.equal(cost, cost0[0]) and torch.equal(xs[1:], xs0[0])
    assert bool(torch.isfinite(xs).all())


def test_receding_horizon_approaches_the_goal(two_link):
    """x <- xs[1] and the warm start shifted by one, as the JAX benchmark's
    receding loop does; the state ends nearer the goal."""
    tm = two_link[1]
    goal = torch.tensor([0.6, -0.3])
    mpc = build_tracking_mpc(tm, goal, 10, DT, iterations=3)
    x, us_warm = torch.zeros(4), torch.zeros(10, 2)
    for _ in range(6):
        us, xs, _ = mpc.solve(x, us_warm)
        x, us_warm = xs[1], torch.cat([us[1:], us[-1:]])
    assert float((x[:2] - goal).abs().max()) < float(goal.abs().max())


@pytest.mark.parametrize("limit", ["horizon", "joints"])
def test_jax_limits_raise(two_link, limit):
    """H > 128 (the TPU's lanes) and n > 8 (the packed AB tile) raise, as
    they do in the JAX package."""
    if limit == "horizon":
        with pytest.raises(ValueError, match="128 lanes"):
            build_tracking_mpc(two_link[1], GOAL, 129, DT)
        assert build_tracking_mpc(two_link[1], GOAL, 128, DT).horizon == 128
    else:
        with pytest.raises(ValueError, match="packed layout"):
            build_tracking_mpc(catalog.serial_chain(9, device=CPU), np.zeros(9), 4, DT)
        assert build_tracking_mpc(catalog.serial_chain(8, device=CPU), np.zeros(8), 4, DT).n == 8


def test_solver_checks_its_inputs(two_link):
    tm = two_link[1]
    mpc = build_tracking_mpc(tm, GOAL, 4, DT, iterations=1)
    for x0, us0, goal in (
        (torch.zeros(5), torch.zeros(4, 2), None),
        (torch.zeros(4), torch.zeros(5, 2), None),
        (torch.zeros(4), torch.zeros(4, 2), torch.zeros(3)),
    ):
        with pytest.raises(ValueError):
            mpc.solve(x0, us0, goal)
    with pytest.raises(ValueError):
        build_tracking_mpc(tm, [0.1, 0.2, 0.3], 4, DT)
    with pytest.raises(ValueError):
        build_tracking_mpc(tm, GOAL, 4, DT, u_limit=[1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        build_tracking_mpc(tm, GOAL, 4, DT, line_search_steps=0)


def _stage_inputs(Hs, A):
    """Zero inputs of every stage for the two-link arm (n=2, nx=4, m=6)."""
    z = torch.zeros
    return {
        "linearize": (z(Hs, 4), z(Hs, 2)),
        "backward": (z(Hs, 4, 6), z(Hs, 4), z(Hs, 2), z(2), z(5, 4), z(())),
        "forward": (z(4), z(Hs, 4), z(Hs, 2), z(Hs, 2, 5), z(2), z(A)),
    }


@pytest.mark.parametrize("stage, Hs, A", [(s, 0, 2) for s in STAGES] + [("forward", 3, 0)])
def test_stages_reject_empty_work(two_link, stage, Hs, A):
    """No stage takes an empty horizon or alpha set, so a launch count only
    moves when a kernel runs."""
    k = SingleMPCKernels(two_link[1], DT, u_lim=[5.0, 5.0])
    with pytest.raises(ValueError):
        getattr(k, stage)(*_stage_inputs(Hs, A)[stage])


def test_stages_reject_wrong_shapes_and_devices(two_link):
    k = SingleMPCKernels(two_link[1], DT, u_lim=[5.0, 5.0])
    with pytest.raises(ValueError):
        k.linearize(torch.zeros(3, 4), torch.zeros(3, 3))
    with pytest.raises(ValueError):
        k.backward(*_stage_inputs(3, 2)["backward"][:5], torch.zeros(1))
    meta = [torch.empty(s, device="meta") for s in ((3, 4), (3, 2))]
    with pytest.raises(ValueError):  # neither the CPU nor one CUDA device
        k.linearize(*meta)


def test_plain_stages_are_the_cpu_stages(two_link):
    k = SingleMPCKernels(two_link[1], DT, u_lim=[5.0, 5.0])
    plain = k.plain()
    rng = np.random.default_rng(4)
    for stage, args in _stage_inputs(3, 2).items():
        args = [torch.from_numpy(rng.uniform(0.1, 0.5, a.shape).astype(np.float32)) for a in args]
        assert getattr(plain, stage) == getattr(k, f"{stage}_plain")
        got, ref = getattr(k, stage)(*args), getattr(plain, stage)(*args)
        for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(g, r)


def test_statements_count_the_shared_primal(arms):
    """K6's bound counts the primal step once per step: ``statements
    ["step"]`` is the emitted step without its tangent, as for K2."""
    tm = arms["panda"]
    k = SingleMPCKernels(tm, 0.01, u_lim=[10.0] * 7)
    _, _, primal = tfd.build_fd_step_source(tm, 0.01, clip_limits=True, clip_velocity=False)
    assert k.statements["step"] == primal
    assert k.statements["linearize"] == BatchMPCKernels(tm, 0.01, u_lim=[10.0] * 7).statements["linearize"]
    assert primal < k.statements["linearize"] < 4 * primal
    assert k.statements["backward"] > k.statements["forward"] > 0


# ---------------------------------------------------------------------------
# The emitted kernel bodies on the host
# ---------------------------------------------------------------------------

# K8 on the host: each block's team (32 alphas) in turn, its storage
# NaN-filled first, every thread a coroutine (TEAM_RUNNER); inputs x0, sd_x,
# sd_u, kK, goal, alphas; outputs xs, us, costs. ``run_ref`` is the emitted
# one-thread step, alpha by alpha, as the kernel before the team ran it.
FWD_TEAMS = """
#if defined(MPT_UNIT_FWD)
struct mpt_fwd_args {{ const float** in; float** out; int H, A, a0; float* tm; }};
static void mpt_fwd_thread(int tid, void* p) {{
  const mpt_fwd_args* a = (const mpt_fwd_args*)p;
  fwd_team(tid, a->tm, a->in[0], a->in[1], a->in[2], a->in[3], a->in[4], a->in[5],
           a->out[0], a->out[1], a->out[2], a->H, a->A, a->a0);
}}
extern "C" int run_forward(const float** in, float** out, int H, int A) {{
  float* tm = (float*)malloc(MPT_T_BYTES);
  int bad = 0;
  for (int a0 = 0; a0 < A; a0 += MPT_WARP) {{
    for (int i = 0; i < MPT_T_FLOATS; ++i) tm[i] = NAN;
    mpt_fwd_args a = {{in, out, H, A, a0, tm}};
    bad |= mpt_run_team(MPT_TEAM_THREADS, mpt_fwd_thread, &a);
  }}
  free(tm);
  return bad;
}}
extern "C" int run_ref(const float** in, float** out, int H, int A) {{
  for (int a = 0; a < A; ++a) {{
    float x[MPT_NX], g[MPT_NJ], sdx[MPT_NX], sdu[MPT_NJ], kk[MPT_NJ * MPT_KK], u[MPT_NJ], c[1], xn[MPT_NX];
    for (int i = 0; i < MPT_NX; ++i) x[i] = in[0][i];
    for (int j = 0; j < MPT_NJ; ++j) g[j] = in[4][j];
    float acc = 0.0f;
    for (int t = 0; t < H; ++t) {{
      for (int i = 0; i < MPT_NX; ++i) sdx[i] = in[1][t * MPT_NX + i];
      for (int j = 0; j < MPT_NJ; ++j) sdu[j] = in[2][t * MPT_NJ + j];
      for (int e = 0; e < MPT_NJ * MPT_KK; ++e) kk[e] = in[3][(size_t)t * MPT_NJ * MPT_KK + e];
      mpc_fwd_step(x, sdx, sdu, kk, g, in[5][a], u, c, xn);
      acc = acc + c[0];
      for (int i = 0; i < MPT_NX; ++i) out[0][((size_t)a * H + t) * MPT_NX + i] = x[i] = xn[i];
      for (int j = 0; j < MPT_NJ; ++j) out[1][((size_t)a * H + t) * MPT_NJ + j] = u[j];
    }}
    mpc_terminal_fused(x, g, c);
    out[2][a] = acc + c[0];
  }}
  return 0;
}}
#endif
"""

# K6's team on the host: every team of S lanes in turn, its storage
# NaN-filled first, every thread a coroutine; inputs xs, us; output AB.
LIN_TEAMS = """
#if defined(MPT_UNIT_LIN) && defined(MPT_LIN_TEAM)
struct mpt_lin_args {{ const float** in; float** out; int HM, idx0; float* tm; }};
static void mpt_lin_thread(int tid, void* p) {{
  const mpt_lin_args* a = (const mpt_lin_args*)p;
  lin_team(tid, a->tm, a->in[0], a->in[1], a->out[0], a->HM, a->idx0);
}}
extern "C" int run_lin_team(const float** in, float** out, int H, int A) {{
  float* tm = (float*)malloc(MPT_L_BYTES);
  int bad = 0;
  for (int idx0 = 0; idx0 < H * MPT_M; idx0 += MPT_LIN_S) {{
    for (int i = 0; i < MPT_L_FLOATS; ++i) tm[i] = NAN;
    mpt_lin_args a = {{in, out, H * MPT_M, idx0, tm}};
    bad |= mpt_run_team(MPT_LIN_THREADS, mpt_lin_thread, &a);
  }}
  free(tm);
  return bad;
}}
#endif
"""

_HARNESS = _braced(TEAM_RUNNER) + """\
#define __device__
#define __forceinline__ inline
#define MPT_HOST_TEAM 1
{src}
""" + FWD_TEAMS + LIN_TEAMS + """
extern "C" void run(const float** in, float** out, int H, int A) {{
#if defined(MPT_UNIT_LIN) && defined(MPT_LIN_TEAM)
  if (run_lin_team(in, out, H, A)) abort();
#elif defined(MPT_UNIT_LIN)
  for (int idx = 0; idx < H * MPT_M; ++idx) lin_thread(in[0], in[1], out[0], idx);
#elif defined(MPT_UNIT_BWD)
  // K7: the block's storage, a host array; under MPT_HOST_TEAM each phase of
  // the sweep runs threads 0..T-1 in turn before the next phase begins.
  static mps_bwd_state state;
  bwd_sweep(0, &state, in[0], in[1], in[2], in[3], in[4], in[5], out[0], H);
#else
  if (run_forward(in, out, H, A)) abort();
#endif
}}
"""


def test_emitted_kernel_bodies_match_plain_versions(two_link, tmp_path):
    """K6-K8's thread bodies, run on the host, against the plain versions
    on the same inputs (a torque limit that engages), within 1e-5 of each
    output's scale: the host's libm ``sinf``/``cosf`` against PyTorch's."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    tm = two_link[1]
    k = build_tracking_mpc(tm, GOAL, H, DT, u_limit=[4.0, 3.0]).kernels
    libs = {}
    for unit, src in k.sources.items():
        cpp, so = tmp_path / f"{unit}.cpp", tmp_path / f"{unit}.so"
        cpp.write_text(_HARNESS.format(src=src))
        subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", str(so), str(cpp)], check=True, timeout=300)
        libs[unit] = ctypes.CDLL(str(so))
        libs[unit].run.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 2

    def call(unit, ins, outs, A=0):
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
        libs[unit].run(ptrs(ins), ptrs(outs), H, A)
        return outs

    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.uniform(-0.3, 0.3, 4).astype(np.float32))
    us = torch.from_numpy(rng.uniform(-5, 5, (H, 2)).astype(np.float32))
    goal = torch.tensor(GOAL)
    xs0 = k.forward(x0, torch.zeros(H, 4), us, torch.zeros(H, 2, 5), goal, torch.zeros(1))[0][0]
    sd_x = torch.cat([x0[None], xs0[:-1]])
    Vterm = torch.from_numpy(rng.uniform(-1, 1, (5, 4)).astype(np.float32))
    Vterm[:4] = torch.diag(torch.tensor([200.0, 200.0, 20.0, 20.0]))
    reg = torch.tensor(1e-3)
    alphas = torch.tensor(0.5 ** np.arange(6), dtype=torch.float32)
    AB = k.linearize(sd_x, us)
    kK = k.backward(AB, sd_x, us, goal, Vterm, reg)
    refs = {"lin": [AB], "bwd": [kK], "fwd": list(k.forward(x0, sd_x, us, kK, goal, alphas))}
    got = {
        "lin": call("lin", [sd_x, us], [torch.empty_like(AB)]),
        "bwd": call("bwd", [AB, sd_x, us, goal, Vterm, reg], [torch.empty_like(kK)]),
        "fwd": call("fwd", [x0, sd_x, us, kK, goal, alphas],
                    [torch.empty(6, H, 4), torch.empty(6, H, 2), torch.empty(6)], A=6),
    }
    for unit in refs:
        for g, r in zip(got[unit], refs[unit]):
            _close_to_scale(g.numpy(), r.numpy(), 1e-5)
    us_fwd = got["fwd"][1]
    assert float(us_fwd[..., 0].abs().max()) <= 4.0 and float(us_fwd[..., 1].abs().max()) <= 3.0


# K7's phases, thread by thread, against the emitted one-thread sweep. Both
# are compiled by g++ with the same flags and both divide with the IEEE
# division (K7 takes no square root), so they must agree bit for bit.

_BWD_REFERENCE = """
{step}
extern "C" void run_ref(const float** in, float** out, int H, int A) {{
  const float *AB = in[0], *xs = in[1], *us = in[2], *goal = in[3], *Vterm = in[4], *reg = in[5];
  float g[MPT_NJ], V[MPT_VN], V_next[MPT_VN], ab[MPT_AB], x[MPT_NX], u[MPT_NJ], kk[MPT_KKN];
  for (int j = 0; j < MPT_NJ; ++j) g[j] = goal[j];
  for (int e = 0; e < MPT_VN; ++e) V[e] = Vterm[e];
  for (int t = H - 1; t >= 0; --t) {{
    for (int e = 0; e < MPT_AB; ++e) ab[e] = AB[(size_t)t * MPT_AB + e];
    for (int i = 0; i < MPT_NX; ++i) x[i] = xs[t * MPT_NX + i];
    for (int j = 0; j < MPT_NJ; ++j) u[j] = us[t * MPT_NJ + j];
    riccati_step_gj(ab, x, u, g, V, reg[0], kk, V_next);
    for (int e = 0; e < MPT_KKN; ++e) out[0][(size_t)t * MPT_KKN + e] = kk[e];
    for (int e = 0; e < MPT_VN; ++e) V[e] = V_next[e];
  }}
}}
"""
TEAM_ROBOTS = ("two_link_planar", "ur5", "panda", "robotiq_2f_85")  # n = 1, 2 leave most threads idle
TEAM_H = 8
TEAM_HS = [1, 8]
TEAM_REGS = [1e-6, 1e-3, 10.0]
NAN_STEP = 4


@pytest.fixture(scope="module")
def team_units(tmp_path_factory):
    """Per robot, on first use: K7's unit with the emitted one-thread sweep
    beside it, compiled by g++ at -O0 (the emitted Panda step is 30k
    statements), and a nominal of TEAM_H steps under random torques from
    rest inside the joint limits (the plain K8 with zero gains), its
    Jacobians (the plain K6) and the terminal value function at the state
    after the last step."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    units = {}

    def get(robot):
        if robot not in units:
            model = _model(robot)
            n = model.num_joints
            k = SingleMPCKernels(model, 0.01, u_lim=[10.0] * n)
            tmp = tmp_path_factory.mktemp(robot)
            cpp, so = tmp / "bwd.cpp", tmp / "bwd.so"
            cpp.write_text(_HARNESS.format(src=k.sources["bwd"]) + _BWD_REFERENCE.format(step=k.riccati_step_source))
            subprocess.run(["g++", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                           check=True, timeout=300)
            lib = ctypes.CDLL(str(so))
            for fn in (lib.run, lib.run_ref):
                fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 2
            rng = np.random.default_rng(7)
            lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
            lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
            q0 = (lo + hi) / 2 + rng.uniform(-0.5, 0.5, n) * (hi - lo) / 2
            x0 = torch.from_numpy(np.concatenate([q0, np.zeros(n)]).astype(np.float32))
            us = torch.from_numpy(rng.uniform(-3.0, 3.0, (TEAM_H, n)).astype(np.float32))
            goal = torch.from_numpy(rng.uniform(-1.0, 1.0, n).astype(np.float32))
            xs = k.forward(x0, torch.zeros(TEAM_H, 2 * n), us, torch.zeros(TEAM_H, n, 1 + 2 * n), goal,
                           torch.zeros(1))[0][0]
            sd_x = torch.cat([x0[None], xs[:-1]])
            units[robot] = SimpleNamespace(k=k, lib=lib, AB=k.linearize(sd_x, us), sd_x=sd_x, us=us, xs=xs, goal=goal)
        return units[robot]

    return get


def _team_inputs(u, H, reg):
    """The first H steps of a unit's nominal, with Vterm the terminal value
    function (diag(2 wT), then 2 wT (x - goal)) at the state after step H."""
    n = u.k.n
    two_wT = torch.tensor([2.0 * w for w in u.k.P.wT])
    Vx = two_wT * (u.xs[H - 1] - torch.cat([u.goal, torch.zeros(n)]))
    Vterm = torch.cat([torch.diag(two_wT), Vx[None]])
    c = lambda x: x.contiguous()
    return [c(u.AB[:H]), c(u.sd_x[:H]), c(u.us[:H]), c(u.goal), c(Vterm), torch.tensor(reg)]


def _team_and_reference(u, ins, H):
    n = u.k.n
    outs = [torch.full((H, n, 1 + 2 * n), 7.0) for _ in range(2)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    u.lib.run(ptrs(ins), ptrs(outs[:1]), H, 0)
    u.lib.run_ref(ptrs(ins), ptrs(outs[1:]), H, 0)
    return outs


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("reg", TEAM_REGS)
@pytest.mark.parametrize("H", TEAM_HS)
@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_bwd_team_phases_match_emitted_step_bitwise(team_units, robot, H, reg):
    u = team_units(robot)
    team, ref = _team_and_reference(u, _team_inputs(u, H, reg), H)
    assert bool(torch.isfinite(ref).all())
    assert torch.equal(_bits(team), _bits(ref))


@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_bwd_team_nan_step_leaves_later_steps_alone(team_units, robot):
    """Every entry of AB at step NAN_STEP of TEAM_H NaN: the gains of that
    step and of every earlier one (the sweep runs backwards) go NaN, those of
    the later steps stay bit for bit those of the clean run; the clean run
    also holds the plain version to 1e-5 of scale."""
    u = team_units(robot)
    H = TEAM_H
    clean = _team_inputs(u, H, 1e-3)
    dirty = [x.clone() for x in clean]
    dirty[0][NAN_STEP] = float("nan")
    team_clean, _ = _team_and_reference(u, clean, H)
    team, ref = _team_and_reference(u, dirty, H)
    assert torch.equal(_bits(team), _bits(ref))
    assert bool(torch.isnan(team[: NAN_STEP + 1]).all())
    assert torch.equal(_bits(team[NAN_STEP + 1:]), _bits(team_clean[NAN_STEP + 1:]))
    _close_to_scale(team_clean.numpy(), u.k.backward_plain(*clean).numpy(), 1e-5)


# K8, one team of W warps per 32 alphas, each closed-loop step the emitted
# step partitioned over the warps (``cg.team_function``): the partition's
# invariants, then the team's threads on the host as coroutines, bit for bit
# against the emitted one-thread step and ``forward_plain`` (sin, cos and
# sqrt PyTorch's own).
FWD_WARPS = [1, 4, 8]


@pytest.mark.parametrize("warps", FWD_WARPS)
@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_forward_team_partition_invariants(robot, warps):
    model = _model(robot)
    k = type("Team", (SingleMPCKernels,), {"FWD_WARPS": warps})(model, 0.01, u_lim=[10.0] * model.num_joints)
    check_team_partition(k.team, k.statements["forward"])
    assert k.chains["forward"] == k.team.chain


@pytest.fixture(scope="module")
def forward_units(tmp_path_factory):
    """Per (robot, W) on first use: the K8 unit with its team of W warps on
    the host, and the one-thread reference beside it."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    units = {}

    def get(robot, warps):
        if (robot, warps) not in units:
            model = _model(robot)
            k = type("Team", (SingleMPCKernels,), {"FWD_WARPS": warps})(model, 0.01, u_lim=[10.0] * model.num_joints)
            lib = compile_team_unit(k.sources["fwd"] + FWD_TEAMS.format(), tmp_path_factory.mktemp(f"{robot}_W{warps}"),
                                    "fwd", ("run_forward", "run_ref"))
            units[(robot, warps)] = SimpleNamespace(k=k, lib=lib, model=model)
        return units[(robot, warps)]

    return get


def _forward_problem(u, A, H, seed=0):
    """x0 inside the joint limits, an open-loop nominal of H steps under
    torques within 30% of 10, gains of 0.1 scale, alphas 0.5^a."""
    model, k = u.model, u.k
    n = model.num_joints
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).contiguous()
    lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
    lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
    x0 = f32(np.concatenate([(lo + hi) / 2 + rng.uniform(-0.4, 0.4, n) * (hi - lo) / 2, rng.uniform(-0.2, 0.2, n)]))
    us = f32(rng.uniform(-3.0, 3.0, (H, n)))
    goal = f32(rng.uniform(-1.0, 1.0, n))
    xs = k.forward_plain(x0, torch.zeros(H, 2 * n), us, torch.zeros(H, n, 1 + 2 * n), goal, torch.zeros(1))[0][0]
    sd_x = torch.cat([x0[None], xs[:-1]]).contiguous()
    kK = f32(rng.uniform(-0.1, 0.1, (H, n, 1 + 2 * n)))
    return [x0, sd_x, us, kK, goal, f32(0.5 ** np.arange(A))]


def _forward_host(u, ins):
    """(the team's outputs, the one-thread reference's), NaN-filled first."""
    H, nx = ins[1].shape
    A = ins[5].shape[0]
    runs = []
    for entry in ("run_forward", "run_ref"):
        outs = [torch.full((A, H, nx), float("nan")), torch.full((A, H, nx // 2), float("nan")),
                torch.full((A,), float("nan"))]
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
        assert getattr(u.lib, entry)(ptrs(ins), ptrs(outs), H, A) == 0  # the team's threads met equally often
        runs.append(outs)
    return runs


@pytest.mark.parametrize("A", [1, 6, 33])
@pytest.mark.parametrize("warps", FWD_WARPS)
@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_forward_team_matches_emitted_step_bitwise(forward_units, robot, warps, A):
    """A = 1 and 6 leave most lanes idle; A = 33 runs two blocks."""
    u = forward_units(robot, warps)
    ins = _forward_problem(u, A, 5, seed=A)
    team, one = _forward_host(u, ins)
    for got, ref, pl in zip(team, one, u.k.forward_plain(*ins)):
        assert bool(torch.isfinite(pl).all())
        assert torch.equal(_bits(got), _bits(ref)) and torch.equal(_bits(got), _bits(pl))


@pytest.mark.parametrize("robot", TEAM_ROBOTS)
def test_forward_team_keeps_a_nan_alpha_to_itself(forward_units, robot):
    """Alpha 2 is NaN: its closed loop goes NaN where the plain version's
    does, and every other alpha keeps the clean run's bits."""
    u = forward_units(robot, 8)
    ins = _forward_problem(u, 6, 5, seed=5)
    clean, _ = _forward_host(u, ins)
    ins[5][2] = float("nan")
    team, one = _forward_host(u, ins)
    for got, ref, pl, cl in zip(team, one, u.k.forward_plain(*ins), clean):
        nan = torch.isnan(pl)
        assert torch.equal(torch.isnan(got), nan) and torch.equal(torch.isnan(ref), nan)
        assert torch.equal(_bits(got)[~nan], _bits(pl)[~nan])
        assert bool(torch.isnan(got[2]).any())
        assert torch.equal(_bits(got[[0, 1, 3, 4, 5]]), _bits(cl[[0, 1, 3, 4, 5]]))


# K6 as a team of W warps per 32 (step, seed) lanes (``lin_team_step``): the
# lean one-seed body partitioned over the warps, the seed an input column.
# The partition's invariants, then every team on the host, its threads as
# coroutines, bit for bit against the emitted one-thread body of the
# default unit (``fd_step_jvp_group`` at one seed, in the same unit) and
# against ``linearize_plain`` (sin, cos and sqrt PyTorch's own).
LIN_TEAM_WARPS = [2, 4, 8]
LIN_TEAM_ROBOTS = ("ur5", "panda", "robotiq_2f_85")  # m = 18, 21, 3 lanes a step
_LIN_REFERENCE = """
{group}
extern "C" int run_ref(const float** in, float** out, int H, int A) {{
  for (int idx = 0; idx < H * MPT_M; ++idx) {{
    const int t = idx / MPT_M, k = idx % MPT_M;
    float x[MPT_NX], u[MPT_NJ], x_next[MPT_NX], col[MPT_NX];
    for (int i = 0; i < MPT_NX; ++i) x[i] = in[0][t * MPT_NX + i];
    for (int j = 0; j < MPT_NJ; ++j) u[j] = in[1][t * MPT_NJ + j];
    fd_step_jvp_group(x, u, k, x_next, col);
    for (int i = 0; i < MPT_NX; ++i) out[0][((size_t)t * MPT_NX + i) * MPT_M + k] = col[i];
  }}
  return 0;
}}
"""


def _lin_team_kernels(model, warps):
    return type("LinTeam", (SingleMPCKernels,), {"LIN_WARPS": warps})(model, 0.01, u_lim=[10.0] * model.num_joints)


@pytest.mark.parametrize("warps", LIN_TEAM_WARPS)
@pytest.mark.parametrize("robot", LIN_TEAM_ROBOTS)
def test_lin_team_partition_invariants(robot, warps):
    """Every statement of the one-seed body in one warp's program, the seed
    an input: the same statements and chain as the default unit's body."""
    k = _lin_team_kernels(_model(robot), warps)
    check_team_partition(k.lin_team, k.statements["linearize_group"], prefix="mpt_lin_team")
    assert k.chains["linearize"] == k.lin_team.chain
    assert k.lin_team.partition.critical < k.statements["linearize_group"]
    assert "#define MPT_LIN_TEAM 1\n" in k.sources["lin"] and "void fd_step_jvp_group(" not in k.sources["lin"]


@pytest.fixture(scope="module")
def lin_team_units(tmp_path_factory):
    """Per (robot, W) on first use: K6's team unit on the host, with the
    default unit's one-thread body beside it."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the emitted C")
    units = {}

    def get(robot, warps):
        if (robot, warps) not in units:
            model = catalog.serial_chain(8, device="cpu") if robot == "serial_chain_8" else _model(robot)
            k = _lin_team_kernels(model, warps)
            group = k.linearize_group_source.replace(cg.KEEP_SOURCE, "")  # mpt_keep: the team unit has it
            lib = compile_team_unit(k.sources["lin"] + LIN_TEAMS.format() + _LIN_REFERENCE.format(group=group),
                                    tmp_path_factory.mktemp(f"lin_{robot}_W{warps}"), "lin", ("run_lin_team", "run_ref"))
            layout = lib.mpt_layout_linearize_team
            layout.restype = ctypes.c_longlong
            units[(robot, warps)] = SimpleNamespace(k=k, lib=lib, model=model, smem=int(layout()))
        return units[(robot, warps)]

    return get


def _lin_team_problem(model, H, seed):
    """xs (H, 2n) inside the joint limits, us (H, n) within 30% of 10."""
    n = model.num_joints
    rng = np.random.default_rng(seed)
    lo, hi = model.joint_lower.double().numpy(), model.joint_upper.double().numpy()
    lo, hi = np.maximum(lo, -np.pi), np.minimum(hi, np.pi)
    q = (lo + hi) / 2 + rng.uniform(-0.8, 0.8, (H, n)) * (hi - lo) / 2
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).contiguous()
    return f32(np.concatenate([q, rng.uniform(-0.5, 0.5, (H, n))], 1)), f32(rng.uniform(-3.0, 3.0, (H, n)))


def _lin_team_host(u, xs, us):
    """(the team's AB, the one-thread body's), NaN-filled first."""
    H = xs.shape[0]
    runs = []
    for entry in ("run_lin_team", "run_ref"):
        AB = torch.full((H, u.k.nx, u.k.m), float("nan"))
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
        assert getattr(u.lib, entry)(ptrs([xs, us]), ptrs([AB]), H, 0) == 0  # the team's threads met equally often
        runs.append(AB)
    return runs


@pytest.mark.parametrize("robot, warps, H", [
    *[(r, w, H) for r in LIN_TEAM_ROBOTS for w in LIN_TEAM_WARPS for H in (1, 3)],
    ("serial_chain_8", 4, 1), ("serial_chain_8", 4, 3),
])
def test_lin_team_matches_one_thread_body_bitwise(lin_team_units, robot, warps, H):
    """H*m lanes end mid-team at every H here (m = 18, 21, 24); a chain of
    8 joints has more slots than 32 lanes fit a block, so its team takes 16
    lanes, each repeated by a second lane."""
    u = lin_team_units(robot, warps)
    xs, us = _lin_team_problem(u.model, H, seed=H + warps)
    team, one = _lin_team_host(u, xs, us)
    ref = u.k.linearize_plain(xs, us)
    assert bool(torch.isfinite(ref).all())
    assert torch.equal(_bits(team), _bits(one)) and torch.equal(_bits(team), _bits(ref))
    lanes = 16 if robot == "serial_chain_8" else 32
    lane_bytes = (2 * u.k.nx + u.k.n + u.k.m + u.k.lin_team.slots) * 4  # x, u, s, the column, the slots
    assert u.smem == lanes * lane_bytes <= 232448
    assert lanes == 32 or 2 * lanes * lane_bytes > 232448  # the most lanes that fit a block


@pytest.mark.parametrize("robot", LIN_TEAM_ROBOTS)
def test_lin_team_keeps_a_nan_step_to_itself(lin_team_units, robot):
    """Step 1 of 3 has a NaN velocity of joint 0: its Jacobian goes NaN
    where the plain version's does (in the lanes of both of its teams), and
    steps 0 and 2 keep the clean run's bits."""
    u = lin_team_units(robot, 4)
    xs, us = _lin_team_problem(u.model, 3, seed=9)
    clean, _ = _lin_team_host(u, xs, us)
    xs[1, u.k.n if u.k.n > 1 else 0] = float("nan")  # a one-joint arm's Jacobian never reads its velocity
    team, one = _lin_team_host(u, xs, us)
    ref = u.k.linearize_plain(xs, us)
    for got in (team, one):
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(_bits(got)[~nan], _bits(ref)[~nan])
    assert bool(torch.isnan(team[1]).any())
    assert torch.equal(_bits(team[[0, 2]]), _bits(clean[[0, 2]]))
