"""K8's looped form (the single solve's line-search forward on K0's loop
over links, one warp an alpha and its lanes over the joints, the robot, its
torque bounds and the cost weights in the launch's table:
``csrc/fwd_loop_lanes.cuh``) against the JAX package, and its C on the
host.

* The looped plain K8 (``SingleMPCKernels(..., _fwd_form="looped")`` on CPU
  tensors, ``cuda_mpc_single.loop_forward_plain``) against JAX's
  ``build_tracking_mpc(..., interpret=True)``'s ``forward`` on the two-link
  arm, on ``test_torch_mpc_single``'s inputs, at
  ``test_stage_plain_matches_jax_interpret``'s bar: each output within 2e-4
  of its own largest magnitude (f32).
* The looped plain K8 on the 26 fleet models and the programmatic UR5 and
  Panda, float64 and float32, against a closed loop of JAX's own step
  (``ops/fd_step.py::build_fd_step_planes(clip_limits=True,
  clip_velocity=False)``) over the alphas, on its planes as the JAX kernel
  keeps them on its lanes, with the controller, the running cost and the
  q-then-dq terminal cost of ``mpc/fused.py:322-370`` written out in
  ``jnp``, on
  ``test_torch_fwd_loop``'s draws at each robot's scale. Bars: float32 1e-4
  on q, 1e-3 on dq (of each row's largest magnitude where it passes 1, on
  the calibrated chains), u rtol 1e-4 atol 1e-3, cost rtol 1e-4; float64
  1e-9.
* A whole single solve with the looped K8 on the CPU against JAX's
  interpret-mode solve on the two-link arm and against the port's generic
  iLQR, at ``test_solve_matches_jax_interpret``'s and
  ``test_solve_matches_generic_ilqr``'s bars (cost rtol 1e-5, final state
  5e-4, controls 5e-3).
* The looped unit compiled by the host g++ behind the ``__device__`` shim
  with ``MPT_HOST_TEAM``: every thread of a block a coroutine that yields at
  each barrier, so each phase runs lane by lane (``TEAM_RUNNER``), sin, cos
  and sqrt PyTorch's own; bit for bit its plain version at n = 1, 7, 8 and
  10, A = 1, 6 and 33, one, two (as built) and four warps a block; a robot
  whose torque
  bounds are 0, its controls +0.0; a NaN alpha kept to its own warp.
* One unit per joint count; the team K8 on every robot unless
  ``_fwd_form="looped"`` names the looped one; ``_fwd_form`` through
  ``build_tracking_mpc``, its build arguments and an AOT round trip; the
  public CPU solve bitwise the emitted form's.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.fused import build_tracking_mpc as jax_build
from manipulapy_tpu.ops import fd_step as jfd
from manipulapy_tpu_torch.models import catalog, from_host_arrays, host_arrays, robot_data
from manipulapy_tpu_torch.mpc import ILQRParams, build_tracking_mpc, ilqr, make_step_fn, make_tracking_costs
from manipulapy_tpu_torch.ops import cuda_mpc_single as cms
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops._build import library_key
from manipulapy_tpu_torch.ops.cuda_mpc_single import SingleMPCKernels
from manipulapy_tpu_torch.utils import aot
from test_torch_fleet import DT, G
from test_torch_fwd_loop import DTYPES, ROBOTS, _bits, _scaled_problem
from test_torch_mpc_batch import _TORCH_FNS, compile_team_unit
from test_torch_mpc_single import GOAL, ITERS, STAGE_RTOL, U_LIM, H, _close_to_scale

CPU = torch.device("cpu")
PDT = 0.02  # test_torch_mpc_single's dt
ALPHAS = (1.0, 0.5, 0.25)


def _looped(model, u_lim=None):
    """K8 alone in the looped form (the other units are emitted but not
    built), the robot's own torque limits unless ``u_lim`` is given."""
    u_lim = host_arrays(model)["torque_limit"] if u_lim is None else u_lim
    cls = type("FwdOnly", (SingleMPCKernels,), {"UNITS": {"fwd": cms.UNITS["fwd"]}})
    return cls(model, DT, g=G, u_lim=u_lim, _fwd_form="looped")


# ---------------------------------------------------------------------------
# The two-link arm against JAX's fused kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planar():
    """``test_torch_mpc_single.planar``'s problem: the forward stage's inputs
    (from the port's emitted stages), JAX's forward and solve on them, and
    the port's solve with the looped K8."""
    jm = jax_catalog.two_link_planar(dtype=jnp.float32)
    tm = from_host_arrays(jax_host_arrays(jm), dtype=torch.float32, device=CPU)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, 4).astype(np.float32)
    us = rng.uniform(-5.0, 5.0, (H, 2)).astype(np.float32)
    jmpc = jax_build(jm, jnp.asarray(GOAL, jnp.float32), H, PDT, iterations=ITERS,
                     u_limit=jnp.asarray(U_LIM), interpret=True)
    emitted = build_tracking_mpc(tm, GOAL, H, PDT, iterations=ITERS, u_limit=U_LIM)
    looped = build_tracking_mpc(tm, GOAL, H, PDT, iterations=ITERS, u_limit=U_LIM, _fwd_form="looped")
    assert (emitted.kernels.fwd_form, looped.kernels.fwd_form) == ("emitted", "looped")
    x0_t, us_t, goal = torch.from_numpy(x0), torch.from_numpy(us), torch.tensor(GOAL)
    xs0 = emitted.forward(x0_t, torch.zeros(H, 4), us_t, torch.zeros(H, 2, 5), goal, torch.zeros(1))[0][0]
    sd_x = torch.cat([x0_t[None], xs0[:-1]])
    AB = emitted.linearize(sd_x, us_t)
    two_wT = torch.tensor([200.0, 200.0, 20.0, 20.0])
    Vterm = torch.cat([torch.diag(two_wT), (two_wT * (xs0[-1] - torch.cat([goal, torch.zeros(2)])))[None]])
    kK = emitted.backward(AB, sd_x, us_t, goal, Vterm, torch.tensor(1e-6))
    alphas = torch.tensor(0.5 ** np.arange(6), dtype=torch.float32)
    fwd_j = jmpc.forward(
        jnp.asarray(x0), jnp.asarray(sd_x.numpy()), jnp.asarray(us),
        jnp.asarray(kK[:, :, 0].numpy()), jnp.asarray(kK[:, :, 1:].numpy()), jnp.asarray(alphas.numpy()),
    )
    return {
        "x0": x0, "forward": (list(looped.forward(x0_t, sd_x, us_t, kK, goal, alphas)), [np.asarray(v) for v in fwd_j]),
        "jax_solve": [np.asarray(v) for v in jmpc.solve(jnp.asarray(x0), jnp.zeros((H, 2), jnp.float32))],
        "looped_solve": [v.numpy() for v in looped.solve(x0_t, torch.zeros(H, 2))],
    }


def test_looped_forward_plain_matches_jax_interpret(planar):
    got, ref = planar["forward"]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        _close_to_scale(g.numpy(), r)
    assert float(got[1][..., 0].abs().max()) == U_LIM[0]  # a torque limit engages


def test_looped_solve_matches_jax_interpret(planar):
    (tu, tx, tc), (ju, jx, jc) = planar["looped_solve"], planar["jax_solve"]
    assert tu.shape == (H, 2) and tx.shape == (H + 1, 4) and tc.shape == ()
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    np.testing.assert_allclose(tx[-1], jx[-1], atol=5e-4)
    np.testing.assert_allclose(tu, ju, atol=5e-3)
    np.testing.assert_array_equal(tx[0], planar["x0"])


def test_looped_solve_matches_generic_ilqr():
    """``test_solve_matches_generic_ilqr``'s problem (the two-link arm, goal
    (0.6, -0.4), H=30, 6 iterations) with the looped K8."""
    tm = catalog.two_link_planar(device=CPU)
    q_goal = torch.tensor([0.6, -0.4])
    Hg, iters = 30, 6
    running, terminal = make_tracking_costs(tm, q_goal)
    res = ilqr(make_step_fn(tm, PDT), running, terminal, torch.zeros(4), torch.zeros(Hg, 2),
               ILQRParams(horizon=Hg, dt=PDT, iterations=iters))
    mpc = build_tracking_mpc(tm, q_goal, Hg, PDT, iterations=iters, _fwd_form="looped")
    assert mpc.kernels.fwd_form == "looped"
    us, xs, cost = mpc.solve(torch.zeros(4), torch.zeros(Hg, 2))
    np.testing.assert_allclose(float(cost), float(res.cost), rtol=1e-5)
    np.testing.assert_allclose(xs[-1].numpy(), res.xs[-1].numpy(), atol=5e-4)
    np.testing.assert_allclose(us.numpy(), res.us.numpy(), atol=5e-3)


# ---------------------------------------------------------------------------
# The fleet against a closed loop of JAX's own step, vmapped over alphas
# ---------------------------------------------------------------------------


def _jax_single_loop(jm64, ins, alphas, u_lim, weights, jdt):
    """``fused.py:322-370``'s closed loop of one problem under every alpha,
    the alphas on the step's planes as the JAX kernel puts them on its
    lanes (a ``jax.vmap`` over them computes the same, at ~0.45 ms an
    eager operation of the emitted step, ~9 s a robot here), with JAX's
    emitted step: (xs (A, H, nx), us (A, H, n), cost (A,))."""
    n, step = jfd.build_fd_step_planes(jm64, DT, g=G, clip_limits=True, clip_velocity=False)
    x0, sd_x, sd_u, kK, goal = (jnp.asarray(a, dtype=jdt) for a in ins)
    alpha = jnp.asarray(alphas, dtype=jdt)
    nx, Hs = 2 * n, sd_x.shape[0]
    w_q, w_dq, w_u, w_terminal = weights
    wT = [w_terminal] * n + [0.1 * w_terminal] * n
    x_goal = [goal[j] for j in range(n)] + [0.0] * n
    plane = lambda v: jnp.broadcast_to(v, alpha.shape)
    x = [plane(x0[i]) for i in range(nx)]
    acc = jnp.zeros(alpha.shape, jdt)
    xs, us = [], []
    for t in range(Hs):
        dx = [x[i] - sd_x[t, i] for i in range(nx)]
        u = []
        for j in range(n):
            uj = sd_u[t, j] + alpha * kK[t, j, 0]
            for i in range(nx):
                uj = uj + kK[t, j, 1 + i] * dx[i]
            u.append(jnp.clip(uj, -float(u_lim[j]), float(u_lim[j])))
        c = jnp.zeros_like(acc)
        for i in range(n):
            e = x[i] - goal[i]
            c = c + w_q * e * e
            c = c + w_dq * x[n + i] * x[n + i]
        for j in range(n):
            c = c + w_u * u[j] * u[j]
        acc = acc + c
        q2, dq2, _ = step(x[:n], x[n:], u)
        x = [plane(v) for v in list(q2) + list(dq2)]
        xs.append(jnp.stack(x, axis=-1))
        us.append(jnp.stack(u, axis=-1))
    cT = jnp.zeros_like(acc)
    for i in range(nx):
        e = x[i] - x_goal[i]
        cT = cT + wT[i] * e * e
    return np.asarray(jnp.stack(xs, axis=1)), np.asarray(jnp.stack(us, axis=1)), np.asarray(acc + cT)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("robot", list(ROBOTS))
def test_looped_forward_matches_jax_step(robot, dtype):
    make, calibrated = ROBOTS[robot]
    jdt, tdt = DTYPES[dtype]
    jm64 = make(jnp.float64)
    host = jax_host_arrays(jm64)
    tm = from_host_arrays(host, dtype=tdt, device=CPU)
    n, Hs = tm.num_joints, 4
    ins = [a[..., 0] for a in _scaled_problem(host, 1, Hs, seed=n, dtype=dtype)[:5]]
    weights = (10.0, 0.5, 1e-4, 100.0)
    K = _looped(tm)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    xs, us, cost = (v.numpy() for v in K.forward(*(t(a) for a in ins), torch.tensor(ALPHAS, dtype=tdt)))
    rxs, rus, rcost = _jax_single_loop(jm64, ins, ALPHAS, host["torque_limit"], weights, jdt)
    assert xs.shape == rxs.shape == (len(ALPHAS), Hs, 2 * n) and cost.shape == rcost.shape == (len(ALPHAS),)
    assert np.isfinite(rxs).all() and np.isfinite(rcost).all()
    if dtype == "float64":
        np.testing.assert_allclose(xs, rxs, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(us, rus, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(cost, rcost, rtol=1e-9)
        return
    np.testing.assert_allclose(xs[..., :n], rxs[..., :n], rtol=0, atol=1e-4, err_msg="q")
    scale = np.maximum(1.0, np.abs(rxs[..., n:]).max(axis=(0, 1), keepdims=True)) if calibrated else 1.0
    assert float((np.abs(xs[..., n:] - rxs[..., n:]) / scale).max()) <= 1e-3, "dq"
    np.testing.assert_allclose(us, rus, rtol=1e-4, atol=1e-3, err_msg="u")
    np.testing.assert_allclose(cost, rcost, rtol=1e-4, err_msg="cost")


# ---------------------------------------------------------------------------
# The looped unit on the host
# ---------------------------------------------------------------------------

# Every block of the launch in turn, its storage NaN-filled first, every
# thread a coroutine (TEAM_RUNNER); the table first, then the inputs x0,
# sd_x, sd_u, kK, goal, alphas and the outputs xs, us, costs.
HARNESS = """
struct mpt_fwdl_args { const float* tab; const float** in; float** out; int H, A, a0; float* sm; };
static void mpt_fwdl_thread(int tid, void* p) {
  const mpt_fwdl_args* a = (const mpt_fwdl_args*)p;
  fwd_loop_block(tid, a->sm, a->in[0], a->in[1], a->in[2], a->in[3], a->in[4], a->in[5],
                 a->out[0], a->out[1], a->out[2], a->H, a->A, a->a0, a->tab);
}
extern "C" int run_forward(const float* tab, const float** in, float** out, int H, int A) {
  float* sm = (float*)malloc(MPT_L_BYTES);
  int bad = 0;
  for (int a0 = 0; a0 < A; a0 += MPT_FWDL_WARPS) {
    for (int i = 0; i < MPT_L_FLOATS; ++i) sm[i] = NAN;
    mpt_fwdl_args a = {tab, in, out, H, A, a0, sm};
    bad |= mpt_run_team(MPT_FWDL_THREADS, mpt_fwdl_thread, &a);
  }
  free(sm);
  return bad;
}
"""
HOST_ROBOTS = {  # n = 1, 7, 8, 10
    "robotiq_2f_85": lambda: robot_data.load_robot("robotiq_2f_85", chain_joints_only=True, device=CPU),
    "panda (programmatic)": lambda: catalog.panda(device=CPU),
    "jaco_7dof": lambda: robot_data.load_robot("jaco_7dof", chain_joints_only=True, device=CPU),
    "jaco_7dof (10 joints)": lambda: robot_data.load_robot("jaco_7dof", device=CPU),
}
HOST_WARPS = [1, 2, 4]  # 2: the unit as built (FWD_LOOP_WARPS)


@pytest.fixture(scope="module")
def loop_units(tmp_path_factory):
    """Per (joint count, warps a block), on first use: the looped K8 unit
    compiled by g++ -O0 with the host harness."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the kernel's C")
    libs, tmp = {}, tmp_path_factory.mktemp("fwd_loop_lanes")

    def get(n, warps):
        if (n, warps) not in libs:
            lib = compile_team_unit(cms.single_fwd_loop_unit_source(n, warps) + HARNESS, tmp, f"fwdl{n}w{warps}", ())
            lib.run_forward.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 2
            libs[n, warps] = lib
        return libs[n, warps]

    return get


def _host_problem(model, A, Hs, seed):
    """``test_torch_fwd_loop._scaled_problem``'s draws for one problem
    (torques and gains at each joint's inertia, so the light fingers of the
    10-joint Jaco stay finite) and alphas 0.5^a, float32: [x0 (nx,), sd_x
    (H, nx), sd_u (H, n), kK (H, n, 1+nx), goal (n,), alphas (A,)]."""
    ins = [a[..., 0] for a in _scaled_problem(host_arrays(model), 1, Hs, seed=seed, dtype=np.float32)[:5]]
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return [f32(a) for a in ins] + [f32(0.5 ** np.arange(A))]


def _run_host(lib, K, ins):
    """The unit's xs, us and costs on the host, NaN-filled first."""
    slots = (ctypes.c_void_p * 3).in_dll(lib, "mpt_host_fn")
    for i, fn in enumerate(_TORCH_FNS):
        slots[i] = ctypes.cast(fn, ctypes.c_void_p).value
    Hs, nx = ins[1].shape
    A = ins[5].shape[0]
    outs = [torch.full((A, Hs, nx), float("nan")), torch.full((A, Hs, nx // 2), float("nan")),
            torch.full((A,), float("nan"))]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    assert lib.run_forward(K.fwd_table.data_ptr(), ptrs(ins), ptrs(outs), Hs, A) == 0  # equal barrier counts
    return outs


def _assert_bits(got, ref):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(ref)[~nan])


@pytest.mark.parametrize("warps", HOST_WARPS)
@pytest.mark.parametrize("A", [1, 6, 33])
@pytest.mark.parametrize("robot", list(HOST_ROBOTS))
def test_loop_unit_on_the_host_matches_its_plain_version(loop_units, robot, A, warps):
    """A = 1 and 6 leave most warps of a block of four idle; A = 33 runs
    past a block."""
    model = HOST_ROBOTS[robot]()
    n = model.num_joints
    K = _looped(model)
    ins = _host_problem(model, A, 5, seed=A + n)
    got = _run_host(loop_units(n, warps), K, ins)
    for g, r in zip(got, K.loop_forward_plain(*ins)):
        assert bool(torch.isfinite(r).all())
        assert torch.equal(_bits(g), _bits(r))


def test_zero_torque_bounds_give_plus_zero_controls(loop_units):
    """The ABB arm's URDF gives every joint effort="0": the looped unit's
    controls are +0.0 whatever the gains, and its rollout is the
    zero-control one bit for bit."""
    model = robot_data.load_robot("abb_irb2400", chain_joints_only=True, device=CPU)
    n = model.num_joints
    K = _looped(model)
    assert float(K.fwd_table[tfd.HEAD_FLOATS + tfd.LINK_AT["u_lim"]]) == 0.0
    ins = _host_problem(model, 4, 3, seed=2)
    ins[2] = torch.full_like(ins[2], 5.0)  # nominal torques far past the bounds
    xs, us, costs = _run_host(loop_units(n, 1), K, ins)
    assert torch.equal(_bits(us), torch.zeros_like(_bits(us)))
    zero = K.loop_forward_plain(ins[0], ins[1], torch.zeros_like(ins[2]), torch.zeros_like(ins[3]), ins[4], ins[5])
    assert torch.equal(_bits(xs), _bits(zero[0])) and torch.equal(_bits(costs), _bits(zero[2]))


@pytest.mark.parametrize("warps", HOST_WARPS)
def test_loop_unit_keeps_a_nan_alpha_to_its_warp(loop_units, warps):
    """Alpha 2 is NaN: its closed loop goes NaN where the plain version's
    does, and every other alpha, in its block or not, keeps the clean run's
    bits."""
    model = HOST_ROBOTS["panda (programmatic)"]()
    K = _looped(model)
    ins = _host_problem(model, 6, 5, seed=5)
    clean = _run_host(loop_units(7, warps), K, ins)
    ins[5][2] = float("nan")
    got = _run_host(loop_units(7, warps), K, ins)
    for g, r, c in zip(got, K.loop_forward_plain(*ins), clean):
        _assert_bits(g, r)
        assert bool(torch.isnan(g[2]).any())
        assert torch.equal(_bits(g[[0, 1, 3, 4, 5]]), _bits(c[[0, 1, 3, 4, 5]]))


# ---------------------------------------------------------------------------
# The units, the route, the solver's arguments and the public CPU solve
# ---------------------------------------------------------------------------


def test_one_looped_unit_per_joint_count():
    """Robots of one n share the looped K8 unit whatever their torque limits
    and weights; the other units stay each robot's own."""
    gen3, iiwa7 = (robot_data.load_robot(k, chain_joints_only=True, device=CPU) for k in ("gen3", "iiwa7"))
    a, b = _looped(gen3), _looped(iiwa7, u_lim=[3.0] * 7)
    assert a.sources["fwd"] == b.sources["fwd"] == cms.single_fwd_loop_unit_source(7)
    assert library_key(a.sources["fwd"], "mpc_single_fwd") == library_key(b.sources["fwd"], "mpc_single_fwd")
    assert not torch.equal(a.fwd_table, b.fwd_table)
    assert len({cms.single_fwd_loop_unit_source(n) for n in (1, 6, 7, 8, 10)}) == 5
    src = a.sources["fwd"]
    assert f"#define MPT_FWDL_WARPS {cms.FWD_LOOP_WARPS}" in src and "mpc_fwd_step(" not in src
    assert a.team is None and a.ARGTYPES["forward"][-2:] == [ctypes.c_void_p, ctypes.c_void_p]
    assert a.fwd_loop_ops == tfd.loop_fwd_ops(7)
    emitted = type("FwdOnly", (SingleMPCKernels,), {"UNITS": {"fwd": cms.UNITS["fwd"]}})
    e = emitted(gen3, DT, g=G, u_lim=[1.0] * 7, _fwd_form="emitted")
    assert e.fwd_table is None and e.team is not None and a.statements["forward"] == e.statements["forward"]
    with pytest.raises(ValueError):
        SingleMPCKernels(gen3, DT, u_lim=[1.0] * 7, _fwd_form="straight")
    with pytest.raises(ValueError):  # the team is the emitted form's
        a.team_attributes()


@pytest.mark.parametrize("below, above", [
    (("catalog", "ur5"), ("chain", "ur10")),         # 6 joints
    (("catalog", "panda"), ("chain", "gen3")),       # 7
])
def test_fwd_form_names_the_looped_form_whatever_the_step(below, above):
    """K8's form does not follow the emitted step's size: a short and a
    long step of one joint count both build the team unless ``_fwd_form``
    names the looped form, and then both share the looped unit."""
    load = lambda src, key: (getattr(catalog, key)(device=CPU) if src == "catalog"
                             else robot_data.load_robot(key, chain_joints_only=True, device=CPU))
    lo, hi = load(*below), load(*above)
    n = lo.num_joints
    fwd = type("FwdOnly", (SingleMPCKernels,), {"UNITS": {"fwd": cms.UNITS["fwd"]}})
    a, b = fwd(lo, DT, u_lim=[1.0] * n), fwd(hi, DT, u_lim=[1.0] * n)
    assert n == hi.num_joints and a.statements["forward"] < b.statements["forward"]
    assert (a.fwd_form, b.fwd_form) == ("emitted", "emitted") and a.fwd_table is None is b.fwd_table
    la, lb = (fwd(m, DT, u_lim=[1.0] * n, _fwd_form="looped") for m in (lo, hi))
    assert (la.fwd_form, lb.fwd_form) == ("looped", "looped") and la.sources["fwd"] == lb.sources["fwd"]
    assert la.statements["forward"] == a.statements["forward"] and lb.statements["forward"] == b.statements["forward"]


@pytest.mark.parametrize("robot", [
    "robotiq_2f_85", "robotiq_2f_140", "two_link (programmatic)", "ur5 (programmatic)", "panda (programmatic)", "gen3",
    "panda", "jaco_7dof", "jaco_7dof_full",
])
def test_public_k8_is_the_team_on_every_robot(robot):
    """The solver's K8 is the team's emitted step on every robot: the
    looped form measured slower on every arm of the fleet on an H100 and
    within the spread between turns on the grippers (PERF.md), so no
    robot is routed to it."""
    if robot.endswith("(programmatic)"):
        model = getattr(catalog, robot.split()[0] if robot != "two_link (programmatic)" else "two_link_planar")(
            device=CPU)
    else:
        model = robot_data.load_robot(robot.replace("_full", ""), chain_joints_only=not robot.endswith("_full"),
                                      device=CPU)
    K = type("FwdOnly", (SingleMPCKernels,), {"UNITS": {"fwd": cms.UNITS["fwd"]}})(
        model, DT, u_lim=[1.0] * model.num_joints)
    assert K.fwd_form == "emitted" and K.fwd_table is None and K.team is not None


def test_fwd_form_reaches_the_kernels_build_args_and_aot(tmp_path):
    """``_fwd_form`` names K8's form through ``build_tracking_mpc``: the
    kernel set, its unit keys, the build arguments and a saved solver that
    reloads in that form and solves bitwise (the CPU: no libraries)."""
    tm = catalog.two_link_planar(device=CPU)
    mpc = build_tracking_mpc(tm, GOAL, 6, PDT, iterations=2, _fwd_form="looped")
    assert mpc.kernels.fwd_form == "looped" and mpc.build_args["_fwd_form"] == "looped"
    assert mpc.kernels.sources["fwd"] == cms.single_fwd_loop_unit_source(2)
    assert "_fwd_form" not in build_tracking_mpc(tm, GOAL, 6, PDT, iterations=2).build_args
    solve = aot.load_tracking_mpc(aot.save_tracking_mpc(mpc, str(tmp_path / "looped.aot")))
    assert solve is not None and solve.handle.kernels.fwd_form == "looped"
    assert solve.handle.kernels.unit_keys() == mpc.kernels.unit_keys()
    x0, us = torch.tensor([0.1, -0.2, 0.0, 0.0]), torch.zeros(6, 2)
    for g, r in zip(solve(x0, us), mpc.solve(x0, us)):
        assert torch.equal(_bits(g), _bits(r))


def test_public_cpu_solve_keeps_the_emitted_plain_forward():
    """On the CPU the public solver runs the emitted plain K8, bit for bit
    an emitted-form solve, and its kernels' plain version (``plain()``, the
    card's reference) is the emitted form's; a solve built with
    ``_fwd_form="looped"`` runs the looped plain version."""
    model = catalog.ur5(device=CPU)
    n, Hs = 6, 4
    rng = np.random.default_rng(7)
    goal = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    x0 = torch.from_numpy(np.concatenate([rng.uniform(-0.3, 0.3, n), np.zeros(n)]).astype(np.float32))
    warm = torch.from_numpy(rng.uniform(-1.0, 1.0, (Hs, n)).astype(np.float32))
    mpc = build_tracking_mpc(model, goal, Hs, DT, iterations=2)
    K = mpc.kernels
    assert K.fwd_form == "emitted" and "_fwd_form" not in mpc.build_args
    assert K.plain().forward == K.forward_plain
    got = mpc.solve(x0, warm)
    ref = build_tracking_mpc(model, goal, Hs, DT, iterations=2, _fwd_form="emitted").solve(x0, warm)
    assert all(torch.equal(_bits(g), _bits(r)) for g, r in zip(got, ref))
    looped = build_tracking_mpc(model, goal, Hs, DT, iterations=2, _fwd_form="looped")
    assert looped.kernels.plain().forward == looped.kernels.loop_forward_plain
    lgot = looped.solve(x0, warm)
    assert all(bool(torch.isfinite(v).all()) for v in lgot)
    np.testing.assert_allclose(lgot[2].numpy(), ref[2].numpy(), rtol=1e-4)


def test_looped_plain_takes_float64():
    """The looped plain K8 runs in the inputs' dtype, the table unrounded in
    float64; float16 is refused."""
    model = catalog.panda(device=CPU)
    K = _looped(model)
    ins = _host_problem(model, 3, 4, seed=1)
    f32 = K.loop_forward_plain(*ins)
    f64 = K.loop_forward_plain(*(a.double() for a in ins))
    assert all(v.dtype == torch.float64 for v in f64)
    for a, b in zip(f32, f64):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-3)
    with pytest.raises(TypeError):
        K.loop_forward_plain(*(a.half() for a in ins))
    with pytest.raises(ValueError):
        SingleMPCKernels(model, DT, u_lim=[1.0] * 7, _fwd_form="emitted").loop_forward_plain(*ins)
