"""K4's and K5's looped form (the closed-loop step on K0's loop over links,
the robot, its torque bounds and the cost weights in the launch's table:
``csrc/mpc_batch.cuh`` with ``MPT_FWD_LOOP``) against the JAX package, and
its C on the host.

* The looped plain versions of ``linesearch_costs``, ``linesearch`` and
  ``replay`` (``BatchMPCKernels(..., _fwd_form="looped")`` on CPU tensors,
  ``cuda_mpc_batch.loop_fwd_rollout_plain``) against JAX's
  ``build_batch_tracking_mpc(..., interpret=True)`` on the two-link arm, at
  ``test_stage_plain_matches_jax_interpret``'s bar: each output within
  2e-4 of its own largest magnitude (f32).
* The looped closed-loop rollout on the 26 fleet models and the
  programmatic UR5 and Panda, float64 and float32, against a closed loop of
  JAX's own step (``ops/fd_step.py::build_fd_step_planes(clip_limits=True,
  clip_velocity=False)``) with the controller and costs of
  ``mpc/fused_batch.py:398-422`` written out in ``jnp``. JAX's step runs
  over (B,) planes, its batch axis, eagerly: jitting it compiles each
  robot's straight-line program for tens of seconds on a CPU. The nominal
  torques hold the arm against gravity and add ~1 rad/s^2 a joint, and the
  gains are of that scale too (each joint's diagonal inertia), so the loop
  stays among the states a solve visits: under raw torques of a few N m
  the light wrists and fingers reach 1e3-1e8 rad/s in four steps, where
  f32 roundoff, JAX's as well as the port's, grows past any bar (float64
  holds there too). Bars: float32 1e-4 on q, 1e-3 on dq (of each row's
  largest magnitude where it passes 1), cost rtol 1e-4; float64 1e-9 on q,
  dq and u, cost rtol 1e-9.
* A whole batched solve with K2, K4 and K5 all looped against JAX's generic
  iLQR scenario by scenario, at ``test_looped_solve_matches_jax_generic_ilqr_per_scenario``'s
  bars (cost rtol 1e-5, final state 5e-4, controls 5e-3).
* The looped fwd unit compiled by the host g++ behind the ``__device__``
  shim, bit for bit its plain version with PyTorch's sinf, cosf and sqrtf
  (within 1e-5 of scale with the host's libm): K4 (every alpha's cost and
  trajectory) and K5 on arms of n = 1, 6, 7 and 8; a robot whose torque
  bounds are 0, its controls +0.0 and its cost the zero-control cost; a NaN
  scenario kept to itself.
* One unit per joint count; the table's layout (u_lim +inf in K1's and
  K2's tables, the cost weights after it); the route on each side of its
  threshold; the public CPU solve bitwise the emitted form's.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.fused_batch import build_batch_tracking_mpc as jax_build_batch
from manipulapy_tpu.mpc.costs import make_tracking_costs as jax_tracking_costs
from manipulapy_tpu.mpc.ilqr import ILQRParams as JaxILQRParams
from manipulapy_tpu.mpc.ilqr import ilqr as jax_ilqr
from manipulapy_tpu.mpc.ilqr import make_step_fn as jax_step_fn
from manipulapy_tpu.ops import fd_step as jfd
from manipulapy_tpu_torch.dynamics import gravity_forces, mass_matrix
from manipulapy_tpu_torch.models import catalog, from_host_arrays, host_arrays, robot_data
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc
from manipulapy_tpu_torch.ops import cuda_mpc_batch as cmb
from manipulapy_tpu_torch.ops import cuda_rollout
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops._build import library_key
from manipulapy_tpu_torch.ops.cuda_mpc_batch import BatchMPCKernels
from test_torch_fleet import DT, FLEET, G, IDS, _jax_model
from test_torch_mpc_batch import PB, PDT, PH, PITERS, _close_to_scale, _from_jax, _port_model, _to_jax

CPU = torch.device("cpu")
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}
# The fleet's models and the programmatic arms: (JAX model maker (dtype), calibrated).
ROBOTS = {
    **{i: (lambda dt, k=k, c=c: _jax_model(k, c, dt), True) for (k, c), i in zip(FLEET, IDS)},
    "ur5 (programmatic)": (lambda dt: jax_catalog.ur5(dtype=dt), False),
    "panda (programmatic)": (lambda dt: jax_catalog.panda(dtype=dt), False),
}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _looped(model, u_lim=None, **kw):
    """K4 and K5 alone in the looped form (the other units are not emitted),
    the robot's own torque limits unless ``u_lim`` is given."""
    u_lim = host_arrays(model)["torque_limit"] if u_lim is None else u_lim
    cls = type("FwdOnly", (BatchMPCKernels,), {"UNITS": {"fwd": cmb.UNITS["fwd"]}, **kw})
    return cls(model, DT, g=G, u_lim=u_lim, _fwd_form="looped")


def _problem(host, B, H, seed=0, dtype=np.float64):
    """x0 inside the joint limits (q within [-1, 1]), dq0 in [-0.2, 0.2]; a
    nominal sd_x near x0, controls within 30% of min(limit, 10), gains of
    0.1 scale, goals in [-1, 1], alphas in [0, 1]; from numpy, scenario-
    minor: [x0 (nx, B), sd_x (H, nx, B), sd_u (H, n, B), kK (H, n, 1+nx, B),
    goal (n, B), alpha (B,)]."""
    n = len(host["joint_lower"])
    rng = np.random.default_rng(seed)
    lo, hi = np.maximum(host["joint_lower"], -1.0), np.minimum(host["joint_upper"], 1.0)
    q0 = lo[:, None] + rng.uniform(0.05, 0.95, (n, B)) * (hi - lo)[:, None]
    x0 = np.concatenate([q0, rng.uniform(-0.2, 0.2, (n, B))])
    sd_x = x0[None] + rng.uniform(-0.05, 0.05, (H, 2 * n, B))
    lim = np.minimum(host["torque_limit"], 10.0)[None, :, None]
    sd_u = rng.uniform(-0.3, 0.3, (H, n, B)) * lim
    kK = rng.uniform(-0.1, 0.1, (H, n, 1 + 2 * n, B))
    goal = rng.uniform(-1.0, 1.0, (n, B))
    return [a.astype(dtype) for a in (x0, sd_x, sd_u, kK, goal, rng.uniform(0.0, 1.0, B))]


def _scaled_problem(host, B, H, seed, dtype):
    """``_problem``'s draws at the robot's own scale: the nominal torques
    its gravity torques at x0 plus M_jj(q0) U[-1, 1] (about 1 rad/s^2 a
    joint), k_j M_jj U[-1, 1] and K_ji M_jj U[-0.1, 0.1]; the nominal
    states within 0.05 of x0."""
    ins = _problem(host, B, H, seed=seed)
    n = len(host["joint_lower"])
    rng = np.random.default_rng(seed + 100)
    m64 = from_host_arrays(host, dtype=torch.float64, device=CPU)
    q0 = torch.from_numpy(ins[0][:n].T.copy())
    mjj = torch.diagonal(mass_matrix(m64, q0), dim1=-2, dim2=-1).numpy().T  # (n, B)
    grav = gravity_forces(m64, q0, g=G).numpy().T
    ins[2] = grav[None] + mjj[None] * rng.uniform(-1.0, 1.0, (H, n, B))
    ins[3] = mjj[None, :, None] * np.concatenate(
        [rng.uniform(-1.0, 1.0, (H, n, 1, B)), rng.uniform(-0.1, 0.1, (H, n, 2 * n, B))], axis=2)
    return [a.astype(dtype) for a in ins]


# ---------------------------------------------------------------------------
# The two-link arm against JAX's batched kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planar_fwd():
    """The looped stages and JAX's interpret-mode ones on the same inputs
    (the two-link arm, its own torque limits, ``test_torch_mpc_batch``'s
    shapes): (port outputs, JAX outputs) per stage."""
    jm = jax_catalog.two_link_planar(dtype=jnp.float32)
    tm = _port_model(jm)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-0.3, 0.3, (PB, 4)).astype(np.float32)
    goals = rng.uniform(-0.8, 0.8, (PB, 2)).astype(np.float32)
    us = torch.from_numpy(rng.uniform(-5.0, 5.0, (PH, 2, PB)).astype(np.float32))
    jmpc = jax_build_batch(jm, jnp.asarray(goals), PB, PH, PDT, iterations=PITERS, interpret=True)
    tmpc = build_batch_tracking_mpc(tm, goals, PB, PH, PDT, iterations=PITERS, _fwd_form="looped")
    K = tmpc.kernels
    assert K.fwd_form == "looped" and K.plain().replay == K.loop_replay_plain
    x0_t, goal_t = torch.from_numpy(x0).T.contiguous(), torch.from_numpy(goals).T.contiguous()
    xs0, _, _ = K.replay(x0_t, torch.zeros(PH, 4, PB), us, torch.zeros(PH, 2, 5, PB), goal_t, torch.zeros(PB))
    sd_x = torch.cat([x0_t[None], xs0[:-1]])
    AB = K.linearize(sd_x, us)
    kK = K.backward(AB, sd_x, us, xs0[-1].contiguous(), goal_t, torch.full((PB,), 1e-6))
    alphas = torch.tensor(0.5 ** np.arange(6), dtype=torch.float32)
    alpha = torch.tensor([1.0, 0.5, 0.25])
    J = _to_jax
    ins = (J(x0_t), J(sd_x), J(us), J(kK), J(goal_t))
    costs, xs_all, us_all = K.linesearch(x0_t, sd_x, us, kK, goal_t, alphas)
    replay = K.replay(x0_t, sd_x, us, kK, goal_t, alpha)
    jreplay = jmpc.replay(*ins, J(alpha)[:, None])
    # Every alpha's trajectory, JAX's replay of each alpha in turn.
    jall = [jmpc.replay(*ins, J(torch.full((PB,), float(a)))[:, None]) for a in alphas]
    return {
        "linesearch_costs": ([K.linesearch_costs(x0_t, sd_x, us, kK, goal_t, alphas)],
                             [_from_jax(jmpc.linesearch_costs(*ins, jnp.asarray(alphas.numpy())))]),
        "linesearch": ([costs, xs_all, us_all],
                       [_from_jax(jmpc.linesearch_costs(*ins, jnp.asarray(alphas.numpy()))),
                        np.stack([_from_jax(r[0]).reshape(tuple(replay[0].shape)) for r in jall], axis=2),
                        np.stack([_from_jax(r[1]).reshape(tuple(replay[1].shape)) for r in jall], axis=2)]),
        "replay": (list(replay), [_from_jax(v).reshape(tuple(p.shape)) for v, p in zip(jreplay, replay)]),
    }


@pytest.mark.parametrize("stage", ["linesearch_costs", "linesearch", "replay"])
def test_looped_stage_plain_matches_jax_interpret(planar_fwd, stage):
    got, ref = planar_fwd[stage]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        _close_to_scale(g.numpy(), r)


# ---------------------------------------------------------------------------
# The fleet against a closed loop of JAX's own step
# ---------------------------------------------------------------------------


def _jax_closed_loop(jm64, ins, u_lim, weights, jdt):
    """``fused_batch.py:398-422``'s closed loop over (B,) planes with JAX's
    emitted step: (xs (H, nx, B), us (H, n, B), cost (B,))."""
    n, step = jfd.build_fd_step_planes(jm64, DT, g=G, clip_limits=True, clip_velocity=False)
    x0, sd_x, sd_u, kK, goal, alpha = (jnp.asarray(a, dtype=jdt) for a in ins)
    nx, H = 2 * n, sd_x.shape[0]
    w_q, w_dq, w_u, w_terminal = weights
    wT = [w_terminal] * n + [0.1 * w_terminal] * n
    x = [x0[i] for i in range(nx)]
    acc = jnp.zeros(x0.shape[1:], jdt)
    xs, us = [], []
    for t in range(H):
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
            c = c + w_q * e * e + w_dq * x[n + i] * x[n + i]
        for j in range(n):
            c = c + w_u * u[j] * u[j]
        q2, dq2, _ = step(x[:n], x[n:], u)
        acc = acc + c
        x = [jnp.broadcast_to(v, acc.shape) for v in list(q2) + list(dq2)]
        xs.append(jnp.stack(x))
        us.append(jnp.stack([jnp.broadcast_to(v, acc.shape) for v in u]))
    cT = jnp.zeros_like(acc)
    for i in range(n):
        e = x[i] - goal[i]
        cT = cT + wT[i] * e * e + wT[n + i] * x[n + i] * x[n + i]
    return np.asarray(jnp.stack(xs)), np.asarray(jnp.stack(us)), np.asarray(acc + cT)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("robot", list(ROBOTS))
def test_looped_closed_loop_matches_jax_step(robot, dtype):
    make, calibrated = ROBOTS[robot]
    jdt, tdt = DTYPES[dtype]
    jm64 = make(jnp.float64)
    host = jax_host_arrays(jm64)
    tm = from_host_arrays(host, dtype=tdt, device=CPU)
    n, B, H = tm.num_joints, 4, 4
    ins = _scaled_problem(host, B, H, seed=n, dtype=dtype)
    weights = (10.0, 0.5, 1e-4, 100.0)
    K = _looped(tm)
    assert K.fwd_table.shape == (tfd.HEAD_FLOATS + n * tfd.LINK_STRIDE + len(tfd.COST_FIELDS),)
    xs, us, cost = K.replay_plain(*(torch.from_numpy(a) for a in ins))
    rxs, rus, rcost = _jax_closed_loop(jm64, ins, host["torque_limit"], weights, jdt)
    assert np.isfinite(rxs).all() and np.isfinite(rcost).all()
    xs, us, cost = xs.numpy(), us.numpy(), cost.numpy()
    if dtype == "float64":
        np.testing.assert_allclose(xs, rxs, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(us, rus, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(cost, rcost, rtol=1e-9)
        return
    np.testing.assert_allclose(xs[:, :n], rxs[:, :n], rtol=0, atol=1e-4, err_msg="q")
    scale = np.maximum(1.0, np.abs(rxs[:, n:]).max(axis=(0, 2), keepdims=True)) if calibrated else 1.0
    assert float((np.abs(xs[:, n:] - rxs[:, n:]) / scale).max()) <= 1e-3, "dq"
    np.testing.assert_allclose(us, rus, rtol=1e-4, atol=1e-3, err_msg="u")
    np.testing.assert_allclose(cost, rcost, rtol=1e-4, err_msg="cost")


def test_looped_solve_matches_jax_generic_ilqr_per_scenario():
    """The whole batched solve with K2, K4 and K5 all looped, on the CPU,
    against JAX's generic iLQR (``make_step_fn(fused=False)``) scenario by
    scenario on the 7-joint Panda: cost rtol 1e-5, final state 5e-4,
    controls 5e-3; no torque limit on either side (the generic solver has
    none)."""
    B, H, iters, dt = 2, 4, 2, 0.01
    jm = jax_catalog.panda(dtype=jnp.float32)
    tm = from_host_arrays(jax_host_arrays(jax_catalog.panda(dtype=jnp.float64)), dtype=torch.float32, device=CPU)
    n = tm.num_joints
    rng = np.random.default_rng(11)
    lo, hi = tm.joint_lower.double().numpy(), tm.joint_upper.double().numpy()
    q0 = (lo + hi) / 2 + rng.uniform(-0.3, 0.3, (B, n)) * (hi - lo) / 2
    goals = (q0 + rng.uniform(-0.2, 0.2, (B, n))).astype(np.float32)
    x0 = np.concatenate([q0, np.zeros_like(q0)], 1).astype(np.float32)
    mpc = build_batch_tracking_mpc(tm, goals, B, H, dt, iterations=iters, u_limit=np.inf, _form="looped",
                                   _fwd_form="looped")
    assert (mpc.kernels.form, mpc.kernels.fwd_form) == ("looped", "looped")
    us, xs, cost = mpc.solve(torch.from_numpy(x0), torch.zeros(B, H, n))
    step = jax_step_fn(jm, dt, fused=False)
    for s in range(B):
        running, terminal = jax_tracking_costs(jm, jnp.asarray(goals[s]))
        res = jax_ilqr(step, running, terminal, jnp.asarray(x0[s]), jnp.zeros((H, n), jnp.float32),
                       JaxILQRParams(horizon=H, dt=dt, iterations=iters), linearize_step_fn=step)
        np.testing.assert_allclose(float(cost[s]), float(res.cost), rtol=1e-5)
        np.testing.assert_allclose(xs[s, -1].numpy(), np.asarray(res.xs[-1]), atol=5e-4)
        np.testing.assert_allclose(us[s].numpy(), np.asarray(res.us), atol=5e-3)


# ---------------------------------------------------------------------------
# The looped fwd unit on the host
# ---------------------------------------------------------------------------

_HARNESS = """\
#include <math.h>
extern "C" {{ float (*mpt_host_fn[3])(float); }}
#define sinf(v) mpt_host_fn[0](v)
#define cosf(v) mpt_host_fn[1](v)
#define sqrtf(v) mpt_host_fn[2](v)
#define __device__
#define __forceinline__ inline
{src}
// K4 with its trajectories: every (alpha, scenario) thread in turn.
extern "C" void run_linesearch(const float* tab, const float** in, float** out, int B, int H, int A) {{
  for (int a = 0; a < A; ++a) for (int b = 0; b < B; ++b)
    linesearch_thread(in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2], B, H, A, b, a, tab);
}}
// K4's costs alone.
extern "C" void run_costs(const float* tab, const float** in, float** out, int B, int H, int A) {{
  for (int a = 0; a < A; ++a) for (int b = 0; b < B; ++b)
    cost_thread(in[0], in[1], in[2], in[3], in[4], in[5], out[0], B, H, b, a, tab);
}}
// K5: every scenario under its own alpha.
extern "C" void run_replay(const float* tab, const float** in, float** out, int B, int H, int A) {{
  for (int b = 0; b < B; ++b)
    replay_thread(in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2], B, H, b, tab);
}}
"""
_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)
# PyTorch's float32 sin, cos and sqrt of one value, for the harness.
_TORCH_FNS = [_FN(lambda v, f=f: float(f(torch.tensor([v], dtype=torch.float32))[0]))
              for f in (torch.sin, torch.cos, torch.sqrt)]
_LIBM = ctypes.CDLL("libm.so.6")
HOST_ROBOTS = {  # n = 1, 6 (torque bounds 0), 7, 8
    "robotiq_2f_85": lambda: robot_data.load_robot("robotiq_2f_85", chain_joints_only=True, device=CPU),
    "abb_irb2400": lambda: robot_data.load_robot("abb_irb2400", chain_joints_only=True, device=CPU),
    "gen3": lambda: robot_data.load_robot("gen3", chain_joints_only=True, device=CPU),
    "jaco_7dof": lambda: robot_data.load_robot("jaco_7dof", chain_joints_only=True, device=CPU),
}


@pytest.fixture(scope="module")
def loop_fwd_units(tmp_path_factory):
    """Per joint count, on first use: the looped fwd unit compiled by g++
    -O1 with the host harness."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the kernel's C")
    libs, tmp = {}, tmp_path_factory.mktemp("loop_fwd_units")

    def get(n):
        if n not in libs:
            cpp, so = tmp / f"fwd{n}.cpp", tmp / f"fwd{n}.so"
            cpp.write_text(_HARNESS.format(src=cmb.fwd_loop_unit_source(n)))
            subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
                            str(cpp)], check=True, timeout=300)
            lib = ctypes.CDLL(str(so))
            for entry in ("run_linesearch", "run_costs", "run_replay"):
                getattr(lib, entry).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            libs[n] = lib
        return libs[n]

    return get


def _run_host(lib, fns, K, ins, alphas):
    """(K4's costs, xs_all, us_all; K4's costs alone; K5's xs, us, cost), each
    output NaN-filled first."""
    slots = (ctypes.c_void_p * 3).in_dll(lib, "mpt_host_fn")
    for i, fn in enumerate(fns):
        slots[i] = ctypes.cast(fn, ctypes.c_void_p).value
    H, nx, B = ins[1].shape
    n, A = nx // 2, alphas.shape[0]
    nan = lambda *s: torch.full(s, float("nan"))
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    tab = K.fwd_table.data_ptr()
    ls, costs, rep = [nan(A, B), nan(H, nx, A, B), nan(H, n, A, B)], [nan(A, B)], [nan(H, nx, B), nan(H, n, B), nan(B)]
    lib.run_linesearch(tab, ptrs(ins[:5] + [alphas]), ptrs(ls), B, H, A)
    lib.run_costs(tab, ptrs(ins[:5] + [alphas]), ptrs(costs), B, H, A)
    lib.run_replay(tab, ptrs(ins), ptrs(rep), B, H, A)
    return ls, costs[0], rep


def _assert_bits(got, ref):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(ref)[~nan])


@pytest.mark.parametrize("robot", list(HOST_ROBOTS))
def test_loop_fwd_unit_on_the_host_matches_its_plain_version(loop_fwd_units, robot):
    model = HOST_ROBOTS[robot]()
    n, B, H = model.num_joints, 5, 4
    host = host_arrays(model)
    ins = [torch.from_numpy(a).contiguous() for a in _problem(host, B, H, seed=n, dtype=np.float32)]
    ins[0][n, 3] = float("nan")  # scenario 3 stays its own
    alphas = torch.tensor(0.5 ** np.arange(6), dtype=torch.float32)
    K = _looped(model)
    assert K.sources["fwd"] == cmb.fwd_loop_unit_source(n)
    lib = loop_fwd_units(n)
    ls, costs, rep = _run_host(lib, _TORCH_FNS, K, ins, alphas)
    ref_ls, ref_rep = K.linesearch_plain(*ins[:5], alphas), K.replay_plain(*ins)
    assert bool(torch.isnan(ref_rep[2][3])) and bool(torch.isfinite(ref_rep[2][[0, 1, 2, 4]]).all())
    for got, ref in zip(ls + rep, list(ref_ls) + list(ref_rep)):
        _assert_bits(got, ref)
    _assert_bits(costs, ref_ls[0])
    # The clean scenarios keep a clean run's bits.
    clean = [torch.from_numpy(a).contiguous() for a in _problem(host, B, H, seed=n, dtype=np.float32)]
    clean_rep = K.replay_plain(*clean)
    for got, ref in zip(rep, clean_rep):
        assert torch.equal(_bits(got[..., [0, 1, 2, 4]]), _bits(ref[..., [0, 1, 2, 4]]))
    libm_ls, _, libm_rep = _run_host(lib, [_LIBM.sinf, _LIBM.cosf, _LIBM.sqrtf], K, ins, alphas)
    for got, ref in zip(libm_ls + libm_rep, list(ref_ls) + list(ref_rep)):
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        assert float((got - ref)[~nan].abs().max()) <= 1e-5 * max(1.0, float(ref[~nan].abs().max()))


def test_zero_torque_bounds_give_plus_zero_controls_and_the_zero_control_cost(loop_fwd_units):
    """The ABB arm's URDF gives every joint effort="0": the looped unit's
    controls are +0.0 whatever the gains, and its cost is the zero-control
    rollout's bit for bit."""
    model = HOST_ROBOTS["abb_irb2400"]()
    n, B, H = model.num_joints, 4, 3
    K = _looped(model)
    assert float(K.fwd_table[tfd.HEAD_FLOATS + tfd.LINK_AT["u_lim"]]) == 0.0
    ins = [torch.from_numpy(a).contiguous() for a in _problem(host_arrays(model), B, H, seed=2, dtype=np.float32)]
    ins[2] = torch.full_like(ins[2], 5.0)  # nominal torques far past the bounds
    alphas = torch.tensor([1.0, 0.5], dtype=torch.float32)
    ls, _, rep = _run_host(loop_fwd_units(n), _TORCH_FNS, K, ins, alphas)
    assert torch.equal(_bits(rep[1]), torch.zeros_like(_bits(rep[1])))
    assert torch.equal(_bits(ls[2]), torch.zeros_like(_bits(ls[2])))
    zero = K.replay_plain(ins[0], ins[1], torch.zeros_like(ins[2]), torch.zeros_like(ins[3]), ins[4],
                          torch.zeros(B))
    assert torch.equal(_bits(rep[2]), _bits(zero[2])) and torch.equal(_bits(rep[0]), _bits(zero[0]))


# ---------------------------------------------------------------------------
# The table, the units, the route and the public solve
# ---------------------------------------------------------------------------


def test_table_carries_u_lim_and_the_cost_weights():
    """K1's and K2's tables carry +inf as the torque bound (they read none);
    the closed-loop step's carries the set's bounds, then the cost weights
    as ``Costs`` forms them, rounded once: 4 + 47 n + 5 floats."""
    model = robot_data.load_robot("gen3", chain_joints_only=True, device=CPU)
    n = model.num_joints
    at = lambda k, name: tfd.HEAD_FLOATS + k * tfd.LINK_STRIDE + tfd.LINK_AT[name]
    rollout = cuda_rollout.CudaRollout(model, _form="looped").table
    lin = BatchMPCKernels(model, DT, u_lim=[1.0] * n, _form="looped").table
    for tab in (rollout, lin):
        assert tab.shape == (tfd.HEAD_FLOATS + n * tfd.LINK_STRIDE,)
        assert all(float(tab[at(k, "u_lim")]) == np.inf for k in range(n))
    u_lim = [float(k + 1) for k in range(n)]
    K = BatchMPCKernels(model, DT, g=G, w_q=3.0, w_dq=0.25, w_u=2e-3, w_terminal=7.0, u_lim=u_lim,
                        _fwd_form="looped")
    tab = K.fwd_table
    assert tab.shape == (tfd.HEAD_FLOATS + n * tfd.LINK_STRIDE + tfd.COST_FLOATS,) and tab.dtype == torch.float32
    assert [float(tab[at(k, "u_lim")]) for k in range(n)] == u_lim
    tail = tab[tfd.HEAD_FLOATS + n * tfd.LINK_STRIDE:]
    assert tail.tolist() == torch.tensor([3.0, 0.25, 2e-3, 7.0, 0.1 * 7.0], dtype=torch.float32).tolist()
    assert float(K._fwd_tables[torch.float64][-1]) == 0.1 * 7.0
    assert torch.equal(tab[:tfd.HEAD_FLOATS + n * tfd.LINK_STRIDE],
                       tfd.link_table(model, DT, G, clip_velocity=False, u_lim=u_lim))
    defines = tfd.table_defines()
    assert f"#define MPT_TAB_U_LIM {tfd.LINK_AT['u_lim']}" in defines and "#define MPT_COST_FLOATS 5" in defines
    assert all(f"#define MPT_COST_{name.upper()} {at_}" in defines for name, at_ in tfd.COST_AT.items())


def test_one_looped_fwd_unit_per_joint_count():
    """The robot is the table: robots of one n share the looped fwd unit
    (one build) whatever their torque limits and weights; robots of
    another n do not; the emitted unit stays each robot's own."""
    gen3, iiwa7 = (robot_data.load_robot(k, chain_joints_only=True, device=CPU) for k in ("gen3", "iiwa7"))
    a, b = _looped(gen3), _looped(iiwa7, u_lim=[3.0] * 7)
    assert a.sources["fwd"] == b.sources["fwd"] == cmb.fwd_loop_unit_source(7)
    assert library_key(a.sources["fwd"], "mpc_batch_fwd") == library_key(b.sources["fwd"], "mpc_batch_fwd")
    assert not torch.equal(a.fwd_table, b.fwd_table)
    assert len({cmb.fwd_loop_unit_source(n) for n in (1, 6, 7, 8, 10)}) == 5
    src = a.sources["fwd"]
    assert "#define MPT_FWD_LOOP 1" in src and "void mpc_fwd_step(" not in src and "#define MPT_UNIT_FWD 1" in src
    emitted = type("FwdOnly", (BatchMPCKernels,), {"UNITS": {"fwd": cmb.UNITS["fwd"]}})
    assert emitted(gen3, DT, u_lim=[1.0] * 7, _fwd_form="emitted").sources["fwd"] != \
        emitted(iiwa7, DT, u_lim=[1.0] * 7, _fwd_form="emitted").sources["fwd"]
    assert a.fwd_loop_ops == tfd.loop_fwd_ops(7) > tfd.loop_step_ops(7)
    assert a.statements["replay"] == emitted(gen3, DT, u_lim=[1.0] * 7).statements["replay"]
    assert a.ARGTYPES["replay"][-2:] == [ctypes.c_void_p, ctypes.c_void_p] and len(a.ARGTYPES["replay"]) == 13
    with pytest.raises(ValueError):
        BatchMPCKernels(gen3, DT, u_lim=[1.0] * 7, _fwd_form="straight")
    with pytest.raises(ValueError):  # K5's team splits the emitted step
        type("Team", (BatchMPCKernels,), {"TEAM_WARPS": 4})(gen3, DT, u_lim=[1.0] * 7, _fwd_form="looped")


def test_looped_plain_version_runs_robots_side_by_side():
    """Robots of one joint count in one plain call, a column of the table a
    scenario, give each robot's own bits (the card's fleet check)."""
    models = [robot_data.load_robot(k, chain_joints_only=True, device=CPU) for k in ("ur10", "xarm6", "abb_irb2400")]
    Ks = [_looped(m) for m in models]
    probs = [[torch.from_numpy(a) for a in _problem(host_arrays(m), 2 + i, 3, seed=i, dtype=np.float32)]
             for i, m in enumerate(models)]
    tab = torch.cat([K.fwd_table[:, None].expand(-1, p[0].shape[1]) for K, p in zip(Ks, probs)], dim=1)
    both = cmb.loop_fwd_rollout_plain(tab, 6, *(torch.cat([p[i] for p in probs], dim=-1) for i in range(6)))
    at = 0
    for K, p in zip(Ks, probs):
        cols = p[0].shape[1]
        for got, ref in zip(both, K.replay_plain(*p)):
            assert torch.equal(_bits(got[..., at:at + cols]), _bits(ref))
        at += cols


@pytest.mark.parametrize("below, above", [
    (("catalog", "panda"), ("chain", "gen3")),       # 7 joints
    (("chain", "panda"), ("chain", "jaco_7dof")),    # 8
])
def test_fwd_route_takes_the_looped_form_past_the_threshold(monkeypatch, below, above):
    load = lambda src, key: (getattr(catalog, key)(device=CPU) if src == "catalog"
                             else robot_data.load_robot(key, chain_joints_only=True, device=CPU))
    lo, hi = load(*below), load(*above)
    n = lo.num_joints
    fwd = type("FwdOnly", (BatchMPCKernels,), {"UNITS": {"fwd": cmb.UNITS["fwd"]}})
    st_lo, st_hi = (fwd(m, DT, u_lim=[1.0] * n, _fwd_form="emitted").statements["replay"] for m in (lo, hi))
    assert n == hi.num_joints and st_lo < st_hi
    monkeypatch.setitem(cmb.FWD_LOOP_THRESHOLDS, n, st_lo)
    assert cmb.fwd_form(lo, st_lo) == "emitted" and cmb.fwd_form(hi, st_hi) == "looped"
    a, b = fwd(lo, DT, u_lim=[1.0] * n), fwd(hi, DT, u_lim=[1.0] * n)
    assert (a.fwd_form, b.fwd_form) == ("emitted", "looped") and a.fwd_table is None and b.fwd_table is not None
    monkeypatch.setitem(cmb.FWD_LOOP_THRESHOLDS, n, st_lo - 1)
    assert fwd(lo, DT, u_lim=[1.0] * n).fwd_form == "looped"
    monkeypatch.setitem(cmb.FWD_LOOP_THRESHOLDS, n, st_hi)
    assert fwd(hi, DT, u_lim=[1.0] * n).fwd_form == "emitted"
    team = type("Team", (BatchMPCKernels,), {"UNITS": {"fwd": cmb.UNITS["fwd"]}, "TEAM_WARPS": 4})
    monkeypatch.setitem(cmb.FWD_LOOP_THRESHOLDS, n, 0)
    assert team(hi, DT, u_lim=[1.0] * n).fwd_form == "emitted"  # the team splits the emitted step


@pytest.mark.parametrize("robot, form", [
    ("robotiq_2f_85", "emitted"), ("abb_irb2400", "emitted"), ("ur10", "looped"), ("panda (programmatic)", "emitted"),
    ("xarm6_gripper", "looped"), ("panda", "emitted"), ("jaco_7dof", "looped"), ("jaco_7dof_full", "looped"),
])
def test_fwd_route_as_measured(robot, form):
    """The route's thresholds send each robot where the form measured
    faster, or within 5%, in one call on an H100 (the thresholds' comment):
    the grippers, the short 6-joint arms, the programmatic Panda and the
    8-joint Panda to the emitted step, the rest to the looped one."""
    if robot == "panda (programmatic)":
        model = catalog.panda(device=CPU)
    else:
        model = robot_data.load_robot(robot.replace("_full", ""), chain_joints_only=not robot.endswith("_full"),
                                      device=CPU)
    fwd = type("FwdOnly", (BatchMPCKernels,), {"UNITS": {"fwd": cmb.UNITS["fwd"]}})
    K = fwd(model, DT, u_lim=[1.0] * model.num_joints)
    assert K.fwd_form == form == cmb.fwd_form(model, K.statements["replay"])


def test_public_cpu_solve_keeps_the_emitted_plain_replay(monkeypatch):
    """A robot the route gives the looped K4 and K5: on the CPU the public
    solver runs the emitted plain versions, bit for bit an emitted-form
    solve, while its kernels' plain versions (``plain()``, the card's
    reference) are the looped form's."""
    model = robot_data.load_robot("gen3", chain_joints_only=True, device=CPU)
    monkeypatch.setitem(cmb.FWD_LOOP_THRESHOLDS, 7, 0)
    n, B, H = 7, 2, 3
    rng = np.random.default_rng(7)
    goals = rng.uniform(-0.2, 0.2, (B, n)).astype(np.float32)
    x0 = torch.from_numpy(np.concatenate([rng.uniform(-0.3, 0.3, (B, n)), np.zeros((B, n))], 1).astype(np.float32))
    warm = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, H, n)).astype(np.float32))
    mpc = build_batch_tracking_mpc(model, goals, B, H, DT, iterations=2)
    K = mpc.kernels
    assert K.fwd_form == "looped" and "_fwd_form" not in mpc.build_args
    plain = K.plain()
    assert (plain.replay, plain.linesearch, plain.linesearch_costs) == (
        K.loop_replay_plain, K.loop_linesearch_plain, K.loop_linesearch_costs_plain)
    got = mpc.solve(x0, warm)
    ref = build_batch_tracking_mpc(model, goals, B, H, DT, iterations=2, _fwd_form="emitted").solve(x0, warm)
    assert all(torch.equal(_bits(g), _bits(r)) for g, r in zip(got, ref))
    looped = build_batch_tracking_mpc(model, goals, B, H, DT, iterations=2, _fwd_form="looped")
    assert looped.build_args["_fwd_form"] == "looped"
    assert not all(torch.equal(_bits(g), _bits(r)) for g, r in zip(looped.solve(x0, warm), ref))
