"""K2's looped form (the looped step's forward mode,
``csrc/fd_step_loop_jvp.cuh``, the robot in a table) against the JAX
package, and its C on the host.

* The looped plain linearization (``BatchMPCKernels(..., _form="looped")``
  on CPU tensors, ``fd_step.fd_step_loop_jvp_planes``) against
  ``jax.jacfwd`` of JAX's step (``forward_dynamics_fast``, semi-implicit
  Euler, the position clamp; no velocity clamp, as K2's step), with
  ``test_linearize_plain_matches_jax_jacfwd``'s bars: float64 within 1e-9;
  float32 within 1e-4 on the rows of q' and 1e-3 on those of dq' (on a
  calibrated chain held to each row's scale, as there: a Jaco finger's dq'
  row reaches dt M^-1 ~ 43), on the programmatic UR5 and Panda and fleet
  robots of n = 1, 6, 7, 8 and 10, one state past a joint limit. JAX's
  step takes the model as an argument, so it compiles once per joint count.
* The same against ``torch.func.jacfwd`` of the looped step
  (``fd_step_loop_planes``, float64, 1e-9) on the 26 fleet models.
* The clamp's tangent halved on a limit and whole on the Gen3's unlimited
  joints; a NaN scenario kept to itself, its gains out of K3's plain version
  non-finite.
* The looped K2 unit compiled by the host g++ behind the ``__device__``
  shim on six robots of n = 1 to 10: within 1e-5 of scale of its plain
  version with the host's sinf, cosf and sqrtf, bit for bit with PyTorch's
  (the host libm and PyTorch's CPU maths differ in the last bit on some
  inputs; on the card the kernel's are ``torch.sin``'s).
* One unit per (joint count, seeds a thread); the route on each side of
  its threshold; the public CPU solve bitwise the emitted form's; a whole
  solve on the looped form against JAX's generic iLQR per scenario.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu.dynamics import forward_dynamics_fast
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.costs import make_tracking_costs as jax_tracking_costs
from manipulapy_tpu.mpc.ilqr import ILQRParams as JaxILQRParams
from manipulapy_tpu.mpc.ilqr import ilqr as jax_ilqr
from manipulapy_tpu.mpc.ilqr import make_step_fn as jax_step_fn
from manipulapy_tpu_torch.models import catalog, from_host_arrays, host_arrays, robot_data
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc
from manipulapy_tpu_torch.ops import cuda_mpc_batch as cmb
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops._build import library_key
from manipulapy_tpu_torch.ops.cuda_mpc_batch import BatchMPCKernels, MPCKernelSet
from test_torch_fleet import DT, FLEET, G, IDS, _jax_model

CPU = torch.device("cpu")
# (JAX model maker (dtype) -> model, calibrated): the programmatic arms and
# fleet robots of n = 1, 6, 7 (the Gen3: joints 1, 3, 5, 7 unlimited), 8, 10.
LIN_ROBOTS = {
    "ur5": (lambda dt: jax_catalog.ur5(dtype=dt), False),
    "panda": (lambda dt: jax_catalog.panda(dtype=dt), False),
    "robotiq_2f_85": (lambda dt: _jax_model("robotiq_2f_85", True, dt), True),
    "xarm6": (lambda dt: _jax_model("xarm6", True, dt), True),
    "gen3": (lambda dt: _jax_model("gen3", True, dt), True),
    "jaco_7dof": (lambda dt: _jax_model("jaco_7dof", True, dt), True),
    "jaco_7dof_full": (lambda dt: _jax_model("jaco_7dof", False, dt), True),
}
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _jax_next(model, x, u, g):
    n = u.shape[-1]
    q, dq = x[:n], x[n:]
    ddq = forward_dynamics_fast(model, q, dq, u, g)
    dq2 = dq + ddq * DT
    return jnp.concatenate([jnp.clip(q + dq2 * DT, model.joint_lower, model.joint_upper), dq2])


# One compile per joint count and dtype: the model is an argument.
JAX_JACOBIANS = jax.jit(jax.vmap(jax.jacfwd(_jax_next, argnums=(1, 2)), in_axes=(None, 0, 0, None)))


def _inputs(host, B=4, seed=0, past_limit=True):
    """x (B, 2n) inside the limits (q within [-1, 1]), dq in [-0.5, 0.5], tau
    in [-10, 10] inside the torque limits (``test_linearize_plain_matches_jax_jacfwd``'s
    distributions), scenario 1 past the first finite upper limit by 0.5;
    from numpy, float64."""
    n = len(host["joint_lower"])
    rng = np.random.default_rng(seed)
    lo, hi = np.maximum(host["joint_lower"], -1.0), np.minimum(host["joint_upper"], 1.0)
    q = lo + rng.uniform(0.05, 0.95, (B, n)) * (hi - lo)
    limited = np.flatnonzero(np.isfinite(host["joint_upper"]))
    if past_limit and limited.size:
        q[1, limited[0]] = host["joint_upper"][limited[0]] + 0.5
    tau = rng.uniform(-1.0, 1.0, (B, n)) * np.minimum(host["torque_limit"], 10.0)
    return np.concatenate([q, rng.uniform(-0.5, 0.5, (B, n))], axis=1), tau


def _looped(model, g=G, **kw):
    """K2 alone in the looped form (the other units are not emitted)."""
    cls = type("LinOnly", (BatchMPCKernels,), {"UNITS": {"lin": ("linearize",)}, **kw})
    return cls(model, DT, g=g, u_lim=[10.0] * model.num_joints, _form="looped")


def _AB(K, x, u):
    """K2 on CPU tensors of (B, 2n), (B, n) states and torques (one step):
    (B, nx, m)."""
    xs, us = (torch.from_numpy(a).T[None].contiguous() for a in (x, u))
    return K.linearize(xs, us)[0].permute(2, 0, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("robot", list(LIN_ROBOTS))
def test_loop_linearize_plain_matches_jax_jacfwd(robot, dtype):
    make, calibrated = LIN_ROBOTS[robot]
    jdt, tdt = DTYPES[dtype]
    host = jax_host_arrays(make(jnp.float64))
    tm = from_host_arrays(host, dtype=tdt, device=CPU)
    n = tm.num_joints
    x, u = (a.astype(dtype) for a in _inputs(host))
    got = _AB(_looped(tm), x, u).numpy()
    A, Bm = JAX_JACOBIANS(make(jdt), jnp.asarray(x), jnp.asarray(u), jnp.asarray(G, dtype=jdt))
    ref = np.concatenate([np.asarray(A), np.asarray(Bm)], axis=-1)
    assert got.shape == ref.shape == (x.shape[0], 2 * n, 3 * n) and np.isfinite(ref).all()
    tol_q, tol_dq = (1e-9, 1e-9) if dtype == "float64" else (1e-4, 1e-3)
    np.testing.assert_allclose(got[:, :n], ref[:, :n], rtol=0, atol=tol_q)
    if calibrated and dtype == "float32":
        scale = np.maximum(1.0, np.abs(ref[:, n:]).max(axis=-1, keepdims=True))
        assert float((np.abs(got[:, n:] - ref[:, n:]) / scale).max()) <= tol_dq
    else:
        np.testing.assert_allclose(got[:, n:], ref[:, n:], rtol=0, atol=tol_dq)
    j = int(np.flatnonzero(np.isfinite(host["joint_upper"]))[0])
    assert np.all(got[1, j] == 0.0)  # past the limit: q'_j is clamped, tangent 0


@pytest.mark.parametrize("key, chain", FLEET, ids=IDS)
def test_loop_linearize_plain_matches_torch_jacfwd(key, chain):
    """Autograd of the looped step (its clamp a ``torch.where``, whose
    derivative is 1 inside and 0 past a bound) is a second reference on
    every fleet model, a state past a limit included (float64, 1e-9)."""
    model = robot_data.load_robot(key, chain_joints_only=chain, dtype=torch.float64, device=CPU)
    n = model.num_joints
    x, u = (torch.from_numpy(a) for a in _inputs(host_arrays(model), B=3, seed=5))
    tab = tfd.link_table(model, DT, G, clip_velocity=False, dtype=torch.float64)

    def step(xx, uu):
        q2, dq2, _ = tfd.fd_step_loop_planes(tab, n, [xx[i] for i in range(n)], [xx[n + i] for i in range(n)],
                                             [uu[i] for i in range(n)])
        return torch.stack(q2 + dq2)

    ref = torch.cat(torch.func.vmap(torch.func.jacfwd(step, argnums=(0, 1)))(x, u), dim=-1)
    _, cols = tfd.fd_step_loop_jvp_planes(tab, n, [x[:, i] for i in range(2 * n)], [u[:, i] for i in range(n)],
                                          list(range(3 * n)))
    got = torch.stack([torch.stack(c, dim=-1) for c in cols], dim=-1)
    assert bool(torch.isfinite(ref).all())
    torch.testing.assert_close(got, ref, rtol=1e-9, atol=1e-9)


def _at_rest_on_a_limit(model, j, free_joint=None, B=3):
    """Gravity off: scenario 0 at rest on joint j's lower limit with zero
    torque (so q'_j is the limit exactly), ``free_joint`` far outside [-pi,
    pi] (no limit to clamp it); the others random inside the limits."""
    host = host_arrays(model)
    x, u = _inputs(host, B=B, seed=1, past_limit=False)
    x[0, j] = host["joint_lower"][j]
    if free_joint is not None:
        x[0, free_joint] = 10.0
    x[0, model.num_joints:], u[0] = 0.0, 0.0
    return x.astype(np.float32), u.astype(np.float32)


@pytest.mark.parametrize("robot", ["ur5", "gen3"])
def test_loop_tangent_halves_on_a_limit_and_stays_whole_without_one(robot):
    """JAX's clamp halves the tangent on a bound: d q'_j / d [x; u] is half
    the step's without the position clamp there, bit for bit, while the
    Gen3's unlimited joint 0 (q = 10, the table's bounds +-inf) keeps the
    whole tangent, JAX's not clipping at all."""
    model = catalog.ur5(device=CPU) if robot == "ur5" else robot_data.load_robot("gen3", chain_joints_only=True,
                                                                                device=CPU)
    j, free = (0, None) if robot == "ur5" else (1, 0)
    zero_g = (0.0, 0.0, 0.0)
    x, u = _at_rest_on_a_limit(model, j, free)
    K, free_K = _looped(model, g=zero_g), _looped(model, g=zero_g)
    free_K.table = tfd.link_table(model, DT, zero_g, clip_limits=False, clip_velocity=False)
    free_K._tables = {torch.float32: free_K.table}
    got, unclamped = _AB(K, x, u), _AB(free_K, x, u)
    assert torch.equal(_bits(got[0, j]), _bits(unclamped[0, j] * 0.5))
    assert float(got[0, j, j]) == 0.5 * float(unclamped[0, j, j]) and abs(float(got[0, j, j])) > 0.4
    assert torch.equal(_bits(got[1:]), _bits(unclamped[1:]))  # inside: the whole tangent
    if free is not None:
        assert float(K.table[tfd.HEAD_FLOATS + tfd.LINK_AT["lower"]]) == -np.inf
        assert torch.equal(_bits(got[0, free]), _bits(unclamped[0, free]))
        assert abs(float(got[0, free, free]) - 1.0) < 1e-3


def test_loop_nan_scenario_keeps_to_itself_and_its_gains_go_non_finite():
    """Scenario 1's velocity of joint 0 is NaN at every step: its Jacobians
    go NaN, the other scenarios keep the clean run's bits, and K3's plain
    version gives it non-finite gains (the emitted form's behaviour)."""
    model = robot_data.load_robot("gen3", chain_joints_only=True, device=CPU)
    n, B, H = model.num_joints, 3, 4
    kernels = BatchMPCKernels(model, DT, g=G, u_lim=[10.0] * n, _form="looped")
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(np.concatenate([rng.uniform(-0.5, 0.5, (H, n, B)), rng.uniform(-0.5, 0.5, (H, n, B))],
                                         axis=1).astype(np.float32))
    us = torch.from_numpy(rng.uniform(-3.0, 3.0, (H, n, B)).astype(np.float32))
    clean = kernels.linearize(xs, us)
    xs[:, n, 1] = float("nan")
    AB = kernels.linearize(xs, us)
    assert bool(torch.isnan(AB[..., 1]).any()) and bool(torch.isfinite(AB[..., [0, 2]]).all())
    assert torch.equal(_bits(AB[..., [0, 2]]), _bits(clean[..., [0, 2]]))
    goal = torch.zeros(n, B)
    kK = kernels.backward(AB, xs, us, xs[-1].contiguous(), goal, torch.full((B,), 1e-6))
    assert not bool(torch.isfinite(kK[..., 1]).all()) and bool(torch.isfinite(kK[..., [0, 2]]).all())


# ---------------------------------------------------------------------------
# The looped K2 unit on the host
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
// Every (step, group, scenario) thread, one after the other.
extern "C" void run(const float* tab, const float* xs, const float* us, float* AB, int B, int H) {{
  for (int t = 0; t < H; ++t) for (int g = 0; g < MPT_LIN_GROUPS; ++g) for (int b = 0; b < B; ++b)
    lin_thread(xs, us, AB, B, b, g, t, tab);
}}
"""
_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)
# PyTorch's float32 sin, cos and sqrt of one value, for the harness.
_TORCH_FNS = [_FN(lambda v, f=f: float(f(torch.tensor([v], dtype=torch.float32))[0]))
              for f in (torch.sin, torch.cos, torch.sqrt)]
_LIBM = ctypes.CDLL("libm.so.6")
HOST_ROBOTS = {  # n = 1, 6, 7, 7, 8, 10
    "robotiq_2f_85": lambda: robot_data.load_robot("robotiq_2f_85", chain_joints_only=True, device=CPU),
    "ur5": lambda: catalog.ur5(device=CPU),
    "panda": lambda: catalog.panda(device=CPU),
    "gen3": lambda: robot_data.load_robot("gen3", chain_joints_only=True, device=CPU),
    "jaco_7dof": lambda: robot_data.load_robot("jaco_7dof", chain_joints_only=True, device=CPU),
    "jaco_7dof_full": lambda: robot_data.load_robot("jaco_7dof", device=CPU),
}


@pytest.fixture(scope="module")
def loop_lin_units(tmp_path_factory):
    """Per (joint count, seeds a thread), on first use: the looped K2 unit
    compiled by g++ -O1 with the host harness."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the kernel's C")
    libs, tmp = {}, tmp_path_factory.mktemp("loop_lin_units")

    def get(n, seeds):
        if (n, seeds) not in libs:
            cpp, so = tmp / f"lin{n}_{seeds}.cpp", tmp / f"lin{n}_{seeds}.so"
            cpp.write_text(_HARNESS.format(src=cmb.lin_loop_unit_source(n, seeds)))
            subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
                            str(cpp)], check=True, timeout=300)
            lib = ctypes.CDLL(str(so))
            lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
            libs[n, seeds] = lib
        return libs[n, seeds]

    return get


def _run_host(lib, fns, tab, xs, us):
    slots = (ctypes.c_void_p * 3).in_dll(lib, "mpt_host_fn")
    for i, fn in enumerate(fns):
        slots[i] = ctypes.cast(fn, ctypes.c_void_p).value
    H, nx, B = xs.shape
    AB = torch.full((H, nx, 3 * nx // 2, B), float("nan"))
    lib.run(tab.data_ptr(), xs.data_ptr(), us.data_ptr(), AB.data_ptr(), B, H)
    return AB


@pytest.mark.parametrize("robot", list(HOST_ROBOTS))
def test_loop_lin_unit_on_the_host_matches_its_plain_version(loop_lin_units, robot):
    model = HOST_ROBOTS[robot]()
    n, B, H = model.num_joints, 5, 3
    host = host_arrays(model)
    x, u = _inputs(host, B=B * H, seed=n)
    x[3, n] = np.nan  # a NaN scenario stays its own
    xs = torch.from_numpy(x.reshape(H, B, 2 * n).transpose(0, 2, 1).astype(np.float32)).contiguous()
    us = torch.from_numpy(u.reshape(H, B, n).transpose(0, 2, 1).astype(np.float32)).contiguous()
    for seeds in sorted({1, cmb.lin_loop_seeds(n)}):
        K = _looped(model, LIN_LOOP_SEEDS=seeds)
        assert K.sources["lin"] == cmb.lin_loop_unit_source(n, seeds)
        ref = K.loop_linearize_plain(xs, us)
        assert bool(torch.isnan(ref[0, ..., 3]).any()) and bool(torch.isfinite(ref[1:]).all())
        lib = loop_lin_units(n, seeds)
        got = _run_host(lib, _TORCH_FNS, K.table, xs, us)
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(_bits(got)[~nan], _bits(ref)[~nan])
        libm = _run_host(lib, [_LIBM.sinf, _LIBM.cosf, _LIBM.sqrtf], K.table, xs, us)
        assert torch.equal(torch.isnan(libm), nan)
        assert float((libm - ref)[~nan].abs().max()) <= 1e-5 * float(ref[~nan].abs().max())


# ---------------------------------------------------------------------------
# The units, the route and the solver
# ---------------------------------------------------------------------------


def test_one_looped_unit_per_joint_count_and_seeds():
    """The robot is the table: robots of one n share K2's looped unit (one
    build), robots of another n or seeds a thread do not; the emitted unit
    stays each robot's own."""
    gen3, iiwa7 = (robot_data.load_robot(k, chain_joints_only=True, device=CPU) for k in ("gen3", "iiwa7"))
    a, b = _looped(gen3), _looped(iiwa7)
    flags = cmb.LIN_FLAGS
    assert a.sources["lin"] == b.sources["lin"] == cmb.lin_loop_unit_source(7, a.LIN_LOOP_SEEDS)
    assert library_key(a.sources["lin"], "mpc_batch_lin", flags) == library_key(b.sources["lin"], "mpc_batch_lin", flags)
    assert a.UNIT_FLAGS["lin"] == flags and not torch.equal(a.table, b.table)
    assert len({cmb.lin_loop_unit_source(n, 1) for n in (1, 6, 7, 8, 10)} | {cmb.lin_loop_unit_source(8, 2)}) == 6
    assert "#define MPT_LIN_LOOP 1" in a.sources["lin"] and "void fd_step_jvp_group(" not in a.sources["lin"]
    emitted = type("LinOnly", (BatchMPCKernels,), {"UNITS": {"lin": ("linearize",)}})
    assert emitted(gen3, DT, u_lim=[1.0] * 7, _form="emitted").sources["lin"] != \
        emitted(iiwa7, DT, u_lim=[1.0] * 7, _form="emitted").sources["lin"]
    assert a.loop_ops == tfd.loop_jvp_ops(7, a.LIN_LOOP_SEEDS)
    assert a.loop_ops["total"] == a.loop_ops["q"] + a.loop_ops["dq"] + a.loop_ops["tau"]
    assert a.statements["linearize_group"] == emitted(gen3, DT, u_lim=[1.0] * 7).statements["linearize_group"]
    with pytest.raises(ValueError):
        BatchMPCKernels(gen3, DT, u_lim=[1.0] * 7, _form="straight")


@pytest.mark.parametrize("below, above", [
    (("catalog", "ur5"), ("chain", "ur10")),         # 6 joints
    (("catalog", "panda"), ("chain", "gen3")),       # 7
    (("chain", "panda"), ("chain", "jaco_7dof")),    # 8
])
def test_route_takes_the_looped_form_past_the_threshold(monkeypatch, below, above):
    load = lambda src, key: (getattr(catalog, key)(device=CPU) if src == "catalog"
                             else robot_data.load_robot(key, chain_joints_only=True, device=CPU))
    lo, hi = load(*below), load(*above)
    n = lo.num_joints
    lin = type("LinOnly", (BatchMPCKernels,), {"UNITS": {"lin": ("linearize",)}})
    step_lo, step_hi = (lin(m, DT, u_lim=[1.0] * n, _form="emitted").statements["step"] for m in (lo, hi))
    assert n == hi.num_joints and step_lo < step_hi
    monkeypatch.setitem(cmb.LIN_LOOP_THRESHOLDS, n, step_lo)
    assert cmb.lin_form(lo, step_lo) == "emitted" and cmb.lin_form(hi, step_hi) == "looped"
    a, b = lin(lo, DT, u_lim=[1.0] * n), lin(hi, DT, u_lim=[1.0] * n)
    assert (a.form, b.form) == ("emitted", "looped") and a.table is None and b.table is not None
    monkeypatch.setitem(cmb.LIN_LOOP_THRESHOLDS, n, step_lo - 1)
    assert lin(lo, DT, u_lim=[1.0] * n).form == "looped"
    monkeypatch.setitem(cmb.LIN_LOOP_THRESHOLDS, n, step_hi)
    assert lin(hi, DT, u_lim=[1.0] * n).form == "emitted"


def test_public_cpu_solve_keeps_the_emitted_plain_linearization(monkeypatch):
    """A robot the route gives the looped K2: on the CPU the public solver
    runs the emitted plain linearization, bit for bit, while its kernels'
    plain versions (``plain()``, the card's reference) are the looped
    form's."""
    model = robot_data.load_robot("gen3", chain_joints_only=True, device=CPU)
    monkeypatch.setitem(cmb.LIN_LOOP_THRESHOLDS, 7, 0)
    n, B, H = 7, 2, 3
    rng = np.random.default_rng(7)
    goals = rng.uniform(-0.2, 0.2, (B, n)).astype(np.float32)
    x0 = torch.from_numpy(np.concatenate([rng.uniform(-0.3, 0.3, (B, n)), np.zeros((B, n))], 1).astype(np.float32))
    warm = torch.from_numpy(rng.uniform(-1.0, 1.0, (B, H, n)).astype(np.float32))
    mpc = build_batch_tracking_mpc(model, goals, B, H, DT, iterations=2)
    K = mpc.kernels
    assert K.form == "looped" and "_form" not in mpc.build_args
    assert K.plain().linearize == K.loop_linearize_plain
    got = mpc.solve(x0, warm)
    ref_mpc = build_batch_tracking_mpc(model, goals, B, H, DT, iterations=2)
    ref_mpc.kernels.linearize = lambda xs, us: MPCKernelSet.linearize_plain(ref_mpc.kernels, xs, us)
    ref = ref_mpc.solve(x0, warm)
    assert all(torch.equal(_bits(g), _bits(r)) for g, r in zip(got, ref))
    looped = build_batch_tracking_mpc(model, goals, B, H, DT, iterations=2, _form="looped")
    assert looped.build_args["_form"] == "looped" and looped.kernels.linearize_plain(
        *(torch.zeros(H, 2 * n, B), torch.zeros(H, n, B))).shape == (H, 2 * n, 3 * n, B)


def test_looped_solve_matches_jax_generic_ilqr_per_scenario():
    """The whole batched solve with K2's looped form, on the CPU, against
    JAX's generic iLQR (its array dynamics, ``make_step_fn(fused=False)``)
    scenario by scenario on the 7-joint Panda, at
    ``test_solve_matches_generic_ilqr_per_scenario``'s bars: cost rtol 1e-5,
    final state 5e-4, controls 5e-3; no torque limit on either side (the
    generic solver has none)."""
    B, H, iters, dt = 2, 4, 2, 0.01
    jm = jax_catalog.panda(dtype=jnp.float32)
    tm = from_host_arrays(jax_host_arrays(jax_catalog.panda(dtype=jnp.float64)), dtype=torch.float32, device=CPU)
    n = tm.num_joints
    rng = np.random.default_rng(11)
    lo, hi = tm.joint_lower.double().numpy(), tm.joint_upper.double().numpy()
    q0 = (lo + hi) / 2 + rng.uniform(-0.3, 0.3, (B, n)) * (hi - lo) / 2
    goals = (q0 + rng.uniform(-0.2, 0.2, (B, n))).astype(np.float32)
    x0 = np.concatenate([q0, np.zeros_like(q0)], 1).astype(np.float32)
    mpc = build_batch_tracking_mpc(tm, goals, B, H, dt, iterations=iters, u_limit=np.inf, _form="looped")
    us, xs, cost = mpc.solve(torch.from_numpy(x0), torch.zeros(B, H, n))
    step = jax_step_fn(jm, dt, fused=False)
    for s in range(B):
        running, terminal = jax_tracking_costs(jm, jnp.asarray(goals[s]))
        res = jax_ilqr(step, running, terminal, jnp.asarray(x0[s]), jnp.zeros((H, n), jnp.float32),
                       JaxILQRParams(horizon=H, dt=dt, iterations=iters), linearize_step_fn=step)
        np.testing.assert_allclose(float(cost[s]), float(res.cost), rtol=1e-5)
        np.testing.assert_allclose(xs[s, -1].numpy(), np.asarray(res.xs[-1]), atol=5e-4)
        np.testing.assert_allclose(us[s].numpy(), np.asarray(res.us), atol=5e-3)
