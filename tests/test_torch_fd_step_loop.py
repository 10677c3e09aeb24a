"""The looped step program (K0 as a loop over links, the robot's geometry in
a table) against the JAX package, and its C on the host.

* ``build_fd_step_loop`` (the step of ``LoopRollout``, the plain version of
  ``csrc/fd_step_loop.cuh``) against JAX's generic dynamics
  (``forward_dynamics_fast``, semi-implicit Euler, the limit clamps) on the
  26 fleet models, with ``test_step_program_matches_jax_dynamics``' bars:
  float64 within 1e-9; float32 within 1e-4 / 1e-3 / 2e-1 on q / dq / ddq
  plus 5e-4 of each dq and ddq entry's magnitude. JAX's step takes the
  model as an argument, so it compiles once per joint count.
* A 50-step ``LoopRollout`` against JAX's generic rollout on the
  programmatic UR5 and the Gen3: float64 within 1e-9 / 1e-9 / 1e-7, float32
  within the rollout tolerances 1e-4 / 1e-3 / 2e-1 plus, as above, 5e-4 of
  each dq and ddq entry's magnitude: the Gen3's wrist reaches ~2.4e4 rad/s^2
  under these torques, where the emitted plain version is 0.22 from JAX's
  too.
* The looped K1 unit (``csrc/fd_step_loop.cuh`` inside ``csrc/rollout.cuh``)
  compiled by the host g++ behind the ``__device__`` shim, its staged
  phases run thread by thread (``MPT_HOST_TEAM``), and its step alone, on
  six robots of n = 1 to 8: bit for bit ``LoopRollout``'s, with the host's
  ``sinf``, ``cosf`` and ``sqrtf`` replaced by PyTorch's own (the host libm
  and PyTorch's CPU maths differ in the last bit on some inputs; on the card
  the kernel's are ``torch.sin``'s), so within 1e-5 a fortiori.
* The table of a model built from the JAX package's host arrays is the
  port's own; one unit per joint count; the route's choice on each side of
  the threshold; the engine's plain version on CPU tensors.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import trajectory as jtraj
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch import trajectory as ttraj
from manipulapy_tpu_torch.models import catalog, from_host_arrays, host_arrays, make_robot_model, robot_data
from manipulapy_tpu_torch.ops import cuda_rollout
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.ops._build import library_key
from manipulapy_tpu_torch.ops.cuda_rollout import CHUNK, CudaRollout, loop_unit_source, step_form
from test_torch_fleet import DT, FLEET, G, IDS, JAX_STEP, _jax_model, _step_inputs

CPU = torch.device("cpu")
F64_TOL = (1e-9, 1e-9, 1e-7)
F32_TOL = (1e-4, 1e-3, 2e-1)


def _port_model(key, chain, dtype=torch.float32):
    return from_host_arrays(jax_host_arrays(_jax_model(key, chain, jnp.float64)), dtype=dtype, device=CPU)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("key, chain", FLEET, ids=IDS)
def test_loop_step_matches_jax_dynamics(key, chain, dtype):
    jm = _jax_model(key, chain, jnp.float64)
    host = jax_host_arrays(jm)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    tm = from_host_arrays(host, dtype=tdt, device=CPU)
    if dtype == "float32":
        jm = _jax_model(key, chain, jnp.float32)
    q, dq, tau = (x.astype(dtype) for x in _step_inputs(host))
    got = tfd.build_fd_step_loop(tm, DT, g=G, dtype=tdt)(*(torch.from_numpy(x) for x in (q, dq, tau)))
    ref = JAX_STEP(jm, *(jnp.asarray(x) for x in (q, dq, tau)))
    tols = (1e-9, 1e-9, 1e-9) if dtype == "float64" else (1e-4, 1e-3, 2e-1)
    for name, g_, r, tol in zip(("q", "dq", "ddq"), got, ref, tols):
        g_, r = g_.numpy(), np.asarray(r)
        assert g_.dtype == q.dtype and g_.shape == r.shape == q.shape and np.isfinite(r).all()
        rtol = tol if dtype == "float64" else (0.0 if name == "q" else 5e-4)
        np.testing.assert_allclose(g_, r, rtol=rtol, atol=tol, err_msg=name)


ROLLOUT_ROBOTS = {"ur5": lambda dt: jax_catalog.ur5(dtype=dt),
                  "gen3": lambda dt: _jax_model("gen3", True, dt)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("robot", sorted(ROLLOUT_ROBOTS))
def test_loop_rollout_matches_jax_over_50_steps(robot, dtype):
    jm = ROLLOUT_ROBOTS[robot](jnp.float64 if dtype == "float64" else jnp.float32)
    host = jax_host_arrays(jm)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    tm = from_host_arrays(host, dtype=tdt, device=CPU)
    B, N = 8, 50
    q0, dq0, _ = _step_inputs(host, B=B, seed=3)
    tau = np.random.default_rng(4).uniform(-1.0, 1.0, (B, N, len(q0[0]))) * np.minimum(host["torque_limit"], 10.0)
    x = [a.astype(dtype) for a in (q0, dq0, tau)]
    got = tfd.build_loop_rollout(tm, dt=DT)(*(torch.from_numpy(a) for a in x))
    ref = jtraj._forward_dynamics_trajectory_generic(jm, *(jnp.asarray(a) for a in x), dt=DT)
    for name, g_, r, tol in zip(("q", "dq", "ddq"), got, ref, F64_TOL if dtype == "float64" else F32_TOL):
        r = np.asarray(r)
        assert tuple(g_.shape) == r.shape == (B, N, len(q0[0])) and np.isfinite(r).all()
        rtol = 5e-4 if dtype == "float32" and name != "q" else 0.0
        np.testing.assert_allclose(g_.numpy(), r, rtol=rtol, atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# The looped unit on the host
# ---------------------------------------------------------------------------

_LOOP_HARNESS = """\
#include <math.h>
extern "C" {{ float (*mpt_host_fn[3])(float); }}
#define sinf(v) mpt_host_fn[0](v)
#define cosf(v) mpt_host_fn[1](v)
#define sqrtf(v) mpt_host_fn[2](v)
#define __device__
#define __forceinline__ inline
#define MPT_HOST_TEAM 1
{src}
#include <vector>
// The kernel's blocks of T = 32 threads, every phase thread by thread, its
// tiles NaN at every block.
extern "C" void run_team(const float* tab, const float* q0, const float* dq0, const float* tau,
                         float* qs, float* dqs, float* ddqs, int B, int N) {{
  std::vector<float> tiles(MPT_TILE_FLOATS(32));
  for (int b0 = 0; b0 < B; b0 += 32) {{
    for (float& x : tiles) x = __builtin_nanf("");
    rollout_block<32>(0, tiles.data(), q0, dq0, tau, qs, dqs, ddqs, b0, B, N, tab);
  }}
}}
// One step of each scenario, in place.
extern "C" void run_step(const float* tab, float* q, float* dq, const float* tau, float* ddq, int B) {{
  for (int b = 0; b < B; ++b) fd_step_loop(q + b * MPT_NJ, dq + b * MPT_NJ, tau + b * MPT_NJ, ddq + b * MPT_NJ, tab);
}}
"""
_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)
# PyTorch's float32 sin, cos and sqrt of one value, for the harness.
_TORCH_FNS = [_FN(lambda v, f=f: float(f(torch.tensor([v], dtype=torch.float32))[0]))
              for f in (torch.sin, torch.cos, torch.sqrt)]
HOST_ROBOTS = {  # n = 1, 6, 7, 7, 8, 8
    "robotiq_2f_85": lambda: robot_data.load_robot("robotiq_2f_85", chain_joints_only=True, device=CPU),
    "ur5": lambda: catalog.ur5(device=CPU),
    "panda": lambda: catalog.panda(device=CPU),
    "gen3": lambda: robot_data.load_robot("gen3", chain_joints_only=True, device=CPU),
    "panda_8": lambda: robot_data.load_robot("panda", chain_joints_only=True, device=CPU),
    "jaco_7dof": lambda: robot_data.load_robot("jaco_7dof", chain_joints_only=True, device=CPU),
}
SENTINEL = np.float32(-7.25e33)  # in every output entry before a run


@pytest.fixture(scope="module")
def loop_units(tmp_path_factory):
    """Per joint count, on first use: the looped K1 unit (intRes 1)
    compiled by g++ -O1 with the host harness."""
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to compile the kernel's C")
    libs, tmp = {}, tmp_path_factory.mktemp("loop_units")

    def get(n):
        if n not in libs:
            cpp, so = tmp / f"loop{n}.cpp", tmp / f"loop{n}.so"
            cpp.write_text(_LOOP_HARNESS.format(src=loop_unit_source(n, 1)))
            subprocess.run(["g++", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                           check=True, timeout=300)
            lib = ctypes.CDLL(str(so))
            fns = (ctypes.c_void_p * 3).in_dll(lib, "mpt_host_fn")
            for i, fn in enumerate(_TORCH_FNS):
                fns[i] = ctypes.cast(fn, ctypes.c_void_p).value
            lib.run_team.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
            lib.run_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
            libs[n] = lib
        return libs[n]

    return get


def _assert_same_bits(got, ref):
    """Equal bit for bit; NaN matches NaN (the payload may differ)."""
    for g, r in zip(got, ref):
        nan = np.isnan(r)
        assert np.array_equal(np.isnan(g), nan)
        assert np.array_equal(g.view(np.uint32)[~nan], r.view(np.uint32)[~nan])


def _limited_inputs(model, B, N, seed):
    host = host_arrays(model)
    n = model.num_joints
    rng = np.random.default_rng(seed)
    lo, hi = np.maximum(host["joint_lower"], -1.0), np.minimum(host["joint_upper"], 1.0)
    q0 = lo + rng.uniform(0.0, 1.0, (B, n)) * (hi - lo)
    arrays = (q0, rng.uniform(-0.5, 0.5, (B, n)), rng.uniform(-10.0, 10.0, (B, N, n)))
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("robot", list(HOST_ROBOTS))
def test_loop_unit_on_the_host_matches_loop_rollout(loop_units, robot):
    model = HOST_ROBOTS[robot]()
    n, B, N = model.num_joints, 2 * 32 + 5, 2 * CHUNK + 1
    lib = loop_units(n)
    q0, dq0, tau = _limited_inputs(model, B, N, seed=n)
    q0[B - 3, 0] = np.nan  # a NaN scenario stays its own
    plain = tfd.build_loop_rollout(model, dt=DT)
    tab = plain.table.numpy()
    assert tab.dtype == np.float32 and tab.size == tfd.HEAD_FLOATS + n * tfd.LINK_STRIDE
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    outs = [np.full((B + 32, N, n), SENTINEL, np.float32) for _ in range(3)]
    lib.run_team(ptr(tab), ptr(q0), ptr(dq0), ptr(tau), *map(ptr, outs), B, N)
    for o in outs:
        assert (o[B:] == SENTINEL).all(), "a write past the last scenario"
    ref = [x.numpy() for x in plain(*(torch.from_numpy(a) for a in (q0, dq0, tau)))]
    _assert_same_bits([o[:B] for o in outs], ref)
    assert np.isnan(ref[0][B - 3, 1:]).all() and np.isfinite(np.delete(ref[0], B - 3, axis=0)).all()
    # The step alone, within 1e-5 of the plain step.
    q, dq, t = (np.ascontiguousarray(a) for a in (q0[:B - 3], dq0[:B - 3], tau[:B - 3, 0]))
    ddq = np.empty_like(q)
    step = tfd.build_fd_step_loop(model, DT)(*(torch.from_numpy(a) for a in (q, dq, t)))
    lib.run_step(ptr(tab), ptr(q), ptr(dq), ptr(t), ptr(ddq), B - 3)
    for got, want in zip((q, dq, ddq), step):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The table, the units and the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key, chain", FLEET, ids=IDS)
def test_table_of_jax_host_arrays_is_the_ports_own(key, chain):
    """A model made by ``from_host_arrays`` from the JAX package's robot
    gives the port's own table for that robot, value for value."""
    port = robot_data.load_robot(key, chain_joints_only=chain, device=CPU)
    ours = tfd.link_table(port, DT, G)
    theirs = tfd.link_table(_port_model(key, chain), DT, G)
    assert ours.dtype == torch.float32 and ours.shape == (tfd.HEAD_FLOATS + port.num_joints * tfd.LINK_STRIDE,)
    assert torch.equal(ours.view(torch.int32), theirs.view(torch.int32))
    assert torch.equal(tfd.link_table(port, DT, G, dtype=torch.float64).float(), ours)


def test_robots_side_by_side_keep_their_own_bits():
    """Robots of one joint count in one plain call, a column of the table a
    row, give each robot's own ``LoopRollout`` bits."""
    models = [robot_data.load_robot(k, chain_joints_only=True, device=CPU) for k in ("ur10", "xarm6", "abb_irb2400")]
    inputs = [[torch.from_numpy(a) for a in _limited_inputs(m, 3 + i, 5, seed=i)] for i, m in enumerate(models)]
    plains = [tfd.build_loop_rollout(m, dt=DT) for m in models]
    tab = torch.cat([p.table[:, None].expand(-1, x[0].shape[0]) for p, x in zip(plains, inputs)], dim=1)
    both = tfd.loop_rollout_plain(tab, 6, 1, *(torch.cat([x[i] for x in inputs]) for i in range(3)))
    at = 0
    for p, x in zip(plains, inputs):
        rows = x[0].shape[0]
        for got, ref in zip(both, p(*x)):
            assert torch.equal(got[at:at + rows].view(torch.int32), ref.view(torch.int32))
        at += rows


def test_table_layout_and_clip_flags():
    model = catalog.ur5(device=CPU)
    at = lambda k, name: tfd.HEAD_FLOATS + k * tfd.LINK_STRIDE + tfd.LINK_AT[name]
    tab = tfd.link_table(model, 0.005, (0.0, 0.5, -9.0))
    assert tab[tfd.HEAD_AT["dt"]] == np.float32(0.005) and tab[1:4].tolist() == [0.0, 0.5, -9.0]
    host = host_arrays(model)
    assert tab[at(2, "lower")] == np.float32(host["joint_lower"][2])
    assert tab[at(5, "m")] == np.float32(host["inertias"][5][3, 3])
    free = tfd.link_table(model, 0.005, clip_limits=False, clip_velocity=False)
    assert free[at(2, "lower")] == -np.inf and free[at(2, "upper")] == np.inf and free[at(2, "vel")] == np.inf
    assert "#define MPT_TAB_STRIDE %d" % tfd.LINK_STRIDE in tfd.table_defines()


def test_one_unit_per_joint_count():
    """The robot is the table: robots of one n share a unit source (one
    build), robots of different n or intRes do not."""
    ur5, xarm6 = catalog.ur5(device=CPU), robot_data.load_robot("xarm6", chain_joints_only=True, device=CPU)
    gen3, iiwa7 = (robot_data.load_robot(k, chain_joints_only=True, device=CPU) for k in ("gen3", "iiwa7"))
    a, b = CudaRollout(ur5, _form="looped"), CudaRollout(xarm6, _form="looped")
    assert a.source == b.source and library_key(a.source, "rollout") == library_key(b.source, "rollout")
    assert not torch.equal(a.table, b.table)
    assert loop_unit_source(7, 1) == CudaRollout(gen3, _form="looped").source == CudaRollout(iiwa7, _form="looped").source
    assert len({loop_unit_source(n, 1) for n in (1, 6, 7, 8)} | {loop_unit_source(6, 3)}) == 5
    assert "#define MPT_LOOP_STEP" in a.source and "fd_step_loop(" in a.source and "void fd_step(" not in a.source
    assert a.form == "looped" and a.loop_ops == tfd.loop_step_ops(6) and a.statements == CudaRollout(ur5).statements


@pytest.mark.parametrize("below, above", [
    (("catalog", "ur5"), ("chain", "ur10")),        # 6 joints: 2982 and 4336 statements
    (("catalog", "panda"), ("chain", "iiwa7")),     # 7: 4662 and 5897
    (("chain", "panda"), ("chain", "jaco_7dof")),   # 8: 5452 and 7732
])
def test_route_takes_the_looped_form_past_the_threshold(monkeypatch, below, above):
    """One robot on each side of its joint count's threshold, and the bound
    itself."""
    load = lambda src, key: (getattr(catalog, key)(device=CPU) if src == "catalog"
                             else robot_data.load_robot(key, chain_joints_only=True, device=CPU))
    lo, hi = load(*below), load(*above)
    n = lo.num_joints
    a, b = CudaRollout(lo), CudaRollout(hi)
    assert n == hi.num_joints and a.statements <= cuda_rollout.loop_threshold(n) < b.statements
    assert (a.form, b.form) == ("emitted", "looped")
    assert isinstance(a.plain, tfd.Rollout) and isinstance(b.plain, tfd.LoopRollout)
    monkeypatch.setitem(cuda_rollout.LOOP_THRESHOLDS, n, a.statements)
    assert step_form(lo, a.statements) == "emitted"
    monkeypatch.setitem(cuda_rollout.LOOP_THRESHOLDS, n, a.statements - 1)
    assert step_form(lo, a.statements) == "looped" and CudaRollout(lo).form == "looped"


def test_route_takes_the_looped_form_for_one_joint():
    gripper = robot_data.load_robot("robotiq_2f_85", chain_joints_only=True, device=CPU)
    assert cuda_rollout.loop_threshold(1) == 0 and CudaRollout(gripper).form == "looped"
    assert cuda_rollout.loop_threshold(2) == cuda_rollout.LOOP_THRESHOLD


def test_a_general_inertia_keeps_the_emitted_form():
    """The looped step takes CoM-frame inertias [[I, 0], [0, m 1]]; a model
    with another stays on the emitted step, and its table is refused."""
    G = np.tile(np.eye(6), (2, 1, 1))
    G[1, 0, 4] = G[1, 4, 0] = 0.1
    S = np.array([[0, 0, 1, 0, 0, 0], [0, 1, 0, -0.5, 0, 0]], dtype=np.float64)
    model = make_robot_model(np.eye(4), S, inertias=G, device=CPU)
    assert not tfd.loop_supported(model) and tfd.loop_supported(catalog.ur5(device=CPU))
    assert step_form(model, 10**9) == "emitted"
    with pytest.raises(ValueError):
        tfd.link_table(model, DT)


def test_looped_engine_on_cpu_tensors_runs_its_plain_version():
    model = robot_data.load_robot("gen3", chain_joints_only=True, device=CPU)
    engine = CudaRollout(model, _form="looped")
    x = [torch.from_numpy(a) for a in _limited_inputs(model, 5, 4, seed=1)]
    before, counts = CudaRollout.launch_count, dict(CudaRollout.launch_counts)
    got = engine(*x)
    ref = tfd.build_loop_rollout(model)(*x)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert engine.launches == 0 and CudaRollout.launch_count == before and CudaRollout.launch_counts == counts
    with pytest.raises(ValueError):
        CudaRollout(model, _form="straight")


def test_public_cpu_route_stays_the_emitted_plain_version():
    """On the CPU the public route runs the emitted plain rollout for every
    robot, the looped form's too, bit for bit as before."""
    model = robot_data.load_robot("jaco_7dof", chain_joints_only=True, device=CPU)
    assert CudaRollout(model).form == "looped"
    x = [torch.from_numpy(a) for a in _limited_inputs(model, 3, 4, seed=2)]
    got = ttraj.forward_dynamics_trajectory(model, *x)
    ref = tfd.build_rollout(model)(*x)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
