"""The port's URDF layer against the JAX package's.

* The parser and ``URDF`` on every vendored robot file and every fixture of
  ``tests/urdf_fixtures``: the parsed document (names, types, origins,
  axes, limits, inertials, geometry), the tree, ``link_fk``,
  ``link_fk_batch`` and ``extract_screw_axes`` equal bit for bit; a file
  one package refuses, the other refuses with the same error;
  ``validate``'s issues and ``urdf_to_xml``'s document the same.
* ``URDFToRobotModel`` from a path, a string and a catalog name (which
  resolves through the DH catalog, as in JAX): FK, batched FK, Jacobians,
  inverse and forward dynamics in f64 within 1e-9; the ``joint_limits``
  override, a derivative without host arrays whose step program folds the
  tensors read back, rolled out against JAX's rollout.
* The calibrated robots through K1's plain version
  (``ops/fd_step.py::build_rollout``, which the public rollout takes on the
  CPU) against the JAX package's rollout: float32 at B=8, N=20 within 1e-4
  on q, 1e-3 on dq and 2e-1 on ddq for the UR5, the Panda arm and the
  8-joint Panda; the Gen3 in float32 over N=8 only (its ddq reaches 5.7e4
  rad/s^2 under these torques and leaves the 2e-1 bar at step 9, 7e-6 of
  its scale) and all four in float64 at N=20 within 1e-9 on states and
  1e-7 on ddq. The JAX reference is its generic rollout
  (``trajectory._forward_dynamics_trajectory_generic``, the same step
  semantics as its engines), which compiles in seconds where its emitted
  step program takes up to a minute a robot on a CPU.
* The batched solve's plain path on the calibrated Panda arm (B=4, H=6, 2
  iterations) against an independent generic iLQR solve per scenario at
  the JAX tests' bars (cost rtol 1e-5, final state atol 5e-4, controls atol
  5e-3), and its states against JAX's rollout of its controls. The JAX
  package's own batched solve needs interpret mode on a CPU, which does not
  finish building the Panda arm's program in 25 minutes; its generic iLQR
  takes minutes to compile for 7 joints.
* ``URDFModifier``, ``process_xacro``, ``Scene``, the mesh loaders (the
  native and the pure-Python loader equal, and equal to JAX's), the
  primitives, ``CollisionChecker`` and ``build_link_adjacency``, and the
  matplotlib views where matplotlib is installed.
"""

import dataclasses
import enum
import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import dynamics as jdyn
from manipulapy_tpu import potential_field as jpf
from manipulapy_tpu import trajectory as jtraj
from manipulapy_tpu import urdf as ju
from manipulapy_tpu.models import robot_data as jax_robot_data
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.urdf import geometry as jgeom
from manipulapy_tpu_torch import native, potential_field, trajectory
from manipulapy_tpu_torch import urdf as tu
from manipulapy_tpu_torch.models import catalog, data, host_arrays, robot_data
from manipulapy_tpu_torch.mpc.costs import make_tracking_costs
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc
from manipulapy_tpu_torch.mpc.ilqr import ILQRParams, ilqr, make_step_fn
from manipulapy_tpu_torch.ops import fd_step as tfd
from manipulapy_tpu_torch.planner import TrajectoryPlanner
from manipulapy_tpu_torch.sim import Simulation
from manipulapy_tpu_torch.urdf import geometry as tgeom

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "urdf_fixtures")
PORT_DATA = os.path.join(REPO, "manipulapy_tpu_torch", "data", "robots")
ROBOT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), PORT_DATA) for d, _, fs in os.walk(PORT_DATA) for f in fs if f.endswith(".urdf")
)
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".urdf"))
DOCUMENTS = [os.path.join(PORT_DATA, f) for f in ROBOT_FILES] + [os.path.join(FIXTURES, f) for f in FIXTURE_FILES]
F64_TOL = (1e-9, 1e-9, 1e-7)
F32_TOL = (1e-4, 1e-3, 2e-1)
PANDA_ARM = dict(tip_link="panda_hand", chain_joints_only=True)


def _same(a, b, where="doc"):
    """Structural equality across the two packages' classes: the same class
    name and fields, arrays bit for bit (NaN and inf in the same places)."""
    if isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name and a.value == b.value, where
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and (a == b or (a != a and b != b)), where
    elif dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, where
        assert list(vars(a)) == list(vars(b)), where
        for k in vars(a):
            _same(getattr(a, k), getattr(b, k), f"{where}.{k}")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _load(pkg, path):
    try:
        return pkg.URDF.load(path), None
    except Exception as e:  # the JAX package's refusal is the reference
        return None, e


@pytest.mark.parametrize("path", DOCUMENTS, ids=lambda p: os.path.relpath(p, REPO))
def test_urdf_matches_jax(path):
    _same(tu.URDFParser().parse_file(path), ju.URDFParser().parse_file(path), "parsed")
    _same(tu.validate(tu.URDFParser().parse_file(path)), ju.validate(ju.URDFParser().parse_file(path)), "validate")
    port, port_err = _load(tu, path)
    ref, ref_err = _load(ju, path)
    if ref_err is not None:
        assert type(port_err) is type(ref_err) and str(port_err) == str(ref_err)
        return
    assert port_err is None
    _same(port.robot, ref.robot, "robot")
    for attr in ("roots", "base_link", "topological_links", "end_links"):
        _same(getattr(port, attr), getattr(ref, attr), attr)
    assert [j.name for j in port.actuated_joints] == [j.name for j in ref.actuated_joints]
    assert port.default_tip_link() == ref.default_tip_link()
    assert port.get_chain() == ref.get_chain()
    _same(port.joint_limits, ref.joint_limits, "joint_limits")
    _same(port.link_radii(), ref.link_radii(), "link_radii")
    assert tu.urdf_to_xml(port.robot) == ju.urdf_to_xml(ref.robot)
    n = len(ref.actuated_joints)
    cfgs = np.random.default_rng(n).uniform(-1.0, 1.0, (5, n))
    _same(port.link_fk_batch(cfgs), ref.link_fk_batch(cfgs), "link_fk_batch")
    cfg = {j.name: float(v) for j, v in zip(ref.actuated_joints, cfgs[0])}
    _same(port.link_fk(cfg), ref.link_fk(cfg), "link_fk")
    for chain_only in (False, True):
        try:
            want = ref.extract_screw_axes(chain_joints_only=chain_only)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                port.extract_screw_axes(chain_joints_only=chain_only)
            continue
        _same(port.extract_screw_axes(chain_joints_only=chain_only), want, f"extract_screw_axes({chain_only})")


def test_parser_errors_match_jax():
    for bad in ("<robot name='x'><link name='a'/><joint name='j' type='bogus'/></robot>", "not xml at all",
                "<robot name='x'><link name='a'/><link name='a'/></robot>"):
        errors = []
        for pkg in (ju, tu):
            try:
                pkg.URDF.from_string(bad)
                errors.append(None)
            except Exception as e:  # compared below
                errors.append((type(e).__name__, str(e)))
        assert errors[0] == errors[1], bad
    resolver = (tu.PackageResolver({"pkg": "/opt/pkg"}), ju.PackageResolver({"pkg": "/opt/pkg"}))
    for uri in ("package://pkg/meshes/a.stl", "meshes/b.stl", "file:///c.stl"):
        assert resolver[0].resolve(uri, "/base") == resolver[1].resolve(uri, "/base")


def _f64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(port, ref, tol=1e-9):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["path", "string", "name"])
def test_processor_matches_jax(kind):
    path = robot_data.get_robot_urdf("gen3")
    source = {"path": path, "string": open(path, encoding="utf-8").read(), "name": "ur5"}[kind]
    port = tu.URDFToRobotModel(source, dtype=torch.float64, device=CPU)
    ref = ju.URDFToRobotModel(source, dtype=jnp.float64)
    assert host_arrays(port.model)["digest"] == jax_host_arrays(ref.model)["digest"]
    if kind == "name":  # the DH catalog's robot, as in JAX, not the calibrated one
        assert host_arrays(port.model)["digest"] == host_arrays(data.load_robot("ur5", dtype=torch.float64, device=CPU))["digest"]
        assert host_arrays(port.model)["digest"] != host_arrays(robot_data.load_robot("ur5", dtype=torch.float64, device=CPU))["digest"]
    _same(port.robot_data(), {k: np.asarray(v) if not isinstance(v, list) else v for k, v in ref.robot_data().items()})
    n = port.num_joints
    rng = np.random.default_rng(7)
    q, dq, ddq, tau = (rng.uniform(-1, 1, (4, n)) for _ in range(4))
    jm = ref.model
    _close(port.forward_kinematics(q[0]), ref.forward_kinematics(q[0]))
    _close(port.forward_kinematics(q[0], frame="body"), ref.forward_kinematics(q[0], frame="body"))
    _close(port.batch_forward_kinematics(q), ref.batch_forward_kinematics(q))
    _close(port.jacobian(q[1]), ref.jacobian(q[1]))
    _close(port.jacobian(q[1], frame="body"), ref.jacobian(q[1], frame="body"))
    _close(port.inverse_dynamics(q[2], dq[2], ddq[2]), jdyn.inverse_dynamics(jm, jnp.asarray(q[2]), jnp.asarray(dq[2]), jnp.asarray(ddq[2])))
    _close(port.forward_dynamics(q[3], dq[3], tau[3]), jdyn.forward_dynamics(jm, jnp.asarray(q[3]), jnp.asarray(dq[3]), jnp.asarray(tau[3])))
    assert isinstance(port.planner(), TrajectoryPlanner) and isinstance(port.simulation(), Simulation)
    with pytest.raises(ValueError, match="unknown IK method"):
        port.inverse_kinematics(port.forward_kinematics(q[0]), method="newton")


def test_processor_ik_reaches_an_fk_pose():
    port = tu.URDFToRobotModel(robot_data.get_robot_urdf("ur5"), dtype=torch.float64, device=CPU)
    q = torch.tensor([0.1, -0.5, 0.8, 0.2, -0.3, 1.1], dtype=torch.float64)
    res = port.inverse_kinematics(port.forward_kinematics(q), theta0=q + 0.1, max_iterations=100)
    assert bool(res.success) and float(res.trans_err) < 1e-6


def test_joint_limits_override_rolls_out_as_jax():
    """The override is a derivative without host arrays: the step program
    folds its tensors read back, so the override's clamps hold."""
    path = robot_data.get_robot_urdf("ur5")
    lower, upper = -0.3 * np.ones(6), 0.4 * np.ones(6)
    port = tu.URDFToRobotModel(path, joint_limits=(lower, upper), dtype=torch.float64, device=CPU)
    ref = ju.URDFToRobotModel(path, joint_limits=(lower, upper), dtype=jnp.float64)
    assert host_arrays(port.model) is None and jax_host_arrays(ref.model) is None
    np.testing.assert_array_equal(port.model.joint_lower.numpy(), lower)
    x = _inputs(port.model, 8, 20, np.float64, seed=3)
    got = trajectory.forward_dynamics_trajectory(port.model, *(torch.from_numpy(v) for v in x))
    want = jtraj._forward_dynamics_trajectory_generic(ref.model, *(jnp.asarray(v) for v in x), None, None, 0.01, 1)
    _compare(got, want, F64_TOL)
    q = got[0].numpy()
    assert q.min() == -0.3 and q.max() == 0.4  # the clamps bite


# ---------------------------------------------------------------------------
# The calibrated robots through K1's plain version
# ---------------------------------------------------------------------------

ROLLOUT_ROBOTS = {"ur5": ("ur5", {}), "gen3": ("gen3", {}), "panda_arm": ("panda", PANDA_ARM), "panda": ("panda", {})}
ROLLOUT_CASES = [(r, "float32", 20) for r in ("ur5", "panda_arm", "panda")] + [("gen3", "float32", 8)]
ROLLOUT_CASES += [(r, "float64", 20) for r in ROLLOUT_ROBOTS]


def _inputs(model, B, N, dtype, seed=0):
    """q0 uniform within each joint's limits clipped to [-1, 1], dq0 in
    [-0.5, 0.5], tau in [-10, 10] (the smoke's distributions)."""
    rng = np.random.default_rng(seed)
    n = model.num_joints
    lo = np.maximum(model.joint_lower.double().numpy(), -1.0)
    hi = np.minimum(model.joint_upper.double().numpy(), 1.0)
    q0 = rng.uniform(lo, hi, (B, n))
    dq0 = rng.uniform(-0.5, 0.5, (B, n))
    tau = rng.uniform(-10.0, 10.0, (B, N, n))
    return [v.astype(dtype) for v in (q0, dq0, tau)]


def _compare(port_out, jax_out, tols):
    for p, j, tol in zip(port_out, jax_out, tols):
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=tol)


@pytest.mark.parametrize("robot,dtype,N", ROLLOUT_CASES)
def test_calibrated_rollout_matches_jax(robot, dtype, N):
    name, kw = ROLLOUT_ROBOTS[robot]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tm = robot_data.load_robot(name, dtype=tdt, device=CPU, **kw)
    jm = jax_robot_data.load_robot(name, dtype=jdt, **kw)
    x = _inputs(tm, 8, N, np.dtype(dtype))
    plain = tfd.build_rollout(tm, dt=0.01)(*(torch.from_numpy(v) for v in x))
    public = trajectory.forward_dynamics_trajectory(tm, *(torch.from_numpy(v) for v in x), dt=0.01)
    for p, q in zip(plain, public):
        assert torch.equal(p, q)  # the public entry point takes the plain version on the CPU
    ref = jtraj._forward_dynamics_trajectory_generic(jm, *(jnp.asarray(v) for v in x), None, None, 0.01, 1)
    _compare(plain, ref, F32_TOL if dtype == "float32" else F64_TOL)
    if name == "panda" and not kw:  # the prismatic finger stays inside its clamps after the first row
        q, dq = plain[0][:, 1:, 7], plain[1][:, 1:, 7]
        assert bool((q >= 0).all() and (q <= 0.04).all() and (dq.abs() <= 0.2).all())


# ---------------------------------------------------------------------------
# The batched solve on the calibrated Panda arm
# ---------------------------------------------------------------------------


def test_batched_solve_on_the_panda_arm():
    B, H, iters, dt = 4, 6, 2, 0.01
    tm = catalog.get_robot("panda", source="calibrated", device=CPU, **PANDA_ARM)
    lo, hi = tm.joint_lower.double().numpy(), tm.joint_upper.double().numpy()
    rng = np.random.default_rng(0)
    q0 = (lo + hi) / 2 + rng.uniform(-1, 1, (B, 7)) * 0.5 * (hi - lo) / 2
    goals = np.clip(q0 + rng.uniform(-0.3, 0.3, (B, 7)), lo, hi).astype(np.float32)
    x0 = np.concatenate([q0, np.zeros_like(q0)], axis=1).astype(np.float32)
    # At the model's torque limits, as on the main path: inside them, and
    # below the zero-control cost.
    mpc = build_batch_tracking_mpc(tm, goals, B, H, dt, iterations=iters)
    us, xs, cost = mpc.solve(torch.from_numpy(x0), torch.zeros(B, H, 7))
    assert bool((us.abs() <= tm.torque_limit).all()) and bool((us.abs() == tm.torque_limit).any())
    _, _, cost_zero = build_batch_tracking_mpc(tm, goals, B, H, dt, iterations=0).solve(
        torch.from_numpy(x0), torch.zeros(B, H, 7))
    assert bool((cost < cost_zero).all())
    # Without them, the problem the generic iLQR solves.
    mpc = build_batch_tracking_mpc(tm, goals, B, H, dt, iterations=iters, u_limit=[np.inf] * 7)
    us, xs, cost = mpc.solve(torch.from_numpy(x0), torch.zeros(B, H, 7))
    step = make_step_fn(tm, dt)
    for s in range(B):
        running, terminal = make_tracking_costs(tm, torch.from_numpy(goals[s]))
        res = ilqr(step, running, terminal, torch.from_numpy(x0[s]), torch.zeros(H, 7),
                   ILQRParams(horizon=H, dt=dt, iterations=iters, line_search_steps=6))
        np.testing.assert_allclose(float(cost[s]), float(res.cost), rtol=1e-5)
        np.testing.assert_allclose(xs[s, -1].numpy(), res.xs[-1].numpy(), atol=5e-4)
        np.testing.assert_allclose(us[s].numpy(), res.us.numpy(), atol=5e-3)
    # JAX's rollout of the solve's controls (row t the state before control
    # t) lands on its states.
    jm = jax_robot_data.load_robot("panda", dtype=jnp.float32, **PANDA_ARM)
    qs, dqs, _ = jtraj._forward_dynamics_trajectory_generic(
        jm, jnp.asarray(x0[:, :7]), jnp.asarray(x0[:, 7:]), jnp.asarray(us.numpy()), None, None, dt, 1)
    np.testing.assert_allclose(xs[:, :H, :7].numpy(), np.asarray(qs), atol=5e-4)
    np.testing.assert_allclose(xs[:, :H, 7:].numpy(), np.asarray(dqs), atol=5e-4)


# ---------------------------------------------------------------------------
# Modifiers, xacro, scenes, meshes, collision
# ---------------------------------------------------------------------------


def _edit(pkg, path, tmp):
    mod = pkg.URDFModifier(pkg.URDF.load(path))
    mod.set_joint_origin("elbow_joint", xyz=[0.0, -0.13, 0.43], rpy=[0.0, 0.01, 0.0])
    mod.set_joint_axis("wrist_1_joint", [0.0, 2.0, 0.1])
    mod.set_joint_limits("shoulder_pan_joint", lower=-1.5, upper=1.5, effort=100.0, velocity=2.0)
    mod.set_joint_zero_offset("wrist_2_joint", 0.05)
    mod.set_link_mass("forearm_link", 2.5)
    mod.set_link_inertia("forearm_link", np.diag([0.01, 0.02, 0.03]))
    mod.set_link_com("upper_arm_link", [0.0, 0.0, 0.21])
    mod.scale_masses(1.1, links=["wrist_1_link", "wrist_2_link"])
    mod.attach_payload("wrist_3_link", mass=0.5, com_offset=(0.0, 0.0, 0.05))
    mod.rename_link("wrist_3_link", "tool_flange")
    mod.rename_joint("wrist_3_joint", "tool_flange_joint")
    cal = os.path.join(tmp, f"{pkg.__name__}.json")
    mod.save_calibration(cal)
    again = pkg.URDFModifier(pkg.URDF.load(path))
    again.load_calibration(cal)
    with open(cal, encoding="utf-8") as f:
        return mod.to_xml(), f.read(), again.to_xml(), mod.modified_urdf().extract_screw_axes()


def test_modifier_matches_jax(tmp_path):
    path = robot_data.get_robot_urdf("ur5")
    port, ref = _edit(tu, path, str(tmp_path)), _edit(ju, path, str(tmp_path))
    assert port[:3] == ref[:3]
    _same(port[3], ref[3], "extract_screw_axes")


XACRO = """
<robot name="x" xmlns:xacro="http://www.ros.org/wiki/xacro">
  <xacro:property name="len" value="0.4"/>
  <xacro:property name="with_tool" value="1"/>
  <xacro:include filename="inc.xacro"/>
  <xacro:macro name="leg" params="name length">
    <link name="${name}"/>
    <joint name="${name}_j" type="revolute">
      <parent link="base"/><child link="${name}"/>
      <origin xyz="0 0 ${length * 2}"/><axis xyz="0 0 1"/>
      <limit lower="${-pi/2}" upper="${pi/2}" effort="10" velocity="1"/>
    </joint>
  </xacro:macro>
  <link name="base"/>
  <xacro:leg name="left" length="${len}"/>
  <xacro:leg name="right" length="0.5"/>
  <xacro:if value="${with_tool}"><link name="tool"/>
    <joint name="tj" type="fixed"><parent link="left"/><child link="tool"/></joint></xacro:if>
  <xacro:unless value="${with_tool}"><link name="stub"/></xacro:unless>
</robot>
"""


def test_xacro_matches_jax(tmp_path):
    (tmp_path / "inc.xacro").write_text(
        '<robot xmlns:xacro="http://www.ros.org/wiki/xacro"><link name="extra"/>'
        '<joint name="ej" type="fixed"><parent link="base"/><child link="extra"/></joint></robot>')
    src = tmp_path / "robot.urdf.xacro"
    src.write_text(XACRO)
    for proc in ((tu.process_xacro, ju.process_xacro),
                 (tu.XacroProcessor(prefer_external=False).process_file,
                  ju.XacroProcessor(prefer_external=False).process_file)):
        assert proc[0](str(src)) == proc[1](str(src))
    out = tu.process_xacro(str(src), mappings={"len": "0.7"})
    assert out == ju.process_xacro(str(src), mappings={"len": "0.7"})
    assert "extra" in tu.URDF.from_string(out).link_map


def test_scene_matches_jax():
    scenes = []
    for pkg in (tu, ju):
        scene = pkg.Scene()
        scene.add_robot("ur5", pkg.URDF.load(robot_data.get_robot_urdf("ur5")), base_position=[0.0, 0.0, 0.0])
        scene.add_robot("gen3", pkg.URDF.load(robot_data.get_robot_urdf("gen3")), base_position=[0.6, 0.1, 0.0])
        scene.add_robot("far", pkg.URDF.load(robot_data.get_robot_urdf("iiwa7")),
                        base_transform=np.array([[0, -1, 0, 5], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]))
        scene.robots["ur5"].set_joint_values(np.linspace(-1, 1, 6))
        scene.robots["gen3"].set_joint_values(np.linspace(1, -1, 7))
        scenes.append(scene)
    port, ref = scenes
    _same(port.all_world_link_fk(), ref.all_world_link_fk(), "world_link_fk")
    for name in ("ur5", "gen3", "far"):
        _same(port.world_end_effector(name), ref.world_end_effector(name), name)
        _same(port.robot_aabb(name, margin=0.01), ref.robot_aabb(name, margin=0.01), name)
    _same(port.check_robot_collision("ur5", "gen3"), ref.check_robot_collision("ur5", "gen3"), "collision")
    _same(port.check_all_collisions(margin=0.05), ref.check_all_collisions(margin=0.05), "all")
    port.remove_robot("far")
    ref.remove_robot("far")
    assert sorted(port.robots) == sorted(ref.robots)


def _mesh_files(tmp_path):
    rng = np.random.default_rng(0)
    tris = np.concatenate([jgeom.box_mesh((0.2, 0.3, 0.4)).vertices[jgeom.box_mesh((0.2, 0.3, 0.4)).faces],
                           rng.uniform(-1, 1, (5, 3, 3))])
    binary, ascii_, obj = tmp_path / "m.stl", tmp_path / "a.stl", tmp_path / "m.obj"
    with open(binary, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris.astype(np.float32):
            f.write(struct.pack("<3f", 0.0, 0.0, 1.0) + struct.pack("<9f", *t.ravel()) + struct.pack("<H", 0))
    with open(ascii_, "w") as f:
        f.write("solid t\n")
        for t in tris:
            f.write(" facet normal 0 0 1\n  outer loop\n")
            f.writelines(f"   vertex {float(v[0])!r} {float(v[1])!r} {float(v[2])!r}\n" for v in t)
            f.write("  endloop\n endfacet\n")
        f.write("endsolid t\n")
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\nf 1/1/1 2/2/2 3/3/3 4/4/4\nf -1 1 2\nf 5 2 3\n")
    return binary, ascii_, obj


def test_mesh_loaders_match_jax(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("the host has no g++ to build the native mesh loader")
    files = _mesh_files(tmp_path)
    assert native.available()
    assert os.path.dirname(native.library_path()) == os.path.join(REPO, "build", "manipulapy_tpu_torch", "native")
    assert os.path.exists(native.library_path())
    loaded = {}
    for route in ("native", "python"):
        if route == "python":
            monkeypatch.setattr(tgeom, "_try_native", lambda *a: None)
        loaded[route] = [tgeom.load_stl(str(files[0])), tgeom.load_stl(str(files[1])), tgeom.load_obj(str(files[2])),
                         tgeom.load_mesh(str(files[0]), scale=[2.0, 1.0, 0.5])]
    monkeypatch.setattr(jgeom, "_try_native", lambda *a: None)
    ref = [jgeom.load_stl(str(files[0])), jgeom.load_stl(str(files[1])), jgeom.load_obj(str(files[2])),
           jgeom.load_mesh(str(files[0]), scale=[2.0, 1.0, 0.5])]
    for route, meshes in loaded.items():
        for got, want in zip(meshes, ref):
            _same(tuple(got), tuple(want), route)
    _same(native.load_stl(str(files[1])), tuple(ref[1]), "native ascii")


def test_primitives_match_jax():
    for make, args in (("box_mesh", ((0.1, 0.2, 0.3),)), ("cylinder_mesh", (0.05, 0.3, 12)), ("sphere_mesh", (0.2, 6))):
        got, want = getattr(tgeom, make)(*args), getattr(jgeom, make)(*args)
        _same(tuple(got), tuple(want), make)
        _same(tgeom.mesh_aabb(got), jgeom.mesh_aabb(want), make)
        _same(tgeom.mesh_bounding_sphere(got), jgeom.mesh_bounding_sphere(want), make)


@pytest.mark.parametrize("fixture", ["primitives.urdf", "simple_arm.urdf"])
def test_collision_checker_matches_jax(fixture):
    path = os.path.join(FIXTURES, fixture)
    port = potential_field.CollisionChecker(tu.URDF.load(path))
    ref = jpf.CollisionChecker(ju.URDF.load(path))
    assert port.allowed == ref.allowed
    assert potential_field.build_link_adjacency(port.urdf) == jpf.build_link_adjacency(ref.urdf)
    _same(port.link_points, ref.link_points, "link_points")
    n = len(ref.urdf.actuated_joints)
    cfgs = np.random.default_rng(1).uniform(-np.pi, np.pi, (32, n))
    hits = 0
    for q in cfgs:
        pairs = port.colliding_pairs(q)
        assert pairs == ref.colliding_pairs(q)
        assert port.check_collision(q) == ref.check_collision(q)
        hits += bool(pairs)
    assert 0 <= hits <= 32


def test_views_where_matplotlib_is_installed():
    pytest.importorskip("matplotlib")
    urdf = tu.URDF.load(robot_data.get_robot_urdf("ur5"))
    fig = urdf.show(cfg={"shoulder_lift_joint": -0.5}, title="ur5")
    assert fig.axes[0].get_title() == "ur5"
    anim = tu.animate_robot(urdf, [{}, {"elbow_joint": 0.4}])
    assert anim is not None
    import matplotlib.pyplot as plt

    plt.close("all")
