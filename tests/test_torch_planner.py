"""The planning path as a whole, through both packages' planners.

``create_planner`` on the same robot (from one set of host arrays) and the
same obstacle cloud, then plan -> avoidance -> inverse dynamics -> rollout
through the planners' methods, on inputs from
``numpy.random.default_rng``. Tolerances: float32 1e-4 / 1e-3 / 2e-1 on q /
dq / ddq of the rollout (the JAX package's rollout tolerances: ddq reaches
~1e3 on the wrist joints) and 1e-4 on the plan, 5e-3 on its torques (the
wrist's torques are sums of cancelling terms of ~1e2); float64 1e-8 on
everything (the avoidance pass carries the summation-order differences over
its gradient steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import kinematics as jkin
from manipulapy_tpu import planner as jplanner
from manipulapy_tpu import potential_field as jpf
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch import create_planner
from manipulapy_tpu_torch import planner as tplanner
from manipulapy_tpu_torch import potential_field as tpf
from manipulapy_tpu_torch.models import from_host_arrays
from manipulapy_tpu_torch.ops.elementwise import ElementwiseKernels

CPU = torch.device("cpu")
Q_START = np.array([0.0, -1.0, 1.2, 0.0, 0.5, 0.0])
Q_GOAL = np.array([1.2, -0.6, 0.8, 0.3, 0.2, 0.4])
TF, N = 1.0, 50


def close(port, ref, tol):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)


def _planners(dtype):
    jm = jax_catalog.ur5(dtype=getattr(jnp, dtype))
    tm = from_host_arrays(jax_host_arrays(jm), dtype=getattr(torch, dtype), device=CPU)
    mid = np.asarray(jpf.link_positions(jax_catalog.ur5(dtype=jnp.float64), jnp.asarray(0.5 * (Q_START + Q_GOAL))))
    cloud = mid[[3, 5]] + np.array([[0.02, 0.0, 0.03], [0.0, 0.03, -0.02]])
    return jplanner.create_planner(jm, obstacle_points=cloud), create_planner(tm, obstacle_points=cloud), cloud


@pytest.fixture(scope="module", params=["float64", "float32"])
def path(request):
    """The whole path through both planners: the plan with the avoidance
    pass, its torques, and the rollout of those torques from the plan's
    start."""
    dtype = request.param
    jp, tp, cloud = _planners(dtype)
    launches = dict(ElementwiseKernels.launch_count)
    out = {"dtype": dtype, "jp": jp, "tp": tp, "cloud": cloud}
    kw = dict(avoid_collisions=True, avoidance_steps=20, avoidance_step_size=0.02, clearance_margin=0.02)
    out["jax_plan"] = jp.joint_trajectory(Q_START, Q_GOAL, TF, N, **kw)
    out["port_plan"] = tp.joint_trajectory(Q_START, Q_GOAL, TF, N, **kw)
    out["jax_tau"] = jp.inverse_dynamics_trajectory(*out["jax_plan"])
    out["port_tau"] = tp.inverse_dynamics_trajectory(*out["port_plan"])
    dt = TF / (N - 1)
    # Both rollouts take the port's torques, so the comparison is of the
    # rollouts alone.
    tau = out["port_tau"].numpy()
    q0, dq0 = out["port_plan"].position.numpy()[0], out["port_plan"].velocity.numpy()[0]
    out["jax_roll"] = jp.forward_dynamics_trajectory(q0, dq0, tau, dt=dt)
    out["port_roll"] = tp.forward_dynamics_trajectory(q0, dq0, tau, dt=dt)
    out["launches"] = (launches, dict(ElementwiseKernels.launch_count))
    return out


def test_plan_with_avoidance_matches_jax(path):
    tol = 1e-8 if path["dtype"] == "float64" else 1e-4
    for g, r in zip(path["port_plan"], path["jax_plan"]):
        assert g.shape == (N, 6) and str(g.dtype).endswith(path["dtype"])
        close(g.numpy(), r, tol if g is path["port_plan"].position else 10 * tol)
    tp = path["tp"]
    straight = tp.joint_trajectory(Q_START, Q_GOAL, TF, N).position
    cloud = tp.obstacle_points
    before = tpf.obstacle_clearance(tp.model, straight, tp.spheres, cloud).amin(-1)
    after = tpf.obstacle_clearance(tp.model, path["port_plan"].position, tp.spheres, cloud).amin(-1)
    assert float(before.min()) < 0.0  # the straight plan hits the cloud
    assert float(after.min()) > float(before.min())
    assert bool((after[before >= 0.02] == before[before >= 0.02]).all())  # clear waypoints stay put
    close(path["port_plan"].position[0].numpy(), Q_START, 1e-6)
    close(path["port_plan"].position[-1].numpy(), Q_GOAL, 1e-6)


def test_inverse_dynamics_of_the_plan_matches_jax(path):
    tol = 1e-8 if path["dtype"] == "float64" else 5e-3
    assert path["port_tau"].shape == (N, 6)
    close(path["port_tau"].numpy(), path["jax_tau"], tol)
    limit = path["tp"].model.torque_limit
    assert bool((path["port_tau"].abs() <= limit).all())


def test_rollout_of_the_plan_matches_jax(path):
    tols = (1e-8, 1e-8, 1e-6) if path["dtype"] == "float64" else (1e-4, 1e-3, 2e-1)
    for g, r, tol in zip(path["port_roll"], path["jax_roll"], tols):
        assert g.shape == (N, 6)
        close(g.numpy(), r, tol)
        assert bool(torch.isfinite(g).all())
    close(path["port_roll"][0][0].numpy(), path["port_plan"].position[0].numpy(), 0)  # row 0 is the start


def test_cpu_path_launches_no_kernel(path):
    before, after = path["launches"]
    assert before == after


def test_performance_stats_follow_the_calls(path):
    stats = path["tp"].get_performance_stats()
    per_op = stats["per_op"]
    assert set(per_op) >= {"joint_trajectory", "collision_avoidance", "inverse_dynamics_trajectory", "forward_dynamics_trajectory"}
    assert stats["calls"] == sum(op["calls"] for op in per_op.values())
    assert stats["total_time"] == pytest.approx(stats["compile_time"] + stats["steady_time"])
    assert stats["compile_time"] == pytest.approx(sum(op["first_time"] for op in per_op.values()))
    assert stats["steady_calls"] == stats["calls"] - len(per_op)
    assert set(stats) == set(path["jp"].get_performance_stats())
    fresh = tplanner.TrajectoryPlanner(path["tp"].model)
    assert fresh.get_performance_stats()["compile_amortization"] == float("inf")
    fresh.batch_joint_trajectory(np.zeros((2, 6)), np.ones((2, 6)), 1.0, 5)
    fresh.batch_joint_trajectory(np.zeros((2, 6)), np.ones((2, 6)), 1.0, 5)
    assert fresh.get_performance_stats()["steady_calls"] == 1
    fresh.reset_performance_stats()
    assert fresh.performance_stats["calls"] == 0 and fresh.performance_stats["per_op"] == {}


@pytest.mark.parametrize("with_cloud", [True, False])
def test_plan_trajectory_matches_jax(with_cloud):
    jp, tp, cloud = _planners("float64")
    kw = dict(num_waypoints=9, descent_steps=20, step_size=0.02)
    if not with_cloud:
        jp, tp = jplanner.create_planner(jp.model), create_planner(tp.model)
    ref = jp.plan_trajectory(Q_START, Q_GOAL, **kw)
    got = tp.plan_trajectory(Q_START, Q_GOAL, **kw)
    assert got.shape == (9, 6)
    close(got.numpy(), ref, 1e-8)
    close(got[0].numpy(), Q_START, 0)
    close(got[-1].numpy(), Q_GOAL, 0)
    straight = Q_START + np.linspace(0, 1, 9)[:, None] * (Q_GOAL - Q_START)
    assert float(np.abs(got.numpy() - straight).max()) > 1e-4  # the interior moved
    given = create_planner(tp.model).plan_trajectory(Q_START, Q_GOAL, obstacle_points=cloud, **kw)
    if with_cloud:
        close(given.numpy(), got.numpy(), 0)  # a cloud given at the call equals one given at construction
    with pytest.raises(ValueError):
        tp.plan_trajectory(Q_START, Q_GOAL, num_waypoints=1)


def test_batch_and_cartesian_trajectories_match_jax():
    jp, tp, _ = _planners("float64")
    rng = np.random.default_rng(0)
    starts, goals = rng.uniform(-1, 1, (5, 6)), rng.uniform(-1, 1, (5, 6))
    for method in (3, 5):
        ref = jp.batch_joint_trajectory(starts, goals, 2.0, 30, method)
        got = tp.batch_joint_trajectory(starts, goals, 2.0, 30, method)
        for g, r in zip(got, ref):
            assert g.shape == (5, 30, 6)
            close(g.numpy(), r, 1e-9)
    X0 = np.array(jkin.forward_kinematics(jp.model, jnp.asarray(Q_START)))
    X1 = np.array(jkin.forward_kinematics(jp.model, jnp.asarray(Q_GOAL)))
    for g, r in zip(tp.cartesian_trajectory(X0, X1, 2.0, 25), jp.cartesian_trajectory(X0, X1, 2.0, 25)):
        close(g.numpy(), r, 1e-9)


def test_self_collision_query_matches_jax():
    jp, tp, _ = _planners("float64")
    for q in (np.zeros(6), np.array([0.0, -0.3, 2.6, 0.0, 0.0, 0.0])):
        hit_t, c_t = tp.check_self_collision(q)
        hit_j, c_j = jp.check_self_collision(q)
        assert isinstance(hit_t, bool) and isinstance(c_t, float)
        assert hit_t == hit_j and c_t == pytest.approx(c_j, abs=1e-9)


def test_rollout_with_tip_wrench_and_zero_gravity():
    """The planner's rollout also takes the generic path: zero torque under
    zero gravity stays put; a tip wrench moves it as JAX's does."""
    jp, tp, _ = _planners("float64")
    q0, zero = np.array([0.3, 0.2, -0.4, 0.1, 0.0, 0.2]), np.zeros(6)
    qs, _, _ = tp.forward_dynamics_trajectory(q0, zero, np.zeros((10, 6)), g=(0.0, 0.0, 0.0))
    close(qs[-1].numpy(), q0, 1e-10)
    F = np.array([0.0, 0.0, 0.0, 1.0, -2.0, 0.5])
    got = tp.forward_dynamics_trajectory(q0, zero, np.zeros((6, 6)), Ftipmat=F, dt=0.02)
    ref = jp.forward_dynamics_trajectory(q0, zero, np.zeros((6, 6)), Ftipmat=jnp.asarray(F), dt=0.02)
    for g, r, tol in zip(got, ref, (1e-9, 1e-9, 1e-7)):
        close(g.numpy(), r, tol)
