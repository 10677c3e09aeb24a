"""The port's potential fields and sphere-based collision checking against
the JAX package's.

Inputs come from ``numpy.random.default_rng`` and go to both packages; the
JAX functions take one configuration and are run per row. Tolerances:
float64 1e-9 on values and on gradients by autograd against ``jax.grad``
(the two sum in other orders); the avoidance pass, 20 gradient steps, 1e-8;
the generic iLQR with the obstacle cost, 1e-6 after 2 iterations (as the
iLQR's own parity test, the iteration carries the difference).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import potential_field as jpf
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc import costs as jcosts
from manipulapy_tpu.mpc.ilqr import ILQRParams as JParams, ilqr as jax_ilqr, make_step_fn as jax_step_fn
from manipulapy_tpu_torch import potential_field as tpf
from manipulapy_tpu_torch.models import from_host_arrays
from manipulapy_tpu_torch.mpc import costs as tcosts
from manipulapy_tpu_torch.mpc.ilqr import ILQRParams, ilqr, make_step_fn

CPU = torch.device("cpu")
T = torch.from_numpy


def close(port, ref, tol=1e-9):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol)


def _pair(make):
    jm = make(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)


@pytest.fixture(scope="module")
def ur5_pair():
    return _pair(jax_catalog.ur5)


@pytest.fixture(scope="module")
def planar_pair():
    return _pair(jax_catalog.two_link_planar)


def _spheres(jm, tm, radius=0.08):
    return jpf.default_link_spheres(jm, radius), tpf.default_link_spheres(tm, radius)


# -- joint-space potentials ------------------------------------------------------


def _joint_case(seed=0, B=5, n=6, O=4):
    rng = np.random.default_rng(seed)
    q, goal = rng.uniform(-1, 1, (B, n)), rng.uniform(-1, 1, n)
    obstacles = rng.uniform(-1, 1, (O, n))
    obstacles[0] = q[0] + 0.05  # well inside the influence distance
    obstacles[1] = q[1]  # exact overlap: the fixed escape direction
    return q, goal, obstacles


def test_joint_space_potentials_match_jax():
    q, goal, obstacles = _joint_case()
    close(tpf.attractive_potential(T(q), T(goal), 1.7).numpy(), jpf.attractive_potential(jnp.asarray(q), jnp.asarray(goal), 1.7))
    got = tpf.repulsive_potential(T(q), T(obstacles), 0.8, 1.2)
    ref = jpf.repulsive_potential(jnp.asarray(q), jnp.asarray(obstacles), 0.8, 1.2)
    assert got.shape == (5,) and float(got[0]) > 0
    close(got[[0, 2, 3, 4]].numpy(), np.asarray(ref)[[0, 2, 3, 4]])
    close(got[1].numpy(), ref[1], 1e-6)  # (1e9 - 1/d0)^2: the last digits of 1e18


@pytest.mark.parametrize("with_obstacles", [True, False])
def test_potential_gradient_matches_jax(with_obstacles):
    q, goal, obstacles = _joint_case(seed=1)
    obs_t, obs_j = (T(obstacles), jnp.asarray(obstacles)) if with_obstacles else (None, None)
    got = tpf.potential_gradient(T(q), T(goal), obs_t, 1.3, 0.7, 1.2)
    ref = jpf.potential_gradient(jnp.asarray(q), jnp.asarray(goal), obs_j, 1.3, 0.7, 1.2)
    close(got.numpy(), ref)
    if with_obstacles:  # the overlap row got the escape direction, not NaN
        assert bool(torch.isfinite(got).all())
        no_push = tpf.potential_gradient(T(q[1]), T(goal), T(obstacles[[0, 2, 3]]), 1.3, 0.7, 1.2)
        assert float((got[1] - no_push)[0]) == -1.0
    empty = tpf.potential_gradient(T(q), T(goal), torch.zeros((0, 6), dtype=torch.float64), 1.3)
    close(empty.numpy(), 1.3 * (q - goal))


def test_analytic_gradient_is_the_autograd_gradient_away_from_overlap():
    q, goal, obstacles = _joint_case(seed=2)
    tq = T(q[2:]).requires_grad_(True)
    U = 0.5 * tpf.attractive_potential(tq, T(goal), 2.0) * 2.0 + tpf.repulsive_potential(tq, T(obstacles), 1.0, 1.5)
    (auto,) = torch.autograd.grad(U.sum(), tq)
    close(auto.numpy(), tpf.potential_gradient(tq.detach(), T(goal), T(obstacles), 2.0, 1.0, 1.5).numpy(), 1e-8)


# -- the Cartesian field -----------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-4)])
def test_cartesian_potential_field_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (4, 25, 3)).astype(dtype)
    goal, obstacles = np.asarray([0.3, -0.2, 0.5], dtype), rng.uniform(-1, 1, (5, 3)).astype(dtype)
    U, g = tpf.cartesian_potential_field(T(pts), T(goal), T(obstacles), 0.6)
    U_j, g_j = jpf.cartesian_potential_field(jnp.asarray(pts), jnp.asarray(goal), jnp.asarray(obstacles), 0.6)
    assert U.shape == (4, 25) and g.shape == (4, 25, 3) and str(U.dtype).endswith(dtype)
    close(U.numpy(), U_j, tol)
    close(g.numpy(), g_j, tol)
    U0, g0 = tpf.cartesian_potential_field(T(pts), T(goal), T(obstacles[:0]), 0.6)
    close(U0.numpy(), 0.5 * ((pts - goal) ** 2).sum(-1), tol)
    close(g0.numpy(), pts - goal, tol)


def test_cartesian_potential_field_gradient_is_its_autograd_gradient():
    rng = np.random.default_rng(4)
    pts = T(rng.uniform(-1, 1, (30, 3))).requires_grad_(True)
    goal, obstacles = T(rng.uniform(-1, 1, 3)), T(rng.uniform(-1, 1, (6, 3)))
    U, g = tpf.cartesian_potential_field(pts, goal, obstacles, 0.7)
    (auto,) = torch.autograd.grad(U.sum(), pts)
    close(auto.numpy(), g.detach().numpy(), 1e-8)


# -- link spheres and clearances -----------------------------------------------------


def test_default_link_spheres_match_jax(ur5_pair):
    js, ts = _spheres(*ur5_pair)
    close(ts.radii.numpy(), js.radii, 0)
    assert float(ts.radii[0]) == 0.08
    np.testing.assert_array_equal(ts.allowed.numpy(), np.asarray(js.allowed))


def _configs(seed, B=6, n=6):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (B, n))


def test_link_positions_and_self_collision_match_jax(ur5_pair):
    jm, tm = ur5_pair
    js, ts = _spheres(jm, tm, radius=0.12)  # large enough that some pairs collide
    q = _configs(5)
    q[0] = [0.0, -0.3, 2.6, 0.0, 0.0, 0.0]  # folded: the forearm comes back to the base
    p = tpf.link_positions(tm, T(q))
    c = tpf.self_collision_distances(tm, T(q), ts)
    hit, min_c = tpf.check_self_collision(tm, T(q), ts)
    assert p.shape == (6, 6, 3) and c.shape == (6, 6, 6) and hit.shape == (6,) and min_c.shape == (6,)
    for b in range(6):
        qb = jnp.asarray(q[b])
        close(p[b].numpy(), jpf.link_positions(jm, qb))
        close(c[b].numpy(), jpf.self_collision_distances(jm, qb, js))
        hit_j, min_j = jpf.check_self_collision(jm, qb, js)
        assert bool(hit[b]) == bool(hit_j)
        close(min_c[b].numpy(), min_j)
    assert bool(hit.any()) and not bool(hit.all())


def _obstacle_case(jm, seed=6):
    """Configurations, and obstacle points placed near some link centres."""
    q = _configs(seed)
    p0 = np.asarray(jpf.link_positions(jm, jnp.asarray(q[0])))
    rng = np.random.default_rng(seed + 100)
    obstacles = np.concatenate([p0[[2, 4]] + rng.uniform(-0.05, 0.05, (2, 3)), rng.uniform(-0.6, 0.6, (5, 3))])
    return q, obstacles


def _clearance_grads(jm, tm, js, ts, q, obstacles):
    tq = T(q).requires_grad_(True)
    clear = tpf.obstacle_clearance(tm, tq, ts, T(obstacles))
    (grad,) = torch.autograd.grad((clear * clear).sum(), tq)
    f = lambda x: jnp.sum(jpf.obstacle_clearance(jm, x, js, jnp.asarray(obstacles)) ** 2)
    ref_clear = np.stack([np.asarray(jpf.obstacle_clearance(jm, jnp.asarray(x), js, jnp.asarray(obstacles))) for x in q])
    ref_grad = np.stack([np.asarray(jax.grad(f)(jnp.asarray(x))) for x in q])
    return clear.detach().numpy(), grad.numpy(), ref_clear, ref_grad


def test_obstacle_clearance_and_gradient_match_jax(ur5_pair):
    jm, tm = ur5_pair
    js, ts = _spheres(jm, tm)
    q, obstacles = _obstacle_case(jm)
    clear, grad, ref_clear, ref_grad = _clearance_grads(jm, tm, js, ts, q, obstacles)
    assert clear.shape == (6, 6) and (clear[0] < 0).any()
    close(clear, ref_clear)
    close(grad, ref_grad, 1e-8)


def test_min_tie_splits_the_gradient_as_jax_does(ur5_pair):
    """Two identical obstacle points tie in the min over points: JAX splits
    the gradient evenly, and ``torch.amin`` does (``torch.min(dim=)`` would
    send it to one index, which gives the same sum here, so the tie is also
    checked on the gradient with respect to the points)."""
    jm, tm = ur5_pair
    js, ts = _spheres(jm, tm)
    q, obstacles = _obstacle_case(jm, seed=7)
    obstacles = np.concatenate([obstacles[:1], obstacles[:1], obstacles[1:]])
    clear, grad, ref_clear, ref_grad = _clearance_grads(jm, tm, js, ts, q[:2], obstacles)
    close(clear, ref_clear)
    close(grad, ref_grad, 1e-8)
    t_obs = T(obstacles).requires_grad_(True)
    (g_obs,) = torch.autograd.grad(tpf.obstacle_clearance(tm, T(q[0]), ts, t_obs).sum(), t_obs)
    ref = jax.grad(lambda o: jnp.sum(jpf.obstacle_clearance(jm, jnp.asarray(q[0]), js, o)))(jnp.asarray(obstacles))
    close(g_obs.numpy(), ref, 1e-8)
    assert float(g_obs[0].abs().sum()) > 0 and torch.equal(g_obs[0], g_obs[1])


def test_exact_overlap_has_a_finite_gradient(ur5_pair):
    """A link centre exactly on an obstacle point: the 1e-9 offset makes the
    gradient a finite direction. Each package gets the overlap at its own
    link centre (the two centres differ in the last bits, and at a distance
    of ~1e-9 that turns the unit direction, so the gradients themselves are
    not compared)."""
    jm, tm = ur5_pair
    js, ts = _spheres(jm, tm)
    q = _configs(8, B=1)[0]
    p_j = np.asarray(jpf.link_positions(jm, jnp.asarray(q)))
    obs_j = jnp.asarray(np.stack([p_j[3], p_j[3] + 0.5]))
    c_j = np.asarray(jpf.obstacle_clearance(jm, jnp.asarray(q), js, obs_j))
    g_j = np.asarray(jax.grad(lambda x: jnp.sum(jpf.obstacle_clearance(jm, x, js, obs_j)))(jnp.asarray(q)))
    p_t = tpf.link_positions(tm, T(q))
    obs_t = torch.stack([p_t[3], p_t[3] + 0.5])
    tq = T(q).requires_grad_(True)
    c_t = tpf.obstacle_clearance(tm, tq, ts, obs_t)
    (g_t,) = torch.autograd.grad(c_t.sum(), tq)
    c_t = c_t.detach().numpy()
    assert np.isfinite(g_j).all() and bool(torch.isfinite(g_t).all())
    assert abs(c_t[3] + 0.08) < 1e-8 and abs(c_j[3] + 0.08) < 1e-8
    close(np.delete(c_t, 3), np.delete(c_j, 3))


# -- the avoidance pass ----------------------------------------------------------------


def _avoidance_case(jm):
    q_start = np.array([0.0, -1.0, 1.2, 0.0, 0.5, 0.0])
    q_goal = np.array([1.2, -0.6, 0.8, 0.3, 0.2, 0.4])
    frac = np.linspace(0.0, 1.0, 15)[:, None]
    traj = q_start + frac * (q_goal - q_start)
    mid = np.asarray(jpf.link_positions(jm, jnp.asarray(traj[7])))
    cloud = mid[[3, 5]] + np.array([[0.02, 0.0, 0.03], [0.0, 0.03, -0.02]])
    return traj, q_goal, cloud


@pytest.mark.parametrize("margin", [0.0, 0.03])
def test_apply_collision_avoidance_matches_jax(ur5_pair, margin):
    jm, tm = ur5_pair
    js, ts = _spheres(jm, tm)
    traj, q_goal, cloud = _avoidance_case(jm)
    kw = dict(step_size=0.02, max_steps=20, clearance_margin=margin)
    ref = jpf.apply_collision_avoidance(jm, jnp.asarray(traj), jnp.asarray(q_goal), js, jnp.asarray(cloud), **kw)
    got = tpf.apply_collision_avoidance(tm, T(traj), T(q_goal), ts, T(cloud), **kw)
    assert got.shape == (15, 6) and not got.requires_grad
    close(got.numpy(), ref, 1e-8)
    before = tpf.obstacle_clearance(tm, T(traj), ts, T(cloud)).amin(-1)
    after = tpf.obstacle_clearance(tm, got, ts, T(cloud)).amin(-1)
    moved = (got - T(traj)).abs().amax(-1) > 0
    assert bool((before < margin).any())
    # Exactly the waypoints that were too close moved, and they gained room.
    assert torch.equal(moved, before < margin)
    assert bool((after[moved] > before[moved]).all())
    assert bool((got <= tm.joint_upper).all() and (got >= tm.joint_lower).all())


def test_apply_collision_avoidance_batches_and_runs_under_no_grad(ur5_pair):
    jm, tm = ur5_pair
    _, ts = _spheres(jm, tm)
    traj, q_goal, cloud = _avoidance_case(jm)
    one = tpf.apply_collision_avoidance(tm, T(traj), T(q_goal), ts, T(cloud), max_steps=5)
    with torch.no_grad():
        two = tpf.apply_collision_avoidance(
            tm, T(np.stack([traj, traj[::-1]])), T(q_goal), ts, T(cloud), max_steps=5
        )
    assert two.shape == (2, 15, 6)
    close(two[0].numpy(), one.numpy(), 1e-12)
    close(two[1].flip(0).numpy(), one.numpy(), 1e-12)


# -- the obstacle cost in the generic iLQR ------------------------------------------------


def test_obstacle_cost_and_its_gradient_match_jax(ur5_pair):
    jm, tm = ur5_pair
    js, ts = _spheres(jm, tm)
    q, obstacles = _obstacle_case(jm, seed=9)
    x = np.concatenate([q[0], np.zeros(6)])
    t_cost = tcosts.obstacle_cost(tm, ts, T(obstacles), 50.0, 0.1)
    j_cost = jcosts.obstacle_cost(jm, js, jnp.asarray(obstacles), 50.0, 0.1)
    u = np.zeros(6)
    assert float(t_cost(T(x), T(u), 0)) > 0
    close(t_cost(T(x), T(u), 0).numpy(), j_cost(jnp.asarray(x), jnp.asarray(u), 0))
    close(torch.func.grad(t_cost)(T(x), T(u), 0).numpy(), jax.grad(j_cost)(jnp.asarray(x), jnp.asarray(u), 0), 1e-8)


def test_ilqr_with_obstacle_cost_matches_jax(planar_pair):
    """Two iterations of the generic iLQR on the 2R arm, the obstacle cost
    plugged into ``make_tracking_costs(extra_cost=...)``, a point in the way
    of the straight motion."""
    jm, tm = planar_pair
    js, ts = _spheres(jm, tm, radius=0.1)
    H, dt, q_goal = 10, 0.05, [0.9, -0.5]
    x0 = np.array([0.1, -0.2, 0.0, 0.3])
    mid = np.asarray(jpf.link_positions(jm, jnp.asarray([0.5, -0.35])))
    cloud = mid[1:] + np.array([[0.0, 0.12, 0.0]])
    t_extra = tcosts.obstacle_cost(tm, ts, T(cloud), 100.0, 0.05)
    j_extra = jcosts.obstacle_cost(jm, js, jnp.asarray(cloud), 100.0, 0.05)
    t_run, t_term = tcosts.make_tracking_costs(tm, torch.tensor(q_goal, dtype=torch.float64), extra_cost=t_extra)
    j_run, j_term = jcosts.make_tracking_costs(jm, jnp.asarray(q_goal), extra_cost=j_extra)
    assert float(t_extra(T(np.array([0.5, -0.35, 0.0, 0.0])), torch.zeros(2, dtype=torch.float64), 0)) > 0
    g0 = (0.0, 0.0, 0.0)
    res_t = ilqr(
        make_step_fn(tm, dt, g=g0), t_run, t_term, T(x0), torch.zeros((H, 2), dtype=torch.float64),
        ILQRParams(horizon=H, dt=dt, iterations=2),
    )
    res_j = jax_ilqr(
        jax_step_fn(jm, dt, g=jnp.zeros(3)), j_run, j_term, jnp.asarray(x0), jnp.zeros((H, 2)),
        JParams(horizon=H, dt=dt, iterations=2),
    )
    for name in ("xs", "us", "cost", "gains_K"):
        close(getattr(res_t, name).numpy(), getattr(res_j, name), 1e-6)
    plain_t, _ = tcosts.make_tracking_costs(tm, torch.tensor(q_goal, dtype=torch.float64))
    total = lambda run: sum(float(run(res_t.xs[t], res_t.us[t], t)) for t in range(H))
    assert total(t_run) > total(plain_t)  # the obstacle term is active along the solution


# -- the facade and the adjacency ---------------------------------------------------------


def test_potential_field_facade_matches_jax():
    q, goal, obstacles = _joint_case(seed=10)
    tf, jf = tpf.PotentialField(1.5, 0.6, 1.1), jpf.PotentialField(1.5, 0.6, 1.1)
    close(tf.compute_attractive_potential(q[0], goal).numpy(), jf.compute_attractive_potential(q[0], goal))
    close(tf.compute_repulsive_potential(q[0], obstacles).numpy(), jf.compute_repulsive_potential(q[0], obstacles))
    close(tf.compute_repulsive_potential(q[0], obstacles[0]).numpy(), jf.compute_repulsive_potential(q[0], obstacles[0]))
    close(tf.compute_gradient(q[0], goal, obstacles).numpy(), jf.compute_gradient(q[0], goal, obstacles))
    close(tf.compute_gradient(q[0], goal).numpy(), jf.compute_gradient(q[0], goal))


def test_build_link_adjacency_matches_jax():
    link = lambda name: SimpleNamespace(name=name)
    joint = lambda parent, child: SimpleNamespace(parent=parent, child=child)
    urdf = SimpleNamespace(
        links=[link(n) for n in ("base", "a", "b", "c", "tool", "loose")],
        joints=[joint("base", "a"), joint("a", "b"), joint("b", "c"), joint("b", "tool"), joint("", "loose")],
    )
    got = tpf.build_link_adjacency(urdf)
    assert got == jpf.build_link_adjacency(urdf)
    assert got["c"] == {"c", "b", "a"} and got["base"] == {"base", "a", "b"} and got["loose"] == {"loose"}
    assert not hasattr(tpf, "CollisionChecker")
