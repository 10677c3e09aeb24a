"""Derivatives of the port's clamps exactly at a bound, against JAX's.

``jnp.clip`` is ``maximum`` then ``minimum`` and ``jnp.maximum``'s
derivative splits a tie evenly, so at a bound JAX gives half the derivative
(a quarter at a bound of zero width); ``torch.clamp`` gives all of it. The
port writes each clamp that can carry a derivative as ``torch.maximum`` /
``torch.minimum`` with tensor bounds, whose derivatives split ties the same
way. Each case puts the input exactly on the bound and compares
``torch.func.jacfwd`` with ``jax.jacfwd`` (float64, 1e-9; float32 for the
camera, which computes in float32), and the values too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from manipulapy_tpu import control as jc
from manipulapy_tpu import potential_field as jpf
from manipulapy_tpu import singularity as js
from manipulapy_tpu import trajectory as jtraj
from manipulapy_tpu import vision as jv
from manipulapy_tpu.core import lie as jlie
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.models.robot import make_robot_model as jax_make_robot_model
from manipulapy_tpu_torch import control as tc
from manipulapy_tpu_torch import potential_field as tpf
from manipulapy_tpu_torch import singularity as ts
from manipulapy_tpu_torch import trajectory as ttraj
from manipulapy_tpu_torch import vision as tv
from manipulapy_tpu_torch.core import lie as tlie
from manipulapy_tpu_torch.models import from_host_arrays, make_robot_model

CPU = torch.device("cpu")
TOL = 1e-9


def close(port, ref, atol=TOL, rtol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def ur5_pair():
    jm = jax_catalog.ur5(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)


def ur5_with(jm, **arrays):
    """Both packages' UR5 with some host arrays replaced."""
    host = {k: v for k, v in jax_host_arrays(jm).items() if k != "digest"}
    host.update(arrays)
    jax_model = dataclasses.replace(jm, **{k: jnp.asarray(v, dtype=jnp.float64) for k, v in arrays.items()})
    return jax_model, from_host_arrays(host, dtype=torch.float64, device=CPU)


# -- trajectory ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["joint_trajectory", "batch_joint_trajectory"])
def test_joint_trajectory_derivative_at_the_lower_limit(ur5_pair, name):
    """UR5, a quintic of 5 waypoints starting exactly on every lower limit:
    d sum(pos) / d theta_start is 1/2 + (1 - s1) + (1 - s2) + (1 - s3) + 0
    = 2.0 per joint in JAX; torch.clamp gave 2.5."""
    jm, tm = ur5_pair
    lo = np.asarray(jax_host_arrays(jm)["joint_lower"])
    end = lo + 0.5
    jfn = getattr(jtraj, name)
    tfn = getattr(ttraj, name)
    ref = jax.jacfwd(lambda s: jfn(jm, s, jnp.asarray(end), 1.0, 5, 5).position.sum())(jnp.asarray(lo))
    got = jacfwd(lambda s: tfn(tm, s, t64(end), 1.0, 5, 5).position.sum())(t64(lo))
    close(got, ref)
    close(got, np.full(6, 2.0))
    close(tfn(tm, t64(lo), t64(end), 1.0, 5, 5).position, jfn(jm, jnp.asarray(lo), jnp.asarray(end), 1.0, 5, 5).position)


def test_inverse_dynamics_trajectory_derivative_at_a_zero_torque_limit(ur5_pair):
    """A torque limit of 0 (three of the vendored robots have one) at rest,
    without gravity: tau = 0 lies on both bounds, and d tau / d ddq is a
    quarter of M in JAX."""
    jm, tm = ur5_pair
    jm, tm = ur5_with(jm, torque_limit=np.zeros(6))
    q = np.random.default_rng(0).uniform(-1.0, 1.0, (3, 6))
    zeros = np.zeros((3, 6))
    g = (0.0, 0.0, 0.0)
    ref = jax.jacfwd(lambda a: jtraj.inverse_dynamics_trajectory(jm, jnp.asarray(q), jnp.asarray(zeros), a, g=g))(
        jnp.asarray(zeros))
    got = jacfwd(lambda a: ttraj.inverse_dynamics_trajectory(tm, t64(q), t64(zeros), a, g=g))(t64(zeros))
    assert float(np.abs(np.asarray(ref)).max()) > 0.0
    close(got, ref)
    close(ttraj.inverse_dynamics_trajectory(tm, t64(q), t64(zeros), t64(zeros), g=g), np.zeros((3, 6)))


def test_forward_dynamics_trajectory_derivative_at_its_clamps(ur5_pair):
    """The generic rollout (taken with a tip wrench), from rest exactly on
    every lower joint limit under no torque and no gravity: q stays on its
    bound; a velocity limit of 0 puts dq on both of its bounds."""
    jm, tm = ur5_pair
    lo = np.asarray(jax_host_arrays(jm)["joint_lower"])[None]
    jm, tm = ur5_with(jm, velocity_limit=np.zeros(6))
    zeros, tau = np.zeros((1, 6)), np.zeros((1, 2, 6))
    f_tip = np.zeros((1, 2, 6))
    g = (0.0, 0.0, 0.0)

    def jfn(q0, dq0, taumat):
        qs, dqs, _ = jtraj.forward_dynamics_trajectory(jm, q0, dq0, taumat, g=g, Ftipmat=jnp.asarray(f_tip), dt=0.01)
        return jnp.concatenate([qs.ravel(), dqs.ravel()])

    def tfn(q0, dq0, taumat):
        qs, dqs, _ = ttraj.forward_dynamics_trajectory(tm, q0, dq0, taumat, g=g, Ftipmat=t64(f_tip), dt=0.01)
        return torch.cat([qs.ravel(), dqs.ravel()])

    args_j = tuple(jnp.asarray(a) for a in (lo, zeros, tau))
    args_t = tuple(t64(a) for a in (lo, zeros, tau))
    ref = jax.jacfwd(jfn, argnums=(0, 1, 2))(*args_j)
    got = jacfwd(tfn, argnums=(0, 1, 2))(*args_t)
    for r, g_ in zip(ref, got):
        close(g_, r)
    close(tfn(*args_t), jfn(*args_j))


# -- vision, core.lie ------------------------------------------------------------


def test_camera_to_pixel_derivative_at_the_depth_floor():
    cam_j, cam_t = jv.CameraConfig(), tv.CameraConfig()
    pts = np.array([[0.3, -0.2, 1e-6], [0.1, 0.4, 2.0]], dtype=np.float32)
    ref = jax.jacfwd(lambda p: jv.camera_to_pixel(p, cam_j))(jnp.asarray(pts))
    got = jacfwd(lambda p: tv.camera_to_pixel(p, cam_t, device="cpu"))(torch.from_numpy(pts))
    close(got, ref, atol=1e-6 * float(np.abs(np.asarray(ref)).max()), rtol=1e-6)
    close(tv.camera_to_pixel(pts, cam_t, device="cpu"), jv.camera_to_pixel(pts, cam_j), rtol=1e-6)


@pytest.mark.parametrize("R", [np.eye(3), np.diag([1.0, -1.0, -1.0])], ids=["identity", "pi_about_x"])
def test_so3_log_derivative_where_cos_theta_is_on_a_bound(R):
    """trace(R) = 3 and -1: (trace - 1) / 2 exactly on the clip's bounds."""
    ref = jax.jacfwd(jlie.so3_log)(jnp.asarray(R))
    got = jacfwd(tlie.so3_log)(t64(R))
    close(got, ref)
    close(tlie.so3_log(t64(R)), jlie.so3_log(jnp.asarray(R)))


def test_rotation_to_rpy_derivative_at_the_cos_pitch_floor():
    """R00^2 + R10^2 = (1e-12)^2 = 1e-24 exactly, the floor of cos(pitch)^2."""
    R = np.array([[1e-12, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 1e-12]])
    ref = jax.jacfwd(jlie.rotation_to_rpy)(jnp.asarray(R))
    got = jacfwd(tlie.rotation_to_rpy)(t64(R))
    close(got, ref)
    close(tlie.rotation_to_rpy(t64(R)), jlie.rotation_to_rpy(jnp.asarray(R)))


# -- potential fields ------------------------------------------------------------

# A point 1e-9 from an obstacle at the origin: sqrt((1e-9)^2) is exactly
# 1e-9, the distance floor.
Q_AT_FLOOR = np.array([[1e-9, 0.0, 0.0]])
OBSTACLES = np.array([[0.0, 0.0, 0.0], [0.2, 0.3, -0.1]])
GOAL = np.array([0.6, 0.2, 0.1])


def test_the_point_lies_on_the_distance_floor():
    d = tpf._norm(t64(Q_AT_FLOOR)[:, None, :] - t64(OBSTACLES))
    assert float(d[0, 0]) == 1e-9
    assert float(jnp.linalg.norm(jnp.asarray(Q_AT_FLOOR)[:, None, :] - jnp.asarray(OBSTACLES), axis=-1)[0, 0]) == 1e-9


def test_repulsive_potential_derivative_at_the_distance_floor():
    ref = jax.jacfwd(lambda q: jpf.repulsive_potential(q, jnp.asarray(OBSTACLES)))(jnp.asarray(Q_AT_FLOOR))
    got = jacfwd(lambda q: tpf.repulsive_potential(q, t64(OBSTACLES)))(t64(Q_AT_FLOOR))
    close(got, ref, 1e-9 * float(np.abs(np.asarray(ref)).max()))
    close(tpf.repulsive_potential(t64(Q_AT_FLOOR), t64(OBSTACLES)),
          jpf.repulsive_potential(jnp.asarray(Q_AT_FLOOR), jnp.asarray(OBSTACLES)), 1e-9 * 1e19)


def test_potential_gradient_derivative_at_the_distance_floor():
    args = (jnp.asarray(GOAL), jnp.asarray(OBSTACLES))
    ref = jax.jacfwd(lambda q: jpf.potential_gradient(q, *args))(jnp.asarray(Q_AT_FLOOR))
    got = jacfwd(lambda q: tpf.potential_gradient(q, t64(GOAL), t64(OBSTACLES)))(t64(Q_AT_FLOOR))
    close(got, ref, 1e-9 * float(np.abs(np.asarray(ref)).max()))


def test_cartesian_potential_field_derivative_at_the_distance_floor():
    def jfn(p):
        U, G = jpf.cartesian_potential_field(p, jnp.asarray(GOAL), jnp.asarray(OBSTACLES), 0.5)
        return jnp.concatenate([U.ravel(), G.ravel()])

    def tfn(p):
        U, G = tpf.cartesian_potential_field(p, t64(GOAL), t64(OBSTACLES), 0.5)
        return torch.cat([U.ravel(), G.ravel()])

    ref = jax.jacfwd(jfn)(jnp.asarray(Q_AT_FLOOR))
    got = jacfwd(tfn)(t64(Q_AT_FLOOR))
    close(got, ref, 1e-9 * float(np.abs(np.asarray(ref)).max()))
    close(tfn(t64(Q_AT_FLOOR)), jfn(jnp.asarray(Q_AT_FLOOR)), 1e-9 * 1e18)


# -- singularity, control ------------------------------------------------------------


def test_condition_number_derivative_at_the_singular_value_floor():
    """One prismatic joint whose body screw is 1e-30 along x: the measure
    Jacobian (the body Jacobian's linear block for n < 6) has the one
    singular value 1e-30, the floor; the derivative is taken with respect
    to the screw."""
    home = np.eye(4)
    screw = np.array([[0.0, 0.0, 0.0, 1e-30, 0.0, 0.0]])
    jm = jax_make_robot_model(home, screw, screws_body=screw, dtype=jnp.float64)
    tm = make_robot_model(home, screw, screws_body=screw, dtype=torch.float64, device=CPU)
    q = np.array([0.2])

    def jfn(S):
        return js.condition_number(dataclasses.replace(jm, screws_body=S), jnp.asarray(q))

    def tfn(S):
        return ts.condition_number(dataclasses.replace(tm, screws_body=S), t64(q))

    assert float(np.asarray(ts.singularity_measure(tm, t64(q)))) == 1e-30
    ref = jax.jacfwd(jfn)(jnp.asarray(screw))
    got = jacfwd(tfn)(t64(screw))
    close(got, ref, 1e-9 * float(np.abs(np.asarray(ref)).max()))
    close(tfn(t64(screw)), jfn(jnp.asarray(screw)))


def test_step_response_overshoot_derivative_at_zero_overshoot():
    """A response whose peak is exactly the setpoint: overshoot's max(., 0)
    on its bound."""
    t = np.linspace(0.0, 1.0, 11)
    y = np.concatenate([np.linspace(0.0, 1.0, 6), np.ones(5)])

    def jfn(y_):
        return jc.step_response_metrics(jnp.asarray(t), y_, 1.0)["percent_overshoot"]

    def tfn(y_):
        return tc.step_response_metrics(t64(t), y_, 1.0)["percent_overshoot"]

    assert float(tfn(t64(y))) == 0.0
    close(jacfwd(tfn)(t64(y)), jax.jacfwd(jfn)(jnp.asarray(y)))


def test_find_ultimate_gain_floor_keeps_its_values(ur5_pair):
    """``find_ultimate_gain_and_period``'s amplitude floor only feeds a
    comparison, so no derivative passes it; its values stay JAX's."""
    jm, tm = ur5_pair
    q0 = np.zeros(6)
    q_goal = np.full(6, 0.1)
    kw = dict(dt=0.01, steps=60, num_gains=5)
    ref = jc.find_ultimate_gain_and_period(jm, jnp.asarray(q0), jnp.asarray(q_goal), jnp.asarray([0.0, 0.0, -9.81]), **kw)
    got = tc.find_ultimate_gain_and_period(tm, t64(q0), t64(q_goal), t64([0.0, 0.0, -9.81]), **kw)
    for r, g_ in zip(ref, got):
        close(g_, r, 1e-7)


# -- the clamp's values --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_maximum_minimum_has_the_clamps_values(dtype):
    """``minimum(maximum(x, lo), hi)`` is ``torch.clamp(x, lo, hi)`` bit for
    bit for ``lo <= hi``: random values, values on the bounds, infinite
    bounds and NaN."""
    rng = np.random.default_rng(3)
    lo = torch.tensor(rng.uniform(-2.0, 0.5, 64), dtype=dtype)
    hi = lo + torch.tensor(rng.uniform(0.0, 2.0, 64), dtype=dtype)
    lo[:4], hi[4:8] = -float("inf"), float("inf")
    x = torch.tensor(rng.uniform(-3.0, 3.0, (5, 64)), dtype=dtype)
    x[1], x[2] = lo, hi
    x[3, ::3] = float("nan")
    got = torch.minimum(torch.maximum(x, lo), hi)
    ref = torch.clamp(x, lo, hi)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    same = ~torch.isnan(ref)
    assert torch.equal(got[same].view(torch.int64 if dtype == torch.float64 else torch.int32),
                       ref[same].view(torch.int64 if dtype == torch.float64 else torch.int32))
