"""The port's trajectory generation, and the ``core.lie`` and ``kinematics``
functions that came with it, against the JAX package's.

Inputs come from ``numpy.random.default_rng`` and go to both packages.
Tolerances: float64 1e-9 (the two sum matrix products in other orders);
float32 1e-5 on positions and angles, with the JAX kernel test's 2e-5 / 2e-4
on velocities and accelerations (``linspace`` differs in the last bit, and
1 / Tf^2 scales it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import kinematics as jkin
from manipulapy_tpu import trajectory as jtraj
from manipulapy_tpu.core import lie as jlie
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch import kinematics as tkin
from manipulapy_tpu_torch import trajectory as ttraj
from manipulapy_tpu_torch.core import lie as tlie
from manipulapy_tpu_torch.models import from_host_arrays

CPU = torch.device("cpu")
F64, F32 = 1e-9, 1e-5


def close(port, ref, tol=F64):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ur5_pair():
    jm = jax_catalog.ur5(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)


def _endpoints(B, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.5, 1.5, (B, n)), rng.uniform(-1.5, 1.5, (B, n))


# -- joint trajectories --------------------------------------------------------


@pytest.mark.parametrize("method", [3, 5, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batch_joint_trajectory_matches_jax(ur5_pair, method, dtype):
    jm, tm = ur5_pair
    start, end = (x.astype(dtype) for x in _endpoints(8))
    end[0] *= 5.0  # past the joint limits: the position clip engages
    if dtype == "float32":
        jm, tm = jax_catalog.ur5(dtype=jnp.float32), tm.to(dtype=torch.float32)
    ref = jtraj.batch_joint_trajectory(jm, jnp.asarray(start), jnp.asarray(end), 1.7, 60, method)
    got = ttraj.batch_joint_trajectory(tm, torch.from_numpy(start), torch.from_numpy(end), 1.7, 60, method)
    tols = (F64,) * 3 if dtype == "float64" else (F32, 2e-5, 2e-4)
    for g, r, tol in zip(got, ref, tols):
        assert g.shape == (8, 60, 6) and str(g.dtype).endswith(dtype)
        close(g.numpy(), r, tol)
    assert bool((got.position <= tm.joint_upper).all()) and bool((got.position >= tm.joint_lower).all())
    unclipped = ttraj.batch_joint_trajectory(tm, torch.from_numpy(start), torch.from_numpy(end), 1.7, 60, method, False)
    assert bool((unclipped.position > tm.joint_upper).any() | (unclipped.position < tm.joint_lower).any())


@pytest.mark.parametrize("Tf,N", [(0.0, 10), (-1.0, 10), (2.0, 1), (2.0, 0)])
def test_degenerate_trajectory_matches_jax(ur5_pair, Tf, N):
    """``Tf <= 0`` sits at the start with zero rates; ``N <= 1`` gives N rows
    of zero profile. Both stay with the tensor formulation on any device."""
    jm, tm = ur5_pair
    start, end = _endpoints(2, seed=1)
    start, end = start * 0.5, end * 0.5
    ref = jtraj.joint_trajectory(jm, jnp.asarray(start), jnp.asarray(end), Tf, N)
    got = ttraj.joint_trajectory(tm, torch.from_numpy(start), torch.from_numpy(end), Tf, N)
    for g, r in zip(got, ref):
        assert g.shape == (2, max(N, 0), 6)
        close(g.numpy(), r)
    if N > 1:
        close(got.position.numpy(), np.broadcast_to(start[:, None, :], (2, N, 6)))
        assert not bool(got.velocity.any()) and not bool(got.acceleration.any())


def test_trajectory_boundary_conditions_and_broadcast(ur5_pair):
    """One start, a batch of goals; the plan starts and ends where asked, at
    rest."""
    _, tm = ur5_pair
    start, end = _endpoints(4, seed=2)
    start, end = torch.from_numpy(start[0] * 0.5), torch.from_numpy(end * 0.5)
    plan = ttraj.joint_trajectory(tm, start, end, 2.0, 50)
    assert plan.position.shape == (4, 50, 6)
    close(plan.position[:, 0].numpy(), np.broadcast_to(start.numpy(), (4, 6)), 1e-12)
    close(plan.position[:, -1].numpy(), end.numpy(), 1e-12)
    close(plan.velocity[:, (0, -1)].numpy(), np.zeros((4, 2, 6)), 1e-12)


def test_trajectory_needing_grad_is_differentiable(ur5_pair):
    _, tm = ur5_pair
    start, end = (torch.from_numpy(x[0] * 0.3) for x in _endpoints(1, seed=3))
    end.requires_grad_(True)
    plan = ttraj.joint_trajectory(tm, start, end, 2.0, 11)
    (grad,) = torch.autograd.grad(plan.position[-1].sum(), end)
    close(grad.numpy(), np.ones(6), 1e-12)


# -- Cartesian trajectories ------------------------------------------------------


def _poses(seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (2, 6))
    jm = jax_catalog.ur5(dtype=jnp.float64)
    return [np.array(jkin.forward_kinematics(jm, jnp.asarray(x))) for x in q]


@pytest.mark.parametrize("method", [3, 5, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cartesian_trajectory_matches_jax(method, dtype):
    X_s, X_e = (x.astype(dtype) for x in _poses(4))
    ref = jtraj.cartesian_trajectory(jnp.asarray(X_s), jnp.asarray(X_e), 1.3, 40, method)
    got = ttraj.cartesian_trajectory(torch.from_numpy(X_s), torch.from_numpy(X_e), 1.3, 40, method)
    tols = (F64,) * 3 if dtype == "float64" else (F32, 2e-5, 2e-4)
    for g, r, tol in zip(got, ref, tols):
        assert str(g.dtype).endswith(dtype)
        close(g.numpy(), r, tol)
    assert got[0].shape == (40, 4, 4) and got[1].shape == (40, 3)
    close(got[0][0].numpy(), X_s, 1e-6)
    close(got[0][-1].numpy(), X_e, 1e-6)


def test_cartesian_trajectory_batches():
    X_s, X_e = _poses(5)
    one = ttraj.cartesian_trajectory(torch.from_numpy(X_s), torch.from_numpy(X_e), 2.0, 9)
    both = ttraj.cartesian_trajectory(
        torch.from_numpy(np.stack([X_s, X_e])), torch.from_numpy(np.stack([X_e, X_s])), 2.0, 9
    )
    assert both[0].shape == (2, 9, 4, 4) and both[1].shape == (2, 9, 3)
    for b, o in zip(both, one):
        close(b[0].numpy(), o.numpy(), 1e-12)


@pytest.mark.parametrize("Tf,N", [(0.0, 5), (1.0, 1)])
def test_cartesian_trajectory_degenerate_matches_jax(Tf, N):
    X_s, X_e = _poses(6)
    ref = jtraj.cartesian_trajectory(jnp.asarray(X_s), jnp.asarray(X_e), Tf, N)
    got = ttraj.cartesian_trajectory(torch.from_numpy(X_s), torch.from_numpy(X_e), Tf, N)
    for g, r in zip(got, ref):
        close(g.numpy(), r)


# -- core.lie ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float64", F64), ("float32", F32)])
def test_rpy_and_quaternion_match_jax(dtype, tol):
    rng = np.random.default_rng(7)
    rpy = rng.uniform(-np.pi, np.pi, (12, 3)).astype(dtype)
    rpy[0] = [0.3, np.pi / 2, -0.4]  # gimbal lock, both signs
    rpy[1] = [-0.2, -np.pi / 2, 0.9]
    R_t = tlie.rpy_to_rotation(torch.from_numpy(rpy))
    R_j = jlie.rpy_to_rotation(jnp.asarray(rpy))
    close(R_t.numpy(), R_j, tol)
    close(tlie.rotation_to_rpy(torch.from_numpy(np.array(R_j))).numpy(), jlie.rotation_to_rpy(R_j), 10 * tol)
    # Away from the lock the angles round-trip.
    close(tlie.rpy_to_rotation(tlie.rotation_to_rpy(R_t[2:])).numpy(), R_t[2:].numpy(), 10 * tol)
    quat = rng.normal(size=(9, 4)).astype(dtype) * 3.0  # not normalized
    quat[0] = 0.0  # the zero quaternion gives the identity
    Q_t = tlie.quat_to_rotation(torch.from_numpy(quat))
    close(Q_t.numpy(), jlie.quat_to_rotation(jnp.asarray(quat)), tol)
    close(Q_t[0].numpy(), np.eye(3, dtype=dtype), tol)
    close((Q_t[1:] @ Q_t[1:].mT).numpy(), np.broadcast_to(np.eye(3, dtype=dtype), (8, 3, 3)), 10 * tol)


# -- kinematics ----------------------------------------------------------------------


@pytest.mark.parametrize("frame", ["space", "body"])
def test_end_effector_velocity_and_joint_velocity_match_jax(ur5_pair, frame):
    jm, tm = ur5_pair
    rng = np.random.default_rng(8)
    q, dq, V = rng.uniform(-1, 1, (5, 6)), rng.uniform(-1, 1, (5, 6)), rng.uniform(-1, 1, (5, 6))
    got_v = tkin.end_effector_velocity(tm, torch.from_numpy(q), torch.from_numpy(dq), frame)
    got_dq = tkin.joint_velocity(tm, torch.from_numpy(q), torch.from_numpy(V), frame)
    assert got_v.shape == (5, 6) and got_dq.shape == (5, 6)
    for b in range(5):
        close(got_v[b].numpy(), jkin.end_effector_velocity(jm, jnp.asarray(q[b]), jnp.asarray(dq[b]), frame))
        close(got_dq[b].numpy(), jkin.joint_velocity(jm, jnp.asarray(q[b]), jnp.asarray(V[b]), frame), 1e-7)
    # J^+ inverts J on a regular configuration.
    back = tkin.joint_velocity(tm, torch.from_numpy(q), got_v, frame)
    close(back.numpy(), dq, 1e-7)


def test_end_effector_pose_and_clip_to_limits_match_jax(ur5_pair):
    jm, tm = ur5_pair
    rng = np.random.default_rng(9)
    q = rng.uniform(-8, 8, (7, 6))
    q[0] = np.asarray(jm.joint_upper)  # exactly on a limit
    ref = np.stack([np.asarray(jkin.end_effector_pose(jm, jnp.asarray(x))) for x in q])
    close(tkin.end_effector_pose(tm, torch.from_numpy(q)).numpy(), ref)
    close(tkin.clip_to_limits(tm, torch.from_numpy(q)).numpy(), jkin.clip_to_limits(jm, jnp.asarray(q)), 0)
    import jax

    tq = torch.from_numpy(q).requires_grad_(True)
    (grad,) = torch.autograd.grad(tkin.clip_to_limits(tm, tq).sum(), tq)
    ref = jax.grad(lambda x: jnp.sum(jkin.clip_to_limits(jm, x)))(jnp.asarray(q))
    close(grad.numpy(), ref, 0)  # 0.5 on the limit in both
    assert float(grad[0, 0]) == 0.5
