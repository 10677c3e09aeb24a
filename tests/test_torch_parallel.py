"""The port's fleet layer (``manipulapy_tpu_torch/parallel``) against the JAX
package's, and its mesh on CPU devices.

* ``stack_models`` field for field, ``masked_forward_dynamics`` (the padded
  accelerations exactly 0), ``fleet_rollout`` and ``fleet_ilqr_solve`` on
  a fleet of the two-link arm and ``serial_chain(3)``, S = 2, f64, 1e-8.
* A CPU mesh of 3 entries with a ragged B = 7: ``sharded_vmap``,
  ``distributed_rollout`` and ``distributed_ik`` equal the unsharded calls
  exactly (padding rows and chunking change no bit).
* ``build_sharded_batch_mpc`` on a CPU mesh of 2 equals the unsharded port
  solver bit for bit; the fleet round on the fused solver against the
  generic iLQR round, rtol 0.05 (the JAX test's bar); the padded joint's
  controls exactly 0.
* ``make_mesh()`` raises on a host without CUDA rather than choosing the
  CPU.

The card's own checks (the fleet's solvers bitwise against each robot's
own, ``distributed_rollout`` through K1) are in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.ilqr import ILQRParams as JParams
from manipulapy_tpu.parallel import fleet as jfleet
from manipulapy_tpu_torch import parallel, trajectory
from manipulapy_tpu_torch.ik import solve_ik_batch
from manipulapy_tpu_torch.kinematics import forward_kinematics
from manipulapy_tpu_torch.models import catalog, from_host_arrays, host_arrays
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc
from manipulapy_tpu_torch.mpc.ilqr import ILQRParams

CPU = torch.device("cpu")
G0 = (0.0, 0.0, 0.0)


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def fleets():
    """The same two-robot fleet in both packages, f64."""
    jms = [jax_catalog.two_link_planar(dtype=jnp.float64), jax_catalog.serial_chain(3, dtype=jnp.float64)]
    tms = [from_host_arrays(jax_host_arrays(m), dtype=torch.float64, device=CPU) for m in jms]
    return jfleet.stack_models(jms), parallel.stack_models(tms)


@pytest.fixture(scope="module")
def cpu_mesh3():
    return parallel.make_mesh(devices=["cpu"] * 3)


def _fleet_states(seed, R=2, S=2, n=3, N=None, mask=None):
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(-0.5, 0.5, (R, S, n)) * mask[:, None]
    dq0 = rng.uniform(-0.3, 0.3, (R, S, n)) * mask[:, None]
    taus = rng.uniform(-2.0, 2.0, (R, S, N, n)) * mask[:, None, None] if N else None
    return q0, dq0, taus


def test_stack_models_matches_jax(fleets):
    jf, tf = fleets
    assert tf.num_robots == 2 and tf.num_joints == 3
    for name in ("home", "screws_space", "screws_body", "inertias", "com_home", "joint_lower", "joint_upper",
                 "velocity_limit", "torque_limit"):
        np.testing.assert_array_equal(getattr(tf.model, name).numpy(), np.asarray(getattr(jf.model, name)))
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))
    # Each padded robot is a model of its own with the stacked values, and
    # unpadding gives back the robot's own f64 arrays (its digest).
    two_link = from_host_arrays(jax_host_arrays(jax_catalog.two_link_planar(dtype=jnp.float64)),
                                dtype=torch.float64, device=CPU)
    padded, mask = tf.robot(0)
    assert torch.equal(padded.com_home, tf.model.com_home[0]) and mask.tolist() == [1.0, 1.0, 0.0]
    assert host_arrays(parallel.unpad_robot(padded, 2))["digest"] == host_arrays(two_link)["digest"]


def test_masked_forward_dynamics_matches_jax(fleets):
    jf, tf = fleets
    q0, dq0, _ = _fleet_states(0, mask=tf.mask.numpy())
    tau = np.random.default_rng(1).uniform(-3, 3, (2, 2, 3)) * tf.mask.numpy()[:, None]
    for r in range(2):
        jm, jmask = jf.robot(r)
        tm, tmask = tf.robot(r)
        ref = jax.jit(jax.vmap(lambda q, dq, u: jfleet.masked_forward_dynamics(jm, jmask, q, dq, u, g=jnp.zeros(3))))(
            jnp.asarray(q0[r]), jnp.asarray(dq0[r]), jnp.asarray(tau[r]))
        got = parallel.masked_forward_dynamics(tm, tmask, torch.from_numpy(q0[r]), torch.from_numpy(dq0[r]),
                                               torch.from_numpy(tau[r]), g=G0)
        close(got.numpy(), ref, 1e-8)
        if r == 0:
            assert not got[:, 2].any()  # the padded joint's acceleration is exactly 0


def test_fleet_rollout_matches_jax(fleets):
    jf, tf = fleets
    q0, dq0, taus = _fleet_states(2, N=6, mask=tf.mask.numpy())
    ref = jfleet.fleet_rollout(jf, *(jnp.asarray(a) for a in (q0, dq0, taus)), dt=0.02, g=jnp.zeros(3))
    got = parallel.fleet_rollout(tf, *(torch.from_numpy(a) for a in (q0, dq0, taus)), dt=0.02, g=G0)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == (2, 2, 6, 3)
        close(a.numpy(), b, 1e-8)
    assert not got[0][0, :, :, 2].any() and not got[1][0, :, :, 2].any()


def test_fleet_ilqr_solve_matches_jax(fleets):
    """The port's loop over robots with ``vmap`` of ``ilqr`` over the
    scenarios against JAX's nested ``vmap``; two iterations, H = 6."""
    jf, tf = fleets
    H, mask = 6, tf.mask.numpy()
    q0, dq0, _ = _fleet_states(3, mask=mask)
    x0 = np.concatenate([q0, dq0], axis=-1)
    us0 = np.zeros((2, 2, H, 3))
    goals = np.random.default_rng(4).uniform(-0.5, 0.5, (2, 2, 3)) * mask[:, None]
    ref = jfleet.fleet_ilqr_solve(jf, *(jnp.asarray(a) for a in (x0, us0, goals)),
                                  JParams(horizon=H, dt=0.02, iterations=2, line_search_steps=4), g=jnp.zeros(3))
    got = parallel.fleet_ilqr_solve(tf, *(torch.from_numpy(a) for a in (x0, us0, goals)),
                                    ILQRParams(horizon=H, dt=0.02, iterations=2, line_search_steps=4), g=G0)
    for name in ("xs", "us", "cost", "gains_K"):
        close(getattr(got, name).numpy(), getattr(ref, name), 1e-8)
    assert got.converged.tolist() == np.asarray(ref.converged).tolist()
    assert not got.us[0, :, :, 2].any()


def test_mesh_basics(cpu_mesh3):
    assert cpu_mesh3.size == 3 and cpu_mesh3.axis_names == ("scenario",)
    x = torch.arange(12.0).reshape(6, 2)
    shards = parallel.shard_batch(x, cpu_mesh3)
    assert [s.tolist() for s in shards] == [x[0:2].tolist(), x[2:4].tolist(), x[4:6].tolist()]
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_batch(x[:5], cpu_mesh3)
    ur5 = catalog.ur5(dtype=torch.float64, device=CPU)
    assert all(host_arrays(m)["digest"] == host_arrays(ur5)["digest"]
               for m in parallel.replicate_model(ur5, cpu_mesh3))
    assert parallel.scaling_efficiency({1: 10.0, 2: 10.5})[2] == pytest.approx(10.0 / 10.5)


def test_make_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        assert parallel.make_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()


def test_sharded_calls_on_a_ragged_batch_equal_the_unsharded_ones(cpu_mesh3):
    """B = 7 over 3 CPU entries (padded to 9, un-padded on return)."""
    ur5 = catalog.ur5(dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(5)
    qs = torch.from_numpy(rng.uniform(-1.0, 1.0, (7, 6)))
    fk = parallel.sharded_vmap(forward_kinematics, cpu_mesh3)(ur5, qs)
    assert torch.equal(fk, vmap(lambda q: forward_kinematics(ur5, q))(qs))

    dq0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (7, 6)))
    taus = torch.from_numpy(rng.uniform(-5.0, 5.0, (7, 4, 6)))
    got = parallel.distributed_rollout(ur5, cpu_mesh3, qs, dq0, taus, dt=0.01)
    ref = trajectory.forward_dynamics_trajectory(ur5, qs, dq0, taus, dt=0.01)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))

    targets = forward_kinematics(ur5, qs)
    kw = dict(max_iterations=40, eomg=1e-6, ev=1e-6)
    got = parallel.distributed_ik(ur5, cpu_mesh3, targets, qs + 0.1, **kw)
    ref = solve_ik_batch(ur5, targets, qs + 0.1, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert bool(got.success.all())


def test_sharded_batch_mpc_equals_the_unsharded_solver():
    """On a CPU mesh of 2 the plain kernels run per chunk: the same bits as
    one solver over the whole batch; the fleet cost is the mean."""
    mesh = parallel.make_mesh(devices=["cpu", "cpu"])
    model = catalog.two_link_planar(dtype=torch.float32, device=CPU)
    B, H, n = 8, 8, 2
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.uniform(-0.3, 0.3, (B, 4)).astype(np.float32))
    goals = torch.from_numpy(rng.uniform(-0.8, 0.8, (B, n)).astype(np.float32))
    us0 = torch.zeros((B, H, n))
    smpc = parallel.build_sharded_batch_mpc(model, mesh, goals, B, H, 0.02, iterations=3)
    us_s, xs_s, cost_s, fleet = smpc.solve(x0, us0)
    ref = build_batch_tracking_mpc(model, goals, B, H, 0.02, iterations=3)
    us_r, xs_r, cost_r = ref.solve(x0, us0)
    assert torch.equal(us_s, us_r) and torch.equal(xs_s, xs_r) and torch.equal(cost_s, cost_r)
    np.testing.assert_allclose(float(fleet), float(cost_r.mean()), rtol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        parallel.build_sharded_batch_mpc(model, parallel.make_mesh(devices=["cpu"] * 3), goals, B, H, 0.02)


def test_fleet_round_fused_matches_ilqr():
    """``fleet_mpc_round(solver='fused_batch')`` on the fleet of the JAX
    test (two-link arm and ``serial_chain(3)``, S = 8, H = 8) against the
    generic round, on a CPU mesh of 2."""
    mesh = parallel.make_mesh(devices=["cpu", "cpu"])
    fl = parallel.stack_models([catalog.two_link_planar(dtype=torch.float32, device=CPU),
                                catalog.serial_chain(3, dtype=torch.float32, device=CPU)])
    R, S, n_max, H = 2, 8, fl.num_joints, 8
    rng = np.random.default_rng(0)
    x0 = torch.zeros((R, S, 2 * n_max))
    us0 = torch.zeros((R, S, H, n_max))
    q_goals = torch.from_numpy(rng.uniform(-0.5, 0.5, (R, S, n_max)).astype(np.float32)) * fl.mask[:, None, :]
    params = ILQRParams(horizon=H, dt=0.02, iterations=2, line_search_steps=4)
    us_f, costs_f, fc_f = parallel.fleet_mpc_round(fl, mesh, x0, us0, q_goals, params, solver="fused_batch")
    assert tuple(us_f.shape) == (R, S, H, n_max)
    assert not us_f[0, :, :, 2:].any()  # the padded joint's controls are exactly 0
    us_g, costs_g, fc_g = parallel.fleet_mpc_round(fl, mesh, x0, us0, q_goals, params, solver="ilqr")
    np.testing.assert_allclose(costs_f.numpy(), costs_g.numpy(), rtol=0.05)
    np.testing.assert_allclose(float(fc_f), float(fc_g), rtol=0.05)
    with pytest.raises(ValueError, match="divisible"):
        parallel.fleet_mpc_round(fl, parallel.make_mesh(devices=["cpu"] * 3), x0, us0, q_goals, params,
                                 solver="fused_batch")
