"""The port's simulated plant (``manipulapy_tpu_torch/sim.py``) against the
JAX package's ``Simulation``.

* One UR5 step under gravity with viscous damping 0.5 and the velocity
  clamp active, four substeps; f64, 1e-10.
* 20 steps of closed-loop computed-torque tracking (``run_controller``)
  along a quintic; f64, 1e-9 on the achieved positions and the final state.
* The CSV export read back against JAX's file; ``set_joint_positions``
  clamps; the self-collision query; the PyBullet gate at call time.
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import trajectory as jtraj
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.sim import Simulation as JaxSimulation
from manipulapy_tpu_torch.models import from_host_arrays
from manipulapy_tpu_torch.sim import Simulation, pybullet_available

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ur5_pair():
    jm = jax_catalog.ur5(dtype=jnp.float64)
    return jm, from_host_arrays(jax_host_arrays(jm), dtype=torch.float64, device=CPU)


def _both(ur5_pair, **kw):
    jm, tm = ur5_pair
    return JaxSimulation(jm, **kw), Simulation(tm, **kw)


def test_step_with_damping_matches_jax(ur5_pair):
    """A fast start under gravity and damping 0.5: the last joint starts at
    4 rad/s, past UR5's 3.14 rad/s limit, so the velocity clamp acts."""
    jsim, tsim = _both(ur5_pair, dt=0.01, substeps=4, joint_damping=0.5)
    q0 = [0.3, -0.8, 1.1, -0.4, 0.6, -0.2]
    dq0 = [2.5, -1.0, 0.5, 0.0, 1.5, 4.0]
    tau = [20.0, -60.0, 15.0, 4.0, -3.0, 2.0]
    jsim.reset(q=q0, dq=dq0)
    tsim.reset(q=q0, dq=dq0)
    jsim.step(jnp.asarray(tau))
    tsim.step(torch.tensor(tau, dtype=torch.float64))
    np.testing.assert_allclose(tsim.q.numpy(), np.asarray(jsim.q), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tsim.dq.numpy(), np.asarray(jsim.dq), rtol=1e-10, atol=1e-10)
    assert tsim.time == jsim.time and len(tsim.history) == len(jsim.history) == 1
    assert tsim.dq[5] == ur5_pair[1].velocity_limit[5]


def test_run_controller_matches_jax(ur5_pair, tmp_path):
    jsim, tsim = _both(ur5_pair, dt=0.01, substeps=2, joint_damping=0.1)
    jm, _ = ur5_pair
    plan = jtraj.joint_trajectory(jm, jnp.zeros(6), jnp.asarray([0.4, -0.3, 0.5, 0.2, -0.1, 0.3]), 0.5, 20, 5)
    desired = [np.array(x) for x in (plan.position, plan.velocity, plan.acceleration)]
    got = tsim.run_controller(*desired)
    ref = jsim.run_controller(*desired)
    assert got.shape == ref.shape == (20, 6)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tsim.dq.numpy(), np.asarray(jsim.dq), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tsim.end_effector_pose(), jsim.end_effector_pose(), atol=1e-9)

    # The CSV export, read back: the same header, times and states.
    tpath, jpath = tmp_path / "port.csv", tmp_path / "jax.csv"
    tsim.save_joint_states(str(tpath))
    jsim.save_joint_states(str(jpath))
    trows = list(csv.reader(tpath.open()))
    jrows = list(csv.reader(jpath.open()))
    assert trows[0] == jrows[0] == ["time"] + [f"q{i}" for i in range(6)] + [f"dq{i}" for i in range(6)]
    assert len(trows) == len(jrows) == 21
    np.testing.assert_allclose(np.array(trows[1:], dtype=float), np.array(jrows[1:], dtype=float),
                               rtol=1e-9, atol=1e-9)


def test_set_joint_positions_and_self_collision_match_jax(ur5_pair):
    jsim, tsim = _both(ur5_pair)
    far = [7.0, -7.0, 0.5, 0.0, 3.0, -1.0]  # outside UR5's +-2 pi on two joints
    jsim.set_joint_positions(far)
    tsim.set_joint_positions(far)
    np.testing.assert_array_equal(tsim.get_joint_positions(), np.asarray(jsim.get_joint_positions()))
    assert not tsim.dq.any()
    for q in ([0.0] * 6, [0.3, -2.5, 2.8, -1.0, 0.4, 0.0]):
        jsim.reset(q=q)
        tsim.reset(q=q)
        t_col, t_clear = tsim.check_self_collision()
        j_col, j_clear = jsim.check_self_collision()
        assert t_col == j_col and isinstance(t_col, bool)
        assert t_clear == pytest.approx(j_clear, abs=1e-12)


def test_pybullet_gated():
    if pybullet_available():
        pytest.skip("pybullet installed")
    with pytest.raises(ImportError, match="PyBullet"):
        Simulation(from_host_arrays(jax_host_arrays(jax_catalog.two_link_planar(dtype=jnp.float64)),
                                    dtype=torch.float64, device=CPU), use_pybullet=True)
