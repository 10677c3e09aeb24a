"""The calibrated fleet: every vendored robot the JAX fleet benchmark
solves, against the JAX package.

The fleet is ``benchmarks/fleet_benchmark.py``'s: the first key of each URDF
in ``robot_data.list_robots()``, each robot's root-to-tip chain
(``load_robot(key, chain_joints_only=True)``), 25 robots of 1 to 8 joints,
and the fully actuated Kinova Jaco (10 joints) besides.

* The step program (the port's tensor emission of ``ops/fd_step.py``, the
  plain version every kernel inlines) against JAX's generic dynamics
  (``dynamics.forward_dynamics_fast``, semi-implicit Euler, the limit
  clamps) on the same robot, given to both through ``from_host_arrays``:
  float64 within 1e-9 (relative and absolute); float32 within 1e-4 / 1e-3 /
  2e-1 on q / dq / ddq (the JAX package's rollout tolerances) plus 5e-4 of
  each dq and ddq entry's magnitude (a Jaco finger weighs grams: its
  accelerations reach ~1e5, where f32 rounding alone, amplified by the
  mass matrix's conditioning, is 8e-5 of them). JAX's step takes the model
  as an argument, so it compiles once per joint count.
* The whole batched solve at n = 1 (``robotiq_2f_85``) against JAX's on its
  CPU route (interpret mode), with the JAX tests' bars on the cost (rtol
  1e-5) and the final state (atol 5e-4); the controls within 5e-3 of their
  largest magnitude (21 N m here): in the second iteration one scenario
  improves its cost by less than f32 resolves (3.2999954 against
  3.2999961), so the two line searches may keep different alphas there.
* A robot whose URDF gives every joint a torque limit of 0
  (``abb_irb2400``): every control is +0.0, and the cost is the
  zero-control cost, JAX's (its generic rollout and the tracking cost,
  rtol 1e-5: JAX's batched solve for 6 joints does not compile in a test's
  time on this CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import trajectory as jtraj
from manipulapy_tpu.dynamics import forward_dynamics_fast
from manipulapy_tpu.models import robot_data as jax_robot_data
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu.mpc.fused_batch import build_batch_tracking_mpc as jax_build_batch
from manipulapy_tpu_torch.models import from_host_arrays, host_arrays, robot_data
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc
from manipulapy_tpu_torch.ops import fd_step as tfd

CPU = torch.device("cpu")
DT = 0.01
G = (0.0, 0.0, -9.81)


def fleet_keys():
    """The fleet benchmark's robots: the first key of each URDF."""
    seen, keys = set(), []
    for key in robot_data.list_robots():
        urdf = robot_data.ROBOT_DATABASE[key].urdf
        if urdf not in seen:
            seen.add(urdf)
            keys.append(key)
    return keys


FLEET = [(key, True) for key in fleet_keys()] + [("jaco_7dof", False)]  # (key, chain joints only)
IDS = [key if chain else f"{key}_full" for key, chain in FLEET]


def test_the_fleet_is_the_benchmarks():
    assert len(FLEET) == 26
    joints = sorted(robot_data.load_robot(k, chain_joints_only=c, device="cpu").num_joints for k, c in FLEET)
    assert joints == [1] * 2 + [6] * 16 + [7] * 5 + [8] * 2 + [10]


def _jax_model(key, chain, dtype):
    return jax_robot_data.load_robot(key, dtype=dtype, chain_joints_only=chain)


@pytest.mark.parametrize("key, chain", FLEET, ids=IDS)
def test_the_port_loads_each_robot_as_jax_does(key, chain):
    """The port's own URDF copy and extraction give the JAX package's
    robot: the same f64 host arrays, so the same digest."""
    port = robot_data.load_robot(key, chain_joints_only=chain, dtype=torch.float64, device="cpu")
    assert host_arrays(port)["digest"] == jax_host_arrays(_jax_model(key, chain, jnp.float64))["digest"]


def _jax_step(model, q, dq, tau):
    ddq = forward_dynamics_fast(model, q, dq, tau, jnp.asarray(G, dtype=q.dtype))
    dq2 = dq + ddq * DT
    q2 = jnp.clip(q + dq2 * DT, model.joint_lower, model.joint_upper)
    return q2, jnp.clip(dq2, -model.velocity_limit, model.velocity_limit), ddq


# One compile per joint count and dtype: the model is an argument.
JAX_STEP = jax.jit(jax.vmap(_jax_step, in_axes=(None, 0, 0, 0)))


def _step_inputs(host, B=16, seed=0):
    """q0 in [-1, 1] inside the joint limits, dq0 in [-0.5, 0.5], tau in
    [-10, 10] inside the torque limits (bench.py's distributions)."""
    n = len(host["joint_lower"])
    rng = np.random.default_rng(seed)
    lo = np.maximum(host["joint_lower"], -1.0)
    hi = np.minimum(host["joint_upper"], 1.0)
    q = lo + rng.uniform(0.0, 1.0, (B, n)) * (hi - lo)
    lim = np.minimum(host["torque_limit"], 10.0)
    return q, rng.uniform(-0.5, 0.5, (B, n)), rng.uniform(-1.0, 1.0, (B, n)) * lim


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("key, chain", FLEET, ids=IDS)
def test_step_program_matches_jax_dynamics(key, chain, dtype):
    jm = _jax_model(key, chain, jnp.float64)
    host = jax_host_arrays(jm)
    tdt, jdt = (torch.float64, jnp.float64) if dtype == "float64" else (torch.float32, jnp.float32)
    tm = from_host_arrays(host, dtype=tdt, device=CPU)
    if dtype == "float32":
        jm = _jax_model(key, chain, jnp.float32)
    q, dq, tau = (x.astype(dtype) for x in _step_inputs(host))
    got = tfd.build_fd_step(tm, DT, g=G)(*(torch.from_numpy(x) for x in (q, dq, tau)))
    ref = JAX_STEP(jm, *(jnp.asarray(x) for x in (q, dq, tau)))
    tols = (1e-9, 1e-9, 1e-9) if dtype == "float64" else (1e-4, 1e-3, 2e-1)
    for name, g_, r, tol in zip(("q", "dq", "ddq"), got, ref, tols):
        g_, r = g_.numpy(), np.asarray(r)
        assert g_.shape == r.shape == q.shape and np.isfinite(r).all()
        rtol = tol if dtype == "float64" else (0.0 if name == "q" else 5e-4)
        np.testing.assert_allclose(g_, r, rtol=rtol, atol=tol, err_msg=name)


# -- the whole batched solve -----------------------------------------------------

SB, SH, SITERS = 3, 10, 2


def _fleet_draws(host, B, seed):
    """The fleet benchmark's problem: limits without inf, clipped to
    +-pi; goals mid +- 0.3 half, q0 mid +- 0.2 half, at rest."""
    lo = np.clip(np.nan_to_num(host["joint_lower"], neginf=-np.pi, posinf=np.pi), -np.pi, np.pi)
    hi = np.clip(np.nan_to_num(host["joint_upper"], neginf=-np.pi, posinf=np.pi), -np.pi, np.pi)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    rng = np.random.default_rng(seed)
    n = len(lo)
    goals = (mid + rng.uniform(-0.3, 0.3, (B, n)) * half).astype(np.float32)
    q0 = (mid + rng.uniform(-0.2, 0.2, (B, n)) * half).astype(np.float32)
    return np.concatenate([q0, np.zeros_like(q0)], axis=1), goals


def test_batched_solve_of_one_joint_matches_jax():
    jm = _jax_model("robotiq_2f_85", True, jnp.float32)
    tm = from_host_arrays(jax_host_arrays(jm), device=CPU)
    x0, goals = _fleet_draws(jax_host_arrays(jm), SB, seed=1)
    jmpc = jax_build_batch(jm, jnp.asarray(goals), SB, SH, DT, iterations=SITERS, interpret=True)
    ju, jx, jc = (np.asarray(v) for v in jmpc.solve(jnp.asarray(x0), jnp.zeros((SB, SH, 1), jnp.float32)))
    tmpc = build_batch_tracking_mpc(tm, goals, SB, SH, DT, iterations=SITERS)
    tu, tx, tc = (v.numpy() for v in tmpc.solve(torch.from_numpy(x0), torch.zeros(SB, SH, 1)))
    assert tu.shape == (SB, SH, 1) and tx.shape == (SB, SH + 1, 2) and np.isfinite(tc).all()
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    np.testing.assert_allclose(tx[:, -1], jx[:, -1], atol=5e-4)
    np.testing.assert_allclose(tu, ju, atol=5e-3 * np.abs(ju).max())


def _tracking_cost(qs, dqs, goals, w_q=10.0, w_dq=0.5, w_terminal=100.0):
    """The solver's cost of a trajectory without controls: the running
    cost at states 0..H-1, the terminal cost at state H."""
    run = (w_q * (qs[:, :-1] - goals[:, None]) ** 2 + w_dq * dqs[:, :-1] ** 2).sum(axis=(1, 2))
    term = (w_terminal * (qs[:, -1] - goals) ** 2 + 0.1 * w_terminal * dqs[:, -1] ** 2).sum(axis=1)
    return run + term


def test_zero_torque_limits_give_zero_controls_and_the_zero_control_cost():
    """``abb_irb2400``'s URDF says effort="0": every control is clamped to
    [-0, 0], so the controls are +0.0 and no alpha improves the cost, which
    stays the zero-control rollout's (the JAX fleet benchmark reports this
    robot's cost the same way)."""
    jm = _jax_model("abb_irb2400", True, jnp.float32)
    host = jax_host_arrays(jm)
    assert not np.any(host["torque_limit"])
    tm = from_host_arrays(host, device=CPU)
    B, H, n = 4, SH, 6
    x0, goals = _fleet_draws(host, B, seed=2)
    mpc = build_batch_tracking_mpc(tm, goals, B, H, DT, iterations=SITERS)
    us, xs, cost = mpc.solve(torch.from_numpy(x0), torch.full((B, H, n), 5.0))
    assert torch.equal(us.view(torch.int32), torch.zeros_like(us).view(torch.int32))
    zero = mpc.replay(torch.from_numpy(x0).T.contiguous(), torch.zeros(H, 2 * n, B), torch.zeros(H, n, B),
                      torch.zeros(H, n, 1 + 2 * n, B), torch.from_numpy(goals).T.contiguous(), torch.zeros(B))
    assert torch.equal(cost, zero[2])
    # K4's every alpha is clamped to +0.0 too.
    sd_x = torch.cat([torch.from_numpy(x0).T[None], xs.permute(1, 2, 0)[1:-1]]).contiguous()
    kK = torch.randn(H, n, 1 + 2 * n, B, generator=torch.Generator().manual_seed(0))
    _, _, us_all = mpc.linesearch(torch.from_numpy(x0).T.contiguous(), sd_x, us.permute(1, 2, 0).contiguous(), kK,
                                  torch.from_numpy(goals).T.contiguous(), torch.tensor([1.0, 0.5]))
    assert torch.equal(us_all.view(torch.int32), torch.zeros_like(us_all).view(torch.int32))
    # JAX's zero-control cost: its generic rollout (no velocity limit is
    # reached in H steps from rest) and the tracking cost.
    qs, dqs, _ = jtraj._forward_dynamics_trajectory_generic(
        jm, jnp.asarray(x0[:, :n]), jnp.asarray(x0[:, n:]), jnp.zeros((B, H + 1, n), jnp.float32), dt=DT)
    qs, dqs = np.asarray(qs, np.float64), np.asarray(dqs, np.float64)
    assert np.abs(dqs).max() < host["velocity_limit"].min()
    np.testing.assert_allclose(cost.numpy(), _tracking_cost(qs, dqs, goals), rtol=1e-5)
