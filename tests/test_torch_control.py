"""The port's controllers against the JAX package's.

Inputs come from ``numpy.random.default_rng`` and go to both packages, in
float64; the JAX functions take one robot and are run per row where the
port takes a batch. Tolerances: 1e-9 on one controller step (the two sum
matrix products in other orders), 1e-7 on the Kalman steps (a Cholesky
solve of a 12 x 12 system) and on the 30-step closed loop, and exact
agreement on the tuning tables and on the discrete outcomes of the gain
sweep and of the step-response metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manipulapy_tpu import control as jc
from manipulapy_tpu.dynamics import forward_dynamics_fast as jax_forward_dynamics_fast
from manipulapy_tpu.models import catalog as jax_catalog
from manipulapy_tpu.models.robot import host_arrays as jax_host_arrays
from manipulapy_tpu_torch import control as tc
from manipulapy_tpu_torch.dynamics import forward_dynamics_fast
from manipulapy_tpu_torch.models import from_host_arrays

CPU = torch.device("cpu")
T = torch.from_numpy
J = jnp.asarray
G = (0.0, 0.0, -9.81)


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


def _states(seed, B=4, n=6):
    """Desired q, dq, ddq and current q, dq, each (B, n)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (B, n)) for _ in range(5)]


GAINS = dict(Kp=np.array([50.0, 40.0, 30.0, 20.0, 10.0, 5.0]), Ki=2.0, Kd=np.array([5.0, 4.0, 3.0, 2.0, 1.0, 0.5]))


def _gains(lib):
    as_lib = T if lib is torch else J
    return {k: (as_lib(v) if isinstance(v, np.ndarray) else v) for k, v in GAINS.items()}


# -- one controller step -----------------------------------------------------------


@pytest.mark.parametrize("i_clamp", [None, 0.004])
def test_computed_torque_control_matches_jax(ur5_pair, i_clamp):
    jm, tm = ur5_pair
    qd, dqd, ddqd, q, dq = _states(0)
    eint = np.random.default_rng(1).uniform(-0.01, 0.01, (4, 6))
    tau, state = tc.computed_torque_control(
        tm, T(qd), T(dqd), T(ddqd), T(q), T(dq), G, 0.01, **_gains(torch), state=tc.ControlState(T(eint)), i_clamp=i_clamp
    )
    assert tau.shape == (4, 6) and state.eint.shape == (4, 6)
    for b in range(4):
        tau_j, state_j = jc.computed_torque_control(
            jm, J(qd[b]), J(dqd[b]), J(ddqd[b]), J(q[b]), J(dq[b]), J(G), 0.01, **_gains(jnp),
            state=jc.ControlState(J(eint[b])), i_clamp=i_clamp,
        )
        close(tau[b].numpy(), tau_j)
        close(state.eint[b].numpy(), state_j.eint)
    if i_clamp:
        assert float(state.eint.abs().max()) == i_clamp


def test_elementwise_laws_match_jax():
    qd, dqd, _, q, dq = _states(2)
    g_t, g_j = _gains(torch), _gains(jnp)
    close(tc.pd_control(T(qd), T(dqd), T(q), T(dq), g_t["Kp"], g_t["Kd"]).numpy(),
          jc.pd_control(J(qd), J(dqd), J(q), J(dq), g_j["Kp"], g_j["Kd"]))
    tau, st = tc.pid_control(T(qd), T(dqd), T(q), T(dq), 0.02, **g_t, state=tc.ControlState(torch.zeros(4, 6, dtype=torch.float64)))
    tau_j, st_j = jc.pid_control(J(qd), J(dqd), J(q), J(dq), 0.02, **g_j, state=jc.ControlState(jnp.zeros((4, 6))))
    close(tau.numpy(), tau_j)
    close(st.eint.numpy(), st_j.eint)
    close(tc.joint_space_control(None, T(qd), T(q), T(dq), g_t["Kp"], g_t["Kd"]).numpy(),
          jc.joint_space_control(None, J(qd), J(q), J(dq), g_j["Kp"], g_j["Kd"]))
    zero = tc.ControlState.zero(6, torch.float64, device="cpu")
    assert zero.eint.shape == (6,) and zero.eint.dtype == torch.float64 and not bool(zero.eint.any())


def test_model_based_laws_match_jax(ur5_pair):
    jm, tm = ur5_pair
    qd, dqd, ddqd, q, dq = _states(3)
    rng = np.random.default_rng(4)
    Ftip, dist, p_des = rng.uniform(-2, 2, 6), rng.uniform(-1, 1, (4, 6)), rng.uniform(-0.5, 0.5, (4, 3))
    g_t, g_j = _gains(torch), _gains(jnp)
    got = {
        "robust": tc.robust_control(tm, T(q), T(dq), T(ddqd), G, T(Ftip), T(dist), 0.3),
        "adaptive": tc.adaptive_control(tm, T(q), T(dq), T(ddqd), G, T(Ftip), T(dist), 0.1, T(dist) * 0.5),
        "feedforward": tc.feedforward_control(tm, T(qd), T(dqd), T(ddqd), G, T(Ftip)),
        "pd_feedforward": tc.pd_feedforward_control(tm, T(qd), T(dqd), T(ddqd), T(q), T(dq), G, T(Ftip), g_t["Kp"], g_t["Kd"]),
        "cartesian": tc.cartesian_space_control(tm, T(p_des), T(q), T(dq), 80.0, 6.0),
    }
    for b in range(4):
        ref = {
            "robust": jc.robust_control(jm, J(q[b]), J(dq[b]), J(ddqd[b]), J(G), J(Ftip), J(dist[b]), 0.3),
            "adaptive": jc.adaptive_control(jm, J(q[b]), J(dq[b]), J(ddqd[b]), J(G), J(Ftip), J(dist[b]), 0.1, J(dist[b]) * 0.5),
            "feedforward": jc.feedforward_control(jm, J(qd[b]), J(dqd[b]), J(ddqd[b]), J(G), J(Ftip)),
            "pd_feedforward": jc.pd_feedforward_control(
                jm, J(qd[b]), J(dqd[b]), J(ddqd[b]), J(q[b]), J(dq[b]), J(G), J(Ftip), g_j["Kp"], g_j["Kd"]
            ),
            "cartesian": jc.cartesian_space_control(jm, J(p_des[b]), J(q[b]), J(dq[b]), 80.0, 6.0),
        }
        for name, r in ref.items():
            if name == "adaptive":
                close(got[name][0][b].numpy(), r[0])
                close(got[name][1][b].numpy(), r[1])
            else:
                close(got[name][b].numpy(), r)


def test_closed_loop_matches_jax(ur5_pair):
    """30 periods of computed-torque control on the exact dynamics, both
    packages stepping the same loop."""
    jm, tm = ur5_pair
    q_goal = np.array([0.3, -0.8, 0.6, 0.2, -0.4, 0.1])
    dt, zero = 0.005, np.zeros(6)
    q_t, dq_t, st_t = T(zero.copy()), T(zero.copy()), tc.ControlState(T(zero.copy()))

    @jax.jit
    def jax_period(q, dq, st):
        tau, st = jc.computed_torque_control(jm, J(q_goal), J(zero), J(zero), q, dq, J(G), dt, 60.0, 1.0, 12.0, st)
        q, dq, tau = jc.enforce_limits(jm, q, dq, tau)
        dq = dq + jax_forward_dynamics_fast(jm, q, dq, tau, J(G)) * dt
        return q + dq * dt, dq, st

    q_j, dq_j, st_j = J(zero), J(zero), jc.ControlState(J(zero))
    for _ in range(30):
        tau_t, st_t = tc.computed_torque_control(tm, T(q_goal), T(zero), T(zero), q_t, dq_t, G, dt, 60.0, 1.0, 12.0, st_t)
        q_t, dq_t, tau_t = tc.enforce_limits(tm, q_t, dq_t, tau_t)
        dq_t = dq_t + forward_dynamics_fast(tm, q_t, dq_t, tau_t, G) * dt
        q_t = q_t + dq_t * dt
        q_j, dq_j, st_j = jax_period(q_j, dq_j, st_j)
    close(q_t.numpy(), q_j, 1e-7)
    close(dq_t.numpy(), dq_j, 1e-7)
    assert float((q_t - T(q_goal)).norm()) < float(T(q_goal).norm())  # it moves toward the goal


# -- Kalman filter ---------------------------------------------------------------------


def test_kalman_filter_matches_jax(ur5_pair):
    jm, tm = ur5_pair
    rng = np.random.default_rng(5)
    q, dq, tau = rng.uniform(-1, 1, (3, 6)), rng.uniform(-0.5, 0.5, (3, 6)), rng.uniform(-5, 5, (3, 6))
    z = np.concatenate([q, dq], axis=-1) + rng.normal(scale=0.05, size=(3, 12))
    A = rng.normal(size=(12, 12))
    Q, R = 1e-3 * np.eye(12), 0.05 * np.eye(12) + 0.01 * (A @ A.T) / 12
    s0 = tc.KalmanState.initial(T(q), T(dq), p0=0.7)
    assert s0.x_hat.shape == (3, 12) and s0.P.shape == (3, 12, 12)
    pred = tc.kalman_filter_predict(tm, s0, T(tau), G, None, 0.01, T(Q))
    upd = tc.kalman_filter_update(pred, T(z), T(R))
    both = tc.kalman_filter_control(tm, s0, T(tau), T(z), G, None, 0.01, T(Q), T(R))
    for b in range(3):
        j0 = jc.KalmanState.initial(J(q[b]), J(dq[b]), p0=0.7)
        close(s0.P[b].numpy(), j0.P, 0)
        jpred = jc.kalman_filter_predict(jm, j0, J(tau[b]), J(G), None, 0.01, J(Q))
        jupd = jc.kalman_filter_update(jpred, J(z[b]), J(R))
        close(pred.x_hat[b].numpy(), jpred.x_hat, 1e-7)
        close(pred.P[b].numpy(), jpred.P)
        close(upd.x_hat[b].numpy(), jupd.x_hat, 1e-7)
        close(upd.P[b].numpy(), jupd.P, 1e-7)
        close(both.x_hat[b].numpy(), jupd.x_hat, 1e-7)
    # The update pulls the estimate toward the measurement and shrinks P.
    assert bool(((upd.x_hat - T(z)).norm(dim=-1) < (pred.x_hat - T(z)).norm(dim=-1)).all())
    assert bool((torch.diagonal(upd.P, dim1=-2, dim2=-1) < torch.diagonal(pred.P, dim1=-2, dim2=-1)).all())


# -- limits, tuning, metrics -----------------------------------------------------------------


def test_enforce_limits_matches_jax(ur5_pair):
    jm, tm = ur5_pair
    rng = np.random.default_rng(6)
    q, dq, tau = rng.uniform(-10, 10, (5, 6)), rng.uniform(-10, 10, (5, 6)), rng.uniform(-500, 500, (5, 6))
    for g, r in zip(tc.enforce_limits(tm, T(q), T(dq), T(tau)), jc.enforce_limits(jm, J(q), J(dq), J(tau))):
        close(g.numpy(), r, 0)
    tq = tm.joint_upper.clone().requires_grad_(True)  # on the limit: derivative 0.5, as jnp.clip's
    (grad,) = torch.autograd.grad(tc.enforce_limits(tm, tq, tq, tq)[0].sum(), tq)
    assert bool((grad == 0.5).all())


@pytest.mark.parametrize("kind", ["P", "PI", "PID", "pid"])
def test_ziegler_nichols_matches_jax(kind):
    Ku, Tu = np.array([10.0, 4.0]), np.array([2.0, 0.5])
    for g, r in zip(tc.ziegler_nichols_tuning(T(Ku), T(Tu), kind), jc.ziegler_nichols_tuning(J(Ku), J(Tu), kind)):
        close(g.numpy(), r, 1e-12)
    for g, r in zip(tc.tune_controller(10.0, 2.0, kind, n=6, device="cpu"), jc.tune_controller(10.0, 2.0, kind, n=6)):
        assert g.shape == (6,)
        close(g.numpy(), np.asarray(r, np.float64), 1e-6)


@pytest.mark.parametrize("Tu", [0.0, -1.0, float("nan"), float("inf")])
def test_ziegler_nichols_rejects_bad_period(Tu):
    for kind in ("PI", "PID"):
        with pytest.raises(ValueError, match="no sustained oscillation"):
            tc.ziegler_nichols_tuning(10.0, Tu, kind, device="cpu")
        with pytest.raises(ValueError):
            jc.ziegler_nichols_tuning(10.0, Tu, kind)
    assert float(tc.ziegler_nichols_tuning(10.0, Tu, "P", device="cpu")[0]) == 5.0  # P needs no period
    with pytest.raises(ValueError, match="Unknown controller kind"):
        tc.ziegler_nichols_tuning(10.0, 1.0, "PD", device="cpu")


@pytest.mark.parametrize(
    "kwargs,oscillates",
    [(dict(steps=400, Kp_start=20.0, num_gains=4), True), (dict(steps=150, num_gains=8), False)],
)
def test_find_ultimate_gain_and_period_matches_jax(planar_pair, kwargs, oscillates):
    """A sweep that sustains oscillation gives Ku, Tu > 0; one whose gains
    only ring down gives Tu == 0 and the largest gain tried."""
    jm, tm = planar_pair
    q0, goal = np.zeros(2), np.array([0.5, -0.3])
    Ku, Tu = tc.find_ultimate_gain_and_period(tm, T(q0), T(goal), (0.0, 0.0, 0.0), **kwargs)
    Ku_j, Tu_j = jc.find_ultimate_gain_and_period(jm, J(q0), J(goal), jnp.zeros(3), **kwargs)
    assert Ku.shape == () and Tu.shape == ()
    close(Ku.numpy(), Ku_j, 1e-12)
    close(Tu.numpy(), Tu_j, 1e-12)
    if oscillates:
        assert float(Ku) >= 20.0 and float(Tu) > 0
        tc.ziegler_nichols_tuning(Ku, Tu, "PID")
    else:
        assert float(Tu) == 0.0 and float(Ku) == pytest.approx(0.5 * 1.1 ** (kwargs["num_gains"] - 1))
        with pytest.raises(ValueError):
            tc.ziegler_nichols_tuning(Ku, Tu, "PID")


def _responses():
    t = np.linspace(0, 10, 801)
    zeta, wn = 0.5, 2.0
    wd = wn * np.sqrt(1 - zeta**2)
    under = 1 - np.exp(-zeta * wn * t) * (np.cos(wd * t) + zeta / np.sqrt(1 - zeta**2) * np.sin(wd * t))
    slow = 1 - np.exp(-0.1 * t)  # never reaches 90%, never settles
    over = 1 - np.exp(-3.0 * t)  # no overshoot
    flat = np.zeros_like(t)  # already at a zero setpoint
    return t, np.stack([under, slow, over, flat], axis=1), np.array([1.0, 1.0, 1.0, 0.0])


def test_step_response_metrics_match_jax():
    t, y, sp = _responses()
    got = tc.step_response_metrics(T(t), T(y), T(sp))
    ref = jc.step_response_metrics(J(t), J(y), J(sp))
    assert set(got) == set(ref)
    for name in got:
        assert got[name].shape == (4,)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-12, atol=1e-12, equal_nan=True)
    expected = 100 * np.exp(-np.pi * 0.5 / np.sqrt(1 - 0.25))
    assert float(got["percent_overshoot"][0]) == pytest.approx(expected, rel=0.05)
    assert np.isnan(float(got["rise_time"][1])) and np.isnan(float(got["settling_time"][1]))
    assert float(got["percent_overshoot"][2]) == 0.0 and float(got["settling_time"][2]) > 0
    assert float(got["settling_time"][3]) == 0.0
    one = tc.step_response_metrics(T(t), T(y[:, 0].copy()), 1.0)
    assert one["rise_time"].shape == () and float(one["rise_time"]) == float(got["rise_time"][0])
